"""K2's vanilla region: the sampling of ``render_vanilla``
(``dreamfusion_tpu/models/renderer.py:186-238``).

``vanilla_coarse`` places the coarse samples: the sphere's near/far (|o| ∓
bound, ``core/sampling.py::near_far_from_bound``), ``stratified_zs`` from
unit jitter draws (or none), the deltas where asked and the positions
clamped to the box.  ``vanilla_resample`` takes the coarse pass's density
and does the rest: alpha, the weights by the exclusive cumprod of
1 - alpha + 1e-15, ``sample_pdf`` over the S - 1 midpoints and the S - 2
interior weights, the merge sorted, the deltas with the trailing
(far - near) / S, and the clamped positions.  Neither has a gradient.

On a CUDA tensor each is one launch of a kernel in ``csrc/occupancy.cu``
(``vanilla_coarse``, ``vanilla_resample``, counted apart); on a CPU tensor
the plain versions run (``*_plain``), whose serial sums and cumprod follow
XLA's order on the CPU.  The kernels hold at most 66 coarse samples and 64
draws a ray and raise beyond.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.sampling import (compute_deltas, near_far_from_bound, sample_pdf,
                             stratified_zs)
from . import kernels

MAX_STEPS, MAX_DRAWS = 66, 64      # csrc/occupancy.cu's kMaxS, kMaxN


def _positions(rays_o, rays_d, z, bound):
    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return torch.clamp(xyzs, -bound, bound)


def vanilla_coarse_plain(rays_o, rays_d, bound: float, lin, u=None,
                         need_deltas: bool = False):
    near, far = near_far_from_bound(rays_o, rays_d, bound, kind="sphere")
    z = stratified_zs(near, far, lin, u)
    deltas = compute_deltas(z, (far - near) / z.shape[-1]) if need_deltas \
        else None
    return z, deltas, _positions(rays_o, rays_d, z, bound)


def vanilla_resample_plain(rays_o, rays_d, bound: float, z, sigma, u):
    near, far = near_far_from_bound(rays_o, rays_d, bound, kind="sphere")
    S = z.shape[-1]
    if u.dim() == 1:
        u = u.expand(z.shape[0], -1)
    step = (far - near) / S
    deltas = compute_deltas(z, step)
    alphas = 1.0 - torch.exp(-deltas * sigma)
    keep = 1.0 - alphas + 1e-15
    # the exclusive cumprod, serial as XLA's CPU cumprod
    trans = [torch.ones_like(step[:, 0])]
    for i in range(S - 1):
        trans.append(trans[-1] * keep[:, i])
    weights = alphas * torch.stack(trans, -1)
    z_mid = z[:, :-1] + 0.5 * deltas[:, :-1]
    new_z = sample_pdf(z_mid, weights[:, 1:-1], u)
    z_all = torch.sort(torch.cat([z, new_z], -1), -1).values
    return (z_all, compute_deltas(z_all, step),
            _positions(rays_o, rays_d, z_all, bound))


def _check_rays(rays_o, rays_d):
    if rays_o.dim() != 2 or rays_o.shape[-1] != 3 or \
            rays_d.shape != rays_o.shape:
        raise ValueError("vanilla sampling takes rays [R, 3]")
    if rays_o.dtype != torch.float32 or rays_d.dtype != torch.float32:
        raise ValueError("vanilla sampling takes fp32 rays")


def _draws(u, R, n, what):
    """u's pointer-ready form and its row stride (0: one row for all)."""
    if u.dtype != torch.float32 or u.shape[-1] != n or \
            u.dim() == 2 and u.shape[0] != R or u.dim() > 2:
        raise ValueError(f"{what}: draws must be fp32 [{R}, {n}] or [{n}]")
    if u.stride(-1) != 1:
        u = u.contiguous()
    return u, 0 if u.dim() == 1 else u.stride(0)


def vanilla_coarse_cuda(rays_o, rays_d, bound: float, lin, u=None,
                        need_deltas: bool = False):
    _check_rays(rays_o, rays_d)
    R, S = rays_o.shape[0], lin.shape[0]
    if not 2 <= S <= MAX_STEPS:
        raise ValueError(f"vanilla_coarse holds 2 to {MAX_STEPS} samples a "
                         f"ray, got num_steps {S}")
    u_sr = 0
    if u is not None:
        u, u_sr = _draws(u, R, S, "vanilla_coarse")
    kernels.check_cuda(lin, *([] if u is None else [u]))
    for t in (rays_o, rays_d):
        if t.device != lin.device:
            raise ValueError(f"expected CUDA tensors on {lin.device}")
    dev = rays_o.device
    z = torch.empty(R, S, device=dev)
    deltas = torch.empty(R, S, device=dev) if need_deltas else None
    xyzs = torch.empty(R, S, 3, device=dev)
    P = kernels.ptr
    kernels.launch("vanilla_coarse", P(rays_o), rays_o.stride(0),
                   rays_o.stride(1), P(rays_d), rays_d.stride(0),
                   rays_d.stride(1), float(bound), P(lin), P(u), u_sr, S, R,
                   P(z), P(deltas), P(xyzs))
    return z, deltas, xyzs


def vanilla_resample_cuda(rays_o, rays_d, bound: float, z, sigma, u):
    _check_rays(rays_o, rays_d)
    R, S = z.shape
    n = u.shape[-1]
    if not 3 <= S <= MAX_STEPS or not 1 <= n <= MAX_DRAWS:
        raise ValueError(f"vanilla_resample holds 3 to {MAX_STEPS} coarse "
                         f"samples and 1 to {MAX_DRAWS} draws a ray, got "
                         f"{S} and {n}")
    if sigma.shape != (R, S) or sigma.dtype != torch.float32 or \
            z.dtype != torch.float32 or rays_o.shape[0] != R:
        raise ValueError(f"vanilla_resample: z and sigma must be fp32 "
                         f"[{rays_o.shape[0]}, {S}]")
    u, u_sr = _draws(u, R, n, "vanilla_resample")
    z, sigma = z.contiguous(), sigma.contiguous()
    kernels.check_cuda(z, sigma, u)
    for t in (rays_o, rays_d):
        if t.device != z.device:
            raise ValueError(f"expected CUDA tensors on {z.device}")
    dev = z.device
    M = S + n
    z_out = torch.empty(R, M, device=dev)
    deltas = torch.empty(R, M, device=dev)
    xyzs = torch.empty(R, M, 3, device=dev)
    P = kernels.ptr
    kernels.launch("vanilla_resample", P(rays_o), rays_o.stride(0),
                   rays_o.stride(1), P(rays_d), rays_d.stride(0),
                   rays_d.stride(1), float(bound), P(z), P(sigma), P(u), u_sr,
                   S, n, R, P(z_out), P(deltas), P(xyzs))
    return z_out, deltas, xyzs


def _route(t, name):
    if t.is_cuda:
        return globals()[name + "_cuda"]
    if t.device.type == "cpu":
        return globals()[name + "_plain"]
    raise ValueError(f"unsupported device {t.device}")


def vanilla_coarse(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float,
                   lin: torch.Tensor, u: Optional[torch.Tensor] = None,
                   need_deltas: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              torch.Tensor]:
    """rays [R, 3] fp32 (any strides), lin [S] = ``linspace(0, 1, S)``, u
    [R, S] unit jitter draws or None → (z [R, S], deltas [R, S] or None,
    xyzs [R, S, 3] = clamp(o + d z, ±bound))."""
    with torch.no_grad():
        return _route(rays_o, "vanilla_coarse")(rays_o, rays_d, bound, lin,
                                                u, need_deltas)


def vanilla_resample(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     bound: float, z: torch.Tensor, sigma: torch.Tensor,
                     u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coarse z and sigma [R, S], u [R, n] non-decreasing draws in
    [0, 1) or one [n] row for every ray → (z [R, S + n] sorted, deltas
    [R, S + n], xyzs [R, S + n, 3])."""
    with torch.no_grad():
        return _route(rays_o, "vanilla_resample")(rays_o, rays_d, bound, z,
                                                  sigma, u)
