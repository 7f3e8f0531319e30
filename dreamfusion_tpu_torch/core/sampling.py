"""Ray-interval math and inverse-CDF sampling
(``dreamfusion_tpu/core/sampling.py``).

``sample_pdf`` is the plain version of the sampling half of the occupancy
march kernel (``ops/occupancy.py``) and, with ``stratified_zs``, of the
vanilla render's resampling (``ops/resample.py``); their uniform draws are
arguments.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def near_far_from_bound(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        bound: float, kind: str = "cube",
                        min_near: float = 0.05
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray/AABB (or sphere) entry and exit distances, [..., 1] each.
    Rays that miss the box get near = far = 1e9; the sphere's are |o| ∓
    bound, unclamped (near may be below min_near, or negative)."""
    if kind == "sphere":
        o = rays_o
        # |o| with the squares summed in order, as the kernels sum them
        radius = torch.sqrt(o[..., :1] * o[..., :1] + o[..., 1:2] * o[..., 1:2]
                            + o[..., 2:3] * o[..., 2:3])
        return radius - bound, radius + bound
    inv_d = 1.0 / (rays_d + 1e-15)
    tmin = (-bound - rays_o) * inv_d
    tmax = (bound - rays_o) * inv_d
    near = torch.minimum(tmin, tmax).amax(-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, 1e9, near)
    far = torch.where(miss, 1e9, far)
    near = torch.clamp(near, min=min_near)
    return near, far


def linspace(start: float, stop: float, num: int, device=None
             ) -> torch.Tensor:
    """fp32 ``start·(1−s) + stop·s`` with s = i / (num−1), the formula of
    ``jnp.linspace``: probe edges and sample positions then round as the
    JAX package's do (``torch.linspace`` rounds differently, and a draw
    that moves by one ulp can cross an occupancy cell boundary)."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    out = torch.tensor(start, dtype=torch.float32) * (1 - s) + \
        torch.tensor(stop, dtype=torch.float32) * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def stratified_zs(near: torch.Tensor, far: torch.Tensor, lin: torch.Tensor,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """near + (far - near)·lin [R, S] for lin = ``linspace(0, 1, S)``,
    jittered by (u - 1/2)·(far - near)/S with unit draws u [R, S] (the
    samples may then leave [near, far] slightly)."""
    z = near + (far - near) * lin[None, :]
    if u is not None:
        z = z + (u - 0.5) * ((far - near) / lin.shape[0])
    return z


def compute_deltas(z_vals: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """z's successive differences [R, S], the last one ``last`` [R, 1]."""
    return torch.cat([z_vals[:, 1:] - z_vals[:, :-1], last], -1)


def stratified_u(unit: torch.Tensor) -> torch.Tensor:
    """Jittered stratified draws (k + U_k) / n from unit uniforms [B, n]:
    one per stratum, monotone along the last axis."""
    n = unit.shape[-1]
    k = torch.arange(n, device=unit.device, dtype=unit.dtype)
    return (k + unit) / n


def det_u(B: int, n: int, device=None) -> torch.Tensor:
    """Deterministic draws at stratum centres, [B, n]."""
    return linspace(0.5 / n, 1.0 - 0.5 / n, n, device=device).expand(B, n)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
               ) -> torch.Tensor:
    """Inverse-CDF sampling: bins [B, T] edges, weights [B, T-1], u [B, n]
    monotone draws in [0, 1) → z [B, n]."""
    T = bins.shape[-1]
    weights = weights + 1e-5
    # sequential sums, in the order the march kernel and XLA's CPU reduce
    # take: the inverse CDF divides any rounding difference by the
    # interval's probability
    total = weights[:, 0]
    for i in range(1, T - 1):
        total = total + weights[:, i]
    pdf = weights / total[:, None]
    cdf = [torch.zeros_like(total)]
    for i in range(T - 1):
        cdf.append(cdf[-1] + pdf[:, i])
    cdf = torch.stack(cdf, -1)                                    # [B, T]
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)            # >= 1
    below = inds - 1
    above = torch.clamp(inds, max=T - 1)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bin_lo = torch.gather(bins, 1, below)
    bin_hi = torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)
