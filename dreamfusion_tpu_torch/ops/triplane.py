"""K1: triplane feature encoder (``dreamfusion_tpu/ops/triplane.py``).

``triplane_encode(x, planes, ...)`` returns bilinear features from three
axis-aligned planes (xy, xz, yz) per sample and, with
``need_jacobian=True``, the closed-form derivative of the features along
x, y and z.  Planes are ``[3, R, R, C]`` fp32, channel-last, one tensor per
scale; x is ``[N, 3]`` in [0, 1].

On a CUDA tensor each scale is one launch of the CUDA kernel in
``csrc/triplane.cu`` forward and one backward; on a CPU tensor the plain
version below runs.  The planes carry gradients through both the
features and the jacobian, so normals built from the jacobian
differentiate into the planes with first-order autograd only.  Positions
carry the features' gradient when they ask for one (the DMTet stage
queries albedo at rasterized surface points): dL/dx = Σ g·∂feat/∂x, the
jacobian from one more forward launch; the jacobian's own gradient into
the positions (a second derivative) is on no path and raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from . import kernels

_PLANE_AXES = ((0, 1), (0, 2), (1, 2))


@dataclass(frozen=True)
class TriplaneSpec:
    resolution: int = 256
    channels: int = 16
    num_scales: int = 2

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(max(16, self.resolution // (2 ** s))
                     for s in range(self.num_scales))

    @property
    def output_dim(self) -> int:
        return 3 * self.channels * self.num_scales


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _corners(x: torch.Tensor, R: int):
    """Per (sample, plane): flat corner row ids [N,3,4], weights and their
    (u, v) derivatives [N,3,4] (derivatives scaled by R-1 and masked to
    0 < coord < 1), and the out-of-bounds sample mask [N]."""
    N = x.shape[0]
    uv = torch.stack([x[:, list(ax)] for ax in _PLANE_AXES], dim=1)  # [N,3,2]
    inside = ((uv > 0.0) & (uv < 1.0)).to(x.dtype)
    pos = torch.clamp(uv, 0.0, 1.0) * (R - 1)
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.long()
    i1 = torch.clamp(i0 + 1, max=R - 1)
    base = torch.arange(3, device=x.device)[None, :] * (R * R)
    iu = (i0[..., 0], i0[..., 0], i1[..., 0], i1[..., 0])
    iv = (i0[..., 1], i1[..., 1], i0[..., 1], i1[..., 1])
    ids = torch.stack([base + a * R + b for a, b in zip(iu, iv)], dim=-1)
    fy, fx = frac[..., 0], frac[..., 1]
    w = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx),
                     fy * fx], dim=-1)
    su = (R - 1) * inside[..., 0:1]
    sv = (R - 1) * inside[..., 1:2]
    du = torch.stack([-(1 - fx), -fx, (1 - fx), fx], dim=-1) * su
    dv = torch.stack([-(1 - fy), (1 - fy), -fy, fy], dim=-1) * sv
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    return ids, w, du, dv, oob


def _route(fu: torch.Tensor, fv: torch.Tensor):
    """Per-plane (u, v) derivatives [N,3,C] → per-axis jx, jy, jz [N,3C]:
    planes xy, xz, yz have (u, v) = (x, y), (x, z), (y, z)."""
    N = fu.shape[0]
    z0 = torch.zeros_like(fu[:, 0])
    jx = torch.stack([fu[:, 0], fu[:, 1], z0], 1).reshape(N, -1)
    jy = torch.stack([fv[:, 0], z0, fu[:, 2]], 1).reshape(N, -1)
    jz = torch.stack([z0, fv[:, 1], fv[:, 2]], 1).reshape(N, -1)
    return jx, jy, jz


def triplane_fwd_plain(x: torch.Tensor, planes: torch.Tensor,
                       need_jacobian: bool) -> List[torch.Tensor]:
    """One scale: [feat] or [feat, jx, jy, jz], each [N, 3C] fp32."""
    C, R = planes.shape[-1], planes.shape[1]
    N = x.shape[0]
    ids, w, du, dv, oob = _corners(x, R)
    vals = planes.reshape(-1, C)[ids.reshape(-1)].reshape(N * 3, 4, C)
    keep = (~oob).to(x.dtype)[:, None]
    if not need_jacobian:
        feat = torch.bmm(w.reshape(N * 3, 1, 4), vals)
        return [feat.reshape(N, 3 * C) * keep]
    wts = torch.stack([w, du, dv], -2).reshape(N * 3, 3, 4)
    f, fu, fv = torch.bmm(wts, vals).reshape(N, 3, 3, C).unbind(2)
    return [f.reshape(N, 3 * C) * keep] + [j * keep for j in _route(fu, fv)]


def triplane_bwd_plain(x: torch.Tensor, planes_shape: Sequence[int],
                       g_feat: Optional[torch.Tensor],
                       g_j: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """dplanes [3,R,R,C] for cotangents on feat and on jx, jy, jz
    (each [N, 3C] or None)."""
    _, R, _, C = planes_shape
    N = x.shape[0]
    ids, w, du, dv, oob = _corners(x, R)
    zero = torch.zeros(N, 3, C, device=x.device, dtype=torch.float32)

    def per_plane(g):
        return zero if g is None else g.float().reshape(N, 3, C)

    keep = (~oob).to(torch.float32)[:, None, None]   # no gradient if OOB
    gx, gy, gz = (per_plane(g) for g in g_j)
    gf = per_plane(g_feat) * keep
    gu = torch.stack([gx[:, 0], gx[:, 1], gy[:, 2]], 1) * keep  # [N,3,C]
    gv = torch.stack([gy[:, 0], gz[:, 1], gz[:, 2]], 1) * keep
    wts = torch.stack([w, du, dv], -1).reshape(N * 3, 4, 3)
    cots = torch.stack([gf, gu, gv], -2).reshape(N * 3, 3, C)
    coef = torch.bmm(wts, cots)                               # [N*3, 4, C]
    dplanes = torch.zeros(3 * R * R, C, device=x.device, dtype=torch.float32)
    dplanes.index_add_(0, ids.reshape(-1), coef.reshape(-1, C))
    return dplanes.reshape(3, R, R, C)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def triplane_fwd_cuda(x: torch.Tensor, planes: torch.Tensor,
                      need_jacobian: bool, out_dtype: torch.dtype
                      ) -> List[torch.Tensor]:
    kernels.check_cuda(x, planes)
    if x.dtype != torch.float32 or planes.dtype != torch.float32:
        raise ValueError("triplane kernel takes fp32 x and planes")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    N, (_, R, _, C) = x.shape[0], planes.shape
    outs = [torch.empty(N, 3 * C, device=x.device, dtype=out_dtype)
            for _ in range(4 if need_jacobian else 1)]
    jx, jy, jz = outs[1:] if need_jacobian else (None, None, None)
    kernels.launch("triplane_fwd", kernels.ptr(planes), kernels.ptr(x), N, R,
                   C, kernels.ptr(outs[0]), kernels.ptr(jx),
                   kernels.ptr(jy), kernels.ptr(jz),
                   int(out_dtype == torch.bfloat16))
    return outs


def triplane_bwd_cuda(x: torch.Tensor, planes_shape: Sequence[int],
                      g_feat: Optional[torch.Tensor],
                      g_j: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    _, R, _, C = planes_shape
    N = x.shape[0]
    g_feat, *g_j = [None if g is None else g.float().contiguous()
                    for g in (g_feat, *g_j)]
    kernels.check_cuda(x, g_feat, *g_j)
    dplanes = torch.zeros(tuple(planes_shape), device=x.device,
                          dtype=torch.float32)
    kernels.launch("triplane_bwd", kernels.ptr(x), N, R, C,
                   kernels.ptr(g_feat), *(kernels.ptr(g) for g in g_j),
                   kernels.ptr(dplanes))
    return dplanes


def _x_grad(x, planes, g_feat):
    """dL/dx [N,3] = Σ_c g_feat · ∂feat/∂x (in [0,1] units)."""
    fwd = triplane_fwd_cuda if x.is_cuda else \
        (lambda *a: triplane_fwd_plain(*a[:3]))
    _, *jac = fwd(x, planes, True, torch.float32)
    g = g_feat.float()
    return torch.stack([(g * j).sum(-1) for j in jac], -1)


class _TriplaneScale(torch.autograd.Function):
    """One scale of the encoder."""

    @staticmethod
    def forward(ctx, x, planes, need_jacobian: bool, out_dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, planes if ctx.needs_input_grad[0] else None)
        ctx.planes_shape = tuple(planes.shape)
        if x.is_cuda:
            outs = triplane_fwd_cuda(x, planes, need_jacobian, out_dtype)
        elif x.device.type == "cpu":
            outs = [o.to(out_dtype)
                    for o in triplane_fwd_plain(x, planes, need_jacobian)]
        else:
            raise ValueError(f"unsupported device {x.device}")
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_feat, *g_j):
        x, planes = ctx.saved_tensors
        g_j = tuple(g_j) + (None,) * (3 - len(g_j))
        if g_feat is None and all(g is None for g in g_j):
            return None, None, None, None
        dx = None
        if ctx.needs_input_grad[0]:
            if any(g is not None for g in g_j):
                raise NotImplementedError(
                    "the jacobian's gradient into the positions is not "
                    "implemented")
            if g_feat is not None:
                dx = _x_grad(x, planes.detach(), g_feat)
        bwd = triplane_bwd_cuda if x.is_cuda else triplane_bwd_plain
        return dx, bwd(x, ctx.planes_shape, g_feat, g_j), None, None


def triplane_encode(x: torch.Tensor, planes: Sequence[torch.Tensor],
                    spec: TriplaneSpec, max_level: Optional[float] = None,
                    out_dtype: torch.dtype = torch.float32,
                    need_jacobian: bool = False):
    """x [N,3] in [0,1] → feat [N, D], or (feat, (jx, jy, jz)) with
    ``need_jacobian``; each j* is [N, D] in [0,1]-coordinate units.  Scale 0
    is the finest; ``max_level`` masks scales from the coarse end."""
    x = x.float().contiguous()
    S = spec.num_scales
    n_active = S
    if max_level is not None:
        n_active = min(max(math.ceil(max_level * S), 1), S)
    n_out = 4 if need_jacobian else 1
    per_scale = []
    for s, p in enumerate(planes):
        if (S - 1 - s) < n_active:
            per_scale.append(_TriplaneScale.apply(x, p, need_jacobian,
                                                  out_dtype))
        else:
            z = torch.zeros(x.shape[0], 3 * p.shape[-1], device=x.device,
                            dtype=out_dtype)
            per_scale.append((z,) * n_out)
    outs = [per_scale[0][i] if S == 1 else
            torch.cat([o[i] for o in per_scale], -1) for i in range(n_out)]
    if need_jacobian:
        return outs[0], tuple(outs[1:])
    return outs[0]


def init_triplane(spec: TriplaneSpec, generator: torch.Generator,
                  scale: float = 1e-1) -> List[torch.Tensor]:
    """[3, R_s, R_s, C] fp32 per scale, N(0, scale²) (CPU generator)."""
    return [torch.randn(3, r, r, spec.channels, generator=generator) * scale
            for r in spec.resolutions]
