"""K6: multiresolution hash-grid encoder (``dreamfusion_tpu/ops/hashgrid.py``).

``hash_encode(x, table, spec, ...)`` returns, per sample and level, the
trilinear (or smoothstep) blend of the 8 lattice corners' rows of one
``[table_size, C]`` fp32 table and, with ``need_jacobian=True``, the
closed-form derivative of the features along x, y and z, in [0,1]-coordinate
units: the same contract as ``ops/triplane.py::triplane_encode``, so the
field builds its normals the same way for both backbones.  Dense levels
(``res³ ≤ size``) index the corner clamped to the lattice; hashed levels
index ``(Σ_d c_d·P_d) mod 2³² mod size`` of the unclamped corner (``affine``)
or ``(⊕_d c_d·P_d) mod size`` of the clamped one (``hash``, xor as in tcnn),
in uint32 arithmetic.  A sample with a coordinate outside [0,1] gives zeros
and no gradient; levels at or above ``ceil(max_level·L)`` give zeros.

On a CUDA tensor the forward is one launch of ``csrc/hashgrid.cu`` and the
backward one more (vector reductions into the table's gradient); on a CPU
tensor the plain versions below run.  The table receives gradients through
both the features and the jacobian, so normals built from the jacobian
differentiate into it with first-order autograd.  The positions receive the
features' gradient when they ask for one (dL/dx = Σ g·∂feat/∂x), from the
same backward launch as the table's (``hashgrid_bwd_dx``), and in that
launch the jacobian's own gradient too (the second derivative ``jax.grad``
takes through ``jax.jvp`` of ``hash_encode``): the trilinear weights'
mixed terms on every level, and under ``interpolation="smoothstep"`` the
pure one, smoothstep″(t) = 6 − 12t; the clip's tie rule enters once per
derivative (a quarter at the lattice's ends for the pure term).

``hashgrid_tv_loss`` (squared differences between sampled lattice cells and
their +x, +y, +z neighbours) and ``hashgrid_wd_loss`` (level-meaned weight
decay) are kernels too, forward and backward.

``_corner_pack`` and the affine rolls of the JAX package are not ported:
they pack rows for the TPU's row-priced gathers; the kernel reads the 8
corners directly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import kernels
from .freq import active_count

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
_D = 3                                  # input dimension (xyz)
INIT_SCALE = 1e-4                       # the table's uniform init bound
TV_SAMPLES = 4096                       # tv cells per level and step


@dataclass(frozen=True)
class HashGridSpec:
    """Levels of the encoder, computed as ``dreamfusion_tpu``'s spec with
    ``input_dim=3``, ``align_corners=False`` and a desired resolution."""
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048
    gridtype: str = "hash"              # hash (xor) | affine
    interpolation: str = "linear"       # linear | smoothstep

    @property
    def scale(self) -> float:
        return 2.0 ** (math.log2(self.desired_resolution /
                                 self.base_resolution)
                       / (self.num_levels - 1))

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(self.base_resolution * self.scale ** l))
                     for l in range(self.num_levels))

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(min(2 ** self.log2_hashmap_size, r ** _D)
                     for r in self.resolutions)

    @property
    def offsets(self) -> Tuple[int, ...]:
        off = [0]
        for s in self.level_sizes:
            off.append(off[-1] + s)
        return tuple(off)

    @property
    def table_size(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def dense(self, l: int) -> bool:
        return self.level_sizes[l] == self.resolutions[l] ** _D


def init_hashgrid(spec: HashGridSpec,
                  generator: torch.Generator) -> torch.Tensor:
    """[table_size, C] fp32, uniform in (-1e-4, 1e-4) (CPU generator)."""
    u = torch.rand(spec.table_size, spec.level_dim, generator=generator)
    return u * (2 * INIT_SCALE) - INIT_SCALE


def n_active_levels(spec: HashGridSpec, max_level: Optional[float]) -> int:
    """max(min(ceil(max_level·L), L), 1) levels (the product in float32),
    or all of them."""
    L = spec.num_levels
    return min(max(active_count(max_level, L), 1), L)


def _check_spec(spec: HashGridSpec) -> None:
    if spec.gridtype not in ("hash", "affine"):
        raise ValueError(f"unsupported gridtype {spec.gridtype!r}")
    if spec.interpolation not in ("linear", "smoothstep"):
        raise ValueError(f"unsupported interpolation {spec.interpolation!r}")
    if spec.gridtype == "affine":
        for l, s in enumerate(spec.level_sizes):
            if not spec.dense(l) and s & (s - 1):
                raise ValueError("an affine-hashed level needs a power-of-2 "
                                 "size")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _level_index(c: torch.Tensor, res: int, size: int, dense: bool,
                 gridtype: str) -> torch.Tensor:
    """Lattice coords [..., 3] int64 → row in the level [...] (int64): the
    raster index on a dense level, else the affine or xor hash in uint32
    arithmetic (int64 masked to 32 bits after every multiply and add)."""
    if dense:
        return c[..., 0] + c[..., 1] * res + c[..., 2] * (res * res)
    h = torch.zeros_like(c[..., 0])
    for d in range(_D):
        term = (c[..., d] * _PRIMES[d]) & _MASK32
        h = ((h + term) & _MASK32) if gridtype == "affine" else (h ^ term)
    return h % size


def _corners(x: torch.Tensor, spec: HashGridSpec, l: int,
             hessian: bool = False):
    """One level: flat table rows of the 8 corners [N, 8] (corner bit d =
    axis d), their weights [N, 8] and the weights' derivatives along x, y,
    z [N, 8, 3] (zero outside the clip interval, half at its ends, as the
    JAX package's clip differentiates); with ``hessian``, also the
    derivatives of those along x, y, z [N, 8, 3, 3] ([k, d, e] = ∂dw[k,
    d]/∂x_e), the clip's factor taken once more for each."""
    res, size = spec.resolutions[l], spec.level_sizes[l]
    dense = spec.dense(l)
    raw = x * res - 0.5
    pos = torch.clamp(raw, 0.0, res - 1)
    fl = torch.floor(pos)
    f = pos - fl
    if spec.interpolation == "smoothstep":
        s = f * f * (3.0 - 2.0 * f)
        ds = 6.0 * f * (1.0 - f)
        d2s = 6.0 - 12.0 * f
    else:
        s, ds, d2s = f, torch.ones_like(f), torch.zeros_like(f)
    inside = (raw > 0) & (raw < res - 1)
    edge = (raw == 0) | (raw == res - 1)
    dpos = torch.where(inside, float(res),
                       torch.where(edge, 0.5 * res, 0.0))
    dt = ds * dpos                                        # [N, 3]
    ddt = d2s * dpos * dpos
    t = torch.stack([1.0 - s, s], -1)                     # [N, 3, 2]
    base = fl.long()
    ws, dws, d2ws, ids = [], [], [], []
    for k in range(8):
        bits = [(k >> d) & 1 for d in range(_D)]
        t0, t1, t2 = tk = [t[:, d, b] for d, b in enumerate(bits)]
        sg = [dt[:, d] if b else -dt[:, d] for d, b in enumerate(bits)]
        ws.append(t0 * t1 * t2)
        dws.append(torch.stack([t1 * t2 * sg[0], t0 * t2 * sg[1],
                                t0 * t1 * sg[2]], -1))
        if hessian:
            h = [[None] * _D for _ in range(_D)]
            for d in range(_D):
                e, g = (d + 1) % _D, (d + 2) % _D
                h[d][d] = tk[e] * tk[g] * (ddt[:, d] if bits[d] else
                                           -ddt[:, d])
                h[d][e] = h[e][d] = tk[g] * sg[d] * sg[e]
            d2ws.append(torch.stack([torch.stack(r, -1) for r in h], -2))
        c = base + torch.tensor(bits, device=x.device)
        if dense or spec.gridtype == "hash":
            c = torch.clamp(c, max=res - 1)
        ids.append(_level_index(c, res, size, dense, spec.gridtype))
    off = spec.offsets[l]
    out = (torch.stack(ids, 1) + off, torch.stack(ws, 1), torch.stack(dws, 1))
    return out + (torch.stack(d2ws, 1),) if hessian else out


def _oob(x: torch.Tensor) -> torch.Tensor:
    return ((x < 0.0) | (x > 1.0)).any(-1)


def hash_fwd_plain(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                   n_active: int, need_jacobian: bool) -> List[torch.Tensor]:
    """[feat] or [feat, jx, jy, jz], each [N, L·C] fp32."""
    N, C, L = x.shape[0], spec.level_dim, spec.num_levels
    keep = (~_oob(x)).to(torch.float32)[:, None]
    outs = [torch.zeros(N, L, C, device=x.device)
            for _ in range(4 if need_jacobian else 1)]
    for l in range(n_active):
        ids, w, dw = _corners(x, spec, l)
        vals = table[ids.reshape(-1)].reshape(N, 8, C)
        if need_jacobian:
            wts = torch.cat([w[:, None], dw.transpose(1, 2)], 1)  # [N,4,8]
        else:
            wts = w[:, None]
        res = torch.bmm(wts, vals)                                # [N,k,C]
        for i, o in enumerate(outs):
            o[:, l] = res[:, i] * keep
    return [o.reshape(N, L * C) for o in outs]


def hash_bwd_plain(x: torch.Tensor, spec: HashGridSpec, n_active: int,
                   g_feat: Optional[torch.Tensor],
                   g_j: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """dtable [T, C] for cotangents on feat and on jx, jy, jz (each
    [N, L·C] or None)."""
    N, C, L = x.shape[0], spec.level_dim, spec.num_levels
    keep = (~_oob(x)).to(torch.float32)[:, None, None]
    zero = torch.zeros(N, L, C, device=x.device)

    def per_level(g):
        return zero if g is None else g.float().reshape(N, L, C) * keep

    gf = per_level(g_feat)
    gj = [per_level(g) for g in g_j]
    dtable = torch.zeros(spec.table_size, C, device=x.device)
    for l in range(n_active):
        ids, w, dw = _corners(x, spec, l)
        cots = torch.stack([gf[:, l]] + [g[:, l] for g in gj], 1)  # [N,4,C]
        wts = torch.cat([w[..., None], dw], -1)                     # [N,8,4]
        coef = torch.bmm(wts, cots)                                 # [N,8,C]
        dtable.index_add_(0, ids.reshape(-1), coef.reshape(-1, C))
    return dtable


def hash_bwd_dx_plain(x: torch.Tensor, table: torch.Tensor,
                      spec: HashGridSpec, n_active: int,
                      g_feat: Optional[torch.Tensor],
                      g_j: Sequence[Optional[torch.Tensor]] = (None,) * 3
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dtable [T, C], dx [N, 3]) for cotangents on feat and on jx, jy, jz
    (each [N, L·C] or None): dx = Σ_l Σ_c g_feat·∂feat/∂x + Σ_d
    g_j_d·∂j_d/∂x, the weights' derivatives under the clip's tie rule
    (``_corners``)."""
    N, C, L = x.shape[0], spec.level_dim, spec.num_levels
    dtable = hash_bwd_plain(x, spec, n_active, g_feat, g_j)
    keep = (~_oob(x)).to(torch.float32)[:, None, None]

    def per_level(g):
        return None if g is None else g.float().reshape(N, L, C) * keep

    gf, gj = per_level(g_feat), [per_level(g) for g in g_j]
    hess = any(g is not None for g in gj)
    dx = torch.zeros(N, 3, device=x.device)
    for l in range(n_active):
        ids, _, dw, *d2w = _corners(x, spec, l, hessian=hess)
        vals = table[ids.reshape(-1)].reshape(N, 8, C)
        if gf is not None:
            s = (vals * gf[:, l, None]).sum(-1)              # [N, 8]
            dx = dx + (dw * s[..., None]).sum(1)
        for d, g in enumerate(gj):
            if g is not None:
                s = (vals * g[:, l, None]).sum(-1)           # [N, 8]
                dx = dx + (d2w[0][:, :, d] * s[..., None]).sum(1)
    return dtable, dx


def _tv_pairs(cells: torch.Tensor, spec: HashGridSpec, l: int):
    """Rows of the sampled cells [S] and of their +x, +y, +z neighbours
    (clamped to the lattice) [3, S] on level l."""
    res, size = spec.resolutions[l], spec.level_sizes[l]
    dense, off = spec.dense(l), spec.offsets[l]
    c = cells.long()
    i0 = _level_index(c, res, size, dense, spec.gridtype) + off
    i1 = []
    for d in range(_D):
        nb = c.clone()
        nb[:, d] = torch.clamp(nb[:, d] + 1, max=res - 1)
        i1.append(_level_index(nb, res, size, dense, spec.gridtype) + off)
    return i0, torch.stack(i1)


def hash_tv_plain(table: torch.Tensor, cells: torch.Tensor,
                  spec: HashGridSpec) -> torch.Tensor:
    """mean over levels of (Σ_d mean_s Σ_c (T[nb_d] − T[cell])²) / 3;
    ``cells`` [L, S, 3] int, one draw per level."""
    total = torch.zeros((), device=table.device)
    for l in range(spec.num_levels):
        i0, i1 = _tv_pairs(cells[l], spec, l)
        v0 = table[i0]
        lvl = sum(((table[i1[d]] - v0) ** 2).sum(-1).mean()
                  for d in range(_D))
        total = total + lvl / _D
    return total / spec.num_levels


def hash_tv_bwd_plain(table: torch.Tensor, cells: torch.Tensor,
                      spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    S = cells.shape[1]
    k = 2.0 * g / (S * _D * spec.num_levels)
    dtable = torch.zeros_like(table)
    for l in range(spec.num_levels):
        i0, i1 = _tv_pairs(cells[l], spec, l)
        for d in range(_D):
            diff = (table[i1[d]] - table[i0]) * k
            dtable.index_add_(0, i1[d], diff)
            dtable.index_add_(0, i0, -diff)
    return dtable


def _level_scale(spec: HashGridSpec, device) -> torch.Tensor:
    """[T, 1]: 1 / (size_l · L) on each row of level l."""
    return torch.cat([torch.full((s, 1), 1.0 / (s * spec.num_levels),
                                 device=device) for s in spec.level_sizes])


def hash_wd_plain(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """0.5 · Σ_l ‖T_l‖² / size_l / L."""
    total = torch.zeros((), device=table.device)
    for l in range(spec.num_levels):
        off, size = spec.offsets[l], spec.level_sizes[l]
        total = total + (table[off:off + size] ** 2).sum() / size
    return 0.5 * total / spec.num_levels


def hash_wd_bwd_plain(table: torch.Tensor, spec: HashGridSpec,
                      g: torch.Tensor) -> torch.Tensor:
    return g * table * _level_scale(spec, table.device)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_LEVELS: Dict[Tuple[HashGridSpec, torch.device], torch.Tensor] = {}


def _levels(spec: HashGridSpec, device) -> torch.Tensor:
    """int32 [L, 4] (res, size, row offset, dense) on the device, made once
    per spec and device."""
    key = (spec, torch.device(device))
    if key not in _LEVELS:
        _LEVELS[key] = torch.tensor(
            [[r, s, o, int(spec.dense(l))] for l, (r, s, o) in enumerate(
                zip(spec.resolutions, spec.level_sizes, spec.offsets))],
            dtype=torch.int32, device=device)
    return _LEVELS[key]


def _modes(spec: HashGridSpec) -> Tuple[int, int]:
    return (int(spec.interpolation == "smoothstep"),
            int(spec.gridtype == "hash"))


def _check_table(table: torch.Tensor, spec: HashGridSpec) -> None:
    kernels.check_aligned(table)          # rows are read as 16-byte vectors
    if table.dtype != torch.float32 or \
            tuple(table.shape) != (spec.table_size, spec.level_dim):
        raise ValueError(f"expected an fp32 table [{spec.table_size}, "
                         f"{spec.level_dim}], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if spec.level_dim not in (2, 4, 8):
        raise ValueError(f"the kernel takes 2, 4 or 8 features per level, "
                         f"not {spec.level_dim}")


def hash_fwd_cuda(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                  n_active: int, need_jacobian: bool,
                  out_dtype: torch.dtype) -> List[torch.Tensor]:
    kernels.check_cuda(x, table)
    _check_table(table, spec)
    if x.dtype != torch.float32:
        raise ValueError("the hash-grid kernel takes fp32 positions")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    N = x.shape[0]
    outs = [torch.empty(N, spec.output_dim, device=x.device, dtype=out_dtype)
            for _ in range(4 if need_jacobian else 1)]
    jx, jy, jz = outs[1:] if need_jacobian else (None, None, None)
    kernels.launch("hashgrid_fwd", kernels.ptr(x), kernels.ptr(table),
                   kernels.ptr(_levels(spec, x.device)), N, spec.num_levels,
                   spec.level_dim, n_active, *_modes(spec),
                   kernels.ptr(outs[0]), kernels.ptr(jx), kernels.ptr(jy),
                   kernels.ptr(jz), int(out_dtype == torch.bfloat16))
    return outs


def _check_bwd(spec: HashGridSpec) -> None:
    if spec.level_dim not in (2, 4, 8):
        raise ValueError(f"the kernel takes 2, 4 or 8 features per level, "
                         f"not {spec.level_dim}")
    if spec.num_levels > 16:
        raise ValueError(f"the backward kernel takes up to 16 levels, not "
                         f"{spec.num_levels}")


def hash_bwd_cuda(x: torch.Tensor, spec: HashGridSpec, n_active: int,
                  g_feat: Optional[torch.Tensor],
                  g_j: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """dtable; the cotangents are read in their own dtype (bf16 or fp32)."""
    (g_feat, *g_j), bf16 = kernels.cotangents(g_feat, *g_j)
    kernels.check_cuda(x, g_feat, *g_j)
    _check_bwd(spec)
    dtable = torch.zeros(spec.table_size, spec.level_dim, device=x.device)
    kernels.launch("hashgrid_bwd", kernels.ptr(x),
                   kernels.ptr(_levels(spec, x.device)), x.shape[0],
                   spec.num_levels, spec.level_dim, n_active, *_modes(spec),
                   kernels.ptr(g_feat), *(kernels.ptr(g) for g in g_j), bf16,
                   kernels.ptr(dtable))
    return dtable


def hash_bwd_dx_cuda(x: torch.Tensor, table: torch.Tensor,
                     spec: HashGridSpec, n_active: int,
                     g_feat: Optional[torch.Tensor],
                     g_j: Sequence[Optional[torch.Tensor]] = (None,) * 3
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dtable, dx) in one launch: ``hash_bwd_dx_plain``'s function (null
    jacobian cotangents: the frozen path's arithmetic, bit for bit)."""
    (g_feat, *g_j), bf16 = kernels.cotangents(g_feat, *g_j)
    kernels.check_cuda(x, table, g_feat, *g_j)
    _check_table(table, spec)
    _check_bwd(spec)
    dtable = torch.zeros(spec.table_size, spec.level_dim, device=x.device)
    dx = torch.empty(x.shape[0], 3, device=x.device)
    kernels.launch("hashgrid_bwd_dx", kernels.ptr(x), kernels.ptr(table),
                   kernels.ptr(_levels(spec, x.device)), x.shape[0],
                   spec.num_levels, spec.level_dim, n_active, *_modes(spec),
                   kernels.ptr(g_feat), *(kernels.ptr(g) for g in g_j), bf16,
                   kernels.ptr(dtable), kernels.ptr(dx))
    return dtable, dx


def _check_cells(cells: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    if cells.ndim != 3 or cells.shape[0] != spec.num_levels or \
            cells.shape[2] != _D:
        raise ValueError(f"expected tv cells [{spec.num_levels}, S, 3], got "
                         f"{tuple(cells.shape)}")
    return cells.to(torch.int32).contiguous()


def hash_tv_cuda(table: torch.Tensor, cells: torch.Tensor,
                 spec: HashGridSpec) -> torch.Tensor:
    cells = _check_cells(cells, spec)
    kernels.check_cuda(table, cells)
    _check_table(table, spec)
    S = cells.shape[1]
    out = torch.zeros((), device=table.device)
    kernels.launch("hashgrid_tv_fwd", kernels.ptr(table),
                   kernels.ptr(_levels(spec, table.device)),
                   kernels.ptr(cells), S, spec.num_levels, spec.level_dim,
                   _modes(spec)[1], 1.0 / (S * _D * spec.num_levels),
                   kernels.ptr(out))
    return out


def hash_tv_bwd_cuda(table: torch.Tensor, cells: torch.Tensor,
                     spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    cells = _check_cells(cells, spec)
    g = g.float().reshape(1).contiguous()
    kernels.check_cuda(table, cells, g)
    S = cells.shape[1]
    dtable = torch.zeros_like(table)
    kernels.launch("hashgrid_tv_bwd", kernels.ptr(table),
                   kernels.ptr(_levels(spec, table.device)),
                   kernels.ptr(cells), S, spec.num_levels, spec.level_dim,
                   _modes(spec)[1], 1.0 / (S * _D * spec.num_levels),
                   kernels.ptr(g), kernels.ptr(dtable))
    return dtable


def hash_wd_cuda(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    kernels.check_cuda(table)
    _check_table(table, spec)
    out = torch.zeros((), device=table.device)
    kernels.launch("hashgrid_wd_fwd", kernels.ptr(table),
                   kernels.ptr(_levels(spec, table.device)), spec.num_levels,
                   spec.level_dim, max(spec.level_sizes), kernels.ptr(out))
    return out


def hash_wd_bwd_cuda(table: torch.Tensor, spec: HashGridSpec,
                     g: torch.Tensor) -> torch.Tensor:
    g = g.float().reshape(1).contiguous()
    kernels.check_cuda(table, g)
    dtable = torch.empty_like(table)
    kernels.launch("hashgrid_wd_bwd", kernels.ptr(table),
                   kernels.ptr(_levels(spec, table.device)), spec.num_levels,
                   spec.level_dim, max(spec.level_sizes), kernels.ptr(g),
                   kernels.ptr(dtable))
    return dtable


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _device_route(t: torch.Tensor) -> bool:
    """True for CUDA (the kernel), False for the CPU (the plain version)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


class _HashEncode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, table, spec, n_active, need_jacobian, out_dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table if ctx.needs_input_grad[0] else None)
        ctx.spec, ctx.n_active = spec, n_active
        if _device_route(x):
            outs = hash_fwd_cuda(x, table, spec, n_active, need_jacobian,
                                 out_dtype)
        else:
            outs = [o.to(out_dtype) for o in
                    hash_fwd_plain(x, table, spec, n_active, need_jacobian)]
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_feat, *g_j):
        x, table = ctx.saved_tensors
        spec, n_active = ctx.spec, ctx.n_active
        g_j = tuple(g_j) + (None,) * (3 - len(g_j))
        if g_feat is None and all(g is None for g in g_j):
            return None, None, None, None, None, None
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            bwd = hash_bwd_dx_cuda if x.is_cuda else hash_bwd_dx_plain
            dtable, dx = bwd(x, table.detach(), spec, n_active, g_feat, g_j)
            if not ctx.needs_input_grad[1]:
                dtable = None
        elif ctx.needs_input_grad[1]:
            bwd = hash_bwd_cuda if x.is_cuda else hash_bwd_plain
            dtable = bwd(x, spec, n_active, g_feat, g_j)
        return dx, dtable, None, None, None, None


class _HashTV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, cells, spec):
        ctx.save_for_backward(table, cells)
        ctx.spec = spec
        if _device_route(table):
            return hash_tv_cuda(table, cells, spec)
        return hash_tv_plain(table, cells, spec)

    @staticmethod
    def backward(ctx, g):
        table, cells = ctx.saved_tensors
        bwd = hash_tv_bwd_cuda if table.is_cuda else hash_tv_bwd_plain
        return bwd(table, cells, ctx.spec, g), None, None


class _HashWD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, spec):
        ctx.save_for_backward(table)
        ctx.spec = spec
        if _device_route(table):
            return hash_wd_cuda(table, spec)
        return hash_wd_plain(table, spec)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        bwd = hash_wd_bwd_cuda if table.is_cuda else hash_wd_bwd_plain
        return bwd(table, ctx.spec, g), None


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                max_level: Optional[float] = None,
                out_dtype: torch.dtype = torch.float32,
                need_jacobian: bool = False):
    """x [N,3] in [0,1] → feat [N, L·C], or (feat, (jx, jy, jz)) with
    ``need_jacobian``; each j* is [N, L·C] in [0,1]-coordinate units."""
    _check_spec(spec)
    outs = _HashEncode.apply(x.float().contiguous(), table, spec,
                             n_active_levels(spec, max_level), need_jacobian,
                             out_dtype)
    if need_jacobian:
        return outs[0], tuple(outs[1:])
    return outs[0]


def hashgrid_tv_loss(cells: torch.Tensor, table: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """Total variation of the table around sampled cells: ``cells`` [L, S,
    3] int, level l's drawn in [0, max(res_l − 1, 1)) (``draw_tv_cells``)."""
    _check_spec(spec)
    return _HashTV.apply(table, cells, spec)


def hashgrid_wd_loss(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Level-meaned weight decay: each level's squared norm over its size."""
    _check_spec(spec)
    return _HashWD.apply(table, spec)


def draw_tv_cells(gen: torch.Generator, spec: HashGridSpec,
                  device) -> torch.Tensor:
    """[L, 4096, 3] int64: uniform cells per level for the tv loss."""
    return torch.stack([
        torch.randint(0, max(r - 1, 1), (TV_SAMPLES, _D), generator=gen,
                      device=device) for r in spec.resolutions])
