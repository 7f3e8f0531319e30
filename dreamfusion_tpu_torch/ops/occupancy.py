"""K2: occupancy grid query, ray march and grid update
(``dreamfusion_tpu/ops/occupancy.py``).

``march_region`` is the render's whole march: the cube's near/far
(``core/sampling.py::near_far_from_bound``), the probes of the bool
occupancy grid at the probe-interval midpoints, the piecewise-constant PDF
of the probe profile, ``n_fine`` samples placed by inverse CDF
(``mode="resample"``) or the probes themselves with their occupancy as the
mask (``mode="mask"``), and the sample positions clamped to the box.  On a
CUDA tensor it is one launch of the kernel in ``csrc/occupancy.cu``; on a
CPU tensor the plain version runs (``march_region_plain``).
``march_rays_occupancy`` is the same march from a caller's near/far (JAX's
interface), without the positions, on the CPU only.  Neither has a
gradient.

``update_density_grid`` is plain torch: a no-grad density query at
jittered cell centres in 64³ chunks, then the EMA-max and threshold.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..core.sampling import linspace, near_far_from_bound, sample_pdf
from . import kernels


class MarchOut(NamedTuple):
    z_vals: torch.Tensor   # [R, S]
    deltas: torch.Tensor   # [R, S]
    mask: torch.Tensor     # [R, S] bool


def probe_edges(n_probe: int, dt_gamma: float = 0.0, device=None
                ) -> torch.Tensor:
    """Normalized probe-interval edges [n_probe + 1] in [0, 1]: uniform, or
    geometric with growth 1 + dt_gamma."""
    if dt_gamma > 0:
        w = (1.0 + dt_gamma) ** torch.arange(n_probe + 1, device=device,
                                             dtype=torch.float32) - 1.0
        edges = w / w[-1]
        edges[0] = 0.0
        return edges
    return linspace(0.0, 1.0, n_probe + 1, device=device)


def mip_from_pos(xyz: torch.Tensor, cascade: int) -> torch.Tensor:
    mx = xyz.abs().amax(-1)
    c = torch.ceil(torch.log2(torch.clamp(mx, min=1e-8)))
    return torch.clamp(c, 0, cascade - 1).long()


def occupancy_lookup(occ_grid: torch.Tensor, xyz: torch.Tensor,
                     bound: float) -> torch.Tensor:
    """Bool occupancy at world positions [..., 3] of a
    [cascade, G, G, G] grid."""
    cascade, G = occ_grid.shape[0], occ_grid.shape[1]
    mip = mip_from_pos(xyz, cascade)
    mip_bound = torch.clamp(torch.exp2(mip.float()), max=bound)[..., None]
    cell = torch.floor((xyz / mip_bound * 0.5 + 0.5) * G).long()
    cell = torch.clamp(cell, 0, G - 1)
    inside = (xyz.abs() <= bound).all(-1)
    occ = occ_grid[mip, cell[..., 0], cell[..., 1], cell[..., 2]]
    return occ & inside


def march_plain(rays_o, rays_d, near, far, occ_grid, bound, edges, u,
                mode: str = "resample") -> MarchOut:
    """Plain version: the JAX formulation, dense rank and all."""
    P = edges.shape[0] - 1
    z_edges = near + (far - near) * edges[None, :]                 # [R, P+1]
    z_mid = 0.5 * (z_edges[:, 1:] + z_edges[:, :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[..., None]
    occ = occupancy_lookup(occ_grid, pts, bound)                   # [R, P]
    if mode == "mask":
        return MarchOut(z_mid, z_edges[:, 1:] - z_edges[:, :-1], occ)
    pdf_w = occ.float() + 1e-3
    any_occ = occ.any(-1, keepdim=True)
    z = sample_pdf(z_edges, pdf_w, u)                              # [R, S]
    S = z.shape[-1]
    deltas = torch.cat([z[:, 1:] - z[:, :-1], (far - near) / S], -1)
    rank = (z_edges[:, None, :] <= z[..., None]).sum(-1)
    interval = torch.clamp(rank - 1, 0, P - 1)
    sample_occ = torch.gather(occ, 1, interval)
    return MarchOut(z, deltas, sample_occ & any_occ)


def march_region_plain(rays_o, rays_d, occ_grid, bound, min_near, edges,
                       u, mode: str = "resample"):
    """Plain version of the region: ``near_far_from_bound``, ``march_plain``
    and the clamped positions, as the renderer ran them → (MarchOut, xyzs
    [R, S, 3])."""
    near, far = near_far_from_bound(rays_o, rays_d, bound, kind="cube",
                                    min_near=min_near)
    if u is not None and u.dim() == 1:
        u = u.expand(rays_o.shape[0], -1)
    out = march_plain(rays_o, rays_d, near, far, occ_grid, bound, edges, u,
                      mode)
    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * out.z_vals[..., None]
    return out, torch.clamp(xyzs, -bound, bound)


def march_region_cuda(rays_o, rays_d, occ_grid, bound, min_near, edges, u,
                      mode: str = "resample"):
    """The region in one launch of the CUDA march kernel: near/far, the
    march and the clamped positions → (MarchOut, xyzs [R, S, 3])."""
    R = rays_o.shape[0]
    P = edges.shape[0] - 1
    if not 1 <= P <= 64:
        raise ValueError(f"march kernel holds 1 to 64 probes, got {P}")
    if rays_o.dim() != 2 or rays_o.shape[-1] != 3 or \
            rays_d.shape != rays_o.shape:
        raise ValueError("march kernel takes rays [R, 3]")
    grid = occ_grid.contiguous().view(torch.uint8)
    mask_mode = mode == "mask"
    if mask_mode:
        S, u_sr, u = P, 0, None
    else:
        if u.stride(-1) != 1:
            u = u.contiguous()
        S = u.shape[-1]
        u_sr = 0 if u.dim() == 1 else u.stride(0)
    # the rays and u are read through their strides; the rest contiguous
    kernels.check_cuda(grid, edges)
    for t in (rays_o, rays_d, u):
        if t is not None and t.device != grid.device:
            raise ValueError(f"expected CUDA tensors on {grid.device}, got "
                             f"{t.device}")
    if any(t.dtype != torch.float32
           for t in (rays_o, rays_d, edges, u) if t is not None):
        raise ValueError("march kernel takes fp32 rays, edges and u")
    dev = rays_o.device
    z = torch.empty(R, S, device=dev, dtype=torch.float32)
    deltas = torch.empty_like(z)
    mask = torch.empty(R, S, device=dev, dtype=torch.bool)
    xyzs = torch.empty(R, S, 3, device=dev, dtype=torch.float32)
    kernels.launch("march_rays", kernels.ptr(rays_o), rays_o.stride(0),
                   rays_o.stride(1), kernels.ptr(rays_d), rays_d.stride(0),
                   rays_d.stride(1), float(min_near), kernels.ptr(grid),
                   occ_grid.shape[0], occ_grid.shape[1], float(bound),
                   kernels.ptr(edges), P, kernels.ptr(u), u_sr, S, R,
                   int(mask_mode), kernels.ptr(z), kernels.ptr(deltas),
                   kernels.ptr(mask), kernels.ptr(xyzs))
    return MarchOut(z, deltas, mask), xyzs


def _check_mode(mode: str) -> None:
    if mode not in ("resample", "mask"):
        raise ValueError(f"unknown occupancy mode {mode!r}")


def march_region(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 occ_grid: torch.Tensor, bound: float, min_near: float,
                 edges: torch.Tensor, u: torch.Tensor | None,
                 mode: str = "resample"):
    """The render's march: rays [R, 3] (any strides), occ_grid [cascade, G,
    G, G] bool, edges [P+1] from ``probe_edges`` (built once and kept by the
    caller), u [R, S] non-decreasing draws in [0, 1) or one [S] row for
    every ray (the deterministic stratum centres, ``det_u``; unused in mask
    mode) → (MarchOut, xyzs [R, S, 3] = clamp(o + d z, ±bound))."""
    _check_mode(mode)
    with torch.no_grad():
        if rays_o.is_cuda:
            return march_region_cuda(rays_o, rays_d, occ_grid, bound,
                                     min_near, edges, u, mode)
        if rays_o.device.type == "cpu":
            return march_region_plain(rays_o, rays_d, occ_grid, bound,
                                      min_near, edges, u, mode)
        raise ValueError(f"unsupported device {rays_o.device}")


def march_rays_occupancy(rays_o: torch.Tensor, rays_d: torch.Tensor,
                         near: torch.Tensor, far: torch.Tensor,
                         occ_grid: torch.Tensor, bound: float,
                         edges: torch.Tensor, u: torch.Tensor | None,
                         mode: str = "resample") -> MarchOut:
    """rays [R,3], near/far [R,1], occ_grid [cascade,G,G,G] bool, edges
    [P+1] from ``probe_edges``, u [R, S] non-decreasing draws in [0, 1)
    (``core.sampling.stratified_u`` / ``det_u``; unused in mask mode).  The
    plain version only: the card runs the march as ``march_region``, which
    forms the near/far itself."""
    _check_mode(mode)
    if rays_o.device.type != "cpu":
        raise ValueError(f"march_rays_occupancy runs on the CPU; on "
                         f"{rays_o.device} call march_region")
    with torch.no_grad():
        return march_plain(rays_o, rays_d, near, far, occ_grid, bound, edges,
                           u, mode)


# ---------------------------------------------------------------------------
# density-grid maintenance (plain torch)
# ---------------------------------------------------------------------------

_DENSITY_CAP = 1e7
_CHUNK = 64 ** 3


def grid_cell_centers(grid_size: int, device=None) -> torch.Tensor:
    """[G³, 3] cell centres in [-1, 1], raster order."""
    ax = 2.0 * torch.arange(grid_size, dtype=torch.float32,
                            device=device) / (grid_size - 1) - 1.0
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], -1)


@torch.no_grad()
def update_density_grid(jitter_u: torch.Tensor, density_grid: torch.Tensor,
                        density_fn: Callable[[torch.Tensor], torch.Tensor],
                        bound: float, decay: float = 0.95,
                        density_thresh: float = 10.0, grid_size: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One EMA-max update from unit-uniform jitter draws
    [cascade, G³, 3].  Returns (grid [cascade, G³], mean density [],
    occupancy [cascade, G, G, G] bool)."""
    cascade = density_grid.shape[0]
    G = grid_size
    base = grid_cell_centers(G, device=density_grid.device)
    rows = []
    for cas in range(cascade):
        cas_bound = min(2 ** cas, bound)
        half_cell = cas_bound / G
        pts = base * (cas_bound - half_cell) + \
            (jitter_u[cas] * 2.0 - 1.0) * half_cell
        rows.append(torch.cat([density_fn(pts[i:i + _CHUNK])
                               for i in range(0, pts.shape[0], _CHUNK)]))
    tmp = torch.stack(rows)
    tmp = torch.clamp(torch.nan_to_num(tmp, nan=0.0, posinf=_DENSITY_CAP,
                                       neginf=0.0), 0.0, _DENSITY_CAP)
    carried = torch.clamp(torch.nan_to_num(density_grid, nan=0.0,
                                           posinf=_DENSITY_CAP, neginf=-1.0),
                          -1.0, _DENSITY_CAP)
    valid = density_grid >= 0
    updated = torch.where(valid, torch.maximum(carried * decay, tmp), carried)
    mean_density = torch.where(valid, updated, 0.0).sum() / \
        torch.clamp(valid.sum(), min=1)
    thresh = torch.clamp(mean_density, max=density_thresh)
    occ = (updated > thresh).reshape(cascade, G, G, G)
    return updated, mean_density, occ
