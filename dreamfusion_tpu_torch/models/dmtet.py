"""DMTet refinement stage: a mesh optimised through the rasterizer
(``dreamfusion_tpu/models/dmtet.py``).

Trainable (sdf, deform) on a tetrahedral grid → marching tets (K8) →
rasterization (K7) → the NeRF field queried as a texture field for albedo
(K1 + K4) → shading → background compositing; the normal-consistency and
Laplacian regularizers come from the same mesh (K8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.math import safe_normalize
from ..mesh.tets import TetGrid
from ..ops.marching_tets import (TetMesh, laplacian_smooth_loss,
                                 marching_tets, normal_consistency_loss,
                                 vertex_normals)
from ..ops.raster import interpolate, project_verts, rasterize


class DMTetParams(NamedTuple):
    sdf: torch.Tensor        # [V]
    deform: torch.Tensor     # [V, 3]
    tet_scale: torch.Tensor  # [3]: the grid's vertices are scaled by it


@dataclass
class DMTetRenderer:
    grid: TetGrid
    max_tris: int = 1 << 17
    tile: int = 32
    tile_cap: int = 512
    soft_edge_px: float = 1.0
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        as_t = lambda a: torch.from_numpy(a).to(self.device)
        self.verts = as_t(self.grid.vertices)
        self.tets = as_t(self.grid.indices)
        self.tet_edges = as_t(self.grid.tet_edges)
        self.unique_edges = as_t(self.grid.unique_edges)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params_from_density(self, density_fn: Callable, density_thresh:
                                 float, chunk: int = 500_000) -> DMTetParams:
        """sdf = clamp(σ − thresh, −1, 1) at the grid's vertices, the grid
        first scaled so that the occupied region fills it."""
        v = self.verts

        def sigma_at(x):
            return torch.cat([density_fn(x[i:i + chunk]).float()
                              for i in range(0, len(x), chunk)])

        valid = sigma_at(v) > density_thresh
        if bool(valid.any()):
            tet_scale = v[valid].abs().amax(0) + 1e-1
        else:
            tet_scale = torch.ones(3, device=v.device)
        sdf = torch.clamp(sigma_at(v * tet_scale) - density_thresh, -1.0, 1.0)
        return DMTetParams(sdf=sdf, deform=torch.zeros_like(v),
                           tet_scale=tet_scale.float())

    def init_params_sphere(self, radius: float = 0.5) -> DMTetParams:
        d = radius - torch.linalg.norm(self.verts, dim=-1)
        return DMTetParams(sdf=torch.clamp(d * 4, -1, 1),
                           deform=torch.zeros_like(self.verts),
                           tet_scale=torch.ones(3, device=self.verts.device))

    # ------------------------------------------------------------------
    def extract_mesh(self, params: DMTetParams) -> TetMesh:
        """verts·tet_scale + tanh(deform) / (2·res) → marching tets."""
        res = self.grid.resolution
        v = self.verts * params.tet_scale + \
            torch.tanh(params.deform) / (2 * res)
        return marching_tets(v, params.sdf, self.tets, self.tet_edges,
                             self.unique_edges, self.max_tris)

    # ------------------------------------------------------------------
    def render(self, params: DMTetParams, albedo_fn: Callable,
               mvp: torch.Tensor, H: int, W: int, rays_o: torch.Tensor,
               rays_d: torch.Tensor, light_d: Optional[torch.Tensor] = None,
               ambient_ratio=1.0, shading: str = "lambertian",
               bg_color=1.0, need_regularizers: bool = False,
               mesh: Optional[TetMesh] = None) -> Dict[str, torch.Tensor]:
        """One view: mvp [4,4], rays [H*W, 3] → image [H,W,3], depth,
        weights_sum (alpha), normal_image and, when asked, the normal and
        Laplacian losses.  ``mesh`` reuses an extracted mesh (several views
        of one step)."""
        if mesh is None:
            mesh = self.extract_mesh(params)
        out = rasterize(project_verts(mesh.verts, mvp), mesh.faces,
                        mesh.face_mask, H, W, tile=self.tile,
                        tile_cap=self.tile_cap,
                        soft_edge_px=self.soft_edge_px)
        vn = vertex_normals(mesh)
        xyz = interpolate(mesh.verts, out, mesh.faces)           # [H, W, 3]
        nrm = safe_normalize(interpolate(vn, out, mesh.faces))
        albedo = albedo_fn(xyz.reshape(-1, 3)).reshape(H, W, 3).float()
        if light_d is None:
            light_d = safe_normalize(rays_o[0])
        lam = ambient_ratio + (1 - ambient_ratio) * torch.clamp(
            (nrm * light_d).sum(-1), min=0.0)                    # [H, W]
        if shading == "albedo":
            color = albedo
        elif shading == "textureless":
            color = lam[..., None].expand_as(albedo)
        elif shading == "normal":
            color = (nrm + 1.0) / 2.0
        else:
            color = albedo * lam[..., None]
        alpha = out.alpha[..., None]
        image = color * alpha + torch.as_tensor(
            bg_color, dtype=torch.float32, device=color.device) * (1.0 - alpha)
        results = {"image": image, "depth": out.depth,
                   "weights_sum": out.alpha,
                   "normal_image": (nrm + 1.0) / 2.0 * alpha}
        if need_regularizers:
            results["normal_loss"] = normal_consistency_loss(mesh)
            results["lap_loss"] = laplacian_smooth_loss(mesh)
        return results
