"""Volume renderer (``dreamfusion_tpu/models/renderer.py``:
``render_grid``, ``render_vanilla``, ``_shade_and_composite`` and the
dispatch ``render``).

The grid and the triplane with an occupancy grid march it (K2: near/far,
probes, resampling and the clamped sample positions in one launch); the
vanilla field (or any field without a grid) samples the bounding sphere:
K2's coarse launch places ``num_steps`` stratified samples, a no-grad
density pass (K4's head) weighs them, and K2's resample launch adds
``upsample_steps`` inverse-CDF draws, merged and sorted.  Then the
field: hash grid (K6) or triplane (K1) + MLP + head with the
normals and the shading (K4) → composite with the background and the orient
loss (K3), plus the other regularizers on the normals: the 3-D normal
smoothness (the normals against those of a second field query at positions
offset by N(0, 1e-2)) and the weighted normal image of the 2-D smoothness
loss.  The light and the view directions go to the kernels one a ray, not
expanded per sample.  The occupancy grid is explicit state passed in, not a
module buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..core.math import safe_normalize
from ..core.sampling import det_u, linspace
from ..ops.composite import composite_rays
from ..ops.occupancy import march_region, probe_edges
from ..ops.resample import vanilla_coarse, vanilla_resample
from .nerf import SHADING_ALBEDO, NeRFField


@dataclass(frozen=True)
class RenderFlags:
    """Static rendering switches."""
    perturb: bool = False
    shading_static_albedo: bool = False
    need_loss_orient: bool = False
    need_normal_perturb: bool = False
    need_normal_image: bool = False
    binarize: bool = False


class NeRFRenderer(nn.Module):
    def __init__(self, bound: float = 1.0, min_near: float = 0.01,
                 grid_probe_steps: int = 32, grid_fine_steps: int = 24,
                 occupancy_mode: str = "resample", dt_gamma: float = 0.0,
                 t_thresh: float = 1e-4, num_steps: int = 64,
                 upsample_steps: int = 32, **field_kwargs):
        super().__init__()
        self.bound = bound
        self.num_steps = num_steps
        self.upsample_steps = upsample_steps
        self.min_near = min_near
        self.grid_probe_steps = grid_probe_steps
        self.grid_fine_steps = grid_fine_steps
        self.occupancy_mode = occupancy_mode
        self.dt_gamma = dt_gamma
        self.t_thresh = t_thresh
        self.field = NeRFField(bound=bound, **field_kwargs)
        self._march_consts = {}

    def march_consts(self, device):
        """The march's probe edges [P+1] and deterministic stratum centres
        [S], built once per device and kept (no per-render ops)."""
        consts = self._march_consts.get(device)
        if consts is None:
            consts = self._march_consts[device] = (
                probe_edges(self.grid_probe_steps, self.dt_gamma,
                            device=device),
                det_u(1, self.grid_fine_steps, device=device)[0].contiguous())
        return consts

    def vanilla_consts(self, device):
        """The vanilla sampling's coarse fractions linspace(0, 1, S) [S] and
        deterministic draws [upsample_steps], built once per device."""
        key = ("vanilla", device)
        consts = self._march_consts.get(key)
        if consts is None:
            consts = self._march_consts[key] = (
                linspace(0.0, 1.0, self.num_steps, device=device),
                det_u(1, max(self.upsample_steps, 1), device=device)[0]
                .contiguous())
        return consts

    def density(self, x: torch.Tensor, max_level: Optional[float] = None):
        return self.field.density(x, max_level)

    def forward(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        return self.render(*args, **kwargs)

    def render(self, flags: RenderFlags, rays_o: torch.Tensor,
               rays_d: torch.Tensor, occ_grid: Optional[torch.Tensor] = None,
               *args, **kwargs) -> Dict[str, torch.Tensor]:
        """The grid march for the grid and the triplane given an occupancy
        grid, else the vanilla sampling (JAX's dispatch); the rest of the
        arguments as ``render_vanilla``'s (``pdf_u`` is the vanilla
        sampling's alone)."""
        if self.field.backbone in ("grid", "triplane") and \
                occ_grid is not None:
            kwargs.pop("pdf_u", None)
            return self.render_grid(flags, rays_o, rays_d, occ_grid, *args,
                                    **kwargs)
        return self.render_vanilla(flags, rays_o, rays_d, *args, **kwargs)

    def render_vanilla(self, flags: RenderFlags, rays_o: torch.Tensor,
                       rays_d: torch.Tensor,
                       light_d: Optional[torch.Tensor] = None,
                       ambient_ratio=1.0, shading=SHADING_ALBEDO,
                       bg_color=None, max_level: Optional[float] = None,
                       march_u: Optional[torch.Tensor] = None,
                       use_bg_net: Optional[torch.Tensor] = None,
                       perturb_noise: Optional[torch.Tensor] = None,
                       pdf_u: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """rays [R,3] flat.  With ``flags.perturb`` the coarse samples take
        the unit jitter draws ``march_u`` [R, num_steps] and the importance
        draws the stratified ``pdf_u`` [R, upsample_steps]; without, the
        linspace and the stratum centres.  The rest as ``render_grid``."""
        lin, centres = self.vanilla_consts(rays_o.device)
        u_coarse, u_pdf = None, centres
        if flags.perturb:
            if march_u is None or pdf_u is None and self.upsample_steps > 0:
                raise ValueError("a perturbed render needs march_u and "
                                 "pdf_u draws")
            u_coarse, u_pdf = march_u, pdf_u
        resample = self.upsample_steps > 0
        z, deltas, xyzs = vanilla_coarse(rays_o, rays_d, self.bound, lin,
                                         u_coarse, need_deltas=not resample)
        if resample:
            # the coarse density pass, without gradient
            with torch.no_grad():
                sigma = self.field.density(xyzs.reshape(-1, 3), max_level
                                           )["sigma"].reshape(z.shape)
            z, deltas, xyzs = vanilla_resample(rays_o, rays_d, self.bound,
                                               z, sigma, u_pdf)
        return self._shade_and_composite(
            flags, rays_o, rays_d, z, deltas, None, light_d, ambient_ratio,
            shading, max_level, bg_color, use_bg_net, perturb_noise,
            xyzs=xyzs)

    def render_grid(self, flags: RenderFlags, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, occ_grid: torch.Tensor,
                    light_d: Optional[torch.Tensor] = None,
                    ambient_ratio=1.0, shading=SHADING_ALBEDO,
                    bg_color=None, max_level: Optional[float] = None,
                    march_u: Optional[torch.Tensor] = None,
                    use_bg_net: Optional[torch.Tensor] = None,
                    perturb_noise: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """rays [R,3] flat.  With ``flags.perturb`` the march takes the
        stratified draws ``march_u`` [R, grid_fine_steps]; without, the
        deterministic stratum centres.  bg_color None means the background
        MLP's colour where the field has one (the eval and test renders),
        else white; a [] bool ``use_bg_net`` picks the background MLP's
        colour over bg_color (per step, as the JAX step's ``jnp.where``).
        ``perturb_noise``
        [R·S, 3] standard normal draws offset the second normal query of
        ``flags.need_normal_perturb``."""
        edges, centres = self.march_consts(rays_o.device)
        if flags.perturb:
            if march_u is None:
                raise ValueError("a perturbed render needs march_u draws")
            u = march_u
        else:
            u = centres
        march, xyzs = march_region(rays_o, rays_d, occ_grid, self.bound,
                                   self.min_near, edges, u,
                                   mode=self.occupancy_mode)
        z_vals, deltas, mask = march
        return self._shade_and_composite(
            flags, rays_o, rays_d, z_vals, deltas, mask, light_d,
            ambient_ratio, shading, max_level, bg_color, use_bg_net,
            perturb_noise, xyzs=xyzs)

    def _shade_and_composite(self, flags: RenderFlags, rays_o, rays_d,
                             z_vals, deltas, mask, light_d, ambient_ratio,
                             shading, max_level, bg_color, use_bg_net=None,
                             perturb_noise=None, *, xyzs
                             ) -> Dict[str, torch.Tensor]:
        """The field at the march's samples, composited (JAX's method of the
        same name): K4 shades, K3 composites, adds the background and the
        orient loss.  ``xyzs`` [R, S, 3] are the march's clamped sample
        positions (``march_region``'s)."""
        R, S = z_vals.shape

        static = flags.shading_static_albedo or (
            isinstance(shading, int) and shading == SHADING_ALBEDO)
        shading_arg = SHADING_ALBEDO if static else shading
        if light_d is None and not static:
            light_d = safe_normalize(rays_o)
        sigmas, rgbs, normals = self.field(
            xyzs.reshape(-1, 3), light_d, ambient_ratio, shading_arg,
            max_level)
        bg_net = None
        if use_bg_net is not None and self.field.bg_net is not None:
            bg_net = self.field.background(safe_normalize(rays_d))
        elif bg_color is None and self.field.bg_net is not None:
            # no colour given (eval and test renders): the background
            # MLP's, as JAX's
            bg_color = self.field.background(safe_normalize(rays_d))
        n = None if normals is None else normals.reshape(R, S, 3)
        orient = n is not None and flags.need_loss_orient
        out = composite_rays(sigmas.reshape(R, S), rgbs.reshape(R, S, 3),
                             z_vals, deltas, mask=mask,
                             t_thresh=self.t_thresh, binarize=flags.binarize,
                             bg_color=1.0 if bg_color is None else bg_color,
                             bg_net=bg_net, use_bg_net=use_bg_net,
                             normals=n if orient else None, rays_d=rays_d)
        results = {
            "image": out.image,
            "depth": out.depth,
            "weights": out.weights,
            "weights_sum": out.weights_sum,
        }
        if n is None:
            return results
        if orient:
            # normals facing away from the camera, punished in K3
            results["loss_orient"] = out.loss_orient
        if flags.need_normal_perturb:
            if perturb_noise is None:
                raise ValueError("the normal-perturb loss needs its draws")
            moved = xyzs + perturb_noise.reshape(xyzs.shape) * 1e-2
            n2 = self.field.normal(moved.reshape(-1, 3), max_level)
            results["loss_normal_perturb"] = (n - n2.reshape(R, S, 3)
                                              ).abs().mean()
        if flags.need_normal_image:
            results["normal_image"] = (out.weights[..., None] *
                                       (n + 1.0) / 2.0).sum(-2)
        return results
