"""DMTet refinement-stage trainer (``dreamfusion_tpu/training/
dmtet_trainer.py``).

The second stage of a run (``--dmtet --init_with <stage-1 checkpoint>``):
trainable (sdf, deform) on a tetrahedral grid beside the stage-1 NeRF
field, reused as a texture field.  One step: marching tets (K8) →
rasterization (K7) → albedo query (K1 + K4) → shading → oracle SDS +
normal-consistency and Laplacian regularizers → backward → guarded Adan →
EMA.  ``--lock_geo`` pins (sdf, deform) and their EMA; the field keeps
training.  The stage bootstraps from the port's own stage-1 checkpoint: the
grid is scaled to the occupied region and sdf = clamp(σ − thresh, −1, 1).
There is no density grid.  Every random number of a step is drawn up front
(``draw_dmtet_step``), so the tests can hand the step the JAX package's
draws.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..core.poses import PoseDraws
from ..mesh.tets import CACHE_DIR, TetGrid, load_cached_tet_grid
from ..models.dmtet import DMTetParams, DMTetRenderer
from ..models.renderer import NeRFRenderer
from ..training import schedules
from .data import CameraBatch, sample_train_batch
from .optimizer import AdanState
from .trainer import (Trainer, _samplers, adan_for, build_renderer, draw_t,
                      draw_view, ema_copy, guarded_update, newest_checkpoint)


class DMTetDraws(NamedTuple):
    """Every random number of one DMTet step."""
    pose: PoseDraws
    fov: torch.Tensor                  # [] degrees
    choice: schedules.ChoiceDraws
    t: torch.Tensor                    # [B] int64 diffusion timestep
    noise: torch.Tensor                # [B, h, w, 3] pixel noise


def draw_dmtet_step(gen: torch.Generator, cfg: Config, device) -> DMTetDraws:
    pose, fov, choice = draw_view(gen, cfg, device)
    t = draw_t(gen, cfg, device)
    _, N = _samplers(gen, device)
    return DMTetDraws(pose, fov, choice, t, N(cfg.batch_size, cfg.h, cfg.w, 3))


class DMTetModel(nn.Module):
    """The stage's trainable parameters: the field (``nerf.*``) and the
    geometry (``geo.sdf`` [V], ``geo.deform`` [V, 3])."""

    def __init__(self, nerf: NeRFRenderer, sdf: torch.Tensor,
                 deform: torch.Tensor):
        super().__init__()
        self.nerf = nerf
        self.geo = nn.ParameterDict({"sdf": nn.Parameter(sdf),
                                     "deform": nn.Parameter(deform)})


@dataclass
class DMTetState:
    model: DMTetModel
    opt_state: AdanState
    ema_params: Dict[str, torch.Tensor]
    tet_scale: torch.Tensor            # [3], fixed after init
    step: int


class DMTetTrainer(Trainer):
    EXTRA_STATE = ("tet_scale",)

    def __init__(self, cfg: Config, device="cuda",
                 tet_grid: Optional[TetGrid] = None,
                 max_tris: Optional[int] = None):
        super().__init__(cfg, device)
        if tet_grid is None:
            # a cube lattice of n = size // 2 has the tet density of the
            # reference's quartet grid of that size
            n = max(8, cfg.tet_grid_size // 2)
            tet_grid = load_cached_tet_grid(CACHE_DIR / f"cube_{n}.npz", n)
        if max_tris is None:
            # surface ∝ size²: 8·size² is ~4x a converged surface
            max_tris = max(1 << 13, 8 * cfg.tet_grid_size ** 2)
        max_tris = min(max_tris, 2 * tet_grid.num_tets)
        self.dmtet_renderer = DMTetRenderer(tet_grid, max_tris=max_tris,
                                            device=self.device)

    def module(self, state: DMTetState) -> nn.Module:
        return state.model

    # ------------------------------------------------------------------
    def load_stage1_field(self, renderer: NeRFRenderer, path: str) -> None:
        """The stage-1 field's EMA weights from the port's checkpoint (a
        rolling ``df_ep*.pth``, a ``checkpoints/`` directory or ``df.pth``)."""
        if os.path.isdir(path):
            found = newest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
            path = found
        raw = torch.load(path, map_location=self.device)
        src = raw.get("ema", raw.get("ema_params", raw.get("module")))
        renderer.load_state_dict(src)
        self.log(f"[dmtet] loaded the stage-1 field from {path}")

    def init_state(self, seed: int, nerf_ckpt: Optional[str] = None
                   ) -> DMTetState:
        """Bootstrap from a stage-1 checkpoint or, with none, from a sphere
        sdf of radius 0.5."""
        cfg = self.cfg
        renderer = build_renderer(cfg)
        renderer.field.reset_parameters(torch.Generator().manual_seed(seed))
        renderer.to(self.device)
        init_with = nerf_ckpt or cfg.init_with
        dmr = self.dmtet_renderer
        if init_with:
            self.load_stage1_field(renderer, init_with)
            geo = dmr.init_params_from_density(
                lambda x: renderer.density(x)["sigma"], cfg.density_thresh)
        else:
            geo = dmr.init_params_sphere(radius=0.5)
        model = DMTetModel(renderer, geo.sdf.float(), geo.deform.float())
        self.optimizer = adan_for(cfg, model)
        return DMTetState(
            model=model, opt_state=self.optimizer.init(
                list(model.parameters())),
            ema_params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
            tet_scale=geo.tet_scale, step=0)

    # ------------------------------------------------------------------
    def draw_step(self, gen: torch.Generator) -> DMTetDraws:
        return draw_dmtet_step(gen, self.cfg, self.device)

    def run_step(self, state: DMTetState, gen: torch.Generator):
        return self.train_step(state, self.draw_step(gen))

    @staticmethod
    def geo_params(model: DMTetModel, tet_scale) -> DMTetParams:
        return DMTetParams(model.geo["sdf"], model.geo["deform"], tet_scale)

    def loss_fn(self, state: DMTetState, draws: DMTetDraws):
        cfg = self.cfg
        H, W = cfg.h, cfg.w
        r_exp = schedules.iter_ratio(state.step, cfg.exp_start_iter or 0,
                                     cfg.exp_end_iter or cfg.iters)
        batch = sample_train_batch(draws.pose, draws.fov, cfg, H, W)
        choices = schedules.sample_step_choices(cfg, draws.choice, r_exp)
        model = state.model
        geo = self.geo_params(model, state.tet_scale)
        dmr = self.dmtet_renderer
        mesh = dmr.extract_mesh(geo)       # one mesh for all views
        images, out0 = [], None
        for b in range(batch.mvp.shape[0]):
            out = dmr.render(
                geo, lambda x: model.nerf.density(x)["albedo"], batch.mvp[b],
                H, W, batch.rays_o[b], batch.rays_d[b],
                ambient_ratio=choices.ambient_ratio, shading="lambertian",
                bg_color=choices.bg_color, need_regularizers=b == 0,
                mesh=mesh)
            if b == 0:
                out0 = out
            images.append(out["image"])
        pred_rgb = torch.stack(images)                      # [B, H, W, 3]
        loss = self.guidance.sds_loss_rays(
            draws.t, draws.noise, batch.rays_o, batch.rays_d,
            choices.bg_color, pred_rgb, grad_scale=cfg.lambda_guidance)
        metrics = {"loss_sds": loss}
        # the regularizers are the same for every view: their batch mean
        if cfg.lambda_mesh_normal > 0:
            loss = loss + cfg.lambda_mesh_normal * out0["normal_loss"]
        if cfg.lambda_mesh_laplacian > 0:
            loss = loss + cfg.lambda_mesh_laplacian * out0["lap_loss"]
        metrics.update(loss=loss, normal_loss=out0["normal_loss"],
                       lap_loss=out0["lap_loss"],
                       n_faces=mesh.face_mask.sum())
        return loss, metrics

    def train_step(self, state: DMTetState, draws: DMTetDraws):
        """One step; updates ``state`` in place → (metrics, gradients in
        ``state.model.parameters()`` order)."""
        cfg = self.cfg
        model = state.model
        params = list(model.parameters())
        loss, metrics = self.loss_fn(state, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        geo_names = [n for n, _ in model.named_parameters()
                     if n.startswith("geo.")]
        if cfg.lock_geo:
            names = [n for n, _ in model.named_parameters()]
            grads = [torch.zeros_like(g) if n.startswith("geo.") else g
                     for n, g in zip(names, grads)]
            pinned = {n: (model.get_parameter(n).detach().clone(),
                          state.ema_params[n].clone()) for n in geo_names}
        metrics["grad_ok"] = guarded_update(self.optimizer, cfg, model,
                                            state.opt_state, state.ema_params,
                                            grads)
        if cfg.lock_geo:
            # Adan's proximal decay would shrink them even with zero
            # gradients: pin them outright
            with torch.no_grad():
                for n, (p, e) in pinned.items():
                    model.get_parameter(n).copy_(p)
                    state.ema_params[n].copy_(e)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}, grads

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, state: DMTetState, batch: CameraBatch, H: int,
                    W: int):
        """Albedo render of a one-view batch through the rasterizer with the
        EMA parameters → (image [H*W, 3], depth [H*W])."""
        model = ema_copy(state.model, state.ema_params)
        out = self.dmtet_renderer.render(
            self.geo_params(model, state.tet_scale),
            lambda x: model.nerf.density(x)["albedo"], batch.mvp[0], H, W,
            batch.rays_o[0], batch.rays_d[0], ambient_ratio=1.0,
            shading="albedo", bg_color=1.0)
        return out["image"].reshape(-1, 3), out["depth"].reshape(-1)

    def eval_metric(self, state) -> Optional[float]:
        """None, as the JAX stage: the df snapshot follows every eval."""
        return None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def extract_dmtet_mesh(self, state: DMTetState
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Marching-tets surface of the EMA geometry, compacted on the host
        (verts [n, 3] float32, tris [m, 3] int32)."""
        geo = DMTetParams(state.ema_params["geo.sdf"],
                          state.ema_params["geo.deform"], state.tet_scale)
        mesh = self.dmtet_renderer.extract_mesh(geo)
        verts = mesh.verts.cpu().numpy()
        faces = mesh.faces.cpu().numpy()[mesh.face_mask.cpu().numpy()]
        used = np.unique(faces)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        return verts[used].astype(np.float32), remap[faces].astype(np.int32)

    def field(self, state: DMTetState) -> NeRFRenderer:
        return ema_copy(state.model, state.ema_params).nerf

