"""DMTet refinement-stage trainer (``dreamfusion_tpu/training/
dmtet_trainer.py``).

The second stage of a run (``--dmtet --init_with <stage-1 checkpoint or
mesh file>``): trainable (sdf, deform) on a tetrahedral grid beside the
NeRF field, reused as a texture field.  One step: marching tets (K8) →
rasterization (K7) → albedo query (K6 or K1, + K4) → shading → the SDS of
the pixel oracle, the image oracle, Stable Diffusion (the VAE encodes the
render at its own size, 512² at the DMTet preset), DeepFloyd-IF or
Zero-1-to-3 (the render resized to its VAE's 256²; the gradient clamped by
K5 under ``--grad_clip_rgb``), and CLIP's term, summed as stage 1 sums
them + normal-consistency and Laplacian
regularizers → backward → guarded Adan → EMA.  Under ``--image`` every
``known_view_interval``-th step is a known-view step instead: the reference
view rendered through K7 at the render's own size, with rgb, mask and the
mesh regularizers.  ``--lock_geo`` pins (sdf, deform) and their EMA; the
field keeps training.

The stage bootstraps from the port's own stage-1 checkpoint (the grid
scaled to the occupied region, sdf = clamp(σ − thresh, −1, 1)) or, from an
.obj or .ply file, from the mesh's signed distance (K9,
``DMTetRenderer.init_params_from_mesh``) with a fresh field drawn from the
seed.  There is no density grid.  Every random number of a step is drawn up
front (``draw_dmtet_step``, ``draw_known_view``), so the tests can hand the
step the JAX package's draws.

Two caps can drop faces: the marching tets keep at most ``max_tris``
faces, and K7 lists at most ``tile_cap`` triangles per 32² tile.  JAX fixes
them at max(2^13, 8·size²) and 512.  Here ``init_state`` sizes
``max_tris`` from the init surface (``fit_caps``: JAX's while the count
stays under half of it, else the power of two at or above twice the
count), K7 lists as many as its 16-bit slots reach (``MAX_TILE_CAP``),
every step reports the true counts (``n_faces_true``, ``tile_max``), and
``check_caps`` logs any step that dropped faces or cut a tile's list and
grows ``max_tris`` past the surface, so that no face is dropped without a
log line saying when and how many.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..core.poses import PoseDraws
from ..mesh.sdf import load_mesh
from ..mesh.tets import CACHE_DIR, TetGrid, load_cached_tet_grid
from ..models.dmtet import DMTetParams, DMTetRenderer
from ..models.renderer import NeRFRenderer
from ..training import schedules
from .data import CameraBatch
from .image_data import RefImages
from .trainer import (PIXELS, NoiseSpec, PriorDraws, Trainer,
                      build_renderer, draw_priors, draw_view, ema_copy,
                      guarded_update, newest_checkpoint, optimizer_for,
                      prior_fields, train_batch)


class DMTetDraws(NamedTuple):
    """Every random number of one DMTet step."""
    pose: PoseDraws
    fov: torch.Tensor                  # [] degrees
    choice: schedules.ChoiceDraws
    t: Optional[torch.Tensor] = None   # the first drawing prior's
    noise: Optional[torch.Tensor] = None     # ``PriorDraws`` (none under
    posterior_noise: Optional[torch.Tensor] = None   # CLIP alone)
    extra: Optional[Dict[str, PriorDraws]] = None   # the other priors'


def draw_dmtet_step(gen: torch.Generator, cfg: Config, device,
                    specs: Sequence[Tuple[str, NoiseSpec]] = PIXELS
                    ) -> DMTetDraws:
    """One step's draws: the view, then each prior's (``draw_priors``)."""
    pose, fov, choice = draw_view(gen, cfg, device)
    return DMTetDraws(pose, fov, choice, **prior_fields(
        draw_priors(gen, cfg, device, specs)))


def face_cap(n_faces: int, tet_grid_size: int, num_tets: int) -> int:
    """The marching tets' max_tris for a surface of ``n_faces``: JAX's
    max(2^13, 8·size²) while the surface fills at most half of it, else
    the smallest power of two >= 2·n_faces; at most 2·num_tets, every
    slot: nothing can drop."""
    jax_cap = max(1 << 13, 8 * tet_grid_size ** 2)
    cap = jax_cap if 2 * n_faces <= jax_cap else \
        1 << (2 * n_faces - 1).bit_length()
    return min(cap, 2 * num_tets)


class DMTetKnownViewDraws(NamedTuple):
    """Every random number of one known-view DMTet step."""
    sel: torch.Tensor                  # [] int64 reference view
    bg: torch.Tensor                   # [3] background colour


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
    opt_state: Any                     # AdanState or AdamState
    ema_params: Dict[str, torch.Tensor]
    tet_scale: torch.Tensor            # [3], fixed after init
    step: int


class DMTetTrainer(Trainer):
    EXTRA_STATE = ("tet_scale",)

    def __init__(self, cfg: Config, device="cuda", guidance=None,
                 embeddings=None, tet_grid: Optional[TetGrid] = None,
                 ref_images: Optional[RefImages] = None, clip=None,
                 clip_z: Optional[Dict[str, torch.Tensor]] = None,
                 priors: Optional[Dict[str, Tuple[Any, Any]]] = None):
        """The priors as ``Trainer``'s."""
        super().__init__(cfg, device, guidance, embeddings,
                         ref_images=ref_images, clip=clip, clip_z=clip_z,
                         priors=priors)
        if tet_grid is None:
            # a cube lattice of n = size // 2 has the tet density of the
            # reference's quartet grid of that size
            n = max(8, cfg.tet_grid_size // 2)
            tet_grid = load_cached_tet_grid(CACHE_DIR / f"cube_{n}.npz", n)
        # JAX's caps until init_state sizes them from the surface
        self.dmtet_renderer = DMTetRenderer(
            tet_grid, max_tris=face_cap(0, cfg.tet_grid_size,
                                        tet_grid.num_tets),
            device=self.device)

    def module(self, state: DMTetState) -> nn.Module:
        return state.model

    # ------------------------------------------------------------------
    def load_stage1_field(self, renderer: NeRFRenderer, path: str) -> None:
        """The stage-1 field's EMA weights from the port's checkpoint (a
        rolling ``df_ep*.pth``, a ``checkpoints/`` directory or ``df.pth``).
        A field checkpoint does not depend on the guidance: a run whose
        stage 1 had no background MLP (the oracles') keeps this run's fresh
        one, which no DMTet render reads (the background is a colour)."""
        if os.path.isdir(path):
            found = newest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
            path = found
        raw = torch.load(path, map_location=self.device)
        src = raw.get("ema", raw.get("ema_params", raw.get("module")))
        missing, unexpected = renderer.load_state_dict(src, strict=False)
        missing = [k for k in missing if not k.startswith("field.bg_net.")]
        if missing or unexpected:
            raise RuntimeError(f"the stage-1 checkpoint {path} does not fit "
                               f"this field: missing {missing}, unexpected "
                               f"{unexpected}")
        self.log(f"[dmtet] loaded the stage-1 field from {path}")

    def init_state(self, seed: int, nerf_ckpt: Optional[str] = None
                   ) -> DMTetState:
        """Bootstrap from a stage-1 checkpoint, from a mesh file (.obj or
        .ply: the geometry from its signed distance, the field fresh from
        the seed) or, with neither, from a sphere sdf of radius 0.5."""
        cfg = self.cfg
        renderer = build_renderer(cfg)
        renderer.field.reset_parameters(torch.Generator().manual_seed(seed))
        renderer.to(self.device)
        init_with = nerf_ckpt or cfg.init_with
        dmr = self.dmtet_renderer
        if init_with.lower().endswith((".obj", ".ply")):
            mv, mt = load_mesh(init_with)
            self.log(f"[dmtet] mesh init from {init_with}: {len(mv)} verts, "
                     f"{len(mt)} tris")
            geo = dmr.init_params_from_mesh(mv, mt)
        elif init_with:
            self.load_stage1_field(renderer, init_with)
            geo = dmr.init_params_from_density(
                lambda x: renderer.density(x)["sigma"], cfg.density_thresh)
        else:
            geo = dmr.init_params_sphere(radius=0.5)
        self.fit_caps(geo)
        model = DMTetModel(renderer, geo.sdf.float(), geo.deform.float())
        self.optimizer = optimizer_for(cfg, model)
        return DMTetState(
            model=model, opt_state=self.optimizer.init(
                list(model.parameters())),
            ema_params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
            tet_scale=geo.tet_scale, step=0)

    # ------------------------------------------------------------------
    def _face_cap(self, n_faces: int) -> int:
        return face_cap(n_faces, self.cfg.tet_grid_size,
                        self.dmtet_renderer.grid.num_tets)

    @torch.no_grad()
    def fit_caps(self, geo: DMTetParams) -> None:
        """Size max_tris from the surface of ``geo`` (counted once: a wait
        for the device)."""
        dmr = self.dmtet_renderer
        n = int(dmr.extract_mesh(geo).n_faces)
        dmr.max_tris = self._face_cap(n)
        self.log(f"[dmtet] the surface has {n} faces: max_tris "
                 f"{dmr.max_tris}")

    def check_caps(self, n_faces: int, fullest: int, step: int) -> None:
        """``n_faces`` and ``fullest``: the most faces the surface had and
        the most triangles one tile listed in the steps before ``step``
        (read where the loop waits for the device anyway).  Over a cap,
        those steps dropped faces: log it, and grow max_tris (at least
        double it) for the steps that follow; tile_cap is the kernel's
        most already."""
        dmr = self.dmtet_renderer
        if n_faces > dmr.max_tris:
            new = min(max(2 * dmr.max_tris, self._face_cap(n_faces)),
                      2 * dmr.grid.num_tets)
            self.log(f"[dmtet] faces dropped before step {step}: the "
                     f"surface reached {n_faces} faces over max_tris "
                     f"{dmr.max_tris}; max_tris {new} from step {step} on")
            dmr.max_tris = new
        if fullest > dmr.tile_cap:
            self.log(f"[dmtet] tile lists cut before step {step}: a tile "
                     f"reached {fullest} triangles over tile_cap "
                     f"{dmr.tile_cap}")

    def draw_step(self, gen: torch.Generator) -> DMTetDraws:
        return draw_dmtet_step(gen, self.cfg, self.device, self.noise_specs)

    def draw_known_view(self, gen: torch.Generator) -> DMTetKnownViewDraws:
        K = self.ref_images.rgb.shape[0]
        sel = torch.randint(0, K, (), generator=gen, device=self.device)
        return DMTetKnownViewDraws(sel, torch.rand(3, generator=gen,
                                                   device=self.device))

    def run_step(self, state: DMTetState, gen: torch.Generator):
        if self.is_known_view_step(state.step):
            return self.known_view_step(state, self.draw_known_view(gen))
        return self.train_step(state, self.draw_step(gen))

    @staticmethod
    def geo_params(model: DMTetModel, tet_scale) -> DMTetParams:
        return DMTetParams(model.geo["sdf"], model.geo["deform"], tet_scale)

    def loss_fn(self, state: DMTetState, draws: DMTetDraws):
        cfg = self.cfg
        H, W = cfg.h, cfg.w
        r_exp = schedules.iter_ratio(state.step, cfg.exp_start_iter or 0,
                                     cfg.exp_end_iter or cfg.iters)
        batch = train_batch(cfg, draws.pose, draws.fov, state.step, H, W)
        choices = schedules.sample_step_choices(cfg, draws.choice, r_exp)
        model = state.model
        geo = self.geo_params(model, state.tet_scale)
        dmr = self.dmtet_renderer
        mesh = dmr.extract_mesh(geo)       # one mesh for all views
        images, tiles, out0 = [], [], None
        for b in range(batch.mvp.shape[0]):
            out = dmr.render(
                geo, lambda x: model.nerf.density(x)["albedo"], batch.mvp[b],
                H, W, batch.rays_o[b], batch.rays_d[b],
                ambient_ratio=choices.ambient_ratio, shading="lambertian",
                bg_color=choices.bg_color, need_regularizers=b == 0,
                mesh=mesh)
            if b == 0:
                out0 = out
            tiles.append(out["tile_counts"])
            images.append(out["image"])
        pred_rgb = torch.stack(images)                      # [B, H, W, 3]
        loss = self.guidance_loss(pred_rgb, batch, draws, choices.bg_color,
                                  False)
        metrics = {"loss_sds": loss}
        # the regularizers are the same for every view: their batch mean
        if cfg.lambda_mesh_normal > 0:
            loss = loss + cfg.lambda_mesh_normal * out0["normal_loss"]
        if cfg.lambda_mesh_laplacian > 0:
            loss = loss + cfg.lambda_mesh_laplacian * out0["lap_loss"]
        metrics.update(loss=loss, normal_loss=out0["normal_loss"],
                       lap_loss=out0["lap_loss"],
                       **self.surface_metrics(mesh, torch.cat(tiles).max()))
        return loss, metrics

    @staticmethod
    def surface_metrics(mesh, tile_max) -> Dict[str, torch.Tensor]:
        """The faces kept, the surface's true count and K7's fullest tile
        (device scalars)."""
        return {"n_faces": mesh.face_mask.sum(),
                "n_faces_true": mesh.n_faces, "tile_max": tile_max}

    def known_view_loss(self, state: DMTetState,
                        draws: DMTetKnownViewDraws):
        """rgb and mask losses of a K7 render of reference view
        ``draws.sel`` at the reference's size, plus the mesh
        regularizers."""
        cfg = self.cfg
        gt, kv = self.known_view(draws.sel)
        Hs, Ws = gt["rgb"].shape[:2]
        model = state.model
        geo = self.geo_params(model, state.tet_scale)
        mesh = self.dmtet_renderer.extract_mesh(geo)
        out = self.dmtet_renderer.render(
            geo, lambda x: model.nerf.density(x)["albedo"], kv.mvp, Hs, Ws,
            kv.rays_o, kv.rays_d, ambient_ratio=1.0,
            shading="lambertian", bg_color=draws.bg, need_regularizers=True,
            mesh=mesh)
        m = gt["mask"].float()
        target = gt["rgb"] * m[..., None] + draws.bg * (1 - m[..., None])
        loss = cfg.lambda_rgb * ((out["image"] - target) ** 2).mean()
        loss = loss + cfg.lambda_mask * ((out["weights_sum"] - m) ** 2).mean()
        loss = loss + cfg.lambda_mesh_normal * out["normal_loss"] + \
            cfg.lambda_mesh_laplacian * out["lap_loss"]
        return loss, {"loss": loss,
                      "loss_sds": torch.zeros((), device=loss.device),
                      "normal_loss": out["normal_loss"],
                      "lap_loss": out["lap_loss"],
                      **self.surface_metrics(mesh, out["tile_counts"].max())}

    def apply_step(self, state: DMTetState, loss, metrics):
        """Backward, the guarded update in place (``--lock_geo`` pins the
        geometry) → (metrics, gradients in ``state.model.parameters()``
        order)."""
        cfg = self.cfg
        model = state.model
        params = list(model.parameters())
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

    def train_step(self, state: DMTetState, draws: DMTetDraws):
        """One step; updates ``state`` in place → (metrics, gradients)."""
        return self.apply_step(state, *self.loss_fn(state, draws))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, state: DMTetState, batch: CameraBatch, H: int,
                    W: int):
        """Albedo render of a one-view batch through the rasterizer with the
        EMA parameters → (image [H*W, 3], depth [H*W], alpha [H*W], K7's
        fullest tile [] before its tile_cap cut, on the device)."""
        model = ema_copy(state.model, state.ema_params)
        out = self.dmtet_renderer.render(
            self.geo_params(model, state.tet_scale),
            lambda x: model.nerf.density(x)["albedo"], batch.mvp[0], H, W,
            batch.rays_o[0], batch.rays_d[0], ambient_ratio=1.0,
            shading="albedo", bg_color=1.0)
        return (out["image"].reshape(-1, 3), out["depth"].reshape(-1),
                out["weights_sum"].reshape(-1), out["tile_counts"].max())

    def view_tile_report(self) -> Dict[str, list]:
        """The eval and test views' fullest tiles (read once, at the end)
        → {"view_tile_max": [[view, n], ...], "view_tile_cut": the views
        whose fullest tile passed tile_cap: their lists were cut}."""
        names = [n for n, _ in self.view_tiles]
        counts = torch.stack([t for _, t in self.view_tiles]).tolist() \
            if self.view_tiles else []
        cap = self.dmtet_renderer.tile_cap
        return {"view_tile_max": [[n, int(c)] for n, c in zip(names, counts)],
                "view_tile_cut": [n for n, c in zip(names, counts)
                                  if c > cap]}

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

