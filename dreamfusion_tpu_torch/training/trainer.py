"""The training step (``dreamfusion_tpu/training/trainer.py``, cut to the
ported paths): state init, the step (render → SDS from the pixel oracle or
Stable Diffusion → entropy and orient regularizers → backward → guarded
Adan → EMA), the density-grid update and the analytic-scene PSNR.

Under SD the first ``latent_iter_ratio`` of the run is the warm-up phase:
normal shading at ambient 1, no background MLP, and the rgb + alpha render
goes to the guidance as the latent itself; after it, random lambertian or
textureless shading, the background MLP when drawn, and the VAE encode.

Every random number a step uses is drawn up front by ``draw_step`` (and
``draw_grid`` for the grid update) from a ``torch.Generator``; the step
itself is deterministic, so the tests can hand it the JAX package's draws
instead.  The JAX step is a pure function; this one updates the
parameters, optimizer moments and EMA in place (``apply_updates_guarded``)
to keep one copy of each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.func import functional_call

from ..config import Config
from ..core.math import safe_normalize
from ..core.poses import PoseDraws, circle_poses
from ..core.rays import get_rays, intrinsics_from_fov
from ..core.sampling import stratified_u
from ..evaluation.analytic import scene_views
from ..guidance.oracle import PixelOracleGuidance
from ..guidance.perpneg import (adjust_text_embeddings,
                                interpolate_view_embedding)
from ..models.nerf import SHADING_ALBEDO, SHADING_NORMAL
from ..models.renderer import NeRFRenderer, RenderFlags
from ..ops.occupancy import update_density_grid
from . import schedules
from .data import sample_train_batch
from .optimizer import Adan, AdanState


def check_slice(cfg: Config) -> None:
    """Refuse configurations outside the ported slice, naming the ROADMAP
    item that ports them."""
    todo = {
        "--backbone other than triplane": (cfg.backbone != "triplane",
                                           "queue 1, item 5"),
        "guidance other than the pixel oracle or SD alone": (
            tuple(cfg.guidance) not in (("oracle",), ("SD",)),
            "queue 1, item 7"),
        "--sd_version 1.x (head dim 40)": (
            not cfg.sd_version.startswith("2"), "queue 1, item 4"),
        "--test": (cfg.test, "queue 1, item 3"),
        "--save_mesh": (cfg.save_mesh, "queue 1, item 3"),
        "--dmtet": (cfg.dmtet, "queue 1, item 6"),
        "--image": (cfg.image is not None, "queue 1, item 7"),
        "--optim other than adan": (cfg.optim != "adan", "queue 1, item 3"),
        "--grad_clip": (cfg.grad_clip >= 0, "queue 1, item 3"),
        "--grad_clip_rgb (K5)": (cfg.grad_clip_rgb >= 0, "queue 2, K5"),
        "--progressive_view": (cfg.progressive_view, "queue 1, item 3"),
        "--lambda_tv / --lambda_wd": (cfg.lambda_tv > 0 or cfg.lambda_wd > 0,
                                      "queue 1, item 3"),
        "normal-smoothness losses": (
            cfg.lambda_3d_normal_smooth > 0 or cfg.lambda_2d_normal_smooth > 0
            or cfg.lambda_normal > 0, "queue 1, item 3"),
        "--normal_mode finite_difference": (
            cfg.normal_mode == "finite_difference", "queue 1, item 2"),
    }
    for what, (hit, item) in todo.items():
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})")


def build_renderer(cfg: Config) -> NeRFRenderer:
    return NeRFRenderer(
        bound=cfg.bound, min_near=cfg.min_near,
        grid_probe_steps=cfg.grid_coarse_steps,
        grid_fine_steps=cfg.grid_fine_steps,
        occupancy_mode=cfg.occupancy_mode, dt_gamma=cfg.dt_gamma,
        hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
        density_act=cfg.density_activation, blob_density=cfg.blob_density,
        blob_radius=cfg.blob_radius,
        triplane_resolution=cfg.triplane_resolution,
        triplane_channels=cfg.triplane_channels,
        triplane_scales=cfg.triplane_scales, bg_radius=cfg.bg_radius,
        hidden_dim_bg=cfg.hidden_dim_bg, num_layers_bg=cfg.num_layers_bg,
        compute_dtype=torch.bfloat16 if cfg.fp16 else torch.float32)


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------

class StepDraws(NamedTuple):
    """Every random number of one main step."""
    pose: PoseDraws
    fov: torch.Tensor                  # [] degrees
    choice: schedules.ChoiceDraws
    march_u: torch.Tensor              # [B*h*w, grid_fine_steps] stratified
    t: torch.Tensor                    # [B] int64 diffusion timestep
    noise: torch.Tensor                # [B, h, w, 3] pixels (oracle) or
    #                                    [B, ls, ls, 4] latents (SD)
    posterior_noise: Optional[torch.Tensor] = None   # [B, ls, ls, 4] (SD)


def draw_step(gen: torch.Generator, cfg: Config, device,
              latent_size: Optional[int] = None) -> StepDraws:
    """One step's draws; ``latent_size`` set means SD guidance (latent
    noise and the VAE posterior draw instead of pixel noise)."""
    B = cfg.batch_size

    def U(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def N(*shape):
        return torch.randn(shape, generator=gen, device=device)

    th = [math.radians(a) for a in cfg.theta_range]
    ph = [math.radians(a) for a in cfg.phi_range]
    pose = PoseDraws(radius=U(B, lo=cfg.radius_range[0],
                              hi=cfg.radius_range[1]),
                     thetas=U(B, lo=th[0], hi=th[1]),
                     phis=U(B, lo=ph[0], hi=ph[1]),
                     sphere_normal=N(B, 3), sphere_u=U(),
                     jitter_center=U(B, 3), jitter_target=N(B, 3),
                     jitter_up=N(B, 3))
    fov = U(lo=cfg.fovy_range[0], hi=cfg.fovy_range[1])
    choice = schedules.ChoiceDraws(U(), U(), U(), U(3), N(3))
    march_u = stratified_u(U(B * cfg.h * cfg.w, cfg.grid_fine_steps))
    lo, hi = (int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1]))
    t = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
    if latent_size is None:
        return StepDraws(pose, fov, choice, march_u, t,
                         N(B, cfg.h, cfg.w, 3))
    ls = latent_size
    return StepDraws(pose, fov, choice, march_u, t, N(B, ls, ls, 4),
                     N(B, ls, ls, 4))


def draw_grid(gen: torch.Generator, cfg: Config, device) -> torch.Tensor:
    """Unit-uniform cell jitter [cascade, G³, 3] for one grid update."""
    return torch.rand(cfg.cascade, cfg.grid_size ** 3, 3, generator=gen,
                      device=device)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    renderer: NeRFRenderer             # holds the trainable parameters
    opt_state: AdanState
    ema_params: Dict[str, torch.Tensor]
    density_grid: torch.Tensor         # [cascade, G³]
    mean_density: torch.Tensor         # []
    occ_grid: torch.Tensor             # [cascade, G, G, G] bool
    step: int


def apply_updates_guarded(optimizer: Adan, cfg: Config, state: TrainState,
                          grads: List[torch.Tensor]) -> torch.Tensor:
    """Adan + EMA that skip non-finite gradients (the amp GradScaler's
    behaviour); updates ``state`` in place and returns grad_ok []."""
    params = list(state.renderer.parameters())
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    ok = torch.isfinite(gn)
    safe = [torch.nan_to_num(g) for g in grads]
    with torch.no_grad():
        new_params, new_opt = optimizer.step(params, safe, state.opt_state)
        old = state.opt_state
        for name in ("m", "diff", "n", "prev_grad"):
            for o, nw in zip(getattr(old, name), getattr(new_opt, name)):
                o.copy_(torch.where(ok, nw, o))
        old.count.copy_(torch.where(ok, new_opt.count, old.count))
        d = cfg.ema_decay
        for (name, p), nw in zip(state.renderer.named_parameters(),
                                 new_params):
            p.copy_(torch.where(ok, nw, p))
            e = state.ema_params[name]
            e.copy_(torch.where(ok, d * e + (1 - d) * p, e))
    state.step += 1
    return ok


class Trainer:
    def __init__(self, cfg: Config, device="cpu", guidance=None,
                 embeddings: Optional[Dict[str, torch.Tensor]] = None):
        """``guidance`` and ``embeddings`` (``guidance/embeddings.py``) are
        the SD guidance's; the oracle builds its own."""
        check_slice(cfg)
        # fp32 products stay fp32 on the card: no TF32 in matmuls or
        # convolutions (PyTorch turns it on for cuDNN by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.sd = cfg.guidance == ("SD",)
        if self.sd:
            if guidance is None or embeddings is None:
                raise ValueError("SD guidance needs its towers and prompt "
                                 "embeddings")
            self.guidance, self.embeddings = guidance, embeddings
        else:
            self.guidance = PixelOracleGuidance(cfg.oracle_scene,
                                                cfg.t_range)
        self.latent_size = guidance.cfg.latent_size if self.sd else None

    def flags(self, latent_phase: bool) -> RenderFlags:
        return RenderFlags(perturb=True, shading_static_albedo=False,
                           need_loss_orient=(self.cfg.lambda_orient > 0
                                             and not latent_phase))

    def latent_phase(self, step: int) -> bool:
        """The warm-up steps, r <= latent_iter_ratio of the exposure range
        (``Trainer.train``'s ``phase_at``)."""
        cfg = self.cfg
        r = schedules.iter_ratio(step, cfg.exp_start_iter or 0,
                                 cfg.exp_end_iter or cfg.iters)
        return cfg.latent_iter_ratio > 0 and r <= cfg.latent_iter_ratio

    def draw_step(self, gen: torch.Generator) -> StepDraws:
        return draw_step(gen, self.cfg, self.device, self.latent_size)

    def init_state(self, seed: int) -> TrainState:
        cfg = self.cfg
        renderer = build_renderer(cfg)
        renderer.field.reset_parameters(torch.Generator().manual_seed(seed))
        renderer.to(self.device)
        names = [n for n, _ in renderer.named_parameters()]
        self.optimizer = Adan(5.0 * cfg.lr, [10.0 if "triplanes" in n
                                             else 1.0 for n in names])
        params = list(renderer.parameters())
        G = cfg.grid_size
        return TrainState(
            renderer=renderer,
            opt_state=self.optimizer.init(params),
            ema_params={n: p.detach().clone() for n, p in
                        renderer.named_parameters()},
            density_grid=torch.zeros(cfg.cascade, G ** 3, device=self.device),
            mean_density=torch.zeros((), device=self.device),
            occ_grid=torch.ones(cfg.cascade, G, G, G, dtype=torch.bool,
                                device=self.device),
            step=0)

    # ------------------------------------------------------------------
    def _volume_reg_losses(self, out, wsum, step: int) -> torch.Tensor:
        cfg = self.cfg
        loss = torch.zeros((), device=wsum.device)
        if cfg.lambda_opacity > 0:
            loss = loss + cfg.lambda_opacity * (wsum ** 2).mean()
        if cfg.lambda_entropy > 0:
            a = torch.clamp(out["weights"], 1e-5, 1 - 1e-5)
            ent = (-a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()
            loss = loss + schedules.lambda_entropy_at(cfg, step) * ent
        if "loss_orient" in out:
            loss = loss + cfg.lambda_orient * out["loss_orient"]
        return loss

    def render_part(self, state: TrainState, draws: StepDraws,
                    latent_phase: bool = False):
        """Render + every non-guidance loss term →
        (pred_rgb [B,h,w,3], or rgb + alpha [B,h,w,4] in the warm-up phase,
        reg loss, batch, bg colour [3])."""
        cfg = self.cfg
        H, W = cfg.h, cfg.w
        r_exp = schedules.iter_ratio(state.step, cfg.exp_start_iter or 0,
                                     cfg.exp_end_iter or cfg.iters)
        batch = sample_train_batch(draws.pose, draws.fov, cfg, H, W)
        choices = schedules.sample_step_choices(cfg, draws.choice, r_exp)
        max_level = schedules.encoder_max_level(cfg, r_exp)
        B = batch.rays_o.shape[0]
        ro = batch.rays_o.reshape(-1, 3)
        rd = batch.rays_d.reshape(-1, 3)
        light_d = safe_normalize(ro + choices.light_noise)
        if latent_phase:
            ambient, shading, use_bg_net = 1.0, SHADING_NORMAL, None
        else:
            ambient, shading = choices.ambient_ratio, choices.shading
            use_bg_net = choices.use_bg_net
        out = state.renderer.render_grid(
            self.flags(latent_phase), ro, rd, state.occ_grid,
            light_d=light_d, ambient_ratio=ambient, shading=shading,
            bg_color=choices.bg_color.expand(ro.shape), max_level=max_level,
            march_u=draws.march_u, use_bg_net=use_bg_net)
        image = out["image"].reshape(B, H, W, 3)
        wsum = out["weights_sum"].reshape(B, H, W)
        reg = self._volume_reg_losses(out, wsum, state.step)
        if latent_phase:
            image = torch.cat([image, wsum[..., None]], dim=-1)
        return image, reg, batch, choices.bg_color

    def _sd_loss(self, pred_rgb, batch, draws: StepDraws,
                 as_latent: bool) -> torch.Tensor:
        """SD SDS with the uncond embedding tiled to the batch and the
        view-interpolated (or Perp-Neg) cond embeddings."""
        cfg, emb = self.cfg, self.embeddings
        B = pred_rgb.shape[0]
        uncond = emb["uncond"].expand(B, -1, -1)
        kw = dict(guidance_scale=cfg.guidance_scale, as_latent=as_latent,
                  grad_scale=cfg.lambda_guidance)
        if cfg.perpneg:
            pn = adjust_text_embeddings(emb, batch.delta_azimuth,
                                        cfg.negative_w,
                                        cfg.front_decay_factor,
                                        cfg.side_decay_factor)
            return self.guidance.sds_loss_perpneg(
                pn.text_z, pn.weights, uncond, pred_rgb, draws.t,
                draws.noise, draws.posterior_noise, **kw)
        cond = interpolate_view_embedding(emb, batch.delta_azimuth)
        return self.guidance.sds_loss(cond, uncond, pred_rgb, draws.t,
                                      draws.noise, draws.posterior_noise,
                                      **kw)

    def loss_fn(self, state: TrainState, draws: StepDraws):
        latent_phase = self.latent_phase(state.step)
        pred_rgb, reg, batch, bg = self.render_part(state, draws,
                                                    latent_phase)
        if self.sd:
            sds = self._sd_loss(pred_rgb, batch, draws, latent_phase)
        else:
            sds = self.guidance.sds_loss_rays(
                draws.t, draws.noise, batch.rays_o, batch.rays_d, bg,
                pred_rgb, grad_scale=self.cfg.lambda_guidance)
        loss = sds + reg
        return loss, {"loss_reg": reg, "loss_sds": sds, "loss": loss}

    def train_step(self, state: TrainState, draws: StepDraws):
        """One step (warm-up or main phase by ``state.step``); updates
        ``state`` in place → (metrics, gradients)."""
        params = list(state.renderer.parameters())
        loss, metrics = self.loss_fn(state, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        metrics["grad_ok"] = apply_updates_guarded(self.optimizer, self.cfg,
                                                   state, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, grads

    def update_grid(self, state: TrainState, jitter_u: torch.Tensor) -> None:
        """Density-grid EMA-max refresh from the current parameters."""
        cfg = self.cfg
        state.density_grid, state.mean_density, state.occ_grid = \
            update_density_grid(
                jitter_u, state.density_grid,
                lambda x: state.renderer.density(x)["sigma"], cfg.bound,
                decay=0.95, density_thresh=cfg.density_thresh,
                grid_size=cfg.grid_size)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, state: TrainState, phi: float):
        """Deterministic albedo render of one orbit view at (h, w) with the
        EMA parameters, in max_ray_batch chunks →
        (image [h*w, 3], rays_o, rays_d)."""
        cfg = self.cfg
        dev = self.device
        poses, _ = circle_poses(
            torch.tensor([cfg.default_radius], device=dev),
            torch.tensor([cfg.default_polar], device=dev),
            torch.tensor([phi], dtype=torch.float32, device=dev),
            angle_overhead=cfg.angle_overhead, angle_front=cfg.angle_front)
        intr = intrinsics_from_fov(
            torch.tensor(cfg.default_fovy, device=dev), cfg.h, cfg.w)
        ro, rd = get_rays(poses, intr, cfg.h, cfg.w)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        flags = RenderFlags(perturb=False, shading_static_albedo=True)
        chunks = []
        for i in range(0, ro.shape[0], cfg.max_ray_batch):
            out = functional_call(
                state.renderer, state.ema_params,
                (flags, ro[i:i + cfg.max_ray_batch],
                 rd[i:i + cfg.max_ray_batch], state.occ_grid),
                {"ambient_ratio": 1.0, "shading": SHADING_ALBEDO},
                strict=True)
            chunks.append(out["image"])
        return torch.cat(chunks), ro, rd

    def oracle_eval_metric(self, state: TrainState) -> float:
        """PSNR of EMA renders of validation-circle views against the
        analytic scene (white background on both sides)."""
        mses = []
        for i in range(min(self.cfg.dataset_size_valid, 4)):
            img, ro, rd = self.render_view(state, (i / 4) * 360.0)
            tgt, _ = scene_views(ro, rd, self.cfg.oracle_scene)
            mses.append(float(((img - tgt) ** 2).mean()))
        return float(-10.0 * math.log10(max(sum(mses) / len(mses), 1e-10)))
