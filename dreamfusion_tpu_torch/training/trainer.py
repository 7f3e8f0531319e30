"""The training step (``dreamfusion_tpu/training/trainer.py``, cut to the
ported paths): state init, the step (render → SDS from the pixel oracle or
Stable Diffusion → entropy and orient regularizers → backward → guarded
Adan → EMA), the density-grid update, and the run's end: eval renders with
the analytic-scene PSNR, the turntable video and the checkpoints
(``torch.save``; the rolling ``df_ep*`` ones and the EMA-only ``df`` kept
best by the eval metric).

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

import copy
import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from ..config import Config
from ..core.math import safe_normalize
from ..core.poses import PoseDraws
from ..core.sampling import stratified_u
from ..evaluation.analytic import scene_views
from ..guidance.oracle import PixelOracleGuidance
from ..guidance.perpneg import (adjust_text_embeddings,
                                interpolate_view_embedding)
from ..models.nerf import SHADING_ALBEDO, SHADING_NORMAL
from ..models.renderer import NeRFRenderer, RenderFlags
from ..ops.occupancy import update_density_grid
from ..utils.device import resolve_device
from ..utils.image import colorize_depth, save_image, save_video
from . import schedules
from .data import (CameraBatch, circle_view_batch, sample_train_batch,
                   six_view_batch)
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
        "--init_with a mesh file (K9)": (
            cfg.init_with.lower().endswith((".obj", ".ply")),
            "queue 2, K9"),
        "--dmtet with guidance other than the pixel oracle": (
            cfg.dmtet and tuple(cfg.guidance) != ("oracle",),
            "queue 1, item 6"),
        "--dmtet with --image (the known-view step)": (
            cfg.dmtet and cfg.image is not None, "queue 1, item 7"),
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


def _samplers(gen: torch.Generator, device):
    def U(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def N(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return U, N


def draw_view(gen: torch.Generator, cfg: Config, device):
    """A step's camera and shading draws → (pose, fov, choice)."""
    B = cfg.batch_size
    U, N = _samplers(gen, device)
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
    return pose, fov, choice


def draw_t(gen: torch.Generator, cfg: Config, device) -> torch.Tensor:
    """[B] int64 diffusion timesteps in the t_range."""
    lo, hi = (int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1]))
    return torch.randint(lo, hi + 1, (cfg.batch_size,), generator=gen,
                         device=device)


def draw_step(gen: torch.Generator, cfg: Config, device,
              latent_size: Optional[int] = None) -> StepDraws:
    """One step's draws; ``latent_size`` set means SD guidance (latent
    noise and the VAE posterior draw instead of pixel noise)."""
    B = cfg.batch_size
    U, N = _samplers(gen, device)
    pose, fov, choice = draw_view(gen, cfg, device)
    march_u = stratified_u(U(B * cfg.h * cfg.w, cfg.grid_fine_steps))
    t = draw_t(gen, cfg, device)
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


def guarded_update(optimizer: Adan, cfg: Config, module: torch.nn.Module,
                   opt_state: AdanState, ema_params: Dict[str, torch.Tensor],
                   grads: List[torch.Tensor]) -> torch.Tensor:
    """Adan + EMA that skip non-finite gradients (the amp GradScaler's
    behaviour), in place on the module's parameters, the optimizer state
    and the EMA → grad_ok []."""
    params = list(module.parameters())
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    ok = torch.isfinite(gn)
    safe = [torch.nan_to_num(g) for g in grads]
    with torch.no_grad():
        new_params, new_opt = optimizer.step(params, safe, opt_state)
        for name in ("m", "diff", "n", "prev_grad"):
            for o, nw in zip(getattr(opt_state, name),
                             getattr(new_opt, name)):
                o.copy_(torch.where(ok, nw, o))
        opt_state.count.copy_(torch.where(ok, new_opt.count, opt_state.count))
        d = cfg.ema_decay
        for (name, p), nw in zip(module.named_parameters(), new_params):
            p.copy_(torch.where(ok, nw, p))
            e = ema_params[name]
            e.copy_(torch.where(ok, d * e + (1 - d) * p, e))
    return ok


def apply_updates_guarded(optimizer: Adan, cfg: Config, state: TrainState,
                          grads: List[torch.Tensor]) -> torch.Tensor:
    """``guarded_update`` of the renderer; advances ``state.step``."""
    ok = guarded_update(optimizer, cfg, state.renderer, state.opt_state,
                        state.ema_params, grads)
    state.step += 1
    return ok


def ema_copy(module: torch.nn.Module, ema: Dict[str, torch.Tensor]
             ) -> torch.nn.Module:
    """A copy of ``module`` holding the EMA parameters."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(ema[n])
    return out


def newest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest rolling ``df_ep*.pth`` in a directory, or None."""
    cands = sorted(glob.glob(os.path.join(ckpt_dir, "df_ep*.pth")))
    return cands[-1] if cands else None


def adan_for(cfg: Config, module: torch.nn.Module) -> Adan:
    """Adan at 5x lr, the triplanes' updates 10x."""
    return Adan(5.0 * cfg.lr, [10.0 if "triplanes" in n else 1.0
                               for n, _ in module.named_parameters()])


class Trainer:
    # state fields saved beside the parameters, optimizer state and EMA
    EXTRA_STATE = ("density_grid", "mean_density", "occ_grid")

    def __init__(self, cfg: Config, device="cuda", guidance=None,
                 embeddings: Optional[Dict[str, torch.Tensor]] = None):
        """``guidance`` and ``embeddings`` (``guidance/embeddings.py``) are
        the SD guidance's; the oracle builds its own.  A ``--test`` run,
        which trains nothing, needs neither.  The device is the card unless
        the caller asks for the CPU."""
        check_slice(cfg)
        # fp32 products stay fp32 on the card: no TF32 in matmuls or
        # convolutions (PyTorch turns it on for cuDNN by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sd = cfg.guidance == ("SD",)
        if self.sd:
            if (guidance is None or embeddings is None) and not cfg.test:
                raise ValueError("SD guidance needs its towers and prompt "
                                 "embeddings")
            self.guidance, self.embeddings = guidance, embeddings
        else:
            self.guidance = PixelOracleGuidance(cfg.oracle_scene,
                                                cfg.t_range)
        self.latent_size = guidance.cfg.latent_size \
            if self.sd and guidance is not None else None
        self.workspace = cfg.workspace
        for sub in ("checkpoints", "validation", "results"):
            os.makedirs(os.path.join(self.workspace, sub), exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log_df.txt")
        self.best_result: Optional[float] = None
        self.checkpoints: List[str] = []        # rolling, oldest first

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def epoch(self, state) -> int:
        return state.step // self.cfg.dataset_size_train

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

    def run_step(self, state: TrainState, gen: torch.Generator):
        """One training step at state.step, with the density-grid refresh on
        its cadence → (metrics, gradients)."""
        if state.step % self.cfg.update_extra_interval == 0:
            self.update_grid(state, draw_grid(gen, self.cfg, self.device))
        return self.train_step(state, self.draw_step(gen))

    def init_state(self, seed: int) -> TrainState:
        cfg = self.cfg
        renderer = build_renderer(cfg)
        renderer.field.reset_parameters(torch.Generator().manual_seed(seed))
        renderer.to(self.device)
        self.optimizer = adan_for(cfg, renderer)
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
    # eval and test renders
    @torch.no_grad()
    def render_view(self, state: TrainState, batch: CameraBatch, H: int,
                    W: int):
        """Deterministic albedo render of a one-view batch at H×W with the
        EMA parameters, in max_ray_batch chunks → (image [H*W, 3], depth
        [H*W])."""
        cfg = self.cfg
        ro, rd = batch.rays_o[0], batch.rays_d[0]
        flags = RenderFlags(perturb=False, shading_static_albedo=True)
        images, depths = [], []
        for i in range(0, ro.shape[0], cfg.max_ray_batch):
            out = functional_call(
                state.renderer, state.ema_params,
                (flags, ro[i:i + cfg.max_ray_batch],
                 rd[i:i + cfg.max_ray_batch], state.occ_grid),
                {"ambient_ratio": 1.0, "shading": SHADING_ALBEDO},
                strict=True)
            images.append(out["image"])
            depths.append(out["depth"])
        return torch.cat(images), torch.cat(depths)

    def oracle_eval_metric(self, state) -> float:
        """PSNR of EMA renders of validation-circle views at h×w against
        the analytic scene (white background on both sides)."""
        cfg = self.cfg
        mses = []
        for i in range(min(cfg.dataset_size_valid, 4)):
            b = circle_view_batch(cfg, i, 4, cfg.h, cfg.w, self.device)
            img, _ = self.render_view(state, b, cfg.h, cfg.w)
            tgt, _ = scene_views(b.rays_o[0], b.rays_d[0], cfg.oracle_scene)
            mses.append(float(((img - tgt) ** 2).mean()))
        return float(-10.0 * math.log10(max(sum(mses) / len(mses), 1e-10)))

    def eval_metric(self, state) -> Optional[float]:
        """The analytic PSNR under the oracle; None otherwise (text-only SDS
        has no ground truth; the CLIP scorer is not ported)."""
        return None if self.sd else self.oracle_eval_metric(state)

    def _frame(self, state, batch: CameraBatch):
        """One eval/test view at H×W → (rgb [H,W,3], depth [H,W]) numpy."""
        H, W = self.cfg.H, self.cfg.W
        img, depth = self.render_view(state, batch, H, W)
        return (img.reshape(H, W, 3).cpu().numpy(),
                depth.reshape(H, W).cpu().numpy())

    def evaluate(self, state) -> Optional[float]:
        """rgb and depth PNGs of min(dataset_size_valid, 4) views at H×W
        (``validation/df_ep{epoch}_{i}_*.png``) → the eval metric."""
        cfg = self.cfg
        n = min(cfg.dataset_size_valid, 4)
        vdir = os.path.join(self.workspace, "validation")
        for i in range(n):
            rgb, depth = self._frame(state, circle_view_batch(
                cfg, i, n, cfg.H, cfg.W, self.device))
            stem = os.path.join(vdir, f"df_ep{self.epoch(state):04d}_{i:04d}")
            save_image(f"{stem}_rgb.png", rgb)
            save_image(f"{stem}_depth.png", colorize_depth(depth))
        return self.eval_metric(state)

    def test(self, state, six_views: bool = False):
        """Turntable of dataset_size_test frames at H×W → results/df_rgb.mp4
        and df_depth.mp4; with ``six_views`` the six axis views as PNGs."""
        cfg = self.cfg
        n = 6 if six_views else cfg.dataset_size_test
        frames, depths = [], []
        for i in range(n):
            b = six_view_batch(cfg, i, cfg.H, cfg.W, self.device) \
                if six_views else \
                circle_view_batch(cfg, i, n, cfg.H, cfg.W, self.device)
            rgb, depth = self._frame(state, b)
            frames.append(rgb)
            depths.append(depth)
        rdir = os.path.join(self.workspace, "results")
        if not six_views:
            save_video(os.path.join(rdir, "df_rgb.mp4"), frames, log=self.log)
            save_video(os.path.join(rdir, "df_depth.mp4"),
                       [colorize_depth(d) for d in depths], log=self.log)
        else:
            for i, f in enumerate(frames):
                save_image(os.path.join(rdir, f"df_{i:04d}_rgb.png"), f)
        return frames

    # ------------------------------------------------------------------
    # checkpoints
    def module(self, state) -> torch.nn.Module:
        """The module holding the trainable parameters."""
        return state.renderer

    def field(self, state) -> NeRFRenderer:
        """The field with the EMA weights (the mesh export's)."""
        return ema_copy(state.renderer, state.ema_params)

    def _ckpt_dir(self) -> str:
        return os.path.join(self.workspace, "checkpoints")

    def _payload(self, state) -> Dict[str, Any]:
        o = state.opt_state
        return {"module": self.module(state).state_dict(),
                "opt": {"count": o.count, "m": o.m, "diff": o.diff,
                        "n": o.n, "prev_grad": o.prev_grad},
                "ema": state.ema_params, "step": state.step,
                "extra": {k: getattr(state, k) for k in self.EXTRA_STATE}}

    @torch.no_grad()
    def _restore(self, state, payload: Dict[str, Any]) -> None:
        self.module(state).load_state_dict(payload["module"])
        o, po = state.opt_state, payload["opt"]
        o.count.copy_(po["count"])
        for name in ("m", "diff", "n", "prev_grad"):
            for dst, src in zip(getattr(o, name), po[name]):
                dst.copy_(src)
        for k, v in payload["ema"].items():
            state.ema_params[k].copy_(v)
        for k, v in payload["extra"].items():
            setattr(state, k, v.to(self.device))
        state.step = int(payload["step"])

    def save_checkpoint(self, state, full: bool = True,
                        metric: Optional[float] = None) -> None:
        """full: the rolling ``df_ep{epoch}.pth`` train state (the newest
        ``max_keep_ckpt`` kept); else the EMA-only ``df.pth``, overwritten
        only when ``metric`` (higher better) improves, or always when there
        is none.  Each file has a ``.meta.json`` beside it.  Saves are
        synchronous."""
        d = self._ckpt_dir()
        os.makedirs(d, exist_ok=True)
        if not full:
            if metric is not None:
                if self.best_result is not None and metric <= self.best_result:
                    self.log(f"[ckpt] eval metric {metric:.3f} <= best "
                             f"{self.best_result:.3f}, keeping the previous "
                             f"df snapshot")
                    return
                self.best_result = metric
            torch.save({"ema_params": state.ema_params},
                       os.path.join(d, "df.pth"))
            with open(os.path.join(d, "df.meta.json"), "w") as f:
                json.dump({"global_step": state.step,
                           "best_result": self.best_result}, f)
            return
        stem = os.path.join(d, f"df_ep{self.epoch(state):04d}")
        torch.save(self._payload(state), stem + ".pth")
        with open(stem + ".meta.json", "w") as f:
            json.dump({"global_step": state.step,
                       "epoch": self.epoch(state)}, f)
        if stem in self.checkpoints:
            self.checkpoints.remove(stem)
        self.checkpoints.append(stem)
        while len(self.checkpoints) > self.cfg.max_keep_ckpt:
            old = self.checkpoints.pop(0)
            for ext in (".pth", ".meta.json"):
                if os.path.exists(old + ext):
                    os.remove(old + ext)

    def load_checkpoint(self, state, ckpt: str = "latest") -> Tuple[Any, bool]:
        """``latest`` (the newest ``df_ep*``), ``best`` / ``latest_model``
        (the EMA-only ``df``: parameters and EMA both set to it) or a path
        → (state, loaded)."""
        d = self._ckpt_dir()
        meta = os.path.join(d, "df.meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.best_result = json.load(f).get("best_result")
        if ckpt in ("best", "latest_model"):
            path = os.path.join(d, "df.pth")
            if not os.path.exists(path):
                return state, False
            ema = torch.load(path, map_location=self.device)["ema_params"]
            with torch.no_grad():
                for n, p in self.module(state).named_parameters():
                    p.copy_(ema[n])
                    state.ema_params[n].copy_(ema[n])
            return state, True
        path = newest_checkpoint(d) if ckpt == "latest" else ckpt
        if path is None:
            return state, False
        self._restore(state, torch.load(path, map_location=self.device))
        return state, True
