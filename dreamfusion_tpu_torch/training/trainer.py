"""The training step (``dreamfusion_tpu/training/trainer.py``): state init,
the step (render → the summed loss of every prior of ``--guidance``, in
sorted name order as JAX sums them: DeepFloyd-IF (pixel space: the render
resized to 64²), Stable Diffusion, CLIP's similarity term, the image
oracle, the pixel oracle and Zero-1-to-3 → entropy, orient and
normal-smoothness regularizers, the hash grid's tv and weight decay and
the triplane's tv → backward → guarded Adan or Adam → EMA), the
density-grid update (the grid and the triplane; the vanilla field renders
without one and keeps JAX's zeros), the ``--save_guidance`` triptychs
(``save_guidance_snapshot``) and the run's end: eval renders with the
analytic-scene PSNR (under ``--image`` or ``--image_config``, the
known-view masked PSNR; for a text run with a CLIP scorer, its CLIP
score), the turntable video and the checkpoints (``torch.save``; the
rolling ``df_ep*`` ones and the EMA-only ``df`` kept best by the eval
metric).

Under SD the first ``latent_iter_ratio`` of the run is the warm-up phase:
normal shading at ambient 1, no background MLP, and the rgb + alpha render
goes to the guidance as the latent itself; after it, random lambertian or
textureless shading, the background MLP when drawn, and the VAE encode.
Under ``--image`` every ``known_view_interval``-th step is a known-view
step instead: the reference camera (jittered by a shared [3] noise), a
per-pixel random background, lambertian shading at ambient 1, and rgb,
mask, Pearson-depth (and normal) losses against the reference image.
``--grad_clip_rgb`` clamps the gradient entering the rendered rgb of both
kinds of step (K5, ``ops/clip_grad.py``).

Every random number a step uses is drawn up front by ``draw_step`` (and
``draw_grid`` for the grid update, ``draw_known_view`` for a known-view
step) from a ``torch.Generator``; the step itself is deterministic, so the
tests can hand it the JAX package's draws instead.  Each prior that draws
(the diffusion priors and the oracles; CLIP draws nothing) takes its own
timestep and noise, and the VAE priors a posterior draw, in sorted name
order: the first one's in ``StepDraws.t``, ``noise`` and
``posterior_noise``, the others' in ``StepDraws.extra`` by name.  The
pose and FOV draws are unit uniforms, scaled by the step's ranges
(progressive under ``--progressive_view``) in ``data.scale_view_draws``.
The JAX step is a pure function; this one updates the parameters,
optimizer moments and EMA in place (``apply_updates_guarded``) to keep one
copy of each.
"""

from __future__ import annotations

import copy
import glob
import json
import math
import os
from dataclasses import dataclass
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..core.math import safe_normalize
from ..core.poses import PoseDraws
from ..core.sampling import stratified_u
from ..evaluation.analytic import scene_views
from ..guidance.oracle import ImageOracleGuidance, PixelOracleGuidance
from ..guidance.perpneg import (adjust_text_embeddings,
                                interpolate_view_embedding)
from ..models.nerf import (SHADING_ALBEDO, SHADING_LAMBERTIAN,
                           SHADING_NORMAL, make_grid_spec)
from ..models.renderer import NeRFRenderer, RenderFlags
from ..ops.clip_grad import clip_grad
from ..ops.hashgrid import (HashGridSpec, draw_tv_cells, hashgrid_tv_loss,
                            hashgrid_wd_loss)
from ..ops.occupancy import update_density_grid
from ..ops.triplane import triplane_tv_loss
from ..utils.device import resolve_device
from ..utils.image import colorize_depth, save_image, save_video
from . import schedules
from .data import (CameraBatch, circle_view_batch, default_view_batch,
                   sample_train_batch, scale_view_draws, six_view_batch)
from .image_data import RefImages, masked_pearson, pil_resize_uint8
from .optimizer import build_optimizer, state_tensors


# the priors ``--guidance`` may name, and those that diffuse (their towers
# and embeddings come from ``main.build_run``)
PRIORS = ("IF", "SD", "clip", "image_oracle", "oracle", "zero123")
DIFFUSION = ("IF", "SD", "zero123")


def check_slice(cfg: Config) -> None:
    """Refuse what JAX's ``main`` refuses (a backbone it does not know,
    zero123 without a reference image, the image oracle without an analytic
    one), and a prior name it does not know."""
    refs = cfg.image is not None or cfg.image_config is not None
    for name in cfg.guidance:
        if name not in PRIORS:
            raise ValueError(f"unknown guidance {name!r}: one of {PRIORS}")
    if "zero123" in cfg.guidance and not refs:
        raise ValueError("zero123 guidance needs a reference image: "
                         "--image or --image_config")
    if "image_oracle" in cfg.guidance and not (
            cfg.image is not None and cfg.image.startswith("analytic:")):
        raise ValueError("--guidance image_oracle needs --image "
                         "analytic:<scene>")
    if cfg.backbone not in ("grid", "triplane", "vanilla"):
        raise ValueError(f"unknown backbone {cfg.backbone!r}")


GRID_FIELDS = ("grid_levels", "grid_features_per_level",
               "grid_log2_hashmap_size", "grid_desired_resolution",
               "grid_interpolation", "grid_hash")


def grid_spec_of(cfg: Config) -> HashGridSpec:
    """The hash-grid spec of the field ``build_renderer(cfg)`` builds."""
    return make_grid_spec(**{k: getattr(cfg, k) for k in GRID_FIELDS},
                          bound=cfg.bound)


def build_renderer(cfg: Config) -> NeRFRenderer:
    return NeRFRenderer(
        bound=cfg.bound, min_near=cfg.min_near,
        grid_probe_steps=cfg.grid_coarse_steps,
        grid_fine_steps=cfg.grid_fine_steps,
        occupancy_mode=cfg.occupancy_mode, dt_gamma=cfg.dt_gamma,
        num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
        backbone=cfg.backbone, hidden_dim=cfg.hidden_dim,
        num_layers=cfg.num_layers,
        density_act=cfg.density_activation, blob_density=cfg.blob_density,
        blob_radius=cfg.blob_radius,
        **{k: getattr(cfg, k) for k in GRID_FIELDS},
        triplane_resolution=cfg.triplane_resolution,
        triplane_channels=cfg.triplane_channels,
        triplane_scales=cfg.triplane_scales, bg_radius=cfg.bg_radius,
        hidden_dim_bg=cfg.hidden_dim_bg, num_layers_bg=cfg.num_layers_bg,
        normal_mode=cfg.normal_mode,
        compute_dtype=torch.bfloat16 if cfg.fp16 else torch.float32)


def samples_per_ray(cfg: Config) -> int:
    """The samples a training render shades on each ray."""
    if cfg.backbone == "vanilla":
        return cfg.num_steps + cfg.upsample_steps
    return cfg.grid_fine_steps


def draw_march(U, cfg: Config, R: int):
    """A render's sampling draws → (march_u, pdf_u): the grid's stratified
    fine draws [R, grid_fine_steps] and None, or the vanilla render's unit
    coarse jitter [R, num_steps] and stratified importance draws [R,
    upsample_steps]."""
    if cfg.backbone != "vanilla":
        return stratified_u(U(R, cfg.grid_fine_steps)), None
    return U(R, cfg.num_steps), stratified_u(U(R, cfg.upsample_steps))


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------

class NoiseSpec(NamedTuple):
    """A prior's draws: noise of `side`² x `channels` (None: the render's
    h x w pixels, 3 channels), and a VAE posterior draw of the same shape
    with `posterior`."""
    side: Optional[int] = None
    channels: int = 3
    posterior: bool = False


class PriorDraws(NamedTuple):
    """One prior's draws in a step or a snapshot."""
    t: torch.Tensor                    # [B] int64 diffusion timestep
    noise: torch.Tensor                # [B, h, w, 3] pixels (oracles),
    #                                    [B, ls, ls, 4] latents (SD,
    #                                    zero123) or [B, 64, 64, 3] (IF)
    posterior_noise: Optional[torch.Tensor] = None   # like noise (VAE)


class StepDraws(NamedTuple):
    """Every random number of one main step."""
    pose: PoseDraws
    fov: torch.Tensor                  # [] degrees
    choice: schedules.ChoiceDraws
    march_u: torch.Tensor              # [B*h*w, grid_fine_steps] stratified
    #                                    (vanilla: [B*h*w, num_steps] unit)
    t: Optional[torch.Tensor] = None   # the first drawing prior's
    noise: Optional[torch.Tensor] = None     # ``PriorDraws`` (none under
    posterior_noise: Optional[torch.Tensor] = None   # CLIP alone)
    tv_cells: Optional[torch.Tensor] = None   # [L, 4096, 3] (grid, tv > 0)
    perturb_noise: Optional[torch.Tensor] = None  # [B*h*w*S, 3] normal
    #                                    (the 3-D normal-smoothness loss)
    pdf_u: Optional[torch.Tensor] = None  # [B*h*w, upsample_steps]
    #                                    stratified (vanilla)
    extra: Optional[Dict[str, PriorDraws]] = None   # the other priors'


class KnownViewDraws(NamedTuple):
    """Every random number of one known-view step."""
    sel: torch.Tensor                  # [] int64 reference view
    ro_noise: torch.Tensor             # [3] standard normal camera shift
    rd_noise: torch.Tensor             # [3]
    bg: torch.Tensor                   # [Hs*Ws, 3] per-pixel background
    march_u: torch.Tensor              # [Hs*Ws, grid_fine_steps]
    perturb_noise: Optional[torch.Tensor] = None  # [Hs*Ws*S, 3]
    pdf_u: Optional[torch.Tensor] = None  # [Hs*Ws, upsample_steps]


def _samplers(gen: torch.Generator, device):
    def U(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def N(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return U, N


def draw_view(gen: torch.Generator, cfg: Config, device):
    """A step's camera and shading draws → (pose, fov, choice); the
    radius, angles and FOV are unit uniforms (``data.scale_view_draws``
    puts them in the step's ranges)."""
    B = cfg.batch_size
    U, N = _samplers(gen, device)
    pose = PoseDraws(radius=U(B), thetas=U(B), phis=U(B),
                     sphere_normal=N(B, 3), sphere_u=U(),
                     jitter_center=U(B, 3), jitter_target=N(B, 3),
                     jitter_up=N(B, 3))
    fov = U()
    choice = schedules.ChoiceDraws(U(), U(), U(), U(3), N(3))
    return pose, fov, choice


def train_batch(cfg: Config, pose: PoseDraws, fov: torch.Tensor, step: int,
                H: int, W: int) -> CameraBatch:
    """The step's random views from unit pose draws, in the step's pose
    ranges (progressive under ``--progressive_view``)."""
    r_exp = schedules.iter_ratio(step, cfg.exp_start_iter or 0,
                                 cfg.exp_end_iter or cfg.iters)
    pose, fov = scale_view_draws(pose, fov,
                                 schedules.view_ranges(cfg, r_exp))
    return sample_train_batch(pose, fov, cfg, H, W)


def draw_t(gen: torch.Generator, cfg: Config, device,
           B: Optional[int] = None) -> torch.Tensor:
    """[B] (default: the batch size) int64 diffusion timesteps in the
    t_range."""
    lo, hi = (int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1]))
    return torch.randint(lo, hi + 1, (B or cfg.batch_size,), generator=gen,
                         device=device)


PIXELS = (("oracle", NoiseSpec()),)


def draw_priors(gen: torch.Generator, cfg: Config, device,
                specs: Sequence[Tuple[str, NoiseSpec]],
                B: Optional[int] = None) -> Dict[str, PriorDraws]:
    """Each prior's t, noise and posterior draw, in the order of `specs`
    ((name, NoiseSpec) pairs)."""
    B = B or cfg.batch_size
    _, N = _samplers(gen, device)
    out = {}
    for name, sp in specs:
        t = draw_t(gen, cfg, device, B)
        shape = (B, cfg.h, cfg.w, 3) if sp.side is None else \
            (B, sp.side, sp.side, sp.channels)
        out[name] = PriorDraws(t, N(*shape),
                               N(*shape) if sp.posterior else None)
    return out


def prior_fields(draws: Dict[str, PriorDraws]) -> Dict[str, Any]:
    """``draw_priors``' draws as StepDraws' (or DMTetDraws') fields: the
    first prior's t, noise and posterior_noise, the rest in ``extra``."""
    if not draws:
        return {}
    first, *rest = draws
    return dict(draws[first]._asdict(),
                extra={n: draws[n] for n in rest} or None)


def draw_step(gen: torch.Generator, cfg: Config, device,
              specs: Sequence[Tuple[str, NoiseSpec]] = PIXELS) -> StepDraws:
    """One step's draws: the view, the march, then each prior's
    (``draw_priors``; by default one prior drawing pixel noise at h x w, an
    oracle's)."""
    B = cfg.batch_size
    U, N = _samplers(gen, device)
    pose, fov, choice = draw_view(gen, cfg, device)
    march_u, pdf_u = draw_march(U, cfg, B * cfg.h * cfg.w)
    draws = StepDraws(pose, fov, choice, march_u, pdf_u=pdf_u,
                      **prior_fields(draw_priors(gen, cfg, device, specs)))
    if cfg.backbone == "grid" and cfg.lambda_tv > 0:
        draws = draws._replace(tv_cells=draw_tv_cells(
            gen, grid_spec_of(cfg), device))
    if cfg.lambda_3d_normal_smooth > 0:
        draws = draws._replace(perturb_noise=N(
            B * cfg.h * cfg.w * samples_per_ray(cfg), 3))
    return draws


def snapshot_panel(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """A snapshot's panel at H×W as JAX writes it: a panel of another size
    clipped and truncated to uint8, resized by Pillow's default filter
    (bicubic), over 255 (float64)."""
    if img.shape[:2] == (H, W):
        return img
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return pil_resize_uint8(u8, H, W) / 255.0


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
    opt_state: Any                     # AdanState or AdamState
    ema_params: Dict[str, torch.Tensor]
    density_grid: torch.Tensor         # [cascade, G³]
    mean_density: torch.Tensor         # []
    occ_grid: torch.Tensor             # [cascade, G, G, G] bool
    step: int


def guarded_update(optimizer, cfg: Config, module: torch.nn.Module,
                   opt_state, ema_params: Dict[str, torch.Tensor],
                   grads: List[torch.Tensor]) -> torch.Tensor:
    """The optimizer (Adan or Adam) + EMA that skip non-finite gradients
    (the amp GradScaler's behaviour), in place on the module's parameters,
    the optimizer state and the EMA → grad_ok []."""
    params = list(module.parameters())
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    ok = torch.isfinite(gn)
    safe = [torch.nan_to_num(g) for g in grads]
    with torch.no_grad():
        new_params, new_opt = optimizer.step(params, safe, opt_state)
        new = state_tensors(new_opt)
        for name, old in state_tensors(opt_state).items():
            for o, nw in zip(*((old, new[name]) if isinstance(old, list)
                               else ([old], [new[name]]))):
                o.copy_(torch.where(ok, nw, o))
        d = cfg.ema_decay
        for (name, p), nw in zip(module.named_parameters(), new_params):
            p.copy_(torch.where(ok, nw, p))
            e = ema_params[name]
            e.copy_(torch.where(ok, d * e + (1 - d) * p, e))
    return ok


def apply_updates_guarded(optimizer, cfg: Config, state: TrainState,
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


def optimizer_for(cfg: Config, module: torch.nn.Module):
    """``build_optimizer`` of the run: Adan at 5x lr, or Adam
    (``--optim``), decayed under the vanilla backbone, clipped under
    ``--grad_clip``; the encoder's (hash table or triplanes) updates 10x."""
    return build_optimizer(
        cfg.optim, cfg.lr, cfg.iters,
        [10.0 if "grid_table" in n or "triplanes" in n else 1.0
         for n, _ in module.named_parameters()],
        vanilla=cfg.backbone == "vanilla", grad_clip=cfg.grad_clip)


class Trainer:
    # state fields saved beside the parameters, optimizer state and EMA
    EXTRA_STATE = ("density_grid", "mean_density", "occ_grid")

    def __init__(self, cfg: Config, device="cuda", guidance=None,
                 embeddings=None, ref_images: Optional[RefImages] = None,
                 clip=None, clip_z: Optional[Dict[str, torch.Tensor]] = None,
                 priors: Optional[Dict[str, Tuple[Any, Any]]] = None):
        """``priors``: {name: (guidance, embeddings)} for the towers of
        ``--guidance`` (``main.build_run``): SD's (the prompt embeddings,
        ``guidance/embeddings.py``), DeepFloyd-IF's
        (``IFGuidance.prepare_embeddings``), zero123's (the reference
        images', ``Zero123Guidance.prepare_image_embeddings``) and CLIP's
        (its targets, ``CLIPGuidance.prepare_embeddings``).  ``guidance``
        and ``embeddings`` name the one diffusion prior of ``--guidance``,
        ``clip`` and ``clip_z`` CLIP's, where that is shorter.  The oracles
        are built here.  A ``--test`` run, which trains nothing, needs none
        of them.  ``ref_images`` are the known views of ``--image`` or
        ``--image_config`` (``image_data.load_ref_images``,
        ``analytic_ref_images``).  The device is the card unless the caller
        asks for the CPU."""
        check_slice(cfg)
        # fp32 products stay fp32 on the card: no TF32 in matmuls or
        # convolutions (PyTorch turns it on for cuDNN by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        priors = dict(priors or {})
        if guidance is not None:
            diffusion = [n for n in cfg.guidance if n in DIFFUSION]
            if len(diffusion) != 1:
                raise ValueError("several diffusion priors: pass them as "
                                 "`priors`")
            priors[diffusion[0]] = (guidance, embeddings)
        if clip is not None:
            priors["clip"] = (clip, clip_z)
        for name in cfg.guidance:
            if name == "oracle":
                priors[name] = (PixelOracleGuidance(cfg.oracle_scene,
                                                    cfg.t_range), None)
            elif name == "image_oracle":
                if ref_images is None:
                    raise ValueError("the image oracle needs the reference "
                                     "images")
                priors[name] = (ImageOracleGuidance(
                    cfg.image.split(":", 1)[1], cfg.t_range,
                    cfg.zero123_grad_scale, ref_images.polars,
                    ref_images.azimuths, ref_images.radii), None)
            elif name not in priors and not cfg.test:
                raise ValueError(f"{name} guidance needs its towers and "
                                 f"embeddings")
        # summed in sorted name order, as JAX's step sums them
        self.priors = {n: priors[n] for n in sorted(priors)}
        # each drawing prior's noise: its own side and channels (the
        # oracles' the render's pixels), with the VAE posterior's draw
        self.noise_specs = tuple(
            (n, NoiseSpec() if isinstance(g, PixelOracleGuidance)
             else NoiseSpec(g.latent_size, g.latent_channels, g.posterior))
            for n, (g, _) in self.priors.items() if n != "clip")
        sides = [sp.side for _, sp in self.noise_specs if sp.side]
        self.latent_size = sides[0] if sides else None
        self.clip_scorer = None          # ``set_clip_scorer``
        self.ref_images = ref_images
        if ref_images is not None:
            as_t = lambda a: None if a is None else \
                torch.from_numpy(np.array(a)).to(self.device)
            self.gt = {k: as_t(getattr(ref_images, k))
                       for k in ("rgb", "mask", "depth", "normal")}
            self.kv_batch = default_view_batch(
                cfg, ref_images.radii, ref_images.polars,
                ref_images.azimuths, cfg.h, cfg.w, self.device)
        self.workspace = cfg.workspace
        for sub in ("checkpoints", "validation", "results"):
            os.makedirs(os.path.join(self.workspace, sub), exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log_df.txt")
        self.best_result: Optional[float] = None
        self.checkpoints: List[str] = []        # rolling, oldest first
        self.view_tiles: List[Tuple[str, torch.Tensor]] = []  # ``_frame``

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def epoch(self, state) -> int:
        return state.step // self.cfg.dataset_size_train

    def flags(self, latent_phase: bool) -> RenderFlags:
        cfg = self.cfg
        return RenderFlags(
            perturb=True, shading_static_albedo=False,
            need_loss_orient=cfg.lambda_orient > 0 and not latent_phase,
            need_normal_perturb=(cfg.lambda_3d_normal_smooth > 0
                                 and not latent_phase),
            need_normal_image=((cfg.lambda_2d_normal_smooth > 0 or
                                cfg.lambda_normal > 0)
                               and not latent_phase))

    def latent_phase(self, step: int) -> bool:
        """The warm-up steps, r <= latent_iter_ratio of the exposure range
        (``Trainer.train``'s ``phase_at``)."""
        cfg = self.cfg
        r = schedules.iter_ratio(step, cfg.exp_start_iter or 0,
                                 cfg.exp_end_iter or cfg.iters)
        return cfg.latent_iter_ratio > 0 and r <= cfg.latent_iter_ratio

    def draw_step(self, gen: torch.Generator) -> StepDraws:
        return draw_step(gen, self.cfg, self.device, self.noise_specs)

    def prior_draws(self, draws, name: str) -> PriorDraws:
        """Prior `name`'s draws in a step's draws (``prior_fields``)."""
        if name == self.noise_specs[0][0]:
            return PriorDraws(draws.t, draws.noise, draws.posterior_noise)
        return draws.extra[name]

    def is_known_view_step(self, step: int) -> bool:
        """Under ``--image``, every ``known_view_interval``-th step."""
        return self.ref_images is not None and \
            step % self.cfg.known_view_interval == 0

    def run_step(self, state: TrainState, gen: torch.Generator):
        """One training step at state.step (a known-view step on its
        cadence), with the density-grid refresh on its cadence →
        (metrics, gradients)."""
        if self.needs_density_grid and \
                state.step % self.cfg.update_extra_interval == 0:
            self.update_grid(state, draw_grid(gen, self.cfg, self.device))
        if self.is_known_view_step(state.step):
            return self.known_view_step(state, self.draw_known_view(gen))
        return self.train_step(state, self.draw_step(gen))

    def init_state(self, seed: int) -> TrainState:
        cfg = self.cfg
        renderer = build_renderer(cfg)
        renderer.field.reset_parameters(torch.Generator().manual_seed(seed))
        renderer.to(self.device)
        self.optimizer = optimizer_for(cfg, renderer)
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
    def _volume_reg_losses(self, out, wsum, shape_bhw, step: int
                           ) -> torch.Tensor:
        """Opacity, ramped entropy, orient and the 3-D and 2-D
        normal-smoothness terms, in every step (known-view steps too)."""
        cfg = self.cfg
        B, H, W = shape_bhw
        loss = torch.zeros((), device=wsum.device)
        if cfg.lambda_opacity > 0:
            loss = loss + cfg.lambda_opacity * (wsum ** 2).mean()
        if cfg.lambda_entropy > 0:
            a = torch.clamp(out["weights"], 1e-5, 1 - 1e-5)
            ent = (-a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()
            loss = loss + schedules.lambda_entropy_at(cfg, step) * ent
        if "loss_orient" in out:
            loss = loss + cfg.lambda_orient * out["loss_orient"]
        if "loss_normal_perturb" in out:
            loss = loss + cfg.lambda_3d_normal_smooth * \
                out["loss_normal_perturb"]
        if cfg.lambda_2d_normal_smooth > 0 and "normal_image" in out:
            ni = out["normal_image"].reshape(B, H, W, 3)
            sm = ((ni[:, 1:] - ni[:, :-1]) ** 2).mean() + \
                ((ni[:, :, 1:] - ni[:, :, :-1]) ** 2).mean()
            loss = loss + cfg.lambda_2d_normal_smooth * sm
        return loss

    def _grid_reg_losses(self, state: TrainState, draws: StepDraws
                         ) -> Optional[torch.Tensor]:
        """The hash grid's tv (on the step's sampled cells) and weight-decay
        terms, or the triplane's tv, or None without them."""
        cfg, field = self.cfg, state.renderer.field
        if cfg.backbone == "triplane" and cfg.lambda_tv > 0:
            return schedules.lambda_tv_at(cfg, state.step) * \
                triplane_tv_loss(list(field.triplanes))
        if cfg.backbone != "grid":
            return None
        loss = None
        if cfg.lambda_tv > 0:
            loss = schedules.lambda_tv_at(cfg, state.step) * \
                hashgrid_tv_loss(draws.tv_cells, field.grid_table, field.spec)
        if cfg.lambda_wd > 0:
            wd = cfg.lambda_wd * hashgrid_wd_loss(field.grid_table,
                                                  field.spec)
            loss = wd if loss is None else loss + wd
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
        batch = train_batch(cfg, draws.pose, draws.fov, state.step, H, W)
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
        out = state.renderer.render(
            self.flags(latent_phase), ro, rd, self.occ_grid(state),
            light_d=light_d, ambient_ratio=ambient, shading=shading,
            bg_color=choices.bg_color.expand(ro.shape), max_level=max_level,
            march_u=draws.march_u, use_bg_net=use_bg_net,
            perturb_noise=draws.perturb_noise, pdf_u=draws.pdf_u)
        image = out["image"].reshape(B, H, W, 3)
        wsum = out["weights_sum"].reshape(B, H, W)
        reg = self._volume_reg_losses(out, wsum, (B, H, W), state.step)
        grid_reg = self._grid_reg_losses(state, draws)
        if grid_reg is not None:
            reg = reg + grid_reg
        if latent_phase:
            image = torch.cat([image, wsum[..., None]], dim=-1)
        return image, reg, batch, choices.bg_color

    def _text_sds(self, name: str, pred_rgb, batch, d: PriorDraws,
                  as_latent: bool) -> torch.Tensor:
        """SD's or IF's SDS with the uncond embedding tiled to the batch
        and the view-interpolated (or Perp-Neg) cond embeddings; IF renders
        no latent (``as_latent`` False, as JAX passes it)."""
        cfg = self.cfg
        g, emb = self.priors[name]
        B = pred_rgb.shape[0]
        uncond = emb["uncond"].expand(B, -1, -1)
        kw = dict(guidance_scale=cfg.guidance_scale,
                  as_latent=as_latent and name == "SD",
                  grad_scale=cfg.lambda_guidance)
        if cfg.perpneg:
            pn = adjust_text_embeddings(emb, batch.delta_azimuth,
                                        cfg.negative_w,
                                        cfg.front_decay_factor,
                                        cfg.side_decay_factor)
            return g.sds_loss_perpneg(pn.text_z, pn.weights, uncond,
                                      pred_rgb, d.t, d.noise,
                                      d.posterior_noise, **kw)
        cond = interpolate_view_embedding(emb, batch.delta_azimuth)
        return g.sds_loss(cond, uncond, pred_rgb, d.t, d.noise,
                          d.posterior_noise, **kw)

    def guidance_loss(self, pred_rgb, batch: CameraBatch, draws, bg,
                      as_latent: bool) -> torch.Tensor:
        """The priors' summed loss of the rendered views, in sorted name
        order, their gradient clamped first under ``--grad_clip_rgb``
        (K5)."""
        cfg = self.cfg
        if cfg.grad_clip_rgb >= 0:
            pred_rgb = clip_grad(pred_rgb, cfg.grad_clip_rgb)
        loss = None
        for name in self.priors:
            term = self.prior_loss(name, pred_rgb, batch, draws, bg,
                                   as_latent)
            loss = term if loss is None else loss + term
        return loss

    def prior_loss(self, name: str, pred_rgb, batch: CameraBatch, draws,
                   bg, as_latent: bool) -> torch.Tensor:
        """Prior `name`'s term: SD's or IF's SDS, zero123's, CLIP's
        weighted 10·(1 − |Δazimuth|/180)·lambda_guidance by the first
        view's azimuth, or an oracle's."""
        cfg = self.cfg
        g, emb = self.priors[name]
        if name == "clip":
            w = 10.0 * (1.0 - batch.delta_azimuth[0].abs() / 180.0) * \
                cfg.lambda_guidance
            return g.loss(emb, pred_rgb, w)
        d = self.prior_draws(draws, name)
        if name in ("SD", "IF"):
            return self._text_sds(name, pred_rgb, batch, d, as_latent)
        if name == "zero123":
            return g.sds_loss(
                emb, pred_rgb, batch.delta_polar, batch.delta_azimuth,
                batch.delta_radius, d.t, d.noise, d.posterior_noise,
                guidance_scale=cfg.guidance_scale, as_latent=as_latent,
                grad_scale=cfg.lambda_guidance)
        if as_latent:
            raise ValueError("the oracles need latent_iter_ratio 0")
        if name == "image_oracle":
            return g.sds_loss_rays_pose(
                d.t, d.noise, batch.rays_o, batch.rays_d, bg, pred_rgb,
                batch.delta_polar, batch.delta_azimuth, batch.delta_radius,
                grad_scale=cfg.lambda_guidance)
        return g.sds_loss_rays(d.t, d.noise, batch.rays_o, batch.rays_d, bg,
                               pred_rgb, grad_scale=cfg.lambda_guidance)

    def loss_fn(self, state: TrainState, draws: StepDraws):
        latent_phase = self.latent_phase(state.step)
        pred_rgb, reg, batch, bg = self.render_part(state, draws,
                                                    latent_phase)
        sds = self.guidance_loss(pred_rgb, batch, draws, bg, latent_phase)
        loss = sds + reg
        return loss, {"loss_reg": reg, "loss_sds": sds, "loss": loss}

    def apply_step(self, state, loss, metrics):
        """Backward of one step's loss, the guarded update in place →
        (metrics, gradients in ``self.module(state).parameters()``
        order)."""
        params = list(self.module(state).parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        metrics["grad_ok"] = apply_updates_guarded(self.optimizer, self.cfg,
                                                   state, grads)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, state: TrainState, draws: StepDraws):
        """One step (warm-up or main phase by ``state.step``); updates
        ``state`` in place → (metrics, gradients)."""
        return self.apply_step(state, *self.loss_fn(state, draws))

    # ------------------------------------------------------------------
    # the known-view step of --image
    def draw_known_view(self, gen: torch.Generator) -> KnownViewDraws:
        cfg = self.cfg
        U, N = _samplers(gen, self.device)
        K = self.ref_images.rgb.shape[0]
        R = self.kv_batch.rays_o.shape[1]
        sel = torch.randint(0, K, (), generator=gen, device=self.device)
        march_u, pdf_u = draw_march(U, cfg, R)
        draws = KnownViewDraws(sel, N(3), N(3), U(R, 3), march_u,
                               pdf_u=pdf_u)
        if cfg.lambda_3d_normal_smooth > 0:
            draws = draws._replace(perturb_noise=N(R * samples_per_ray(cfg),
                                                   3))
        return draws

    def known_view(self, sel: torch.Tensor):
        """Reference view ``sel`` ([] int64 on the device, not read on the
        host, which would wait for the stream) → (its reference images,
        its rays and mvp, each without the leading view axis)."""
        pick = lambda t: None if t is None else \
            torch.index_select(t, 0, sel.reshape(1))[0]
        return ({k: pick(v) for k, v in self.gt.items()},
                CameraBatch(*map(pick, self.kv_batch)))

    def known_view_loss(self, state: TrainState, draws: KnownViewDraws):
        """rgb, mask, Pearson-depth (and, with reference normals, normal)
        losses of a render of reference view ``draws.sel``, plus the volume
        regularizers."""
        cfg = self.cfg
        gt, kv = self.known_view(draws.sel)
        Hs, Ws = gt["rgb"].shape[:2]
        ro, rd = kv.rays_o, kv.rays_d
        if cfg.known_view_noise_scale > 0:
            # one camera shift for all rays, against grid artifacts
            ro = ro + draws.ro_noise * cfg.known_view_noise_scale
            rd = rd + draws.rd_noise * cfg.known_view_noise_scale
        r_exp = schedules.iter_ratio(state.step, cfg.exp_start_iter or 0,
                                     cfg.exp_end_iter or cfg.iters)
        flags = RenderFlags(
            perturb=True, need_loss_orient=cfg.lambda_orient > 0,
            need_normal_perturb=cfg.lambda_3d_normal_smooth > 0,
            need_normal_image=(cfg.lambda_normal > 0 and
                               gt["normal"] is not None)
            or cfg.lambda_2d_normal_smooth > 0)
        out = state.renderer.render(
            flags, ro.contiguous(), rd.contiguous(), self.occ_grid(state),
            light_d=safe_normalize(ro), ambient_ratio=1.0,
            shading=SHADING_LAMBERTIAN, bg_color=draws.bg,
            max_level=schedules.encoder_max_level(cfg, r_exp),
            march_u=draws.march_u, perturb_noise=draws.perturb_noise,
            pdf_u=draws.pdf_u)
        pred = out["image"].reshape(Hs, Ws, 3)
        if cfg.grad_clip_rgb >= 0:
            pred = clip_grad(pred, cfg.grad_clip_rgb)
        pred_mask = out["weights_sum"].reshape(Hs, Ws)
        m = gt["mask"].float()
        target = gt["rgb"] * m[..., None] + \
            draws.bg.reshape(Hs, Ws, 3) * (1 - m[..., None])
        loss = cfg.lambda_rgb * ((pred - target) ** 2).mean()
        loss = loss + cfg.lambda_mask * ((pred_mask - m) ** 2).mean()
        if gt["normal"] is not None and "normal_image" in out:
            pn = 2.0 * out["normal_image"].reshape(Hs, Ws, 3) - 1.0
            gn = 1.0 - 2.0 * gt["normal"]
            cos = (safe_normalize(pn) * safe_normalize(gn)).sum(-1)
            loss = loss + schedules.lambda_normal_at(cfg, state.step) * (
                1.0 - (cos * m).sum() / torch.clamp(m.sum(), min=1.0))
        if gt["depth"] is not None and cfg.lambda_depth > 0:
            pear = masked_pearson(out["depth"].reshape(Hs, Ws), gt["depth"],
                                  gt["mask"])
            loss = loss + schedules.lambda_depth_at(cfg, state.step) * (
                1.0 - pear)
        loss = loss + self._volume_reg_losses(out, pred_mask, (1, Hs, Ws),
                                              state.step)
        return loss, {"loss": loss,
                      "loss_sds": torch.zeros((), device=loss.device)}

    def known_view_step(self, state: TrainState, draws: KnownViewDraws):
        """One known-view step; updates ``state`` in place → (metrics,
        gradients)."""
        return self.apply_step(state, *self.known_view_loss(state, draws))

    @property
    def needs_density_grid(self) -> bool:
        """The grid and the triplane march an occupancy grid; the vanilla
        field samples the bounding sphere (JAX's ``needs_density_grid``)."""
        return self.cfg.backbone in ("grid", "triplane")

    def occ_grid(self, state) -> Optional[torch.Tensor]:
        """The occupancy grid a render marches, None under vanilla."""
        return state.occ_grid if self.needs_density_grid else None

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
        [H*W], alpha [H*W])."""
        cfg = self.cfg
        ro, rd = batch.rays_o[0], batch.rays_d[0]
        flags = RenderFlags(perturb=False, shading_static_albedo=True)
        outs = []
        for i in range(0, ro.shape[0], cfg.max_ray_batch):
            out = functional_call(
                state.renderer, state.ema_params,
                (flags, ro[i:i + cfg.max_ray_batch],
                 rd[i:i + cfg.max_ray_batch], self.occ_grid(state)),
                {"ambient_ratio": 1.0, "shading": SHADING_ALBEDO},
                strict=True)
            outs.append((out["image"], out["depth"], out["weights_sum"]))
        return tuple(torch.cat(o) for o in zip(*outs))

    @property
    def scene(self) -> str:
        """The analytic scene of the oracle priors (the pixel oracle's where
        both are built)."""
        return (self.priors.get("oracle") or self.priors["image_oracle"]
                )[0].scene

    def oracle_eval_metric(self, state) -> float:
        """PSNR of EMA renders of validation-circle views at h×w against
        the analytic scene (white background on both sides)."""
        cfg = self.cfg
        mses = []
        for i in range(min(cfg.dataset_size_valid, 4)):
            b = circle_view_batch(cfg, i, 4, cfg.h, cfg.w, self.device)
            img = self.render_view(state, b, cfg.h, cfg.w)[0]
            tgt, _ = scene_views(b.rays_o[0], b.rays_d[0], self.scene)
            mses.append(float(((img - tgt) ** 2).mean()))
        return float(-10.0 * math.log10(max(sum(mses) / len(mses), 1e-10)))

    def known_view_psnr(self, state) -> float:
        """Masked PSNR of EMA renders of the reference views (their own
        pose, the default FOV, ``known_view_scale`` times h×w) against the
        reference images."""
        ref, mses = self.ref_images, []
        Hs, Ws = ref.rgb.shape[1:3]
        for k in range(ref.rgb.shape[0]):
            b = default_view_batch(self.cfg, ref.radii[k:k + 1],
                                   ref.polars[k:k + 1],
                                   ref.azimuths[k:k + 1], self.cfg.h,
                                   self.cfg.w, self.device)
            pred = self.render_view(state, b, Hs, Ws)[0].reshape(Hs, Ws, 3)
            m = self.gt["mask"][k].float()[..., None]
            se = ((pred - self.gt["rgb"][k]) ** 2) * m
            mses.append(float(se.sum() / torch.clamp(m.sum() * 3, min=1.0)))
        return float(-10.0 * math.log10(max(sum(mses) / len(mses), 1e-10)))

    def set_clip_scorer(self, clip, clip_z: Dict[str, torch.Tensor]
                        ) -> None:
        """Score a text run's eval renders with CLIP (``clip_eval_metric``)
        against ``clip_z``'s text target (else its image target)."""
        self.clip_scorer = (clip, clip_z.get("text", clip_z.get("image")))

    @torch.no_grad()
    def clip_eval_metric(self, state) -> float:
        """100 × the mean CLIP cosine similarity of EMA renders of
        min(dataset_size_valid, 4) views of the validation circle at h×w
        against the scorer's target."""
        clip, target = self.clip_scorer
        cfg = self.cfg
        n = min(cfg.dataset_size_valid, 4)
        imgs = [self.render_view(state, circle_view_batch(
            cfg, i, n, cfg.h, cfg.w, self.device), cfg.h, cfg.w)[0]
            .reshape(cfg.h, cfg.w, 3) for i in range(n)]
        z = clip.get_img_embeds(torch.stack(imgs))
        return float((z * target).sum(-1).mean()) * 100.0

    def eval_metric(self, state) -> Optional[float]:
        """The known-view masked PSNR under ``--image``, the analytic PSNR
        under the oracle, the CLIP score of a text run with a scorer
        (``set_clip_scorer``); None otherwise."""
        if self.ref_images is not None:
            return self.known_view_psnr(state)
        if "oracle" in self.priors:
            return self.oracle_eval_metric(state)
        if self.clip_scorer is not None:
            return self.clip_eval_metric(state)
        return None

    # ------------------------------------------------------------------
    # the --save_guidance snapshot
    def _snapshot_render(self, state) -> torch.Tensor:
        """The default view (azimuth 0) at h×w as the eval renders it (the
        DMTet stage's through the rasterizer) → [h, w, 3]."""
        cfg = self.cfg
        b = circle_view_batch(cfg, 0, 4, cfg.h, cfg.w, self.device)
        return self.render_view(state, b, cfg.h, cfg.w)[0].reshape(
            cfg.h, cfg.w, 3)

    @torch.no_grad()
    def save_guidance_snapshot(
            self, state, draws: Optional[Dict[str, PriorDraws]] = None
    ) -> List[str]:
        """A triptych per prior with a ``guidance_eval`` (SD, IF and
        zero123 at zero pose deltas, each at ``guidance_scale``): the
        default view's render | the noised render | the one-step denoised
        x0, written to ``guidance/step_{step:06d}_{name}.png``.  ``draws``:
        each prior's at batch 1, else drawn from a generator seeded with the
        step → the paths."""
        cfg = self.cfg
        render = self._snapshot_render(state)[None]
        names = [n for n, (g, _) in self.priors.items()
                 if hasattr(g, "guidance_eval")]
        if draws is None:
            gen = torch.Generator(device=self.device).manual_seed(state.step)
            draws = draw_priors(gen, cfg, self.device, [
                sp for sp in self.noise_specs if sp[0] in names], B=1)
        rnd = render[0].float().cpu().numpy()
        gdir = os.path.join(self.workspace, "guidance")
        paths = []
        for name in names:
            g, emb = self.priors[name]
            d = draws[name]
            if name == "zero123":
                zero = torch.zeros(1, device=self.device)
                noisy, x0 = g.guidance_eval(
                    emb, render, zero, zero, zero, d.t, d.noise,
                    d.posterior_noise, guidance_scale=cfg.guidance_scale)
            else:
                noisy, x0 = g.guidance_eval(
                    emb["default"], emb["uncond"], render, d.t, d.noise,
                    d.posterior_noise, guidance_scale=cfg.guidance_scale)
            panels = [snapshot_panel(a[0].float().cpu().numpy(), cfg.h,
                                     cfg.w) for a in (noisy, x0)]
            path = os.path.join(gdir, f"step_{state.step:06d}_{name}.png")
            save_image(path, np.concatenate([rnd] + panels, axis=1))
            paths.append(path)
        return paths

    def _frame(self, state, batch: CameraBatch, view: str):
        """One eval/test view at H×W → (rgb [H,W,3], depth [H,W]) numpy.
        A rasterized view (the DMTet stage's) also gives K7's fullest tile,
        kept under the view's name in ``view_tiles``."""
        H, W = self.cfg.H, self.cfg.W
        img, depth, _, *tile = self.render_view(state, batch, H, W)
        if tile:
            self.view_tiles.append((view, tile[0]))
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
                cfg, i, n, cfg.H, cfg.W, self.device),
                f"eval step {state.step} view {i}")
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
            rgb, depth = self._frame(state, b, f"test view {i}")
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
        return {"module": self.module(state).state_dict(),
                "opt": state_tensors(state.opt_state),
                "ema": state.ema_params, "step": state.step,
                "extra": {k: getattr(state, k) for k in self.EXTRA_STATE}}

    @torch.no_grad()
    def _restore(self, state, payload: Dict[str, Any]) -> None:
        self.module(state).load_state_dict(payload["module"])
        for name, dst in state_tensors(state.opt_state).items():
            src = payload["opt"][name]
            if isinstance(dst, list):
                for d, v in zip(dst, src):
                    d.copy_(v)
            else:
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
