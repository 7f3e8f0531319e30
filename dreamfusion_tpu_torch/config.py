"""Experiment configuration for the port's slice.

A subset of ``dreamfusion_tpu/config.py``: every field here has the same
name and default as there (tests/test_torch_package.py checks it), and
only the fields the ported paths (the oracle, image-oracle, SD,
DeepFloyd-IF, CLIP and Zero-1-to-3 guidance on the hash-grid, triplane
and vanilla backbones, the run's end and the DMTet stage) read are
carried, and those JAX parses and never reads (``t5_iters``,
``test_interval``, ``hf_key``, ``vram_O``, ``learned_embeds_path``,
``ckpt_extra``, ``max_steps``, ``lambda_clip``, ``freq_multires``,
``freq_multires_bg``), so that every flag of its CLI parses here too.
``apply_O``, ``apply_O2``, ``apply_IF`` (``--IF``), ``apply_image_mode``
(``--image`` alone), ``apply_image_text_mode`` (``--image`` with
``--text``) and ``apply_dmtet`` are the presets, applied in that order
after the flags; ``finalize`` applies the fix-ups those paths need: the other grid backends' names mapped to ``grid``, the oracle preset
and the resolved exposure range.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # ---- workspace / run mode ----
    text: Optional[str] = None
    negative: str = ""
    workspace: str = "workspace"
    seed: Optional[int] = None
    test: bool = False
    six_views: bool = False
    eval_interval: int = 1
    test_interval: int = 100           # parsed, never read (as in JAX)
    save_interval: int = 1
    save_mesh: bool = False
    mcubes_resolution: int = 256
    decimate_target: int = 50000
    ckpt: str = "latest"
    ckpt_extra: Optional[str] = None   # parsed, never read (as in JAX)

    # ---- guidance ----
    guidance: Tuple[str, ...] = ("SD",)
    guidance_scale: float = 100.0
    sd_version: str = "2.1"
    # converted weights (``root/<tower>.npz``, ``utils/params.py``) and the
    # CLIP tokenizer's vocab.json + merges.txt; random weights without it
    pretrained_root: Optional[str] = None
    oracle_scene: str = "two_sphere"
    # the reference's hub token, low-VRAM switch and textual-inversion
    # embeddings: parsed, never read (as in JAX)
    hf_key: Optional[str] = None
    vram_O: bool = False
    learned_embeds_path: Optional[str] = None
    fp16: bool = True
    t_range: Tuple[float, float] = (0.02, 0.98)

    # ---- image-conditioned mode ----
    image: Optional[str] = None
    image_config: Optional[str] = None
    known_view_interval: int = 4
    known_view_scale: float = 1.5
    known_view_noise_scale: float = 2e-3
    dmtet_reso_scale: float = 8.0
    bg_radius: float = 1.4

    # ---- training ----
    iters: int = 10000
    lr: float = 1e-3
    update_extra_interval: int = 16
    num_steps: int = 64            # vanilla: coarse samples
    upsample_steps: int = 32       # vanilla: importance samples
    max_ray_batch: int = 4096
    latent_iter_ratio: float = 0.2
    albedo_iter_ratio: float = 0.0
    min_ambient_ratio: float = 0.1
    textureless_ratio: float = 0.2
    jitter_pose: bool = False
    jitter_center: float = 0.2
    jitter_target: float = 0.2
    jitter_up: float = 0.02
    uniform_sphere_rate: float = 0.0
    grad_clip: float = -1.0
    grad_clip_rgb: float = -1.0

    # ---- model / rendering ----
    backbone: str = "grid"
    optim: str = "adan"
    bound: float = 1.0
    dt_gamma: float = 0.0
    min_near: float = 0.01
    density_activation: str = "exp"
    density_thresh: float = 10.0
    blob_density: float = 5.0
    blob_radius: float = 0.2
    grid_size: int = 128
    max_steps: int = 1024              # parsed, never read (as in JAX)
    grid_coarse_steps: int = 32
    grid_fine_steps: int = 24
    occupancy_mode: str = "resample"

    # ---- network arch ----
    hidden_dim: int = 64
    num_layers: int = 3
    # the hash grid (``ops/hashgrid.py``); the field never reads
    # grid_base_resolution, as in the JAX package (its base is always 16)
    grid_levels: int = 4
    grid_features_per_level: int = 8
    grid_log2_hashmap_size: int = 19
    grid_base_resolution: int = 16
    grid_desired_resolution: int = 2048
    grid_interpolation: str = "smoothstep"     # linear | smoothstep
    grid_hash: str = "affine"                  # affine | xor
    triplane_resolution: int = 256
    triplane_channels: int = 16
    triplane_scales: int = 1
    normal_mode: str = "autograd"
    hidden_dim_bg: int = 32
    num_layers_bg: int = 2
    # parsed, never read: the vanilla field encodes at its own degrees
    # (ROADMAP queue 3, "The vanilla field's degree 12")
    freq_multires: int = 6
    freq_multires_bg: int = 4

    # ---- camera / dataset ----
    w: int = 64
    h: int = 64
    H: int = 800                       # eval and test render resolution
    W: int = 800
    dataset_size_train: int = 100
    dataset_size_valid: int = 8
    dataset_size_test: int = 100
    batch_size: int = 1
    radius_range: Tuple[float, float] = (3.0, 3.5)
    theta_range: Tuple[float, float] = (45.0, 105.0)
    phi_range: Tuple[float, float] = (-180.0, 180.0)
    fovy_range: Tuple[float, float] = (10.0, 30.0)
    default_radius: float = 3.2
    default_polar: float = 90.0
    default_azimuth: float = 0.0
    default_fovy: float = 20.0
    progressive_view: bool = False
    progressive_view_init_ratio: float = 0.2
    progressive_level: bool = False
    angle_overhead: float = 30.0
    angle_front: float = 60.0
    # the viewer's light for its lambertian and textureless modes (polar
    # and azimuth, degrees)
    light_theta: float = 60.0
    light_phi: float = 0.0
    t5_iters: int = -1                 # parsed, never read (as in JAX)
    dont_override_stuff: bool = False

    # ---- lambdas ----
    lambda_entropy: float = 1e-3
    lambda_opacity: float = 0.0
    lambda_orient: float = 1e-2
    lambda_tv: float = 0.0
    lambda_wd: float = 0.0
    lambda_mesh_normal: float = 0.5
    lambda_mesh_laplacian: float = 0.5
    lambda_guidance: float = 1.0
    lambda_rgb: float = 1000.0
    lambda_mask: float = 500.0
    lambda_normal: float = 0.0
    lambda_depth: float = 10.0
    lambda_2d_normal_smooth: float = 0.0
    lambda_3d_normal_smooth: float = 0.0
    lambda_clip: float = 1.0           # parsed, never read (as in JAX)

    # ---- Perp-Neg ----
    perpneg: bool = False
    negative_w: float = -2.0
    front_decay_factor: float = 2.0
    side_decay_factor: float = 10.0

    # ---- DMTet stage ----
    dmtet: bool = False
    tet_grid_size: int = 128
    init_with: str = ""
    lock_geo: bool = False

    # ---- zero123 (the image oracle uses its pose weighting) ----
    # the yaml and .ckpt of a raw zero123 checkpoint: stored, never read (as
    # in JAX; --pretrained_root takes the .ckpt)
    zero123_config: Optional[str] = None
    zero123_ckpt: Optional[str] = None
    zero123_grad_scale: str = "angle"     # angle | None

    # ---- misc ----
    ema_decay: float = 0.95
    # scalars under workspace/run through tensorboardX, where it imports
    use_tensorboard: bool = True
    max_keep_ckpt: int = 2
    # a text run's eval metric: the CLIP similarity of its eval renders
    # (``Trainer.set_clip_scorer``), so --ckpt best keeps the best snapshot
    clip_eval: bool = True
    # after an eval, every save_guidance_interval epochs: a triptych per
    # diffusion prior (render | noised | one-step denoised) under guidance/
    save_guidance: bool = False
    save_guidance_interval: int = 10
    exp_start_iter: Optional[int] = None
    exp_end_iter: Optional[int] = None

    @property
    def cascade(self) -> int:
        return 1 + max(0, int(math.ceil(math.log2(max(self.bound, 1.0)))))


def save_config_json(cfg: Config, path: str) -> None:
    """The run's Config as JSON (the viewer rebuilds a run's model from
    it)."""
    with open(path, "w") as f:
        json.dump(asdict(cfg), f, indent=1)


def load_config_json(path: str) -> Config:
    """A Config from a workspace's ``config.json`` (the port's, or the JAX
    package's: keys this Config lacks are left out, lists become
    tuples)."""
    with open(path) as f:
        raw = json.load(f)
    defaults = Config()
    kw = {}
    for k, v in raw.items():
        if not hasattr(defaults, k):
            continue
        kw[k] = tuple(v) if isinstance(getattr(defaults, k), tuple) and \
            isinstance(v, list) else v
    return Config(**kw)


def apply_O(cfg: Config) -> Config:
    """``-O``: fp16 and the hash-grid backbone."""
    return replace(cfg, fp16=True, backbone="grid")


def apply_O2(cfg: Config) -> Config:
    """``-O2``: fp16, the vanilla backbone and progressive level masking."""
    return replace(cfg, fp16=True, backbone="vanilla", progressive_level=True)


def apply_IF(cfg: Config) -> Config:
    """``--IF``: DeepFloyd-IF guidance in SD's place, and no warm-up phase
    (IF diffuses pixels: there is no latent to render as)."""
    guidance = tuple("IF" if g == "SD" else g for g in cfg.guidance)
    return replace(cfg, guidance=guidance, latent_iter_ratio=0.0)


def apply_image_mode(cfg: Config) -> Config:
    """Image-only conditioning (``--image`` without ``--text``): zero123
    guidance, unless an oracle guidance is named (``--guidance
    image_oracle`` with ``--image analytic:<scene>``, kept), and, unless
    ``--dont_override_stuff``, the image recipe: a fixed FOV, the 3-D
    normal-smoothness, entropy and orient weights, no warm-up, progressive
    view and level.  It overrides the command line's values."""
    gd = cfg.guidance if any("oracle" in g for g in cfg.guidance) \
        else ("zero123",)
    if cfg.dont_override_stuff:
        return replace(cfg, guidance=gd)
    return replace(
        cfg, guidance=gd, fovy_range=(cfg.default_fovy, cfg.default_fovy),
        guidance_scale=5.0, lambda_3d_normal_smooth=10.0, lambda_entropy=1.0,
        lambda_orient=1.0, latent_iter_ratio=0.0, progressive_view=True,
        progressive_level=True)


def apply_image_text_mode(cfg: Config) -> Config:
    """Image and text (``--image`` with ``--text``): SD + CLIP guidance and
    no background MLP, and, unless ``--dont_override_stuff``, the recipe's
    guidance scale, timestep range, known-view cadence and 3-D
    normal-smoothness weight."""
    out = replace(cfg, guidance=("SD", "clip"), bg_radius=-1.0)
    if cfg.dont_override_stuff:
        return out
    return replace(out, guidance_scale=10.0, t_range=(0.2, 0.6),
                   known_view_interval=2, lambda_3d_normal_smooth=20.0)


def apply_dmtet(cfg: Config) -> Config:
    """The DMTet refinement stage's overrides (``--dmtet``): training
    renders ``dmtet_reso_scale`` times larger and, unless
    ``--dont_override_stuff``, the lower half of the timestep range, no
    warm-up, albedo phase or progressive view, and under ``--image`` the
    known views at the render's own resolution."""
    h = int(cfg.h * cfg.dmtet_reso_scale)
    w = int(cfg.w * cfg.dmtet_reso_scale)
    out = replace(cfg, dmtet=True, h=h, w=w)
    if cfg.dont_override_stuff:
        return out
    out = replace(out, t_range=(0.02, 0.5), latent_iter_ratio=0.0,
                  albedo_iter_ratio=0.0, progressive_view=False)
    if cfg.image is not None:
        out = replace(out, known_view_scale=1.0)
    return out


def finalize(cfg: Config) -> Config:
    """Derived-value fix-ups applied once after all flags
    (``dreamfusion_tpu/config.py::finalize``)."""
    if cfg.backbone in ("grid_taichi", "grid_tcnn"):
        # the reference's other hash-grid backends are the one grid here
        cfg = replace(cfg, backbone="grid")
    if "oracle" in cfg.guidance or "image_oracle" in cfg.guidance:
        # pixel-space oracle: rgb from the first step, white eval
        # background, albedo-only shading draws (the analytic target has
        # no lighting model)
        cfg = replace(cfg, latent_iter_ratio=0.0, bg_radius=-1.0,
                      albedo_iter_ratio=1.0)
    exp_start = cfg.exp_start_iter if cfg.exp_start_iter is not None else 0
    exp_end = cfg.exp_end_iter if cfg.exp_end_iter is not None else cfg.iters
    return replace(cfg, exp_start_iter=exp_start, exp_end_iter=exp_end)
