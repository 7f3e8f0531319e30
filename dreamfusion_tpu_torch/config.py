"""Experiment configuration for the port's slice.

A subset of ``dreamfusion_tpu/config.py``: every field here has the same
name and default as there (tests/test_torch_package.py checks it), and
only the fields the ported paths (the oracle and SD 2.1 guidance on the
triplane backbone, the run's end and the DMTet stage) read are carried.
``apply_dmtet`` is the ``--dmtet`` preset; ``finalize`` applies the fix-ups
those paths need: the oracle preset and the resolved exposure range.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
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
    save_interval: int = 1
    save_mesh: bool = False
    mcubes_resolution: int = 256
    decimate_target: int = 50000
    ckpt: str = "latest"

    # ---- guidance ----
    guidance: Tuple[str, ...] = ("SD",)
    guidance_scale: float = 100.0
    sd_version: str = "2.1"
    oracle_scene: str = "two_sphere"
    fp16: bool = True
    t_range: Tuple[float, float] = (0.02, 0.98)
    image: Optional[str] = None
    dmtet_reso_scale: float = 8.0
    bg_radius: float = 1.4

    # ---- training ----
    iters: int = 10000
    lr: float = 1e-3
    update_extra_interval: int = 16
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
    grid_coarse_steps: int = 32
    grid_fine_steps: int = 24
    occupancy_mode: str = "resample"

    # ---- network arch ----
    hidden_dim: int = 64
    num_layers: int = 3
    triplane_resolution: int = 256
    triplane_channels: int = 16
    triplane_scales: int = 1
    normal_mode: str = "autograd"
    hidden_dim_bg: int = 32
    num_layers_bg: int = 2

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
    progressive_level: bool = False
    angle_overhead: float = 30.0
    angle_front: float = 60.0

    # ---- lambdas ----
    lambda_entropy: float = 1e-3
    lambda_opacity: float = 0.0
    lambda_orient: float = 1e-2
    lambda_tv: float = 0.0
    lambda_wd: float = 0.0
    lambda_mesh_normal: float = 0.5
    lambda_mesh_laplacian: float = 0.5
    lambda_guidance: float = 1.0
    lambda_normal: float = 0.0
    lambda_2d_normal_smooth: float = 0.0
    lambda_3d_normal_smooth: float = 0.0

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

    # ---- misc ----
    ema_decay: float = 0.95
    max_keep_ckpt: int = 2
    exp_start_iter: Optional[int] = None
    exp_end_iter: Optional[int] = None

    @property
    def cascade(self) -> int:
        return 1 + max(0, int(math.ceil(math.log2(max(self.bound, 1.0)))))


def apply_dmtet(cfg: Config) -> Config:
    """The DMTet refinement stage's overrides (``--dmtet``): training
    renders ``dmtet_reso_scale`` times larger, the lower half of the
    timestep range, no warm-up or albedo phase."""
    h = int(cfg.h * cfg.dmtet_reso_scale)
    w = int(cfg.w * cfg.dmtet_reso_scale)
    return replace(cfg, dmtet=True, h=h, w=w, t_range=(0.02, 0.5),
                   latent_iter_ratio=0.0, albedo_iter_ratio=0.0,
                   progressive_view=False)


def finalize(cfg: Config) -> Config:
    """Derived-value fix-ups applied once after all flags
    (``dreamfusion_tpu/config.py::finalize``)."""
    if "oracle" in cfg.guidance or "image_oracle" in cfg.guidance:
        # pixel-space oracle: rgb from the first step, white eval
        # background, albedo-only shading draws (the analytic target has
        # no lighting model)
        cfg = replace(cfg, latent_iter_ratio=0.0, bg_radius=-1.0,
                      albedo_iter_ratio=1.0)
    exp_start = cfg.exp_start_iter if cfg.exp_start_iter is not None else 0
    exp_end = cfg.exp_end_iter if cfg.exp_end_iter is not None else cfg.iters
    return replace(cfg, exp_start_iter=exp_start, exp_end_iter=exp_end)
