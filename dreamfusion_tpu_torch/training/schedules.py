"""Training schedules as functions of the step index
(``dreamfusion_tpu/training/schedules.py``).  The per-step shading choices
take their random numbers as arguments (``ChoiceDraws``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..models.nerf import (SHADING_ALBEDO, SHADING_LAMBERTIAN,
                           SHADING_TEXTURELESS)


def iter_ratio(step: int, start: int, end: int) -> float:
    return (step - start) / max(end - start, 1)


def progressive_view_ranges(cfg: Config, r_exp: float):
    """The pose ranges under ``--progressive_view``: each widens linearly
    from the default view to its full range, fully open from
    r = min(1, init_ratio + 2·r_exp) = 1 on → (radius, theta, phi, fovy)
    (lo, hi) pairs."""
    r = min(1.0, cfg.progressive_view_init_ratio + 2.0 * r_exp)

    def lerp_range(default, full):
        return (default * (1 - r) + full[0] * r,
                default * (1 - r) + full[1] * r)

    return (lerp_range(cfg.default_radius, cfg.radius_range),
            lerp_range(cfg.default_polar, cfg.theta_range),
            lerp_range(cfg.default_azimuth, cfg.phi_range),
            lerp_range(cfg.default_fovy, cfg.fovy_range))


def view_ranges(cfg: Config, r_exp: float):
    """The step's pose ranges: progressive, or the configured ones."""
    if cfg.progressive_view:
        return progressive_view_ranges(cfg, r_exp)
    return cfg.radius_range, cfg.theta_range, cfg.phi_range, cfg.fovy_range


def encoder_max_level(cfg: Config, r_exp: float) -> Optional[float]:
    """min(1, 0.25 + 2·r_exp) under progressive level training, in float32
    as the JAX step computes it from its float32 ratio: the encoders' band
    counts ceil(max_level·n) then agree with JAX's where the product lands
    on an integer."""
    if not cfg.progressive_level:
        return None
    r = np.float32(r_exp)
    return float(np.minimum(np.float32(1.0),
                            np.float32(0.25) + np.float32(2.0) * r))


def lambda_entropy_at(cfg: Config, step: int) -> float:
    return cfg.lambda_entropy * min(1.0, 2.0 * step / cfg.iters)


def lambda_normal_at(cfg: Config, step: int) -> float:
    return cfg.lambda_normal * min(1.0, step / cfg.iters)


def lambda_depth_at(cfg: Config, step: int) -> float:
    return cfg.lambda_depth * min(1.0, step / cfg.iters)


def lambda_tv_at(cfg: Config, step: int) -> float:
    return cfg.lambda_tv * min(1.0, step / (0.5 * cfg.iters))


class ChoiceDraws(NamedTuple):
    """Random numbers of one step's shading choices."""
    ambient_u: torch.Tensor     # [] uniform [0, 1)
    shading_u: torch.Tensor     # [] uniform [0, 1)
    bg_net_u: torch.Tensor      # [] uniform [0, 1)
    bg_color: torch.Tensor      # [3] uniform [0, 1)
    light_noise: torch.Tensor   # [3] standard normal


class StepChoices(NamedTuple):
    ambient_ratio: torch.Tensor  # []
    shading: torch.Tensor        # [] int shading id
    bg_color: torch.Tensor       # [3]
    use_bg_net: torch.Tensor     # [] bool
    light_noise: torch.Tensor    # [3]


def sample_step_choices(cfg: Config, draws: ChoiceDraws,
                        r_exp: float) -> StepChoices:
    in_albedo_phase = r_exp <= cfg.albedo_iter_ratio
    ambient = cfg.min_ambient_ratio + (1.0 - cfg.min_ambient_ratio) * \
        draws.ambient_u
    textureless = draws.shading_u >= (1.0 - cfg.textureless_ratio)
    shading = torch.where(textureless, SHADING_TEXTURELESS,
                          SHADING_LAMBERTIAN)
    if in_albedo_phase:
        ambient = torch.ones_like(ambient)
        shading = torch.full_like(shading, SHADING_ALBEDO)
    use_bg_net = (draws.bg_net_u > 0.5) & (cfg.bg_radius > 0)
    return StepChoices(ambient, shading, draws.bg_color, use_bg_net,
                       draws.light_noise)
