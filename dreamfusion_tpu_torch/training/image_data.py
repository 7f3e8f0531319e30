"""Reference images of image-conditioned training
(``dreamfusion_tpu/training/image_data.py``): the analytic reference of
``--image analytic:<scene>`` and the masked Pearson correlation of the
known-view depth loss.  The PNG loader (``--image file.png``,
``--image_config``) is not ported yet (ROADMAP queue 1: Zero-1-to-3 and
the file-based image mode)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..evaluation.analytic import scene_views_full
from .data import default_view_batch


@dataclass
class RefImages:
    rgb: np.ndarray                     # [K, H, W, 3] float32, premasked
    mask: np.ndarray                    # [K, H, W] bool
    depth: Optional[np.ndarray]         # [K, H, W] float32 or None
    normal: Optional[np.ndarray]        # [K, H, W, 3] float32 or None
    polars: Tuple[float, ...] = (90.0,)
    azimuths: Tuple[float, ...] = (0.0,)
    radii: Tuple[float, ...] = (3.2,)
    weights: Tuple[float, ...] = (1.0,)


def masked_pearson(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of pred and gt over the mask's pixels []."""
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mp, mg = (pred * m).sum() / n, (gt * m).sum() / n
    vp, vg = pred - mp, gt - mg
    cov = (vp * vg * m).sum() / n
    sp = torch.sqrt((vp * vp * m).sum() / n + 1e-8)
    sg = torch.sqrt((vg * vg * m).sum() / n + 1e-8)
    return cov / (sp * sg + 1e-8)


def analytic_ref_images(cfg: Config, H: int, W: int,
                        scene: str = "two_sphere") -> RefImages:
    """The analytic scene from the default view at ``known_view_scale``
    times H×W: rgb premasked (black outside the silhouette), the hit mask
    and the ray-t depth (the depth loss is a correlation, so ray t serves);
    no normals.  Floats as rendered, without the PNG loader's uint8
    rounding."""
    polars, azimuths = (cfg.default_polar,), (cfg.default_azimuth,)
    radii = (cfg.default_radius,)
    batch = default_view_batch(cfg, radii, polars, azimuths, H, W)
    Hs, Ws = int(cfg.known_view_scale * H), int(cfg.known_view_scale * W)
    rgb, hit, depth, _ = scene_views_full(batch.rays_o.reshape(-1, 3),
                                          batch.rays_d.reshape(-1, 3), scene)
    rgb = (rgb * hit[:, None].float()).numpy()
    return RefImages(
        rgb=rgb.reshape(1, Hs, Ws, 3).astype(np.float32),
        mask=hit.numpy().reshape(1, Hs, Ws),
        depth=depth.numpy().reshape(1, Hs, Ws).astype(np.float32),
        normal=None, polars=polars, azimuths=azimuths, radii=radii,
        weights=(1.0,))
