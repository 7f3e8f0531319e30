"""Reference images of image-conditioned training
(``dreamfusion_tpu/training/image_data.py``): the PNG loader of ``--image
file.png`` and ``--image_config refs.csv`` (``load_ref_images``), the
analytic reference of ``--image analytic:<scene>`` and the masked Pearson
correlation of the known-view depth loss.

``load_ref_images`` reads ``*_rgba.png`` (alpha premultiplied, the mask
alpha > 0.5) and its ``*_depth.png`` and ``*_normal.png`` sidecars where
every reference has them, each resized to the known-view size by
``pil_bilinear_resize``: Pillow's ``BILINEAR`` resize of the uint8 image
(clipped and truncated to uint8 first, as JAX hands it to Pillow), which
the GPU host lacks, written out in numpy: the filter (triangle, or
Pillow's default ``BICUBIC`` with a = -0.5 in ``pil_resize_uint8``)
widened by the scale when it shrinks, fixed-point weights of 22 fractional
bits, the rows resized before the columns with a uint8 rounding and clip
between.
"""

from __future__ import annotations

import csv
import functools
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..evaluation.analytic import scene_views_full
from ..utils.image import load_image, to_rgba
from .data import default_view_batch

_PRECISION_BITS = 22        # Pillow's fixed-point weights for 8-bit images


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


def _triangle(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def _bicubic(x: float) -> float:
    """Pillow's ``bicubic_filter`` (a = -0.5)."""
    a, x = -0.5, abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# Pillow's filters: (function, support)
_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=32)
def _pil_weights(n_in: int, n_out: int,
                 resample: str = "bilinear") -> np.ndarray:
    """Pillow's fixed-point weights [n_out, n_in] (int64) of a filter:
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc``, sums in its
    order."""
    fn, support = _FILTERS[resample]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = support * filterscale
    out = np.zeros((n_out, n_in), np.int64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), n_in) - lo
        w = [fn((x + lo - center + 0.5) / filterscale) for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            v = v / total if total != 0.0 else v
            out[o, lo + x] = int(v * (1 << _PRECISION_BITS) +
                                 (0.5 if v >= 0 else -0.5))
    return out


def _pil_pass(x: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """One pass along `axis` of uint8 `x`, rounded and clipped to uint8."""
    acc = np.tensordot(w, x.astype(np.int64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_uint8(x: np.ndarray, H: int, W: int,
                     resample: str = "bicubic") -> np.ndarray:
    """uint8 [h, w] or [h, w, 3] → uint8 [H, W(, 3)], as Pillow's
    ``Image.fromarray(x).resize((W, H), resample)`` (its default filter,
    ``BICUBIC``, unless asked)."""
    h, w = x.shape[:2]
    if w != W:
        x = _pil_pass(x, _pil_weights(w, W, resample), 1)
    if h != H:
        x = _pil_pass(x, _pil_weights(h, H, resample), 0)
    return x


def pil_bilinear_resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Float [h, w] or [h, w, 3] → [H, W(, 3)] float32 in [0, 1], as
    ``Image.fromarray((clip(img, 0, 1) * 255).astype(uint8)).resize((W,
    H), BILINEAR)`` over 255 (JAX's ``_resize``).  Grey and RGB only:
    Pillow resizes RGBA premultiplied, which no reference needs."""
    if img.ndim == 3 and img.shape[-1] not in (1, 3):
        raise ValueError(f"grey or RGB images only, got {img.shape}")
    x = pil_resize_uint8((np.clip(img, 0, 1) * 255).astype(np.uint8), H, W,
                         "bilinear")
    return x.astype(np.float32) / 255.0


def parse_image_config(path: str) -> List[dict]:
    """A CSV with columns image, polar, azimuth, radius, zero123_weight (in
    any order; spaces after the commas and in the header are stripped, as
    in ``config/example.csv``) → one dict a row."""
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f, skipinitialspace=True):
            rows.append({k.strip(): (v.strip() if isinstance(v, str) else v)
                         for k, v in row.items() if k is not None})
    return rows


def load_ref_images(cfg: Config, H: int, W: int) -> RefImages:
    """The reference images at the known-view size (``known_view_scale``
    times H×W): ``--image_config``'s rows with their poses and zero123
    weights, else ``--image`` at the default pose with weight 1; depth and
    normals where every reference has its sidecar."""
    Hs = int(cfg.known_view_scale * H)
    Ws = int(cfg.known_view_scale * W)
    if cfg.image_config:
        rows = parse_image_config(cfg.image_config)
        paths = [r["image"] for r in rows]
        polars = tuple(float(r.get("polar", 90.0)) for r in rows)
        azimuths = tuple(float(r.get("azimuth", 0.0)) for r in rows)
        radii = tuple(float(r.get("radius", 3.2)) for r in rows)
        weights = tuple(float(r.get("zero123_weight", 1.0)) for r in rows)
    else:
        if cfg.image is None:
            raise ValueError("no reference image: --image or --image_config")
        paths = [cfg.image]
        polars, azimuths = (cfg.default_polar,), (cfg.default_azimuth,)
        radii, weights = (cfg.default_radius,), (1.0,)
    rgbs, masks, depths, normals = [], [], [], []
    have_depth = have_normal = True
    for p in paths:
        rgba = to_rgba(load_image(p))   # grey, LA and RGB too: alpha 1
        mask = rgba[..., 3] > 0.5
        rgb = rgba[..., :3] * rgba[..., 3:4]
        rgbs.append(pil_bilinear_resize(rgb, Hs, Ws))
        masks.append(pil_bilinear_resize(mask.astype(np.float32), Hs, Ws)
                     > 0.5)
        dp = p.replace("_rgba", "_depth")
        if dp != p and os.path.exists(dp):
            d = load_image(dp)
            depths.append(pil_bilinear_resize(d[..., 0] if d.ndim == 3
                                              else d, Hs, Ws))
        else:
            have_depth = False
        npth = p.replace("_rgba", "_normal")
        if npth != p and os.path.exists(npth):
            normals.append(pil_bilinear_resize(
                to_rgba(load_image(npth))[..., :3], Hs, Ws))
        else:
            have_normal = False
    return RefImages(
        rgb=np.stack(rgbs), mask=np.stack(masks),
        depth=np.stack(depths) if have_depth and depths else None,
        normal=np.stack(normals) if have_normal and normals else None,
        polars=polars, azimuths=azimuths, radii=radii, weights=weights)


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
