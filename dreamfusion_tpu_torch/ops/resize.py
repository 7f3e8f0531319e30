"""Bilinear resize as two interpolation matrix products
(``dreamfusion_tpu/ops/resize.py::resize_bilinear``).

Separable bilinear interpolation is ``A_h @ x @ A_wᵀ`` with [out, in]
weight matrices, rows normalised.  Two grids, as in JAX:
- half-pixel centres (the default), where shrinking widens the triangle
  kernel by the scale factor (antialias, as ``jax.image.resize``); with
  ``antialias=False`` the kernel keeps its two taps, as
  ``F.interpolate(mode="bilinear", align_corners=False)`` (DPT's
  pos-embed resize);
- ``align_corners=True``: output i samples input i·(n_in − 1)/(n_out −
  1), as ``F.interpolate(align_corners=True)`` (DPT's fusion and head
  upsamples), never antialiased.
Forward and backward are plain matrix products.  Each matrix is built
once per (shape, grid, device) and kept on that device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_out: int, n_in: int, antialias: bool = True
                   ) -> np.ndarray:
    inv_scale = n_in / n_out
    kw = max(1.0, inv_scale) if antialias else 1.0    # half-width, input px
    src = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    d = (np.arange(n_in)[None, :] - src[:, None]) / kw
    m = np.clip(1.0 - np.abs(d), 0.0, None).astype(np.float32)
    m /= m.sum(axis=1, keepdims=True)
    return m


@functools.lru_cache(maxsize=32)
def _interp_matrix_ac(n_out: int, n_in: int) -> np.ndarray:
    """The align_corners=True grid's [n_out, n_in] weights."""
    if n_out == 1 or n_in == 1:
        return np.full((n_out, n_in), 1.0 / n_in, dtype=np.float32)
    src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    d = np.arange(n_in)[None, :] - src[:, None]
    m = np.clip(1.0 - np.abs(d), 0.0, None).astype(np.float32)
    m /= m.sum(axis=1, keepdims=True)
    return m


@functools.lru_cache(maxsize=64)
def interp_matrix(n_out: int, n_in: int, device: torch.device,
                  align_corners: bool = False, antialias: bool = True
                  ) -> torch.Tensor:
    """The [n_out, n_in] fp32 weights on `device`, copied there once."""
    m = _interp_matrix_ac(n_out, n_in) if align_corners else \
        _interp_matrix(n_out, n_in, antialias)
    return torch.from_numpy(m).to(device)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False,
                    antialias: bool = True) -> torch.Tensor:
    """x [B, H, W, C] → [B, out_h, out_w, C] in x's dtype, fp32 inside."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x
    ah = interp_matrix(oh, H, x.device, align_corners, antialias)
    aw = interp_matrix(ow, W, x.device, align_corners, antialias)
    y = torch.einsum("oh,bhwc->bowc", ah, x.float())
    y = torch.einsum("pw,bowc->bopc", aw, y)
    return y.to(x.dtype)
