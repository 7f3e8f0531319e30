"""Bilinear resize as two interpolation matrix products
(``dreamfusion_tpu/ops/resize.py::resize_bilinear``).

Separable bilinear interpolation is ``A_h @ x @ A_wᵀ`` with [out, in]
weight matrices: half-pixel centres, rows normalised and, when shrinking,
the triangle kernel widened by the scale factor (antialias, as
``jax.image.resize``).  Forward and backward are plain matrix products.
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


def resize_bilinear(x: torch.Tensor, out_hw, antialias: bool = True
                    ) -> torch.Tensor:
    """x [B, H, W, C] → [B, out_h, out_w, C] in x's dtype, fp32 inside."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x
    ah = torch.from_numpy(_interp_matrix(oh, H, antialias)).to(x.device)
    aw = torch.from_numpy(_interp_matrix(ow, W, antialias)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", ah, x.float())
    y = torch.einsum("pw,bowc->bopc", aw, y)
    return y.to(x.dtype)
