"""Frequency (positional) encoding (``dreamfusion_tpu/ops/freq.py``)."""

from __future__ import annotations

import torch


def freq_encode_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """x [..., D] → [x, sin(2^0 x), cos(2^0 x), ..., cos(2^(deg-1) x)],
    [..., D*(1+2*degree)], bands ordered (degree, sin|cos, D)."""
    freqs = torch.tensor([2.0 ** i for i in range(degree)], dtype=x.dtype,
                         device=x.device)
    xb = x[..., None, :] * freqs[:, None]                 # [..., deg, D]
    bands = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, bands.reshape(*x.shape[:-1], -1)], dim=-1)
