"""Frequency (positional) encoding (``dreamfusion_tpu/ops/freq.py``), with
progressive band masking and the encoding's closed-form jacobian."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch


def freq_encode_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def active_count(max_level: Optional[float], n: int) -> int:
    """``ceil(max_level · n)`` in float32, as the JAX package computes it
    from its traced float32 ``max_level`` (a product that lands on an
    integer in float32 keeps that many; in float64 it may keep one more)."""
    if max_level is None:
        return n
    return int(math.ceil(np.float32(max_level) * np.float32(n)))


def freq_encode(x: torch.Tensor, degree: int,
                max_level: Optional[float] = None, need_jacobian: bool = False,
                unit: float = 1.0
                ) -> torch.Tensor | Tuple[torch.Tensor, List[torch.Tensor]]:
    """x [..., D] → [x, sin(2^0 x), cos(2^0 x), ..., cos(2^(deg-1) x)],
    [..., D*(1+2*degree)], bands ordered (degree, sin|cos, D).  Bands at
    or above ``ceil(max_level·degree)`` are zero.

    With ``need_jacobian`` (D = 3) also the encoding's derivative along
    each axis a, [..., D*(1+2*degree)] each: band (i, sin|cos, d) depends
    on x_d alone, so along a it is 2^i cos(2^i x_a) | -2^i sin(2^i x_a) at
    d = a and 0 elsewhere (1 at the input's own column a); the masked
    bands' derivatives are zero too.  `unit` is the length of x that one
    unit of the differentiation coordinate spans: each derivative is
    multiplied by it (a field over [-b, b] passes 2b, so that its jacobian
    is along u = (x + b) / (2b), as the grid's and the triplane's are)."""
    freqs = torch.tensor([2.0 ** i for i in range(degree)], dtype=x.dtype,
                         device=x.device)
    xb = x[..., None, :] * freqs[:, None]                 # [..., deg, D]
    s, c = torch.sin(xb), torch.cos(xb)
    keep = None
    if max_level is not None:
        n = active_count(max_level, degree)
        keep = (torch.arange(degree, device=x.device) < n).to(x.dtype)
        s, c = s * keep[:, None], c * keep[:, None]
    lead = x.shape[:-1]
    enc = torch.cat([x, torch.stack([s, c], dim=-2).reshape(*lead, -1)],
                    dim=-1)
    if not need_jacobian:
        return enc
    D = x.shape[-1]
    scale = (freqs if keep is None else freqs * keep) * unit
    ds, dc = c * scale[:, None], -s * scale[:, None]      # d/dx_d, [deg, D]
    jac = []
    for a in range(D):
        onehot = torch.zeros(D, dtype=x.dtype, device=x.device)
        onehot[a] = 1.0
        band = torch.stack([ds * onehot, dc * onehot], dim=-2)
        jac.append(torch.cat([(onehot * unit).expand(*lead, D),
                              band.reshape(*lead, -1)], dim=-1))
    return enc, jac
