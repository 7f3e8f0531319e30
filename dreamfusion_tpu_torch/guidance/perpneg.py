"""Perp-Neg aggregation and view-dependent prompt embeddings
(``dreamfusion_tpu/guidance/perpneg.py``), vectorised over the batch."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


def weighted_perpendicular_aggregator(delta_noise_preds: torch.Tensor,
                                      weights: torch.Tensor,
                                      batch_size: int) -> torch.Tensor:
    """Main positive delta plus the weighted components of the K-1
    negative deltas perpendicular to it.  delta [B*K, ...] (K groups
    interleaved by B), weights [B*K] → [B, ...]."""
    B = batch_size
    K = delta_noise_preds.shape[0] // B
    d = delta_noise_preds.reshape(K, B, *delta_noise_preds.shape[1:])
    w = weights.reshape(K, B)
    main = d[0]
    axes = tuple(range(1, main.ndim))
    bshape = (B,) + (1,) * (main.ndim - 1)
    ynorm2 = torch.clamp((main * main).sum(dim=axes), min=1e-6)
    acc = torch.zeros_like(main)
    for i in range(1, K):
        x = d[i]
        dot = (x * main).sum(dim=axes)
        perp = x - (dot / ynorm2).reshape(bshape) * main
        wi = torch.where(w[i].abs() > 1e-4, w[i], torch.zeros_like(w[i]))
        acc = acc + wi.reshape(bshape) * perp
    return acc + main


class PerpNegEmbeds(NamedTuple):
    text_z: torch.Tensor    # [B*K, L, D], K = 3, interleaved by batch
    weights: torch.Tensor   # [B*K]


def _view_ratio(az: torch.Tensor):
    in_front = (az >= -90) & (az < 90)
    r = torch.where(in_front, 1.0 - az.abs() / 90.0,
                    1.0 - (az.abs() - 90.0) / 90.0)
    return in_front, r


def adjust_text_embeddings(embeddings: Dict[str, torch.Tensor],
                           azimuth_deg: torch.Tensor,
                           negative_w: float = -2.0,
                           front_decay_factor: float = 2.0,
                           side_decay_factor: float = 10.0) -> PerpNegEmbeds:
    """Per-view positive embedding plus two decayed negatives
    ([pos, neg1, neg2]); embeddings 'front'/'side'/'back' [1, L, D]."""
    front, side, back = (embeddings[k][0] for k in ("front", "side", "back"))
    in_front, r = _view_ratio(azimuth_deg)
    f3 = in_front[:, None, None]
    rb = r[:, None, None]
    pos = torch.where(f3, rb * front + (1 - rb) * side,
                      rb * side + (1 - rb) * back)
    neg1 = torch.where(f3, front, side)
    neg2 = torch.where(f3, side, front)
    zero = torch.zeros_like(r)
    front_w_f = torch.where(r > 0.8, zero,
                            torch.exp(-r * front_decay_factor) * negative_w)
    side_w_f = torch.where(r < 0.2, zero, torch.exp(
        -(1 - r) * side_decay_factor) * negative_w)
    side_w_b = torch.where(r > 0.8, zero, torch.exp(
        -r * side_decay_factor) * negative_w / 2)
    front_w_b = torch.full_like(r, negative_w)
    w1 = torch.where(in_front, front_w_f, side_w_b)
    w2 = torch.where(in_front, side_w_f, front_w_b)
    return PerpNegEmbeds(torch.cat([pos, neg1, neg2], dim=0),
                         torch.cat([torch.ones_like(r), w1, w2], dim=0))


def interpolate_view_embedding(embeddings: Dict[str, torch.Tensor],
                               azimuth_deg: torch.Tensor) -> torch.Tensor:
    """Lerp front↔side for |az| < 90, side↔back beyond → [B, L, D]."""
    front, side, back = (embeddings[k][0] for k in ("front", "side", "back"))
    in_front, r = _view_ratio(azimuth_deg)
    rb = r[:, None, None]
    return torch.where(in_front[:, None, None], rb * front + (1 - rb) * side,
                       rb * side + (1 - rb) * back)
