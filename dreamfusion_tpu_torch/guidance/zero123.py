"""Zero-1-to-3's pose weighting (``dreamfusion_tpu/guidance/zero123.py``,
:66-105): the angle between a novel view and the reference views, and the
SDS gradient scale it sets.  The image oracle (``guidance/oracle.py``)
weights its SDS with it; the zero123 tower itself is not ported yet
(ROADMAP queue 1: Zero-1-to-3 and the file-based image mode)."""

from __future__ import annotations

from typing import Tuple

import torch


def spherical_angle_between(v1: torch.Tensor, v2: torch.Tensor
                            ) -> torch.Tensor:
    """Angles (rad) between spherical coordinates [N, (r, theta, phi)] and
    [M, (r, theta, phi)], pairwise → [N, M]."""
    def to_cart(sv):
        r, th, ph = sv[..., 0], sv[..., 1], sv[..., 2]
        return torch.stack([r * torch.sin(th) * torch.cos(ph),
                            r * torch.sin(th) * torch.sin(ph),
                            r * torch.cos(th)], dim=-1)

    a, b = to_cart(v1), to_cart(v2)
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
    cos = torch.clamp((a[:, None, :] * b[None, :, :]).sum(-1), -1.0, 1.0)
    return torch.arccos(cos)


def pose_angle_grad_scale(ref_polars: torch.Tensor,
                          ref_azimuths: torch.Tensor,
                          ref_radii: torch.Tensor, polar: torch.Tensor,
                          azimuth: torch.Tensor, radius: torch.Tensor,
                          mode: str, grad_scale, B: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The views' deltas from the default view (degrees; [B]) against K
    reference views → (grad scale [B], angles to the references in
    degrees [B, K]).  Mode ``angle``: the smallest angle / (180 / K) times
    ``grad_scale`` (views far from every reference pull harder); any other
    mode: ones."""
    K = ref_polars.shape[0]
    v1 = torch.stack([radius + ref_radii[0],
                      torch.deg2rad(polar + ref_polars[0]),
                      torch.deg2rad(azimuth + ref_azimuths[0])], dim=-1)
    v2 = torch.stack([ref_radii, torch.deg2rad(ref_polars),
                      torch.deg2rad(ref_azimuths)], dim=-1)
    angles = torch.rad2deg(spherical_angle_between(v1, v2))      # [B, K]
    if mode == "angle":
        out = angles.min(dim=1).values / (180.0 / K) * grad_scale
    else:
        out = torch.ones(B, device=angles.device)
    return out, angles
