"""Analytic ground-truth scenes (``dreamfusion_tpu/evaluation/analytic.py``):
closed-form ray-traced views of simple procedural scenes."""

from __future__ import annotations

from typing import Tuple

import torch

SCENES = ("sphere", "two_sphere")


def scene_views(ro: torch.Tensor, rd: torch.Tensor, scene: str = "sphere"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays [N, 3] → (rgb [N, 3] in [0,1] on white, hit mask [N] bool)."""
    img, hit, _, _ = scene_views_full(ro, rd, scene)
    return img, hit


def scene_views_full(ro: torch.Tensor, rd: torch.Tensor,
                     scene: str = "sphere"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """``scene_views`` plus the geometry: (rgb [N,3], hit [N], depth [N] —
    the ray t along the unit direction, 0 where nothing is hit — and the
    unit surface normal [N,3], 0 where nothing is hit)."""
    if scene not in SCENES:
        raise ValueError(f"unknown analytic scene {scene!r}; one of {SCENES}")
    rdn = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if scene == "sphere":
        spheres = [((0.0, 0.0, 0.0), 0.5)]
    else:
        spheres = [((0.26, 0.0, 0.08), 0.36), ((-0.3, 0.0, -0.14), 0.24)]
    N = ro.shape[0]
    best_t = torch.full((N,), float("inf"), device=ro.device)
    hit = torch.zeros(N, dtype=torch.bool, device=ro.device)
    normal = torch.zeros_like(ro)
    p_hit = torch.zeros_like(ro)
    for center, rad in spheres:
        ctr = torch.tensor(center, dtype=ro.dtype, device=ro.device)
        oc = ro - ctr
        b = (oc * rdn).sum(-1)
        c = (oc * oc).sum(-1) - rad ** 2
        disc = b * b - c
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        h = (disc > 0) & (t > 0)
        closer = h & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        p = ro + rdn * t[:, None]
        normal = torch.where(closer[:, None], (p - ctr) / rad, normal)
        p_hit = torch.where(closer[:, None], p, p_hit)
        hit = hit | h
    if scene == "sphere":
        color = 0.5 + 0.5 * normal
    else:
        tex = (torch.sin(9.0 * p_hit[:, 0]) * torch.sin(7.0 * p_hit[:, 1])
               * torch.sin(8.0 * p_hit[:, 2]))
        color = torch.clamp(0.35 + 0.3 * normal + 0.3 * tex[:, None], 0.0, 1.0)
    return (torch.where(hit[:, None], color, 1.0), hit,
            torch.where(hit, best_t, 0.0),
            torch.where(hit[:, None], normal, 0.0))
