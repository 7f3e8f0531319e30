"""Synthetic camera batches (``dreamfusion_tpu/training/data.py``).

A batch is a pure function of pre-drawn random numbers: there is no
dataloader.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..core.poses import PoseDraws, circle_poses, rand_poses
from ..core.rays import (get_rays, intrinsics_from_fov, mvp_from_pose,
                         projection_matrix)

FAR = 1000.0


class CameraBatch(NamedTuple):
    rays_o: torch.Tensor         # [B, H*W, 3]
    rays_d: torch.Tensor         # [B, H*W, 3]
    mvp: torch.Tensor            # [B, 4, 4]
    dirs: torch.Tensor           # [B] int32 view bins
    delta_polar: torch.Tensor    # [B]
    delta_azimuth: torch.Tensor  # [B] in [-180, 180]
    delta_radius: torch.Tensor   # [B]


def _batch_from_poses(cfg: Config, poses, dirs, thetas, phis, radius, fov,
                      H: int, W: int) -> CameraBatch:
    intr = intrinsics_from_fov(fov, H, W)
    proj = projection_matrix(intr[0], H, W, cfg.min_near, FAR)
    mvp = mvp_from_pose(poses, proj)
    rays_o, rays_d = get_rays(poses, intr, H, W)
    delta_polar = thetas - cfg.default_polar
    delta_azimuth = phis - cfg.default_azimuth
    delta_azimuth = torch.where(delta_azimuth > 180, delta_azimuth - 360,
                                delta_azimuth)
    delta_radius = radius - cfg.default_radius
    return CameraBatch(rays_o, rays_d, mvp, dirs, delta_polar, delta_azimuth,
                       delta_radius)


def sample_train_batch(pose: PoseDraws, fov: torch.Tensor, cfg: Config,
                       H: int, W: int) -> CameraBatch:
    """Random training views from pose draws and a drawn vertical FOV
    (degrees)."""
    pb = rand_poses(
        pose, angle_overhead=cfg.angle_overhead, angle_front=cfg.angle_front,
        uniform_sphere_rate=cfg.uniform_sphere_rate,
        jitter_pose=cfg.jitter_pose, jitter_center=cfg.jitter_center,
        jitter_target=cfg.jitter_target, jitter_up=cfg.jitter_up)
    return _batch_from_poses(cfg, pb.poses, pb.dirs, pb.thetas, pb.phis,
                             pb.radius, fov, H, W)


def fixed_view_batch(cfg: Config, theta: float, phi: float, H: int, W: int,
                     device=None) -> CameraBatch:
    """The orbit view at polar ``theta`` and azimuth ``phi`` (degrees), the
    default radius and FOV."""
    t = lambda v: torch.tensor([v], dtype=torch.float32, device=device)
    poses, dirs = circle_poses(t(cfg.default_radius), t(theta), t(phi),
                               angle_overhead=cfg.angle_overhead,
                               angle_front=cfg.angle_front)
    return _batch_from_poses(
        cfg, poses, dirs, t(theta), t(phi), t(cfg.default_radius),
        torch.tensor(cfg.default_fovy, dtype=torch.float32, device=device),
        H, W)


def circle_view_batch(cfg: Config, index: int, size: int, H: int, W: int,
                      device=None) -> CameraBatch:
    """Deterministic turntable view for eval and test."""
    return fixed_view_batch(cfg, cfg.default_polar, (index / size) * 360.0,
                            H, W, device)


SIX_VIEW_THETAS = (90.0, 90.0, 90.0, 90.0, 1e-3, 179.999)
SIX_VIEW_PHIS = (0.0, 90.0, 180.0, -90.0, 0.0, 0.0)


def six_view_batch(cfg: Config, index: int, H: int, W: int,
                   device=None) -> CameraBatch:
    """Axis-aligned views: front, sides, back, top, bottom."""
    return fixed_view_batch(cfg, SIX_VIEW_THETAS[index], SIX_VIEW_PHIS[index],
                            H, W, device)
