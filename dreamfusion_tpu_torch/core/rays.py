"""Pinhole ray generation (``dreamfusion_tpu/core/rays.py``).

OpenGL-style camera: it looks down local -z, +x right, +y up; ray
directions are rotated to world space and deliberately not normalized.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates i (column) and j (row), each [H*W]."""
    j, i = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return i.reshape(-1) + 0.5, j.reshape(-1) + 0.5


def get_rays(poses: torch.Tensor, intrinsics: torch.Tensor, H: int, W: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """poses [B,4,4] cam2world, intrinsics [4] = fx, fy, cx, cy →
    (rays_o, rays_d), each [B, H*W, 3]."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    i, j = pixel_grid(H, W, dtype=poses.dtype, device=poses.device)
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)                                  # [HW, 3]
    rays_d = torch.einsum("nk,bjk->bnj", dirs, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def intrinsics_from_fov(fovy_deg: torch.Tensor, H: int, W: int
                        ) -> torch.Tensor:
    """[fx, fy, cx, cy] from a vertical FOV in degrees."""
    focal = H / (2.0 * torch.tan(torch.deg2rad(fovy_deg) / 2.0))
    return torch.stack([focal, focal, torch.full_like(focal, W / 2.0),
                        torch.full_like(focal, H / 2.0)])


def projection_matrix(focal: torch.Tensor, H: int, W: int, near: float,
                      far: float) -> torch.Tensor:
    """OpenGL clip-space projection of the DMTet rasterization path, [4, 4]
    (its y row negated, as the JAX package's)."""
    P = torch.zeros(4, 4, dtype=torch.float32, device=focal.device)
    P[0, 0] = 2 * focal / W
    P[1, 1] = -2 * focal / H
    P[2, 2] = -(far + near) / (far - near)
    P[2, 3] = -(2 * far * near) / (far - near)
    P[3, 2] = -1.0
    return P


def mvp_from_pose(poses: torch.Tensor, projection: torch.Tensor
                  ) -> torch.Tensor:
    """projection @ world2cam, with the closed-form rigid inverse:
    poses [B,4,4] cam2world, projection [4,4] or [B,4,4] → [B,4,4]."""
    Rt = poses[:, :3, :3].transpose(-1, -2)
    w2c = torch.zeros_like(poses)
    w2c[:, :3, :3] = Rt
    w2c[:, :3, 3] = -torch.einsum("bij,bj->bi", Rt, poses[:, :3, 3])
    w2c[:, 3, 3] = 1.0
    if projection.ndim == 2:
        projection = projection[None]
    return torch.einsum("bij,bjk->bik", projection, w2c)
