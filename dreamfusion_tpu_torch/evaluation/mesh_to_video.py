"""Turntable video of an exported OBJ mesh
(``dreamfusion_tpu/evaluation/mesh_to_video.py``).

The mesh is rendered through K7 (``ops/raster.py``: ``rasterize`` with
hard edges, and ``interpolate`` of the texture coordinates), the camera
orbiting the object: the albedo texture sampled bilinearly (0.7 grey
without one) under two-sided Lambert shading from the camera, on white.
One ``raster_fwd`` a frame, and one ``interpolate_fwd`` where the mesh is
textured.  On the card unless ``--device cpu``.

    python -m dreamfusion_tpu_torch.evaluation.mesh_to_video \\
        --mesh ws/mesh/mesh.obj --out turntable.mp4 --frames 60 --size 512
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

import numpy as np
import torch

from ..core.math import safe_normalize
from ..core.poses import circle_poses
from ..core.rays import mvp_from_pose, projection_matrix
from ..mesh.export import read_obj
from ..ops.raster import interpolate, project_verts, rasterize
from ..utils.device import resolve_device
from ..utils.image import load_image, save_video


@torch.no_grad()
def render_turntable(verts: np.ndarray, tris: np.ndarray,
                     uv: Optional[np.ndarray], texture: Optional[np.ndarray],
                     frames: int = 60, size: int = 512, radius: float = 3.2,
                     elevation_deg: float = 75.0, fovy_deg: float = 40.0,
                     device="cuda") -> List[np.ndarray]:
    """`frames` views at azimuths i / frames · 360° → [size, size, 3]
    float32 frames in [0, 1]."""
    dev = resolve_device(device)
    H = W = size
    v = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    f = torch.as_tensor(tris, dtype=torch.int32, device=dev)
    fmask = torch.ones(len(tris), dtype=torch.bool, device=dev)
    textured = texture is not None and uv is not None
    if textured:
        tex = torch.as_tensor(texture, dtype=torch.float32, device=dev)
        uvt = torch.as_tensor(uv, dtype=torch.float32, device=dev)
    focal = torch.tensor(H / (2 * math.tan(math.radians(fovy_deg) / 2)),
                         dtype=torch.float32, device=dev)
    proj = projection_matrix(focal, H, W, 0.01, 100.0)
    fl = f.long()
    fn = torch.cross(v[fl[:, 1]] - v[fl[:, 0]], v[fl[:, 2]] - v[fl[:, 0]],
                     dim=-1)
    fn = fn * torch.rsqrt(torch.clamp((fn * fn).sum(-1, keepdim=True),
                                      min=1e-20))
    tile_cap = min(2048, max(64, len(tris)))
    out_frames = []
    for i in range(frames):
        poses, _ = circle_poses(
            torch.tensor([radius], device=dev),
            torch.tensor([elevation_deg], device=dev),
            torch.tensor([i / frames * 360.0], device=dev))
        mvp = mvp_from_pose(poses, proj)[0]
        out = rasterize(project_verts(v, mvp), f, fmask, H, W, tile=32,
                        tile_cap=tile_cap, soft_edge_px=0.0)
        nrm = fn[out.tri_id.clamp(min=0).long()]                # [H, W, 3]
        light = safe_normalize(poses[0, :3, 3])
        lam = 0.3 + 0.7 * (nrm * light).sum(-1).abs()           # two-sided
        if textured:
            uvp = interpolate(uvt, out, f)                      # [H, W, 2]
            th, tw = tex.shape[:2]
            x = torch.clamp(uvp[..., 0] * (tw - 1), 0, tw - 1)
            y = torch.clamp(uvp[..., 1] * (th - 1), 0, th - 1)
            x0, y0 = torch.floor(x).long(), torch.floor(y).long()
            x1 = torch.clamp(x0 + 1, max=tw - 1)
            y1 = torch.clamp(y0 + 1, max=th - 1)
            wx, wy = (x - x0)[..., None], (y - y0)[..., None]
            alb = (tex[y0, x0] * (1 - wx) * (1 - wy) +
                   tex[y0, x1] * wx * (1 - wy) +
                   tex[y1, x0] * (1 - wx) * wy + tex[y1, x1] * wx * wy)
        else:
            alb = torch.full((H, W, 3), 0.7, device=dev)
        a = out.alpha[..., None]
        img = alb * lam[..., None] * a + 1.0 * (1 - a)
        out_frames.append(img.clamp(0, 1).cpu().numpy())
    return out_frames


def main(argv=None):
    ap = argparse.ArgumentParser("mesh_to_video")
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--fps", type=int, default=25)
    ap.add_argument("--device", type=str, default="cuda",
                    help="default cuda; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    verts, tris, uv, tex_path = read_obj(args.mesh)
    texture = None
    if tex_path and os.path.exists(tex_path):
        img = load_image(tex_path)
        texture = img[..., :3] if img.ndim == 3 else \
            np.repeat(img[..., None], 3, axis=-1)
    frames = render_turntable(verts, tris, uv, texture, frames=args.frames,
                              size=args.size, device=args.device)
    out = args.out or os.path.splitext(args.mesh)[0] + "_turntable.mp4"
    out = save_video(out, frames, fps=args.fps)
    print(f"wrote {out} ({len(frames)} frames @ {args.size}²)")
    return out


if __name__ == "__main__":
    main()
