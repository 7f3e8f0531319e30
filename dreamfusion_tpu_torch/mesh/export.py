"""Textured mesh export (``dreamfusion_tpu/mesh/export.py``).

Density grid query → marching cubes → clean → decimate → UV unwrap →
texture bake → OBJ + MTL + albedo PNG.  The surface comes from the field
(stage 1) or from the DMTet geometry (stage 2).  Marching cubes, clean,
decimate and unwrap are the host library ``native/meshops``; the bake
rasterizes the UV atlas with K7 forward (``soft_edge_px`` 0, ``tile_cap``
min(1024, T)), interpolates world positions per texel, queries the field's
albedo there on the device and fills the gutters by nearest covered texel
(an exact EDT, scipy).  The export runs on the trainer's device.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.sampling import linspace
from ..native import meshops
from ..ops.raster import interpolate, rasterize
from ..utils.image import save_image


@torch.no_grad()
def query_grid(trainer, state, resolution: int = 256,
               chunk: int = 64 ** 3) -> np.ndarray:
    """sigma of the EMA field on a resolution³ grid over [-bound, bound]³,
    through float16 as the JAX package's volume → [R, R, R] float32."""
    field = trainer.field(state)
    bound = trainer.cfg.bound
    R = resolution
    dev = trainer.device
    xs = linspace(-bound, bound, R, device=dev)
    out = torch.empty(R ** 3, dtype=torch.float16, device=dev)
    for c0 in range(0, R ** 3, chunk):
        idx = torch.arange(c0, min(c0 + chunk, R ** 3), device=dev)
        pts = torch.stack([xs[idx // (R * R)], xs[(idx // R) % R],
                           xs[idx % R]], -1)
        out[c0:c0 + len(idx)] = field.density(pts)["sigma"].half()
    return out.float().cpu().numpy().reshape(R, R, R)


def sigmas_to_mesh(sigmas: np.ndarray, density_thresh: float, bound: float,
                   decimate_target: int = 50_000, clean: bool = True,
                   log=print, mark=lambda n: None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Density volume → cleaned, decimated world-space mesh.  A noise-like
    field can emit tens of millions of triangles: the surface size is
    estimated first (occupancy flips along the axes) and the volume halved
    until the estimate is within 32x the decimation target."""
    sigmas = np.nan_to_num(np.asarray(sigmas, np.float32),
                           nan=0.0, posinf=3.3e6, neginf=0.0)
    max_raw = max(32 * decimate_target, 2_000_000) if decimate_target \
        else 16_000_000
    R = sigmas.shape[0]

    def est_tris(s):
        occ = s > density_thresh
        return 2 * sum(int(np.count_nonzero(np.diff(occ, axis=a)))
                       for a in range(3))

    est = est_tris(sigmas)
    while est > max_raw and R > 64:
        R //= 2
        log(f"[extract_mesh] degenerate surface (~{est} est. tris at "
            f"{R * 2}³): extracting at {R}³ instead")
        sigmas = sigmas.reshape(R, 2, R, 2, R, 2).mean(axis=(1, 3, 5))
        est = est_tris(sigmas)
    verts, tris = meshops.marching_cubes(sigmas, float(density_thresh))
    mark("mc")
    if len(tris) == 0:
        return verts, tris
    verts = verts / (R - 1) * (2 * bound) - bound     # index space → world
    if clean:
        verts, tris = meshops.clean_mesh(verts, tris, weld_eps=1e-4 * bound,
                                         min_faces=8, min_frac=0.02)
    mark("clean")
    if decimate_target and len(tris) > decimate_target:
        verts, tris = meshops.decimate_mesh(verts, tris, decimate_target)
    mark("decimate")
    return verts.astype(np.float32), tris.astype(np.int32)


def extract_mesh(trainer, state, resolution: int = 256,
                 density_thresh: Optional[float] = None,
                 decimate_target: int = 50_000, clean: bool = True,
                 mark=lambda n: None) -> Tuple[np.ndarray, np.ndarray]:
    """Field density → triangle mesh in world coordinates."""
    cfg = trainer.cfg
    sigmas = np.nan_to_num(query_grid(trainer, state, resolution), nan=0.0,
                           posinf=3.3e6, neginf=0.0)
    mark("query")
    if density_thresh is None:
        # relax the threshold if the field is faint
        live = sigmas > 1e-3
        mean_live = float(sigmas[live].mean()) if live.any() \
            else cfg.density_thresh
        density_thresh = min(2 * mean_live, cfg.density_thresh)
        if not (sigmas > density_thresh).any() and float(sigmas.max()) > 0:
            density_thresh = float(sigmas.max()) * 0.5
            trainer.log(f"[extract_mesh] field below threshold everywhere "
                        f"(max {sigmas.max():.3g}); using the densest "
                        f"iso-surface at {density_thresh:.3g}")
    return sigmas_to_mesh(sigmas, float(density_thresh), cfg.bound,
                          decimate_target=decimate_target, clean=clean,
                          log=trainer.log, mark=mark)


@torch.no_grad()
def bake_texture(trainer, state, verts: np.ndarray, tris: np.ndarray,
                 uv: np.ndarray, tex_res: int = 1024,
                 chunk: int = 512 * 512) -> np.ndarray:
    """Rasterize the UV atlas (K7), interpolate world positions per texel,
    query the field's albedo there, inpaint the gutters → [R, R, 3]."""
    field = trainer.field(state)
    dev = trainer.device
    u, v = uv[:, 0], uv[:, 1]
    clip = np.stack([u * 2 - 1, -(v * 2 - 1), np.zeros_like(u),
                     np.ones_like(u)], -1).astype(np.float32)
    faces = torch.from_numpy(np.ascontiguousarray(tris, np.int32)).to(dev)
    out = rasterize(torch.from_numpy(clip).to(dev), faces,
                    torch.ones(len(tris), dtype=torch.bool, device=dev),
                    tex_res, tex_res, tile=32,
                    tile_cap=min(1024, len(tris)), soft_edge_px=0.0)
    xyz = interpolate(torch.from_numpy(np.asarray(verts, np.float32)).to(dev),
                      out, faces).reshape(-1, 3)
    cols = torch.cat([torch.round(torch.clamp(
        field.density(xyz[i:i + chunk])["albedo"].float(), 0.0, 1.0) * 255.0)
        for i in range(0, xyz.shape[0], chunk)]).to(torch.uint8)
    mask = (out.tri_id >= 0).cpu().numpy()
    tex = cols.reshape(tex_res, tex_res, 3).cpu().numpy().astype(
        np.float32) / 255.0
    tex = tex * mask[..., None]
    if (~mask).any() and mask.any():
        from scipy.ndimage import distance_transform_edt
        _, idx = distance_transform_edt(~mask, return_indices=True)
        tex = tex[idx[0], idx[1]]
    return np.clip(tex, 0.0, 1.0)


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray,
              uv: Optional[np.ndarray] = None,
              texture: Optional[np.ndarray] = None, name: str = "mesh"):
    """OBJ (+ MTL and ``<name>_albedo.png`` with a texture)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    base = os.path.splitext(path)[0]
    lines = []
    if uv is not None:
        lines += [f"mtllib {os.path.basename(base)}.mtl", f"usemtl {name}"]
    lines += [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in verts]
    if uv is not None:
        # OBJ's vt origin is bottom-left; v here runs top-down
        lines += [f"vt {t[0]:.6f} {1.0 - t[1]:.6f}" for t in uv]
        lines += [f"f {f[0]}/{f[0]} {f[1]}/{f[1]} {f[2]}/{f[2]}"
                  for f in tris + 1]
    else:
        lines += [f"f {f[0]} {f[1]} {f[2]}" for f in tris + 1]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if uv is not None and texture is not None:
        tex_path = f"{base}_albedo.png"
        save_image(tex_path, texture)
        with open(f"{base}.mtl", "w") as fh:
            fh.write(f"newmtl {name}\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                     f"Tr 1\nillum 1\nNs 0\n"
                     f"map_Kd {os.path.basename(tex_path)}\n")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray], Optional[str]]:
    """Minimal OBJ reader (v/vt/f) → (verts, tris, uv per vertex or None,
    texture path or None)."""
    verts, uvs, tris, uvt = [], [], [], []
    tex = None
    d = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for line in fh:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                uvs.append([float(p[1]), 1.0 - float(p[2])])
            elif p[0] == "f":
                ids = [q.split("/") for q in p[1:4]]
                tris.append([int(q[0]) - 1 for q in ids])
                if len(ids[0]) > 1 and ids[0][1]:
                    uvt.append([int(q[1]) - 1 for q in ids])
            elif p[0] == "mtllib":
                mtl = os.path.join(d, p[1])
                if os.path.exists(mtl):
                    with open(mtl) as mf:
                        for ml in mf:
                            if ml.strip().startswith("map_Kd"):
                                tex = os.path.join(d, ml.split()[1])
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    uv = None
    if uvs and uvt:
        uv = np.zeros((len(verts), 2), np.float32)
        uva = np.asarray(uvs, np.float32)
        for f, tf in zip(tris, np.asarray(uvt, np.int32)):
            uv[f] = uva[tf]
    return verts, tris, uv, tex


def export_mesh(trainer, state, save_dir: str, resolution: int = 256,
                decimate_target: int = 50_000, tex_res: int = 1024,
                name: str = "mesh",
                phases: Optional[Dict[str, float]] = None) -> str:
    """The whole pipeline → the OBJ path ('' when the surface is empty).
    ``phases`` (if given) receives the wall seconds of each phase: query,
    mc, clean, decimate (stage 1) or dmtet (stage 2), unwrap_uv,
    bake_texture, write."""
    t0 = time.time()
    phases = {} if phases is None else phases

    def mark(what: str) -> None:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        phases[what] = time.time() - t0 - sum(phases.values())

    if trainer.cfg.dmtet:
        verts, tris = trainer.extract_dmtet_mesh(state)
        verts, tris = meshops.clean_mesh(verts, tris,
                                         weld_eps=1e-4 * trainer.cfg.bound,
                                         min_faces=8, min_frac=0.02)
        if decimate_target and len(tris) > decimate_target:
            verts, tris = meshops.decimate_mesh(verts, tris, decimate_target)
        mark("dmtet")
    else:
        verts, tris = extract_mesh(trainer, state, resolution=resolution,
                                   decimate_target=decimate_target,
                                   mark=mark)
    if len(tris) == 0:
        trainer.log("[export_mesh] empty surface, nothing to export")
        return ""
    verts, tris, uv, _src = meshops.unwrap_uv(verts, tris, atlas_res=tex_res)
    mark("unwrap_uv")
    texture = bake_texture(trainer, state, verts, tris, uv, tex_res=tex_res)
    mark("bake_texture")
    path = os.path.join(save_dir, f"{name}.obj")
    write_obj(path, verts, tris, uv=uv, texture=texture, name=name)
    mark("write")
    trainer.log(f"[export_mesh] wrote {path}: {len(verts)} verts, "
                f"{len(tris)} tris, {tex_res}² texture in "
                f"{time.time() - t0:.1f} s "
                f"{ {k: round(v, 3) for k, v in phases.items()} }")
    return path
