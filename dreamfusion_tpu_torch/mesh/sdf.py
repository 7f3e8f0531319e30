"""Mesh files and the signed distance of points to a mesh
(``dreamfusion_tpu/mesh/sdf.py``), for DMTet's mesh-file init
(``--dmtet --init_with mesh.obj|.ply``).

The loaders are numpy and read what the JAX package's read: OBJ ``v`` and
``f`` lines (``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``, negative indices,
polygons fan-triangulated) and PLY (ascii or binary little-endian, typed
vertex properties, face lists fan-triangulated).

K9, ``signed_distance``: for each point the distance to the nearest
triangle (Ericson's closest point, JAX's region logic and guards), negative
inside, where the generalized winding number (van Oosterom–Strackee solid
angles) exceeds 0.5.  On a CUDA tensor it is one launch call of
``csrc/sdf.cu`` (a record per triangle, then the points, the distance part
culled exactly by the records' bounding spheres); on a CPU tensor the
plain version runs, chunked over the points as JAX's ``lax.map`` is.
Nothing is differentiated.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops import kernels


# ---------------------------------------------------------------------------
# mesh files
# ---------------------------------------------------------------------------

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ → (verts [V, 3] float32, tris [T, 3] int32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):          # fan
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"no geometry in OBJ file {path}")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A .obj or .ply file → (verts [V, 3] float32, tris [T, 3] int32)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".ply"):
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format: {path} (obj/ply)")


_PLY_SCALARS = {
    "char": "<i1", "int8": "<i1", "uchar": "<u1", "uint8": "<u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
}


def _load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt, n_vert, n_face = None, 0, 0
        vprops = []                      # [(name, numpy dtype str)]
        fcount_t, findex_t = "<u1", "<i4"
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: EOF before end_header")
            line = line.strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n_vert, cur = int(line.split()[-1]), "v"
            elif line.startswith(b"element face"):
                n_face, cur = int(line.split()[-1]), "f"
            elif line.startswith(b"element"):
                cur = "other"
            elif line.startswith(b"property list") and cur == "f":
                _, _, ct, it, _name = line.decode().split()
                fcount_t, findex_t = _PLY_SCALARS[ct], _PLY_SCALARS[it]
            elif line.startswith(b"property") and cur == "v":
                _, typ, name = line.decode().split()
                vprops.append((name, _PLY_SCALARS[typ]))
            elif line == b"end_header":
                break
        names = [n for n, _ in vprops]
        if not all(a in names for a in "xyz"):
            raise ValueError(f"{path}: vertex x/y/z properties missing")
        faces = []
        if fmt == "ascii":
            verts = np.empty((n_vert, 3), np.float32)
            for i in range(n_vert):
                vals = f.readline().split()
                verts[i] = [float(vals[names.index(a)]) for a in "xyz"]
            for _ in range(n_face):
                vals = [int(x) for x in f.readline().split()]
                idx = vals[1:1 + vals[0]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            return verts, np.asarray(faces, np.int32)
        if fmt == "binary_little_endian":
            vert_rec = np.dtype(vprops)
            raw = np.frombuffer(f.read(vert_rec.itemsize * n_vert),
                                dtype=vert_rec)
            if len(raw) != n_vert:
                raise ValueError(f"{path}: truncated vertex block")
            verts = np.stack([raw[a] for a in "xyz"], axis=1).astype(
                np.float32)
            cdt, idt = np.dtype(fcount_t), np.dtype(findex_t)
            for _ in range(n_face):
                n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                idx = np.frombuffer(f.read(idt.itemsize * n), idt)
                for k in range(1, n - 1):
                    faces.append([int(idx[0]), int(idx[k]),
                                  int(idx[k + 1])])
            return verts, np.asarray(faces, np.int32)
        raise ValueError(f"{path}: unsupported PLY format {fmt}")


def normalize_mesh(verts: np.ndarray) -> np.ndarray:
    """Centre the bounding box and scale its longest extent to 0.8."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    scale = 0.8 / float(np.max(hi - lo))
    center = (hi + lo) / 2.0
    return ((verts - center) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K9: point-triangle distance + winding number
# ---------------------------------------------------------------------------

def _dot(x, y):
    return (x * y).sum(-1)


def _guard(x):
    return torch.where(x == 0, 1e-30, x)


def point_tri_dist2(p, a, b, c):
    """Squared distance point → triangle over broadcast [..., 3] inputs."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    q = a + v[..., None] * ab + w[..., None] * ac          # the face
    t_ab = torch.clamp(d1 / _guard(d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(d2 / _guard(d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / _guard((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    vert_a = (d1 <= 0) & (d2 <= 0)
    vert_b = (d3 >= 0) & (d4 <= d3)
    vert_c = (d6 >= 0) & (d5 <= d6)
    edge_ab = ~vert_a & ~vert_b & (d1 >= 0) & (d3 <= 0) & (vc <= 0)
    edge_ac = ~vert_a & ~vert_c & (d2 >= 0) & (d6 <= 0) & (vb <= 0)
    edge_bc = ~vert_b & ~vert_c & (d4 - d3 >= 0) & (d5 - d6 >= 0) & (va <= 0)
    # later regions take precedence, as in JAX
    for hit, cand in ((edge_ab, a + t_ab[..., None] * ab),
                      (edge_ac, a + t_ac[..., None] * ac),
                      (edge_bc, b + t_bc[..., None] * (c - b)),
                      (vert_a, a), (vert_b, b), (vert_c, c)):
        q = torch.where(hit[..., None], cand, q)
    return ((p - q) ** 2).sum(-1)


def winding_term(p, a, b, c):
    """Solid angle / 4π of triangle (a, b, c) seen from p."""
    ra, rb, rc = a - p, b - p, c - p
    la, lb, lc = (torch.linalg.norm(r, dim=-1) for r in (ra, rb, rc))
    det = _dot(ra, torch.linalg.cross(rb, rc, dim=-1))
    den = la * lb * lc + _dot(ra, rb) * lc + _dot(rb, rc) * la + \
        _dot(rc, ra) * lb
    return torch.atan2(det, den) / (2.0 * math.pi)


def _corners(verts: torch.Tensor, tris: torch.Tensor):
    tris = tris.long()
    return verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]


def signed_distance_plain(points: torch.Tensor, verts: torch.Tensor,
                          tris: torch.Tensor, chunk: int = 1024,
                          return_winding: bool = False):
    """The plain version: [chunk, T] tiles, the tail padded with zeros."""
    a, b, c = _corners(verts.float(), tris)
    P = points.shape[0]
    pad = (-P) % chunk
    pts = torch.cat([points.float(), points.new_zeros(pad, 3)]) if pad \
        else points.float()
    sds, wns = [], []
    for i in range(0, pts.shape[0], chunk):
        pe = pts[i:i + chunk, None, :]
        d2 = point_tri_dist2(pe, a[None], b[None], c[None])
        wn = winding_term(pe, a[None], b[None], c[None]).sum(-1)
        dist = torch.sqrt(d2.min(-1).values)
        sds.append(torch.where(wn > 0.5, -dist, dist))
        wns.append(wn)
    sd = torch.cat(sds)[:P]
    return (sd, torch.cat(wns)[:P]) if return_winding else sd


def signed_distance_cuda(points: torch.Tensor, verts: torch.Tensor,
                         tris: torch.Tensor, return_winding: bool = False,
                         cull: bool = True, count: torch.Tensor = None):
    """One launch call of the K9 kernels over every point: the triangle
    records, then the points (the triangles' indices must lie in the
    vertices' range: the kernel gathers without a check, and
    ``signed_distance`` checks them).  ``cull=False`` runs the distance part
    for every pair (the same result); ``count``, a CUDA int64 [1] tensor,
    gets the number of pairs whose distance part ran added to it."""
    pts = points.float().contiguous()
    v = verts.float().contiguous()
    f = tris.to(torch.int32).contiguous()
    kernels.check_cuda(pts, v, f, count)
    if count is not None and (count.dtype != torch.int64 or
                              count.numel() < 1):
        raise ValueError("count must be an int64 tensor of at least one "
                         "element")
    P, T = pts.shape[0], f.shape[0]
    rec = torch.empty(T, 24, device=pts.device)
    sd = torch.empty(P, device=pts.device)
    wn = torch.empty(P, device=pts.device) if return_winding else None
    kernels.launch("signed_distance", kernels.ptr(pts), kernels.ptr(v),
                   kernels.ptr(f), P, T, kernels.ptr(rec), int(cull),
                   kernels.ptr(sd), kernels.ptr(wn), kernels.ptr(count))
    return (sd, wn) if return_winding else sd


@torch.no_grad()
def signed_distance(points: torch.Tensor, verts: torch.Tensor,
                    tris: torch.Tensor, return_winding: bool = False):
    """points [P, 3], mesh verts [V, 3] and tris [T, 3] → sd [P] (positive
    outside), and the winding number [P] with ``return_winding``.  The
    triangles' indices are checked against the vertices (a mesh file's
    bad index raises on every device)."""
    if tris.shape[0] == 0:
        raise ValueError("signed_distance needs at least one triangle")
    if int(tris.min()) < 0 or int(tris.max()) >= verts.shape[0]:
        raise ValueError("the mesh has a triangle index out of range")
    if points.is_cuda:
        return signed_distance_cuda(points, verts, tris, return_winding)
    if points.device.type == "cpu":
        return signed_distance_plain(points, verts, tris,
                                     return_winding=return_winding)
    raise ValueError(f"unsupported device {points.device}")
