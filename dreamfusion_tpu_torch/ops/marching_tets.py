"""K8: marching tetrahedra at fixed slots and the mesh regularizers
(``dreamfusion_tpu/ops/marching_tets.py``: ``marching_tets``,
``vertex_normals``, ``laplacian_smooth_loss``,
``normal_consistency_loss``).

The tet grid's unique-edge topology is static (``mesh/tets.py``), so each
surface vertex lives at its edge's slot; every tet emits up to 2 triangles
and the valid ones are compacted, in slot order, into a ``max_tris``
buffer with a mask.  On CUDA tensors each function is a kernel sequence of
``csrc/marching_tets.cu`` with a backward kernel; on CPU tensors the plain
version runs (it may sort and scatter as it likes: it is the yardstick,
not the port).  The regularizers' final sum and division stay in torch.

Semantics kept from the JAX version: occ = sdf > 0; the crossing
denominator keeps its sign under the guard (|d| < 1e-10 → ±1e-10, d = 0 →
+1e-10); t = clip(sa / d, 0, 1), so a non-crossing edge gets no gradient,
except at an exact tie with a bound, where jnp.clip (a maximum, then a
minimum) passes half of it: an edge between two vertices of sdf exactly 0
(lattice points on the sphere init) gets half of 1/1e-10, in both packages;
edges in the order (01, 02, 03, 12, 13, 23) and bit k of the tet index is
vertex k's occupancy; slot 2f holds tet f's first triangle, 2f+1 its
second, and invalid slots become (0, 0, 0) with mask false; normals are
area-weighted with rsqrt(max(n², 1e-20)) and a degenerate vertex gets
(0, 1, 0); the Laplacian counts directed face edges (a neighbour reached
through two faces counts twice); normal consistency pairs faces that share
an undirected edge, never an invalid face, and takes the mean over pairs
with a floor of 1.  With more than two faces on one edge the pairing is
undefined in both packages (JAX pairs neighbours of an unstable sort, the
kernel pairs each face with the edge's first arrival; the plain version
pairs neighbours of a stable sort).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels

TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], dtype=np.int32)

NUM_TRIANGLES = np.array([0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0],
                         dtype=np.int32)


class TetMesh(NamedTuple):
    verts: torch.Tensor       # [E, 3] — one slot per unique tet edge
    vert_valid: torch.Tensor  # [E] bool — edge actually crossed
    faces: torch.Tensor       # [max_tris, 3] int32 into verts
    face_mask: torch.Tensor   # [max_tris] bool


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def marching_tets_plain(vert_pos, sdf, tets, tet_edges, unique_edges,
                        max_tris: int) -> TetMesh:
    occ = sdf > 0
    a, b = unique_edges[:, 0].long(), unique_edges[:, 1].long()
    sa, sb = sdf[a], sdf[b]
    crossing = occ[a] != occ[b]
    denom = sa - sb
    denom = torch.where(denom.abs() < 1e-10,
                        torch.where(denom < 0, -1e-10, 1e-10), denom)
    # maximum then minimum, as jnp.clip: a tie at 0 or 1 halves the gradient
    t = torch.minimum(torch.maximum(sa / denom, torch.zeros_like(sa)),
                      torch.ones_like(sa))
    verts = vert_pos[a] + (vert_pos[b] - vert_pos[a]) * t[:, None]

    dev = sdf.device
    occ4 = occ[tets.long()].to(torch.int32)                     # [F, 4]
    tetindex = (occ4 * torch.tensor([1, 2, 4, 8], dtype=torch.int32,
                                    device=dev)).sum(-1)
    tri_tab = torch.from_numpy(TRIANGLE_TABLE).to(dev)[tetindex]
    ntri = torch.from_numpy(NUM_TRIANGLES).to(dev)[tetindex]
    glob = torch.gather(tet_edges.long(), 1, tri_tab.clamp(min=0).long())
    faces_all = glob.reshape(-1, 3)                             # [2F, 3]
    mask_all = torch.stack([ntri >= 1, ntri == 2], -1).reshape(-1)
    idx = torch.sort((~mask_all).to(torch.uint8), stable=True)[1][:max_tris]
    face_mask = mask_all[idx]
    faces = torch.where(face_mask[:, None], faces_all[idx], 0)
    return TetMesh(verts, crossing, faces.to(torch.int32), face_mask)


def _face_cross(verts, faces):
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    return torch.cross(v1 - v0, v2 - v0, dim=-1)


def vertex_normals_plain(verts, faces, face_mask) -> torch.Tensor:
    fn = torch.where(face_mask[:, None], _face_cross(verts, faces), 0.0)
    out = torch.zeros_like(verts)
    for k in range(3):
        out = out.index_add(0, faces[:, k].long(), fn)
    n2 = (out * out).sum(-1, keepdim=True)
    n = out * torch.rsqrt(torch.clamp(n2, min=1e-20))
    up = torch.tensor([0.0, 1.0, 0.0], device=verts.device)
    return torch.where(n2 > 1e-20, n, up)


def laplacian_plain(verts, faces, face_mask) -> torch.Tensor:
    f = faces.long()
    m = face_mask.to(verts.dtype)
    E = verts.shape[0]
    nb_sum = torch.zeros_like(verts)
    nb_cnt = torch.zeros(E, device=verts.device, dtype=verts.dtype)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        for src, dst in ((i, j), (j, i)):
            nb_sum = nb_sum.index_add(0, f[:, dst],
                                      verts[f[:, src]] * m[:, None])
            nb_cnt = nb_cnt.index_add(0, f[:, dst], m)
    active = nb_cnt > 0
    mean_nb = nb_sum / torch.clamp(nb_cnt, min=1.0)[:, None]
    d2 = ((mean_nb - verts) ** 2).sum(-1)
    return torch.where(active, d2, 0.0).sum() / torch.clamp(active.sum(),
                                                             min=1)


def _unit_face_normals(verts, faces):
    fn = _face_cross(verts, faces)
    fn2 = (fn * fn).sum(-1, keepdim=True)
    return fn * torch.rsqrt(torch.clamp(fn2, min=1e-20))


def normal_consistency_plain(verts, faces, face_mask) -> torch.Tensor:
    fn = _unit_face_normals(verts, faces)
    E, T = verts.shape[0], faces.shape[0]
    f = faces.long()
    ar = torch.arange(T, device=verts.device)
    keys = []
    for k, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        lo = torch.minimum(f[:, i], f[:, j])
        hi = torch.maximum(f[:, i], f[:, j])
        # invalid faces get unique sentinel keys: they never pair
        lo = torch.where(face_mask, lo, E + k * T + ar)
        keys.append(lo * E + hi)
    order = torch.sort(torch.cat(keys), stable=True)[1]
    ks = torch.cat(keys)[order]
    ns = fn.repeat(3, 1)[order]
    pair = ks[1:] == ks[:-1]
    cos = (ns[1:] * ns[:-1]).sum(-1)
    return torch.where(pair, 1.0 - cos, 0.0).sum() / torch.clamp(pair.sum(),
                                                                 min=1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/marching_tets.cu)
# ---------------------------------------------------------------------------

P = kernels.ptr


class _MarchingTetsCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vert_pos, sdf, tets, tet_edges, unique_edges, max_tris):
        kernels.check_cuda(vert_pos, sdf, tets, tet_edges, unique_edges)
        V, F, E = vert_pos.shape[0], tets.shape[0], unique_edges.shape[0]
        dev = sdf.device
        verts = torch.empty(E, 3, device=dev)
        crossing = torch.empty(E, device=dev, dtype=torch.uint8)
        faces = torch.zeros(max_tris, 3, device=dev, dtype=torch.int32)
        mask = torch.zeros(max_tris, device=dev, dtype=torch.uint8)
        block_sums = torch.empty((F + 1023) // 1024 + 1, device=dev,
                                 dtype=torch.int32)
        kernels.launch("marching_tets_fwd", P(vert_pos), P(sdf), P(tets),
                       P(tet_edges), P(unique_edges), V, F, E, max_tris,
                       P(block_sums), P(verts), P(crossing), P(faces),
                       P(mask))
        ctx.save_for_backward(vert_pos, sdf, unique_edges)
        crossing, mask = crossing.view(torch.bool), mask.view(torch.bool)
        ctx.mark_non_differentiable(crossing, faces, mask)
        return verts, crossing, faces, mask

    @staticmethod
    def backward(ctx, g_verts, _gc, _gf, _gm):
        vert_pos, sdf, unique_edges = ctx.saved_tensors
        g_pos = torch.zeros_like(vert_pos)
        g_sdf = torch.zeros_like(sdf)
        if g_verts is not None:
            g_verts = g_verts.contiguous()
            kernels.launch("marching_tets_bwd", P(vert_pos), P(sdf),
                           P(unique_edges), unique_edges.shape[0],
                           P(g_verts), P(g_pos), P(g_sdf))
        return g_pos, g_sdf, None, None, None, None


class _VertexNormalsCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask):
        kernels.check_cuda(verts, faces, mask)
        E, T = verts.shape[0], faces.shape[0]
        acc = torch.zeros_like(verts)
        out = torch.empty_like(verts)
        kernels.launch("vertex_normals_fwd", P(verts), P(faces), P(mask), E,
                       T, P(acc), P(out))
        ctx.save_for_backward(verts, faces, mask, acc, out)
        return out

    @staticmethod
    def backward(ctx, g_n):
        verts, faces, mask, acc, out = ctx.saved_tensors
        g_acc = torch.empty_like(verts)
        g_verts = torch.zeros_like(verts)
        kernels.launch("vertex_normals_bwd", P(verts), P(faces), P(mask),
                       P(acc), P(out), P(g_n.contiguous()), verts.shape[0],
                       faces.shape[0], P(g_acc), P(g_verts))
        return g_verts, None, None


class _LaplacianCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask):
        kernels.check_cuda(verts, faces, mask)
        E, T = verts.shape[0], faces.shape[0]
        nb_sum = torch.zeros_like(verts)
        nb_cnt = torch.zeros(E, device=verts.device)
        d2 = torch.empty(E, device=verts.device)
        kernels.launch("laplacian_fwd", P(verts), P(faces), P(mask), E, T,
                       P(nb_sum), P(nb_cnt), P(d2))
        # the final mean over the active vertices (torch)
        n_active = torch.clamp((nb_cnt > 0).sum(), min=1).float()
        ctx.save_for_backward(verts, faces, mask, nb_sum, nb_cnt, n_active)
        return d2.sum() / n_active

    @staticmethod
    def backward(ctx, g):
        verts, faces, mask, nb_sum, nb_cnt, n_active = ctx.saved_tensors
        gs = (g / n_active).reshape(1).contiguous()
        g_sum = torch.empty_like(verts)
        g_verts = torch.empty_like(verts)
        kernels.launch("laplacian_bwd", P(verts), P(faces), P(mask),
                       P(nb_sum), P(nb_cnt), P(gs), verts.shape[0],
                       faces.shape[0], P(g_sum), P(g_verts))
        return g_verts, None, None


def _pow2_at_least(n: int) -> int:
    return 1 << max(10, (n - 1).bit_length())


class _NormalConsistencyCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask):
        kernels.check_cuda(verts, faces, mask)
        E, T = verts.shape[0], faces.shape[0]
        dev = verts.device
        size = _pow2_at_least(6 * T)        # load factor <= 1/2
        keys = torch.full((size,), -1, device=dev, dtype=torch.int64)
        cnt = torch.zeros(size, device=dev, dtype=torch.int32)
        first = torch.empty(size, device=dev, dtype=torch.int32)
        slot = torch.empty(3 * T, device=dev, dtype=torch.int32)
        pos = torch.empty(3 * T, device=dev, dtype=torch.int32)
        nrm = torch.empty(T, 3, device=dev)
        partner = torch.empty(3 * T, device=dev, dtype=torch.int32)
        terms = torch.empty(3 * T, device=dev)
        kernels.launch("normal_consistency_fwd", P(verts), P(faces), P(mask),
                       T, size, P(keys), P(cnt), P(first), P(slot), P(pos),
                       P(nrm), P(partner), P(terms))
        # the final mean over the pairs (torch)
        n_pairs = torch.clamp((partner >= 0).sum(), min=1).float()
        ctx.save_for_backward(verts, faces, mask, nrm, partner, n_pairs)
        return terms.sum() / n_pairs

    @staticmethod
    def backward(ctx, g):
        verts, faces, mask, nrm, partner, n_pairs = ctx.saved_tensors
        gs = (g / n_pairs).reshape(1).contiguous()
        g_nrm = torch.zeros_like(nrm)
        g_verts = torch.zeros_like(verts)
        kernels.launch("normal_consistency_bwd", P(verts), P(faces), P(mask),
                       P(nrm), P(partner), P(gs), faces.shape[0], P(g_nrm),
                       P(g_verts))
        return g_verts, None, None


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return True


def marching_tets(vert_pos: torch.Tensor, sdf: torch.Tensor,
                  tets: torch.Tensor, tet_edges: torch.Tensor,
                  unique_edges: torch.Tensor, max_tris: int) -> TetMesh:
    """vert_pos [V,3] deformed grid vertices, sdf [V], tets [F,4],
    tet_edges [F,6], unique_edges [E,2] (int32) → TetMesh; differentiable
    in vert_pos and sdf through the surface vertices."""
    if _on_cpu(sdf):
        return marching_tets_plain(vert_pos, sdf, tets, tet_edges,
                                   unique_edges, max_tris)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return TetMesh(*_MarchingTetsCuda.apply(
        vert_pos.float().contiguous(), sdf.float().contiguous(), i32(tets),
        i32(tet_edges), i32(unique_edges), max_tris))


def _mesh_args(mesh: TetMesh):
    return (mesh.verts.contiguous(), mesh.faces.to(torch.int32).contiguous(),
            mesh.face_mask.contiguous().view(torch.uint8))


def vertex_normals(mesh: TetMesh) -> torch.Tensor:
    """Area-weighted unit vertex normals [E, 3]."""
    if _on_cpu(mesh.verts):
        return vertex_normals_plain(mesh.verts, mesh.faces, mesh.face_mask)
    return _VertexNormalsCuda.apply(*_mesh_args(mesh))


def laplacian_smooth_loss(mesh: TetMesh) -> torch.Tensor:
    """||mean(neighbours) − v||² averaged over the active vertices."""
    if _on_cpu(mesh.verts):
        return laplacian_plain(mesh.verts, mesh.faces, mesh.face_mask)
    return _LaplacianCuda.apply(*_mesh_args(mesh))


def normal_consistency_loss(mesh: TetMesh) -> torch.Tensor:
    """Mean (1 − cos) between the unit normals of faces sharing an edge."""
    if _on_cpu(mesh.verts):
        return normal_consistency_plain(mesh.verts, mesh.faces,
                                        mesh.face_mask)
    return _NormalConsistencyCuda.apply(*_mesh_args(mesh))
