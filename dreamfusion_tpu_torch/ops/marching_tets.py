"""K8: marching tetrahedra at fixed slots and the mesh regularizers
(``dreamfusion_tpu/ops/marching_tets.py``: ``marching_tets``,
``vertex_normals``, ``laplacian_smooth_loss``,
``normal_consistency_loss``).

The tet grid's unique-edge topology is static (``mesh/tets.py``), so each
surface vertex lives at its edge's slot; every tet emits up to 2 triangles
and the valid ones are compacted, in slot order, into a ``max_tris``
buffer with a mask; the mesh also carries the surface's true face count
(``TetMesh.n_faces``, the slots past ``max_tris`` included, on the
device), so that a caller can see the faces the cut dropped.  On CUDA
tensors each function, forward and backward,
is one launch of ``csrc/marching_tets.cu``: the forward also records each
tet triangle's slot (``MeshSlots``), and with the grid's static adjacency
(``tet_topology``, built once per grid) the backward and the regularizers
gather per vertex over the tets around its edge, with no atomics and no
zero fills; normal consistency takes each edge's partner from the tet
adjacency, and each loss's mean is finished on the card.  On CPU tensors
the plain version runs (it may sort and scatter as it likes: it is the
yardstick, not the port); ``mesh_slots_plain`` and ``nc_partners_plain``
are the plain versions of the kernels' slots and pairs.

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
with a floor of 1.  A tet grid's surface has at most two faces on an edge
(an edge between two tet edges lies on one tet face, or is a quad's
diagonal inside one tet), so the sort's pairs and the adjacency's are the
same set, open surfaces and triangles dropped at max_tris included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    # [] int: the surface's faces before the max_tris cut (> the mask's sum
    # when faces were dropped); None only where a caller built the mesh
    n_faces: Optional[torch.Tensor] = None
    # the kernel's slots (``MeshSlots``), which the card's regularizers
    # gather by; None from the plain version
    slots: Optional["MeshSlots"] = None


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
    return TetMesh(verts, crossing, faces.to(torch.int32), face_mask,
                   mask_all.sum().to(torch.int32))


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


def _sorted_edge_keys(faces, face_mask, E: int):
    """The faces' undirected edge keys (face edge k of slot t at k·T + t)
    sorted stably → (keys, order); invalid faces get unique sentinel keys
    and never pair."""
    T = faces.shape[0]
    f = faces.long()
    ar = torch.arange(T, device=faces.device)
    keys = []
    for k, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        lo = torch.minimum(f[:, i], f[:, j])
        hi = torch.maximum(f[:, i], f[:, j])
        lo = torch.where(face_mask, lo, E + k * T + ar)
        keys.append(lo * E + hi)
    order = torch.sort(torch.cat(keys), stable=True)[1]
    return torch.cat(keys)[order], order


def nc_pairs_plain(faces, face_mask, E: int) -> torch.Tensor:
    """The face-slot pairs the plain normal consistency sums over (equal
    neighbours of the sorted keys) → [P, 2] int64, each row (lower slot,
    higher slot), rows sorted."""
    T = faces.shape[0]
    ks, order = _sorted_edge_keys(faces, face_mask, E)
    same = ks[1:] == ks[:-1]
    a, b = order[:-1][same] % T, order[1:][same] % T
    pairs = torch.stack([torch.minimum(a, b), torch.maximum(a, b)], -1)
    return torch.unique(pairs, dim=0)


def normal_consistency_plain(verts, faces, face_mask) -> torch.Tensor:
    fn = _unit_face_normals(verts, faces)
    ks, order = _sorted_edge_keys(faces, face_mask, verts.shape[0])
    ns = fn.repeat(3, 1)[order]
    pair = ks[1:] == ks[:-1]
    cos = (ns[1:] * ns[:-1]).sum(-1)
    return torch.where(pair, 1.0 - cos, 0.0).sum() / torch.clamp(pair.sum(),
                                                                 min=1)


# ---------------------------------------------------------------------------
# the static topology and the slots the card's kernels gather by
# ---------------------------------------------------------------------------

# tet edges (01, 02, 03, 12, 13, 23): for two edges that share a vertex, the
# tet vertex on neither (opposite the tet face holding both); -1 for two
# opposite edges (local ids summing to 5), a quad's diagonal
OPP_VERT = np.array([[-1, 3, 2, 3, 2, -1], [3, -1, 1, 3, -1, 1],
                     [2, 1, -1, -1, 2, 1], [3, 3, -1, -1, 0, 0],
                     [2, -1, 2, 0, -1, 0], [-1, 1, 1, 0, 0, -1]],
                    dtype=np.int32)


class TetTopology(NamedTuple):
    """A tet grid's static adjacency (``tet_topology``), int32."""
    edge_tets_off: torch.Tensor   # [E+1]
    edge_tets: torch.Tensor       # [6F] each edge's ring of tets, by tet id
    tet_nbr: torch.Tensor         # [F, 4] the tet across the face opposite
    #                               vertex i (-1 on the grid's boundary)


class MeshSlots(NamedTuple):
    """What the card's regularizers gather by, beside a TetMesh."""
    tri_slot: torch.Tensor    # [2F] int32: slot of tet f's k-th triangle at
    #                           2f + k (-1: no second triangle, or a slot past
    #                           max_tris); a tet with none: -1 in the plain
    #                           version, not written by the kernel
    face_info: torch.Tensor   # [max_tris] int32: f << 5 | k << 4 | tet index
    #                           (0 where masked)
    topo: TetTopology


def tet_topology(tets, tet_edges, V: int, E: int) -> TetTopology:
    """The adjacency the card's K8 regularizers gather by, computed once
    per grid (torch sorts, on the grid's device): each edge's ring of tets
    (the per-vertex gathers) and each tet's neighbour across each face
    (normal consistency's pairs)."""
    dev = tets.device
    F = tets.shape[0]
    keys = tet_edges.long().reshape(-1)
    order = torch.sort(keys, stable=True)[1]          # ring tets by tet id
    et_off = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    et_off[1:] = torch.cumsum(torch.bincount(keys, minlength=E), 0)
    et = (order // 6).to(torch.int32)
    # the face opposite vertex i holds the other three: a key of the sorted
    # triple (V < 2**21, so V**3 fits in int64); equal keys are neighbours
    others = torch.tensor([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]],
                          device=dev)
    tri = torch.sort(tets.long()[:, others], dim=-1)[0]        # [F, 4, 3]
    key = ((tri[..., 0] * V + tri[..., 1]) * V + tri[..., 2]).reshape(-1)
    order = torch.sort(key)[1]
    same = key[order][1:] == key[order][:-1]
    a, b = order[:-1][same], order[1:][same]
    nbr = torch.full((4 * F,), -1, dtype=torch.int64, device=dev)
    nbr[a], nbr[b] = b // 4, a // 4
    return TetTopology(et_off.to(torch.int32), et,
                       nbr.reshape(F, 4).to(torch.int32))


def mesh_slots_plain(sdf, tets, max_tris: int):
    """The plain version of the slots the marching-tets kernel records beside
    the faces → (tri_slot [2F], face_info [max_tris]) (``MeshSlots``)."""
    dev = sdf.device
    max_tris = min(max_tris, 2 * tets.shape[0])     # as marching_tets_plain
    occ4 = (sdf > 0)[tets.long()].to(torch.int64)               # [F, 4]
    idx = (occ4 * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)
    ntri = torch.from_numpy(NUM_TRIANGLES).to(dev)[idx]
    valid = torch.stack([ntri >= 1, ntri == 2], -1).reshape(-1)  # [2F]
    slot = torch.cumsum(valid.to(torch.int64), 0) - 1
    keep = valid & (slot < max_tris)
    tri_slot = torch.where(keep, slot, -1).to(torch.int32)
    F = tets.shape[0]
    f = torch.arange(F, device=dev).repeat_interleave(2)
    k = torch.arange(2, device=dev).repeat(F)
    info = (f << 5) | (k << 4) | idx.repeat_interleave(2)
    face_info = torch.zeros(max_tris, dtype=torch.int64, device=dev)
    face_info[slot[keep]] = info[keep]
    return tri_slot, face_info.to(torch.int32)


def _holds(faces, s, a, b):
    """Whether face slots s (clamped to the slots) hold both vertices a and
    b."""
    f = faces.long()[s.clamp(0, faces.shape[0] - 1)]
    return (f == a[:, None]).any(-1) & (f == b[:, None]).any(-1)


def nc_partners_plain(faces, face_mask, slots: MeshSlots) -> torch.Tensor:
    """The plain version of the normal-consistency kernel's pairing: for
    face slot s and its edge k (vertices k, k+1), the slot of the other
    face on that edge, from the static topology → [T, 3] int32 (-1: none).
    A quad's diagonal pairs the tet's two triangles; any other edge lies on
    the tet face holding both of its tet edges and pairs with the triangle
    of the tet across that face that holds both."""
    dev = faces.device
    tri_slot = slots.tri_slot.long()
    info = slots.face_info.long()
    f, j, idx = info >> 5, (info >> 4) & 1, info & 15
    tab = torch.from_numpy(TRIANGLE_TABLE).to(dev).long()[idx]    # [T, 6]
    loc = torch.gather(tab, 1, 3 * j[:, None] + torch.arange(3, device=dev))
    opp = torch.from_numpy(OPP_VERT).to(dev).long()
    nbr = slots.topo.tet_nbr.long()
    fv = faces.long()
    out = []
    for k in range(3):
        la, lb = loc[:, k].clamp(min=0), loc[:, (k + 1) % 3].clamp(min=0)
        a, b = fv[:, k], fv[:, (k + 1) % 3]
        # (a masked slot reads tet 0's entries; its result is dropped)
        diag = tri_slot[2 * f + 1 - j]
        g = nbr[f, opp[la, lb].clamp(min=0)]
        across = torch.full_like(g, -1)
        for jj in range(2):
            s2 = tri_slot[2 * g.clamp(min=0) + jj]
            ok = (g >= 0) & (s2 >= 0) & _holds(faces, s2, a, b)
            across = torch.where(ok, s2, across)
        p = torch.where(la + lb == 5, diag, across)
        out.append(torch.where(face_mask, p, -1))
    return torch.stack(out, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/marching_tets.cu)
# ---------------------------------------------------------------------------

P = kernels.ptr


class _MarchingTetsCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vert_pos, sdf, tets, tet_edges, unique_edges, max_tris):
        kernels.check_cuda(vert_pos, sdf, tets, tet_edges, unique_edges)
        F, E = tets.shape[0], unique_edges.shape[0]
        if F >= 1 << 26:
            raise ValueError("the marching-tets kernel packs tet ids in 26 "
                             "bits")
        dev = sdf.device
        i32 = dict(device=dev, dtype=torch.int32)
        verts = torch.empty(E, 3, device=dev)
        crossing = torch.empty(E, device=dev, dtype=torch.uint8)
        faces = torch.empty(max_tris, 3, **i32)
        mask = torch.empty(max_tris, device=dev, dtype=torch.uint8)
        tri_slot = torch.empty(2 * F, **i32)
        face_info = torch.empty(max_tris, **i32)
        n_faces = torch.empty((), **i32)
        status = kernels.zeroed(dev, "mt_status", -(-F // 1024),
                                torch.int64)
        done = kernels.zeroed(dev, "mt_done", 1)
        kernels.launch("marching_tets_fwd", P(vert_pos), P(sdf), P(tets),
                       P(tet_edges), P(unique_edges), F, E, max_tris,
                       P(status), P(done), P(verts), P(crossing), P(faces),
                       P(mask), P(tri_slot), P(face_info), P(n_faces))
        ctx.save_for_backward(vert_pos, sdf, unique_edges)
        crossing, mask = crossing.view(torch.bool), mask.view(torch.bool)
        ctx.mark_non_differentiable(crossing, faces, mask, tri_slot,
                                    face_info, n_faces)
        ctx.set_materialize_grads(False)
        return verts, crossing, faces, mask, tri_slot, face_info, n_faces

    @staticmethod
    def backward(ctx, g_verts, g_crossing, g_faces, g_mask, g_slot, g_info,
                 g_n):
        vert_pos, sdf, unique_edges = ctx.saved_tensors
        if g_verts is None:
            return (None,) * 6
        g_verts = g_verts.contiguous()
        g_pos = torch.empty_like(vert_pos)          # zeroed in the launch
        g_sdf = torch.empty_like(sdf)
        kernels.launch("marching_tets_bwd", P(vert_pos), P(sdf),
                       P(unique_edges), vert_pos.shape[0],
                       unique_edges.shape[0], P(g_verts), P(g_pos), P(g_sdf),
                       2 * kernels.sm_count(sdf.device))
        return g_pos, g_sdf, None, None, None, None


class _VertexNormalsCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask, crossing, tri_slot, et_off, et):
        E = verts.shape[0]
        out = torch.empty_like(verts)
        rs = torch.empty(E, device=verts.device)    # 1 / |acc| on the surface
        kernels.launch("vertex_normals_fwd", P(verts), P(faces), P(crossing),
                       P(tri_slot), P(et_off), P(et), E, P(out), P(rs))
        ctx.save_for_backward(verts, faces, mask, crossing, tri_slot, et_off,
                              et, out, rs)
        return out

    @staticmethod
    def backward(ctx, g_n):
        verts, faces, mask, crossing, tri_slot, et_off, et, out, rs = \
            ctx.saved_tensors
        T = faces.shape[0]
        term = _face_terms(verts.device, T)
        g_verts = torch.empty_like(verts)
        kernels.launch("vertex_normals_bwd", P(verts), P(faces), P(mask),
                       P(crossing), P(tri_slot), P(et_off), P(et), P(out),
                       P(rs), P(g_n.contiguous()), verts.shape[0], T,
                       P(term), P(g_verts))
        return g_verts, None, None, None, None, None, None


def _face_terms(dev, T: int) -> torch.Tensor:
    """Scratch of a regularizer's backward: each face's terms of its three
    vertices [T, 3, 4] (x, y, z, -), gathered per vertex after."""
    return torch.empty(T, 3, 4, device=dev)


def _loss_outputs(dev, name: str):
    """(partial sums [1024 blocks, 2], counter, loss [], denominator [1])
    of a loss kernel's last-block mean."""
    return (torch.empty(1024, 2, device=dev), kernels.zeroed(dev, name, 1),
            torch.empty((), device=dev), torch.empty(1, device=dev))


class _LaplacianCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask, crossing, tri_slot, et_off, et):
        E = verts.shape[0]
        aux = torch.empty(E, 4, device=verts.device)  # mean - v, count
        partials, done, loss, den = _loss_outputs(verts.device,
                                                  "lap_done")
        kernels.launch("laplacian_fwd", P(verts), P(faces), P(crossing),
                       P(tri_slot), P(et_off), P(et), E, P(aux),
                       P(partials), P(done), P(loss), P(den))
        ctx.save_for_backward(faces, mask, crossing, tri_slot, et_off, et,
                              aux, den)
        return loss

    @staticmethod
    def backward(ctx, g):
        faces, mask, crossing, tri_slot, et_off, et, aux, den = \
            ctx.saved_tensors
        E, T = aux.shape[0], faces.shape[0]
        term = _face_terms(aux.device, T)
        g_verts = torch.empty(E, 3, device=aux.device)
        kernels.launch("laplacian_bwd", P(faces), P(mask), P(crossing),
                       P(tri_slot), P(et_off), P(et), P(aux),
                       P(g.contiguous()), P(den), E, T, P(term), P(g_verts))
        return g_verts, None, None, None, None, None, None


class _NormalConsistencyCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, verts, faces, mask, crossing, face_info, tri_slot,
                tet_nbr, et_off, et):
        T = faces.shape[0]
        dev = verts.device
        nrm = torch.empty(T, 4, device=dev)         # unit normal, |fn|²
        partner = torch.empty(T, 3, device=dev, dtype=torch.int32)
        partials, done, loss, den = _loss_outputs(dev, "nc_done")
        kernels.launch("normal_consistency_fwd", P(verts), P(faces), P(mask),
                       P(face_info), P(tri_slot), P(tet_nbr), T, P(nrm),
                       P(partner), P(partials), P(done), P(loss), P(den))
        ctx.save_for_backward(verts, faces, mask, crossing, tri_slot, et_off,
                              et, nrm, partner, den)
        ctx.mark_non_differentiable(partner)
        ctx.set_materialize_grads(False)
        return loss, partner

    @staticmethod
    def backward(ctx, g, g_partner):
        if g is None:
            return (None,) * 9
        (verts, faces, mask, crossing, tri_slot, et_off, et, nrm, partner,
         den) = ctx.saved_tensors
        T = faces.shape[0]
        term = _face_terms(verts.device, T)
        g_verts = torch.empty_like(verts)
        kernels.launch("normal_consistency_bwd", P(verts), P(faces), P(mask),
                       P(crossing), P(tri_slot), P(et_off), P(et), P(nrm),
                       P(partner), P(g.contiguous()), P(den), verts.shape[0],
                       T, P(term), P(g_verts))
        return g_verts, None, None, None, None, None, None, None, None


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
                  unique_edges: torch.Tensor, max_tris: int,
                  topo: Optional[TetTopology] = None) -> TetMesh:
    """vert_pos [V,3] deformed grid vertices, sdf [V], tets [F,4],
    tet_edges [F,6], unique_edges [E,2] (int32) → TetMesh; differentiable
    in vert_pos and sdf through the surface vertices.  On the card the mesh
    carries the slots and the grid's ``tet_topology`` (built here when not
    given: pass it to build it once per grid) that the regularizers'
    kernels gather by."""
    if _on_cpu(sdf):
        return marching_tets_plain(vert_pos, sdf, tets, tet_edges,
                                   unique_edges, max_tris)
    i32 = lambda t: t.to(torch.int32).contiguous()
    tets, tet_edges, unique_edges = map(i32, (tets, tet_edges, unique_edges))
    if topo is None:
        topo = tet_topology(tets, tet_edges, vert_pos.shape[0],
                            unique_edges.shape[0])
    verts, crossing, faces, mask, tri_slot, face_info, n_faces = \
        _MarchingTetsCuda.apply(vert_pos.float().contiguous(),
                                sdf.float().contiguous(), tets, tet_edges,
                                unique_edges, max_tris)
    return TetMesh(verts, crossing, faces, mask, n_faces,
                   MeshSlots(tri_slot, face_info, topo))


def _card_args(mesh: TetMesh):
    """verts, faces, the face and crossing masks (uint8) and the slots of a
    mesh from the card's marching tets."""
    if mesh.slots is None:
        raise ValueError("the card's mesh regularizers take the TetMesh of "
                         "the marching-tets kernel (its slots)")
    u8 = lambda t: t.contiguous().view(torch.uint8)
    return (mesh.verts.contiguous(), mesh.faces.to(torch.int32).contiguous(),
            u8(mesh.face_mask), u8(mesh.vert_valid), mesh.slots)


def vertex_normals(mesh: TetMesh) -> torch.Tensor:
    """Area-weighted unit vertex normals [E, 3]."""
    if _on_cpu(mesh.verts):
        return vertex_normals_plain(mesh.verts, mesh.faces, mesh.face_mask)
    v, f, m, c, sl = _card_args(mesh)
    return _VertexNormalsCuda.apply(v, f, m, c, sl.tri_slot,
                                    sl.topo.edge_tets_off, sl.topo.edge_tets)


def laplacian_smooth_loss(mesh: TetMesh) -> torch.Tensor:
    """||mean(neighbours) − v||² averaged over the active vertices."""
    if _on_cpu(mesh.verts):
        return laplacian_plain(mesh.verts, mesh.faces, mesh.face_mask)
    v, f, m, c, sl = _card_args(mesh)
    return _LaplacianCuda.apply(v, f, m, c, sl.tri_slot,
                                sl.topo.edge_tets_off, sl.topo.edge_tets)


def normal_consistency_cuda(mesh: TetMesh):
    """The card's normal consistency → (loss, each face edge's partner slot
    [T, 3] int32, -1 for none: ``nc_partners_plain``'s pairs)."""
    v, f, m, c, sl = _card_args(mesh)
    return _NormalConsistencyCuda.apply(v, f, m, c, sl.face_info, sl.tri_slot,
                                        sl.topo.tet_nbr,
                                        sl.topo.edge_tets_off,
                                        sl.topo.edge_tets)


def normal_consistency_loss(mesh: TetMesh) -> torch.Tensor:
    """Mean (1 − cos) between the unit normals of faces sharing an edge."""
    if _on_cpu(mesh.verts):
        return normal_consistency_plain(mesh.verts, mesh.faces,
                                        mesh.face_mask)
    return normal_consistency_cuda(mesh)[0]
