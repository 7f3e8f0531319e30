"""The host-side and plain-side logic of K7's and K8's Hopper kernels,
against the JAX package on the CPU (the kernels themselves run only on the
card: ``tests/test_torch_cuda.py``).

* ``tet_topology``: each edge's ring of tets and each tet's neighbour
  across each face, against brute force on the grid.
* ``mesh_slots_plain``: the slots the marching-tets kernel records beside
  the faces (each tet triangle's slot, each slot's tet and table row).
* Normal consistency's pairs from the static topology
  (``nc_partners_plain``, the kernel's search written in torch) are the
  pairs of equal keys of the sort (``nc_pairs_plain``), on closed and open
  surfaces and with triangles dropped at max_tris; their mean (1 - cos)
  is JAX's ``normal_consistency_loss``.
* The kernels' ring walk (the triangles of the tets around a surface
  vertex's edge), written here in torch, gives JAX's
  ``laplacian_smooth_loss`` and ``vertex_normals``.
* The raster kernel's binning (per-block tile histograms, their prefix
  over blocks, per-warp counts and in-warp lane ranks), written here in
  torch, gives ``tile_lists`` and JAX's ``top_k`` tile lists.

Tolerances: topology, slots, pairs and lists exact; the losses and normals
1e-5 rel with a floor of 1e-6 (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.ops import marching_tets as jmt
from dreamfusion_tpu_torch.ops import marching_tets as pmt
from dreamfusion_tpu_torch.ops import raster as pr

torch.set_num_threads(2)


def _surface(n, centre, max_tris, seed=0):
    """Grid n, a lumpy sphere's sdf around `centre` (no exact zeros; a
    centre near the grid's side cuts the surface open) and a small
    deformation → (grid, pos, sdf) as numpy."""
    grid = jtets.generate_tet_grid(n)
    rng = np.random.default_rng(seed)
    v = grid.vertices
    sdf = ((0.62 - np.linalg.norm(v - np.asarray(centre), axis=-1)) * 4
           + 0.2 * np.sin(7 * v[:, 1])).astype(np.float32)
    sdf = np.clip(sdf, -1, 1)
    sdf[np.abs(sdf) < 1e-4] = 1e-3
    pos = (v + rng.normal(scale=0.01, size=v.shape)).astype(np.float32)
    return grid, pos, sdf


def _topology(grid):
    t = torch.from_numpy
    return pmt.tet_topology(t(grid.indices), t(grid.tet_edges),
                            len(grid.vertices), len(grid.unique_edges))


@pytest.mark.parametrize("n", [4, 8])
def test_tet_topology(n):
    grid = jtets.generate_tet_grid(n)
    topo = _topology(grid)
    F, E = len(grid.indices), len(grid.unique_edges)
    et_off, et = topo.edge_tets_off.numpy(), topo.edge_tets.numpy()
    for e in range(E):
        want = np.flatnonzero((grid.tet_edges == e).any(1))
        np.testing.assert_array_equal(et[et_off[e]:et_off[e + 1]], want)
    nbr = topo.tet_nbr.numpy()
    tets = grid.indices
    for f in range(F):
        for i in range(4):
            g = nbr[f, i]
            face = set(np.delete(tets[f], i))
            if g < 0:
                continue
            assert f in nbr[g]
            assert face <= set(tets[g]) and g != f
    # the cube's sides: 6 sides x n² squares x 2 triangles have no neighbour
    assert (nbr < 0).sum() == 12 * n * n


@pytest.mark.parametrize("max_tris", [6144, 300])      # 300: dropped
def test_mesh_slots(max_tris):
    grid, pos, sdf = _surface(8, [0.05, 0, 0], max_tris)
    t = torch.from_numpy
    mesh = pmt.marching_tets_plain(t(pos), t(sdf), t(grid.indices),
                                   t(grid.tet_edges), t(grid.unique_edges),
                                   max_tris)
    tri_slot, face_info = pmt.mesh_slots_plain(t(sdf), t(grid.indices),
                                               max_tris)
    T = mesh.faces.shape[0]
    assert face_info.shape == (T,)
    kept = tri_slot >= 0
    slots = tri_slot[kept].long()
    assert torch.equal(torch.sort(slots)[0],
                       torch.arange(int(mesh.face_mask.sum())))
    info = face_info.long()[slots]
    f, k, idx = info >> 5, (info >> 4) & 1, info & 15
    assert torch.equal(2 * f + k, torch.nonzero(kept)[:, 0])
    rows = torch.from_numpy(pmt.TRIANGLE_TABLE).long()[idx]
    loc = torch.gather(rows, 1, 3 * k[:, None] + torch.arange(3))
    want = torch.gather(t(grid.tet_edges).long()[f], 1, loc)
    assert torch.equal(mesh.faces.long()[slots], want)
    assert not face_info[~mesh.face_mask].any()
    assert (max_tris == 300) == bool((mesh.face_mask.sum() == 300))


@pytest.mark.parametrize("centre,max_tris", [([0.05, 0, 0], 6144),
                                             ([0.6, 0, 0], 6144),
                                             ([0.05, 0, 0], 900)])
def test_normal_consistency_pairs_from_the_topology(centre, max_tris):
    grid, pos, sdf = _surface(8, centre, max_tris)
    t = torch.from_numpy
    mesh = pmt.marching_tets_plain(t(pos), t(sdf), t(grid.indices),
                                   t(grid.tet_edges), t(grid.unique_edges),
                                   max_tris)
    slots = pmt.MeshSlots(*pmt.mesh_slots_plain(t(sdf), t(grid.indices),
                                                max_tris), _topology(grid))
    partner = pmt.nc_partners_plain(mesh.faces, mesh.face_mask, slots)
    s = torch.arange(partner.shape[0])[:, None].expand_as(partner)
    live = partner >= 0
    a, b = s[live], partner[live].long()
    # every pair seen from both faces
    assert torch.equal(torch.sort(a * partner.shape[0] + b)[0],
                       torch.sort(b * partner.shape[0] + a)[0])
    pairs = torch.unique(torch.stack([torch.minimum(a, b),
                                      torch.maximum(a, b)], -1), dim=0)
    E = len(grid.unique_edges)
    assert torch.equal(pairs, pmt.nc_pairs_plain(mesh.faces, mesh.face_mask,
                                                 E))
    if centre[0] > 0.5:       # open: edges on the grid's boundary unpaired
        assert 3 * int(mesh.face_mask.sum()) > 2 * pairs.shape[0]
    # the kernel's loss: (1 - cos) over each pair once, from the lower slot
    fn = pmt._unit_face_normals(mesh.verts, mesh.faces)
    lo, hi = pairs[:, 0], pairs[:, 1]
    loss = (1.0 - (fn[lo] * fn[hi]).sum(-1)).sum() / max(pairs.shape[0], 1)
    jm = jmt.marching_tets(jnp.asarray(pos), jnp.asarray(sdf),
                           jnp.asarray(grid.indices),
                           jnp.asarray(grid.tet_edges),
                           jnp.asarray(grid.unique_edges), max_tris)
    want = float(jmt.normal_consistency_loss(jm))
    np.testing.assert_allclose(float(loss), want, rtol=1e-5, atol=1e-6)


def _ring_faces(mesh, slots, e):
    """The kernels' walk: the triangles of the tets around edge e that hold
    vertex e → [(slot, position of e in the face)]."""
    topo = slots.topo
    out = []
    for r in range(int(topo.edge_tets_off[e]), int(topo.edge_tets_off[e + 1])):
        g = int(topo.edge_tets[r])
        for j in range(2):
            s = int(slots.tri_slot[2 * g + j])
            if s < 0:
                continue
            f = mesh.faces[s].tolist()
            if e in f:
                out.append((s, f.index(e)))
    return out


@pytest.mark.parametrize("centre,max_tris", [([0.05, 0, 0], 6144),
                                             ([0.6, 0, 0], 6144),
                                             ([0.05, 0, 0], 900)])
def test_ring_gathers_give_the_laplacian_and_normals(centre, max_tris):
    grid, pos, sdf = _surface(8, centre, max_tris)
    t = torch.from_numpy
    mesh = pmt.marching_tets_plain(t(pos), t(sdf), t(grid.indices),
                                   t(grid.tet_edges), t(grid.unique_edges),
                                   max_tris)
    slots = pmt.MeshSlots(*pmt.mesh_slots_plain(t(sdf), t(grid.indices),
                                                max_tris), _topology(grid))
    verts = mesh.verts.double()
    fl = mesh.faces.long()
    cross = torch.cross(verts[fl[:, 1]] - verts[fl[:, 0]],
                        verts[fl[:, 2]] - verts[fl[:, 0]], dim=-1)
    E = verts.shape[0]
    normals = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64).repeat(
        E, 1)
    d2, active = 0.0, 0
    live = set(fl[mesh.face_mask].reshape(-1).tolist())
    for e in torch.nonzero(mesh.vert_valid)[:, 0].tolist():
        ring = _ring_faces(mesh, slots, e)
        # exactly the valid faces that hold e
        want = torch.nonzero(mesh.face_mask & (fl == e).any(1))[:, 0]
        assert sorted(s for s, _ in ring) == want.tolist()
        if not ring:
            assert e not in live
            continue
        acc = sum(cross[s] for s, _ in ring)
        if float((acc * acc).sum()) > 1e-20:
            normals[e] = acc / acc.norm()
        nb = sum(verts[fl[s, (k + 1) % 3]] + verts[fl[s, (k + 2) % 3]]
                 for s, k in ring)
        dm = nb / (2 * len(ring)) - verts[e]
        d2 += float((dm * dm).sum())
        active += 1
    jm = jmt.marching_tets(jnp.asarray(pos), jnp.asarray(sdf),
                           jnp.asarray(grid.indices),
                           jnp.asarray(grid.tet_edges),
                           jnp.asarray(grid.unique_edges), max_tris)
    np.testing.assert_allclose(d2 / max(active, 1),
                               float(jmt.laplacian_smooth_loss(jm)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(normals.numpy(),
                               np.asarray(jmt.vertex_normals(jm)),
                               rtol=1e-5, atol=1e-5)


def _bin_like_the_kernel(rect, ntx, nty, cap, block=256):
    """raster.cu's binning in torch: per-block tile histograms, their
    prefix over blocks, then each triangle's rank in a tile = the earlier
    blocks' count + the earlier warps' of its block + the earlier lanes of
    its warp whose rectangles hold the tile → lists [G, cap] (-1 past the
    count), counts [G]."""
    T = rect.shape[0]
    G = ntx * nty
    nb = max(1, -(-T // block))
    tiles = [[(ty * ntx + tx) for ty in range(int(r[2]), int(r[3]) + 1)
              for tx in range(int(r[0]), int(r[1]) + 1)] for r in rect]
    hist = torch.zeros(G, nb, dtype=torch.int64)
    for t, ts in enumerate(tiles):
        for g in ts:
            hist[g, t // block] += 1
    prefix = torch.cumsum(hist, 1) - hist
    counts = hist.sum(1)
    lists = torch.full((G, cap), -1, dtype=torch.int64)
    for t, ts in enumerate(tiles):
        b, w, lane = t // block, (t % block) // 32, t % 32
        w0 = b * block + 32 * w
        for g in ts:
            rank = int(prefix[g, b])
            rank += sum(g in tiles[u] for u in range(b * block, w0))
            rank += sum(g in tiles[u] for u in range(w0, w0 + lane))
            if rank < cap:
                lists[g, rank] = t
    return lists, counts


@pytest.mark.parametrize("H,W,cap,soft,seed", [(70, 100, 16, 1.0, 0),
                                               (64, 64, 64, 0.0, 1)])
def test_binning_gives_tile_lists_and_jax_top_k(H, W, cap, soft, seed):
    """Tiles over the cap keep their first cap triangles by index; every
    tile's count counts all of its triangles."""
    rng = np.random.default_rng(seed)
    T = 700                                     # three binning blocks
    c = rng.uniform(0, [W, H], (T, 2))
    c[:200] = rng.uniform(2, 12, (200, 2))      # a crowded corner tile
    p = (c[:, None] + rng.uniform(-6, 6, (T, 3, 2))).astype(np.float32)
    sx = torch.from_numpy(p[..., 0].reshape(-1).copy())
    sy = torch.from_numpy(p[..., 1].reshape(-1).copy())
    sz = torch.zeros_like(sx)
    faces = torch.arange(3 * T, dtype=torch.int32).reshape(T, 3)
    valid = torch.from_numpy(rng.uniform(size=T) > 0.1)
    *_, bmin, bmax = pr._face_coeffs(sx, sy, sz, faces.long())
    tile = 32
    ntx, nty = -(-W // tile), -(-H // tile)
    pad = soft + 1.0
    rect = torch.stack([torch.floor((bmin[:, 0] - pad) / tile).clamp(min=0),
                        torch.floor((bmax[:, 0] + pad) / tile).clamp(
                            max=ntx - 1),
                        torch.floor((bmin[:, 1] - pad) / tile).clamp(min=0),
                        torch.floor((bmax[:, 1] + pad) / tile).clamp(
                            max=nty - 1)], -1).long()
    rect[~valid] = torch.tensor([1, 0, 1, 0])   # a dropped triangle
    lists, counts = _bin_like_the_kernel(rect, ntx, nty, cap)
    ids, listed = pr.tile_lists(bmin, bmax, valid, H, W, tile, cap, soft)
    assert torch.equal(counts.clamp(max=cap), listed.sum(1))
    assert bool((counts > cap).any())
    assert torch.equal(torch.where(listed, ids, -1), lists)
    # JAX's rasterize compacts each tile with top_k over this score
    gy, gx = torch.meshgrid(torch.arange(nty), torch.arange(ntx),
                            indexing="ij")
    gx, gy = gx.reshape(-1, 1), gy.reshape(-1, 1)
    o = jnp.asarray(((rect[:, 0] <= gx) & (gx <= rect[:, 1])
                     & (rect[:, 2] <= gy) & (gy <= rect[:, 3])).numpy())
    score = o.astype(jnp.float32) * (
        1.0 + jnp.arange(T, 0, -1, dtype=jnp.float32) / (T + 1))
    _, top = jax.lax.top_k(score, cap)
    got = np.take_along_axis(np.asarray(o), np.asarray(top), 1)
    np.testing.assert_array_equal(np.where(got, np.asarray(top), -1),
                                  lists.numpy())
