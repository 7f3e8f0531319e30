"""K7's plain version against the JAX rasterizer (``ops/raster.py``):
``rasterize`` and ``interpolate`` on random non-degenerate triangles, on an
image that is not a multiple of the tile, with a soft edge of 1 and of 0,
a tile over its cap, a triangle behind the camera and masked faces.

Tolerances: tri_id exact; bary and depth where tri_id >= 0 1e-5 abs (the
same fp32 formulas, summed in another order, and with fused multiply-adds
under jit); the interpolated attributes 1e-5 of the attributes' largest
magnitude (those barycentric errors times the attribute); alpha 1e-4 abs
(its margin is in pixels: the barycentric rounding times sqrt|den|, up to
~100 px here, then a sigmoid of slope up to 1 at soft_edge_px 1);
gradients of a scalar of (interpolate, alpha) with respect to the
clip-space vertices and the attributes rtol 1e-4 with a floor of 1e-4 of
each tensor's largest entry, as tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops import raster as jr
from dreamfusion_tpu_torch.ops import raster as pr

torch.set_num_threads(2)


def _scene(seed: int, V: int = 60, T: int = 40, crowd: int = 0):
    """Clip-space vertices, faces, mask and attributes: random triangles of
    a reasonable size, one with a vertex behind the camera, a few masked,
    and ``crowd`` extra small triangles piled into one corner tile."""
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.1, 1.1, (V, 3)).astype(np.float32)
    ndc[:, 2] = rng.uniform(-0.9, 0.9, V)
    w = rng.uniform(0.5, 2.0, (V, 1)).astype(np.float32)
    faces = []
    while len(faces) < T:
        f = rng.choice(V, 3, replace=False)
        p = ndc[f, :2]
        area = abs((p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1])
                   - (p[1, 1] - p[0, 1]) * (p[2, 0] - p[0, 0]))
        if 0.02 < area < 1.0:
            faces.append(f)
    if crowd:
        base = len(ndc)
        c = rng.uniform(-0.95, -0.75, (3 * crowd, 3)).astype(np.float32)
        c[:, 2] = rng.uniform(-0.9, 0.9, 3 * crowd)
        ndc = np.concatenate([ndc, c])
        w = np.concatenate([w, rng.uniform(0.5, 2.0, (3 * crowd, 1))
                            .astype(np.float32)])
        faces += [base + 3 * i + np.arange(3) for i in range(crowd)]
    clip = np.concatenate([ndc * w, w], -1).astype(np.float32)
    clip[faces[0][0], 3] = -0.5                 # behind the camera
    faces = np.asarray(faces, np.int32)
    mask = np.ones(len(faces), bool)
    mask[[3, 7]] = False
    attrs = rng.normal(size=(len(clip), 4)).astype(np.float32)
    return clip, faces, mask, attrs


CASES = {  # H, W, tile, cap, soft, crowd, seed
    "soft1": (45, 70, 32, 32, 1.0, 0, 0),
    "soft0": (45, 70, 32, 32, 0.0, 0, 1),
    "tile16_soft1": (37, 29, 16, 32, 1.0, 0, 2),
    "over_cap": (40, 40, 16, 12, 1.0, 20, 3),
    "over_cap_soft0": (40, 40, 16, 12, 0.0, 20, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_and_interpolate_match_jax(case):
    H, W, tile, cap, soft, crowd, seed = CASES[case]
    clip, faces, mask, attrs = _scene(seed, crowd=crowd)
    jo = jax.jit(lambda c: jr.rasterize(
        c, jnp.asarray(faces), jnp.asarray(mask), H, W, tile=tile,
        tile_cap=cap, soft_edge_px=soft))(jnp.asarray(clip))
    po = pr.rasterize(torch.from_numpy(clip), torch.from_numpy(faces),
                      torch.from_numpy(mask), H, W, tile=tile, tile_cap=cap,
                      soft_edge_px=soft)
    tri = np.asarray(jo.tri_id)
    np.testing.assert_array_equal(po.tri_id.numpy(), tri)
    hit = tri >= 0
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_allclose(po.bary.numpy()[hit],
                               np.asarray(jo.bary)[hit], atol=1e-5)
    np.testing.assert_allclose(po.depth.numpy(), np.asarray(jo.depth),
                               atol=1e-5)
    np.testing.assert_allclose(po.alpha.numpy(), np.asarray(jo.alpha),
                               atol=1e-4)
    if soft > 0:
        assert ((po.alpha.numpy() > 0.01) & (po.alpha.numpy() < 0.99)).any()
    ji = jr.interpolate(jnp.asarray(attrs), jo, jnp.asarray(faces))
    pi = pr.interpolate(torch.from_numpy(attrs), po, torch.from_numpy(faces))
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji),
                               atol=1e-5 * np.abs(attrs).max())

    # gradients of sum(c1·interpolate) + sum(c2·alpha)
    rng = np.random.default_rng(1)
    c1 = rng.normal(size=(H, W, attrs.shape[1])).astype(np.float32)
    c2 = rng.normal(size=(H, W)).astype(np.float32)

    def jloss(cv, at):
        o = jr.rasterize(cv, jnp.asarray(faces), jnp.asarray(mask), H, W,
                         tile=tile, tile_cap=cap, soft_edge_px=soft)
        return jnp.sum(jr.interpolate(at, o, jnp.asarray(faces)) * c1) + \
            jnp.sum(o.alpha * c2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(clip),
                                         jnp.asarray(attrs))
    cv = torch.from_numpy(clip).requires_grad_()
    at = torch.from_numpy(attrs).requires_grad_()
    o = pr.rasterize(cv, torch.from_numpy(faces), torch.from_numpy(mask), H,
                     W, tile=tile, tile_cap=cap, soft_edge_px=soft)
    loss = (pr.interpolate(at, o, torch.from_numpy(faces))
            * torch.from_numpy(c1)).sum() + (o.alpha * torch.from_numpy(c2)
                                             ).sum()
    pg = torch.autograd.grad(loss, [cv, at])
    for name, a, b in zip(("clip_verts", "attrs"), pg, jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_project_verts_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        pr.project_verts(torch.from_numpy(v), torch.from_numpy(m)).numpy(),
        np.asarray(jr.project_verts(jnp.asarray(v), jnp.asarray(m))),
        rtol=1e-6, atol=1e-6)


def test_tile_lists_keep_the_first_cap_triangles_by_index():
    """A tile over its cap lists its first `cap` overlapping triangles in
    index order, and a triangle behind the camera is listed nowhere."""
    clip, faces, mask, _ = _scene(5, crowd=20)
    cv = torch.from_numpy(clip)
    f = torch.from_numpy(faces).long()
    sx, sy, sz, valid = pr.screen_coords(cv, f, torch.from_numpy(mask), 40,
                                         40)
    _, _, _, _, bb_min, bb_max = pr._face_coeffs(sx, sy, sz, f)
    ids, listed = pr.tile_lists(bb_min, bb_max, valid, 40, 40, 16, 12, 1.0)
    assert bool(listed.all(1).any())             # some tile is full
    for g in range(ids.shape[0]):
        got = ids[g][listed[g]].tolist()
        assert got == sorted(got)
    assert not bool(valid[0])                    # face 0 is behind
    assert 0 not in ids[listed].tolist()
