"""K9's module against the JAX package: the mesh loaders (OBJ with fans,
negative indices and v/vt/vn; PLY ascii and binary little-endian with
interleaved colours; a truncated header raises), normalize_mesh, the plain
signed distance on a UV sphere and on a mesh with a degenerate and a sliver
triangle (random points and tet-grid points), and DMTet's mesh-file init
(``init_params_from_mesh`` and ``DMTetTrainer.init_state``) from a sphere
OBJ at tet grid 16.

Tolerances: loaders and normalize_mesh exact; distances |Δ| ≤ 1e-5 +
1e-5·|sd|; signs equal wherever JAX's winding number is more than 1e-4 away
from 0.5 (the winding sums run in another order); no NaN; the init's sdf,
which is clamp(-10·sd), within ten times the distance tolerance where the
signs are clear, and tet_scale exact.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.config import Config, apply_dmtet, finalize
from dreamfusion_tpu.mesh import sdf as jsdf
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.models.dmtet import DMTetRenderer as JRenderer
from dreamfusion_tpu_torch.mesh import sdf as psdf
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.models.dmtet import DMTetParams, DMTetRenderer
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer

from torch_parity import port_cfg

torch.set_num_threads(2)


def _uv_sphere(radius=1.0, n_theta=12, n_phi=18):
    """A watertight UV sphere → (verts [V,3] float32, tris [T,3] int32)."""
    th = np.pi * np.arange(1, n_theta) / n_theta
    ph = 2 * np.pi * np.arange(n_phi) / n_phi
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones_like(ph))], -1)
    verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3),
                            [[0, 0, -1]]]) * radius
    r = lambda i, j: 1 + i * n_phi + j % n_phi
    tris = [(0, r(0, j), r(0, j + 1)) for j in range(n_phi)]
    for i in range(n_theta - 2):
        for j in range(n_phi):
            tris += [(r(i, j), r(i + 1, j), r(i + 1, j + 1)),
                     (r(i, j), r(i + 1, j + 1), r(i, j + 1))]
    bot = len(verts) - 1
    tris += [(bot, r(n_theta - 2, j + 1), r(n_theta - 2, j))
             for j in range(n_phi)]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def _write_obj(path, verts, tris):
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris)


def _with_slivers(verts, tris):
    """One degenerate triangle (a repeated vertex) and one sliver (two
    vertices 1e-7 apart), as a decimated export has."""
    extra = np.array([[0.1, 0.2, 0.3], [0.1 + 1e-7, 0.2, 0.3],
                      [0.3, -0.2, 0.1]], np.float32)
    V = len(verts)
    more = np.array([[V, V, V + 2], [V, V + 1, V + 2]], np.int32)
    return np.concatenate([verts, extra]), np.concatenate([tris, more])


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def test_obj_loader_matches_jax(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("# a quad, a pentagon by negative indices, v/vt/vn styles\n"
                 "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\n"
                 "vt 0 0\nvn 0 0 1\n"
                 "f 1/1/1 2/1/1 3/1/1 4/1/1\n"
                 "f -5//1 -4//1 -3//1 -2//1 -1//1\n"
                 "f 2/1 3/1 5/1\n")
    pv, pt = psdf.load_mesh(str(p))
    jv, jt = jsdf.load_mesh(str(p))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    assert pv.dtype == np.float32 and pt.dtype == np.int32
    assert pt.shape == (6, 3)
    np.testing.assert_array_equal(psdf.normalize_mesh(pv),
                                  jsdf.normalize_mesh(jv))


def _ply_header(fmt, n_vert, n_face, colours):
    h = f"ply\nformat {fmt} 1.0\nelement vertex {n_vert}\n"
    h += "property float x\nproperty float y\nproperty float z\n"
    if colours:
        h += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    h += f"element face {n_face}\nproperty list uchar int vertex_indices\n"
    return h + "end_header\n"


VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]],
                 np.float32)
FACES = [[0, 1, 2], [0, 1, 3, 4], [1, 2, 3]]           # a quad → fan


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_ply_loader_matches_jax(tmp_path, fmt):
    p = tmp_path / "m.ply"
    with open(p, "wb") as f:
        f.write(_ply_header(fmt, len(VERTS), len(FACES),
                            fmt != "ascii").encode())
        if fmt == "ascii":
            f.writelines(f"{x} {y} {z}\n".encode() for x, y, z in VERTS)
            f.writelines((" ".join(map(str, [len(fc)] + fc)) + "\n").encode()
                         for fc in FACES)
        else:
            for v in VERTS:
                f.write(struct.pack("<fffBBB", *v, 200, 100, 50))
            for fc in FACES:
                f.write(struct.pack(f"<B{len(fc)}i", len(fc), *fc))
    pv, pt = psdf.load_mesh(str(p))
    jv, jt = jsdf.load_mesh(str(p))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pv, VERTS)
    assert pt.shape == (4, 3)


def test_ply_truncated_header_raises(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 3\n")
    for mod in (psdf, jsdf):
        with pytest.raises(ValueError, match="end_header"):
            mod.load_mesh(str(p))


# ---------------------------------------------------------------------------
# signed distance
# ---------------------------------------------------------------------------

def _jax_sd_and_winding(pts, verts, tris):
    sd = np.asarray(jsdf.signed_distance(jnp.asarray(pts), jnp.asarray(verts),
                                         jnp.asarray(tris), chunk=256))
    a, b, c = (jnp.asarray(verts[tris[:, k]])[None] for k in range(3))
    wn = np.asarray(jnp.sum(jsdf._winding(jnp.asarray(pts)[:, None], a, b,
                                          c), -1))
    return sd, wn


def _check_sd(pts, verts, tris):
    jd, jw = _jax_sd_and_winding(pts, verts, tris)
    pd, pw = psdf.signed_distance_plain(torch.from_numpy(pts),
                                        torch.from_numpy(verts),
                                        torch.from_numpy(tris), chunk=256,
                                        return_winding=True)
    pd, pw = pd.numpy(), pw.numpy()
    assert not np.isnan(pd).any() and not np.isnan(pw).any()
    tol = 1e-5 + 1e-5 * np.abs(jd) + 1e-12
    np.testing.assert_array_less(np.abs(np.abs(pd) - np.abs(jd)), tol)
    # where the winding number is clear of 0.5 the signs agree (the signed
    # values, as a point on the surface has sd = ±0)
    clear = np.abs(jw - 0.5) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_less(np.abs(pd - jd)[clear], tol[clear])
    return pd


@pytest.mark.parametrize("slivers", [False, True], ids=["sphere", "slivers"])
@pytest.mark.parametrize("where", ["random", "tet_grid"])
def test_signed_distance_matches_jax(slivers, where):
    verts, tris = _uv_sphere(0.4)
    if slivers:
        verts, tris = _with_slivers(verts, tris)
    if where == "random":
        pts = np.random.default_rng(0).uniform(-0.6, 0.6, (1500, 3))
        # and points on the mesh: vertices, edge midpoints
        pts = np.concatenate([pts, verts[:40], (verts[tris[:40, 0]] +
                                                verts[tris[:40, 1]]) / 2])
    else:
        pts = jtets.generate_tet_grid(8).vertices * 0.5
    pts = pts.astype(np.float32)
    pd = _check_sd(pts, verts, tris)
    ref = np.linalg.norm(pts, axis=-1) - 0.4
    away = np.abs(ref) > 0.05
    np.testing.assert_array_equal(np.sign(pd[away]), np.sign(ref[away]))


def test_signed_distance_wrapper_runs_the_plain_version_on_the_cpu():
    verts, tris = _uv_sphere(0.4)
    pts = torch.rand(100, 3) - 0.5
    a = psdf.signed_distance(pts, torch.from_numpy(verts),
                             torch.from_numpy(tris))
    b = psdf.signed_distance_plain(pts, torch.from_numpy(verts),
                                   torch.from_numpy(tris))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="triangle"):
        psdf.signed_distance(pts, torch.from_numpy(verts),
                             torch.zeros(0, 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# DMTet's mesh-file init
# ---------------------------------------------------------------------------

def test_init_params_from_mesh_matches_jax():
    grid = jtets.generate_tet_grid(8)
    verts, tris = _uv_sphere(1.0, 14, 20)
    jp = JRenderer(grid, max_tris=6144).init_params_from_mesh(verts, tris)
    pp = DMTetRenderer(ptets.generate_tet_grid(8),
                       max_tris=6144).init_params_from_mesh(verts, tris)
    np.testing.assert_array_equal(pp.tet_scale.numpy(),
                                  np.asarray(jp.tet_scale))
    js, ps = np.asarray(jp.sdf), pp.sdf.numpy()
    sd = -js / 10.0
    clear = np.abs(js) > 1e-3
    np.testing.assert_array_less(np.abs(ps - js)[clear],
                                 10 * (1e-5 + 1e-5 * np.abs(sd[clear])) +
                                 1e-12)
    np.testing.assert_array_equal(np.sign(ps[clear]), np.sign(js[clear]))
    assert not pp.deform.any()


def test_init_state_from_a_sphere_obj(tmp_path):
    """As tests/test_dmtet_stage.py::test_dmtet_init_from_mesh_obj: the
    grid scaled by 0.5, inner-positive sdf, the surface at radius 0.4."""
    obj = tmp_path / "sphere.obj"
    _write_obj(obj, *_uv_sphere(1.0, 14, 20))
    cfg = finalize(apply_dmtet(Config(
        guidance=("oracle",), backbone="triplane", w=4, h=4,
        triplane_resolution=16, triplane_channels=4, hidden_dim=16,
        tet_grid_size=16, init_with=str(obj), workspace=str(tmp_path))))
    tr = DMTetTrainer(port_cfg(cfg), "cpu")
    state = tr.init_state(0)
    np.testing.assert_allclose(state.tet_scale.numpy(), 0.5 * np.ones(3))
    v = tr.dmtet_renderer.verts * state.tet_scale
    r = torch.linalg.norm(v, dim=-1)
    sdf = state.model.geo["sdf"].detach()
    assert float((sdf[r < 0.34] > 0).float().mean()) > 0.98
    assert float((sdf[r > 0.46] < 0).float().mean()) > 0.98
    mesh = tr.dmtet_renderer.extract_mesh(DMTetParams(
        sdf, state.model.geo["deform"].detach(), state.tet_scale))
    sv = mesh.verts[mesh.vert_valid]
    assert len(sv) > 50
    assert abs(float(torch.linalg.norm(sv, dim=-1).median()) - 0.4) < 0.05
