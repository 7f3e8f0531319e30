"""The DMTet stage against the JAX package: the tet grid's topology, K8's
plain version (marching tets, vertex normals, the Laplacian and normal
consistency losses, values and gradients), the camera's mvp, a render of a
sphere init, one whole DMTet train step from the same parameters and the
same random draws, and ``--lock_geo``.

Tolerances: topology, faces and masks exact; surface vertices 1e-6; the
regularizers 1e-5 rel; gradients rtol 1e-4 with a floor of 1e-4 of each
tensor's largest entry (sums in another order); the render 1e-4 abs (the
soft-edge alpha's margin is in pixels, see tests/test_torch_raster.py);
the step as tests/test_torch_slice.py: loss 1e-5 rel, gradients as above,
updated parameters and EMA 1e-5 where the gradient is clearly nonzero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_dmtet, finalize
from dreamfusion_tpu.guidance.oracle import PixelOracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.models.dmtet import DMTetRenderer as JRenderer
from dreamfusion_tpu.ops import marching_tets as jmt
from dreamfusion_tpu.training import data as jdata
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JTrainer
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.mesh.sdf import signed_distance
from dreamfusion_tpu_torch.models.dmtet import DMTetRenderer
from dreamfusion_tpu_torch.ops import marching_tets as pmt
from dreamfusion_tpu_torch.training import data as pdata
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import (jax_dmtet_step_draws, port_cfg, tt,
                          uncut_jax_tile_cap)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def grid():
    return jtets.generate_tet_grid(8)          # tet_grid_size 12 → n = 8


def test_build_topology_matches_jax(grid):
    p = ptets.generate_tet_grid(max(8, 12 // 2))
    for k in ("vertices", "indices", "unique_edges", "tet_edges"):
        np.testing.assert_array_equal(getattr(p, k), getattr(grid, k), k)
    assert p.resolution == grid.resolution == 8


def _geometry(grid, seed=0):
    """A lumpy sphere sdf (no exact zeros) and a small deformation."""
    rng = np.random.default_rng(seed)
    v = grid.vertices
    sdf = (0.55 - np.linalg.norm(v, axis=-1)
           + 0.05 * np.sin(5 * v[:, 0]) * np.cos(4 * v[:, 1])).astype(
               np.float32) * 4
    sdf = np.clip(sdf, -1, 1)
    sdf[np.abs(sdf) < 1e-4] = 1e-3
    pos = (v + rng.normal(scale=0.02, size=v.shape)).astype(np.float32)
    return pos, sdf


def _jmesh(grid, pos, sdf, max_tris):
    return jmt.marching_tets(jnp.asarray(pos), jnp.asarray(sdf),
                             jnp.asarray(grid.indices),
                             jnp.asarray(grid.tet_edges),
                             jnp.asarray(grid.unique_edges), max_tris)


def _pmesh(grid, pos, sdf, max_tris):
    t = torch.from_numpy
    return pmt.marching_tets(pos, sdf, t(grid.indices), t(grid.tet_edges),
                             t(grid.unique_edges), max_tris)


@pytest.mark.parametrize("max_tris", [6144, 200])       # 200: overflow
def test_marching_tets_matches_jax(grid, max_tris):
    pos, sdf = _geometry(grid)
    jm = _jmesh(grid, pos, sdf, max_tris)
    pm = _pmesh(grid, torch.from_numpy(pos), torch.from_numpy(sdf), max_tris)
    np.testing.assert_array_equal(pm.faces.numpy(), np.asarray(jm.faces))
    np.testing.assert_array_equal(pm.face_mask.numpy(),
                                  np.asarray(jm.face_mask))
    np.testing.assert_array_equal(pm.vert_valid.numpy(),
                                  np.asarray(jm.vert_valid))
    np.testing.assert_allclose(pm.verts.numpy(), np.asarray(jm.verts),
                               atol=1e-6)
    n = int(pm.face_mask.sum())
    assert (n == max_tris) if max_tris == 200 else (200 < n < max_tris)


REGS = {
    "verts": lambda m, c: (m.verts * c).sum(),
    "normals": lambda m, c: (pmt.vertex_normals(m) * c).sum(),
    "laplacian": lambda m, c: pmt.laplacian_smooth_loss(m),
    "normal_consistency": lambda m, c: pmt.normal_consistency_loss(m),
}
JREGS = {
    "verts": lambda m, c: jnp.sum(m.verts * c),
    "normals": lambda m, c: jnp.sum(jmt.vertex_normals(m) * c),
    "laplacian": lambda m, c: jmt.laplacian_smooth_loss(m),
    "normal_consistency": lambda m, c: jmt.normal_consistency_loss(m),
}


@pytest.mark.parametrize("which", list(REGS))
def test_k8_values_and_gradients_match_jax(grid, which):
    pos, sdf = _geometry(grid, 1)
    c = np.random.default_rng(2).normal(
        size=(len(grid.unique_edges), 3)).astype(np.float32)

    def jf(p, s):
        return JREGS[which](_jmesh(grid, p, s, 6144), c)

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(pos), jnp.asarray(sdf))
    p = torch.from_numpy(pos).requires_grad_()
    s = torch.from_numpy(sdf).requires_grad_()
    pv = REGS[which](_pmesh(grid, p, s, 6144), torch.from_numpy(c))
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-5)
    pg = torch.autograd.grad(pv, [p, s])
    for name, a, b in zip(("vert_pos", "sdf"), pg, jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def _cfg(tmp_path, **kw):
    base = dict(guidance=("oracle",), oracle_scene="two_sphere",
                workspace=str(tmp_path / "ws"), backbone="triplane", w=4, h=4,
                iters=100, batch_size=1, triplane_resolution=32,
                triplane_channels=8, hidden_dim=32, num_layers=3,
                fp16=False, seed=0, eval_interval=-1, tet_grid_size=12,
                lambda_3d_normal_smooth=0.0, use_tensorboard=False,
                guidance_scale=1.0, lr=2e-3)
    base.update(kw)
    return finalize(apply_dmtet(Config(**base)))


def test_mvp_matches_jax(tmp_path):
    cfg = _cfg(tmp_path)
    for i in range(3):
        jb = jdata.circle_view_batch(cfg, i, 3, 24, 40)
        pb = pdata.circle_view_batch(port_cfg(cfg), i, 3, 24, 40)
        np.testing.assert_allclose(pb.mvp.numpy(), np.asarray(jb.mvp),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pb.rays_d.numpy(), np.asarray(jb.rays_d),
                                   rtol=1e-6, atol=1e-6)
    jb = jdata.six_view_batch(cfg, 4, 24, 40)
    pb = pdata.six_view_batch(port_cfg(cfg), 4, 24, 40)
    np.testing.assert_allclose(pb.mvp.numpy(), np.asarray(jb.mvp),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shading", ["lambertian", "albedo", "normal"])
def test_render_of_a_sphere_init_matches_jax(grid, tmp_path, shading):
    cfg = _cfg(tmp_path)
    jr = JRenderer(grid, max_tris=6144)
    pr = DMTetRenderer(ptets.generate_tet_grid(8), max_tris=6144)
    jp, pp = jr.init_params_sphere(0.5), pr.init_params_sphere(0.5)
    np.testing.assert_array_equal(pp.sdf.numpy(), np.asarray(jp.sdf))
    H = W = 48
    jb = jdata.circle_view_batch(cfg, 1, 4, H, W)
    pb = pdata.circle_view_batch(port_cfg(cfg), 1, 4, H, W)

    def jalb(x):
        return jax.nn.sigmoid(3 * x + 0.5)

    def palb(x):
        return torch.sigmoid(3 * x + 0.5)

    light = np.array([0.3, 0.8, 0.52], np.float32)
    jo = jax.jit(lambda p: jr.render(
        p, jalb, jb.mvp[0], H, W, jb.rays_o[0], jb.rays_d[0],
        light_d=jnp.asarray(light), ambient_ratio=0.3, shading=shading,
        bg_color=jnp.asarray([0.2, 0.4, 0.9]), need_regularizers=True))(jp)
    po = pr.render(pp, palb, pb.mvp[0], H, W, pb.rays_o[0], pb.rays_d[0],
                   light_d=torch.from_numpy(light), ambient_ratio=0.3,
                   shading=shading, bg_color=torch.tensor([0.2, 0.4, 0.9]),
                   need_regularizers=True)
    for k in ("image", "depth", "weights_sum", "normal_image"):
        np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                   atol=1e-4, err_msg=k)
    assert 0.1 < float(po["weights_sum"].mean()) < 0.9
    for k in ("normal_loss", "lap_loss"):
        np.testing.assert_allclose(float(po[k]), float(jo[k]), rtol=1e-5)


def _trainers(tmp_path, grid, **kw):
    cfg = _cfg(tmp_path, **kw)
    g = JOracle(SDConfig(tiny=True, t_range=cfg.t_range),
                scene=cfg.oracle_scene)
    jt = JTrainer(cfg, tet_grid=grid, guidances={"oracle": g},
                  guidance_params={"oracle": {}},
                  embeddings={"oracle": jnp.zeros(())})
    pt = DMTetTrainer(port_cfg(cfg), "cpu",
                      tet_grid=ptets.generate_tet_grid(8))
    return cfg, jt, pt


def test_one_dmtet_step_matches_jax(tmp_path, grid, monkeypatch):
    STEP = 7
    cfg, jt, pt = _trainers(tmp_path, grid)
    assert cfg.h == cfg.w == 32 and cfg.t_range == (0.02, 0.5)
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0))
    # a surface off the lattice points: the sphere init puts sdf = 0 on
    # them, and the faces of the edges that meet there are degenerate
    pos, sdf = _geometry(grid, 3)
    geo = {"sdf": jnp.asarray(sdf),
           "deform": jnp.asarray(np.arctanh(np.clip(
               (pos - grid.vertices) * 2 * grid.resolution, -0.9, 0.9)))}
    params = {**js.params, "geo": geo}
    js = js.replace(step=jnp.asarray(STEP, jnp.int32), params=params,
                    ema_params=params)
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, {
        **js.params, "tet_scale": js.tet_scale}))
    js = js.replace(tet_scale=js.tet_scale)
    ps.tet_scale = sd.pop("tet_scale")
    ps.model.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = STEP
    np.testing.assert_array_equal(ps.tet_scale.numpy(),
                                  np.asarray(js.tet_scale))
    # the port lists every triangle of a tile, JAX its first 512, which the
    # step's one tile exceeds: JAX lists every one too
    uncut_jax_tile_cap(jt, pt, ps)

    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_dmtet_step_draws(cfg, base, STEP))

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["loss_sds"]), float(jm["loss_sds"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    assert 0 < int(pm["n_faces"]) < pt.dmtet_renderer.max_tris
    assert 512 < int(pm["tile_max"]) <= jt.dmtet_renderer.tile_cap
    names = [n for n, _ in ps.model.named_parameters()]
    jg = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    ema_j = params_from_jax(jax.tree.map(np.asarray, js2.ema_params))
    pparams = dict(ps.model.named_parameters())
    for name, grad in zip(names, pgrads):
        if not (name.startswith("geo.") or "triplanes" in name):
            continue
        ref = jg[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        assert clear.sum() > 0
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ps.ema_params[name].numpy()[clear],
                                   ema_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)


def test_lock_geo_pins_the_geometry(tmp_path, grid):
    _, _, pt = _trainers(tmp_path, grid, lock_geo=True)
    ps = pt.init_state(0)
    before = {n: p.detach().clone() for n, p in ps.model.named_parameters()}
    ema = {n: e.clone() for n, e in ps.ema_params.items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        m, grads = pt.run_step(ps, gen)
        assert bool(m["grad_ok"])
    after = dict(ps.model.named_parameters())
    for n in ("geo.sdf", "geo.deform"):
        assert torch.equal(after[n].detach(), before[n])
        assert torch.equal(ps.ema_params[n], ema[n])
    tri = "nerf.field.triplanes.0"
    assert not torch.equal(after[tri].detach(), before[tri])
    assert ps.step == 2


def test_mesh_init_refuses_an_index_out_of_range():
    """K9's kernel gathers the triangles' corners without a check, so
    ``signed_distance`` checks the indices first, on every device (the CPU
    twin would wrap a negative one); the mesh-file init goes through it."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    r = DMTetRenderer(ptets.generate_tet_grid(4), max_tris=64)
    for bad in ([[0, 1, 3]], [[0, -1, 2]]):
        with pytest.raises(ValueError, match="out of range"):
            signed_distance(torch.zeros(2, 3), torch.from_numpy(verts),
                            torch.tensor(bad, dtype=torch.int32))
        with pytest.raises(ValueError, match="out of range"):
            r.init_params_from_mesh(verts, np.array(bad, np.int32))
    assert r.init_params_from_mesh(verts, np.array([[0, 1, 2]])).sdf.shape \
        == r.verts.shape[:1]
