"""The run's end against the JAX package: the port's meshops copy
(marching cubes, clean, decimate, unwrap), the density-grid query, the
texture bake, the OBJ writer and reader, checkpoints, and a tiny two-stage
CLI run (oracle stage with --save_mesh, then --dmtet from its checkpoints).

Tolerances: meshops outputs identical (the same C++ source); the query's
float16 volume within one float16 ulp (fp32 sums in another order, then
one rounding); baked texels within 1/255 where both bakes cover (one uint8
rounding of the same albedo); checkpoints restore bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, finalize
from dreamfusion_tpu.guidance.oracle import PixelOracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig
from dreamfusion_tpu.mesh import export as jexport
from dreamfusion_tpu.native import meshops as jmeshops
from dreamfusion_tpu_torch.main import main
from dreamfusion_tpu_torch.mesh import export as pexport
from dreamfusion_tpu_torch.native import meshops as pmeshops
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax
from dreamfusion_tpu_torch.utils.image import decode_png

from torch_parity import port_cfg

torch.set_num_threads(2)


def _sphere_field(R=40):
    ax = np.linspace(-1, 1, R, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 20.0 * (0.6 - np.sqrt(X ** 2 + (1.3 * Y) ** 2 + Z ** 2))


def test_meshops_copy_gives_the_jax_packages_meshes():
    field = _sphere_field()
    outs = []
    for m in (jmeshops, pmeshops):
        v, t = m.marching_cubes(field, 0.0)
        vc, tc = m.clean_mesh(v / 39 * 2 - 1, t, weld_eps=1e-4, min_faces=8,
                              min_frac=0.02)
        vd, td = m.decimate_mesh(vc, tc, 500)
        outs.append((v, t, vc, tc, vd, td, *m.unwrap_uv(vd, td, 256)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert 400 <= len(outs[1][5]) <= 600 and len(outs[1][1]) > 2000


def _pair(tmp_path, plane_scale=1.0):
    """A JAX trainer and state with its parameters in a port trainer (the
    triplanes scaled by ``plane_scale``)."""
    cfg = finalize(Config(
        guidance=("oracle",), workspace=str(tmp_path / "ws"),
        backbone="triplane", w=16, h=16, iters=10, triplane_resolution=32,
        triplane_channels=8, hidden_dim=32, num_layers=3, grid_size=30,
        fp16=False, seed=0, eval_interval=-1, use_tensorboard=False,
        lambda_3d_normal_smooth=0.0, blob_density=10.0, blob_radius=0.5))
    g = JOracle(SDConfig(tiny=True), scene=cfg.oracle_scene)
    jt = jtrainer.Trainer(cfg, guidances={"oracle": g},
                          guidance_params={"oracle": {}},
                          embeddings={"oracle": jnp.zeros(())})
    js = jt.init_state(jax.random.PRNGKey(0))
    field = dict(js.params["field"])
    field["triplanes"] = [p * plane_scale for p in field["triplanes"]]
    params = {**js.params, "field": field}
    js = js.replace(params=params, ema_params=params)
    pt = Trainer(port_cfg(cfg), "cpu")
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    return jt, js, pt, ps


def test_query_grid_matches_jax(tmp_path):
    jt, js, pt, ps = _pair(tmp_path)
    jv = jexport.query_grid(jt, js, resolution=24, chunk=4096)
    pv = pexport.query_grid(pt, ps, resolution=24, chunk=4096)
    assert pv.dtype == np.float32 and pv.shape == (24, 24, 24)
    assert (pv > 10).any() and (pv < 10).any()
    np.testing.assert_allclose(pv, jv, rtol=2 ** -10, atol=0)


def test_bake_texture_matches_jax(tmp_path):
    jt, js, pt, ps = _pair(tmp_path, plane_scale=30.0)
    v, t = pmeshops.marching_cubes(_sphere_field(24), 0.0)
    v = (v / 23 * 2 - 1).astype(np.float32)
    v, t = pmeshops.decimate_mesh(*pmeshops.clean_mesh(v, t, 1e-4), 300)
    v, t, uv, _ = pmeshops.unwrap_uv(v, t, 64)
    jtex = jexport.bake_texture(jt, js, v, t, uv, tex_res=64)
    ptex = pexport.bake_texture(pt, ps, v, t, uv, tex_res=64)
    assert ptex.shape == (64, 64, 3)
    np.testing.assert_allclose(ptex, jtex, atol=1 / 255 + 1e-6)
    assert jtex.std() > 0.05


def test_obj_round_trip(tmp_path):
    v, t = pmeshops.marching_cubes(_sphere_field(16), 0.0)
    v, t, uv, _ = pmeshops.unwrap_uv(v.astype(np.float32), t, 64)
    tex = np.random.default_rng(0).uniform(size=(64, 64, 3))
    path = str(tmp_path / "m" / "mesh.obj")
    pexport.write_obj(path, v, t, uv=uv, texture=tex)
    rv, rt, ruv, rtex = pexport.read_obj(path)
    np.testing.assert_allclose(rv, v, atol=1e-6)
    np.testing.assert_array_equal(rt, t)
    np.testing.assert_allclose(ruv, uv, atol=1e-6)
    assert rtex == str(tmp_path / "m" / "mesh_albedo.png")
    with open(rtex, "rb") as f:
        png = decode_png(f.read())
    np.testing.assert_array_equal(png, (tex * 255).astype(np.uint8))
    # the JAX package reads the port's files
    jv, jt_, juv, _ = jexport.read_obj(path)
    np.testing.assert_array_equal(jt_, t)


def test_checkpoints_restore_the_state_and_best_keeps_the_better(tmp_path):
    cfg = port_cfg(finalize(Config(
        guidance=("oracle",), workspace=str(tmp_path / "ws"),
        backbone="triplane", w=8, h=8, triplane_resolution=16,
        triplane_channels=4, hidden_dim=16, grid_size=16,
        dataset_size_train=2, max_keep_ckpt=2, fp16=False,
        lambda_3d_normal_smooth=0.0)))
    tr = Trainer(cfg, "cpu")
    st = tr.init_state(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for _ in range(2):
            tr.run_step(st, gen)
        tr.save_checkpoint(st)
    names = sorted(os.listdir(tmp_path / "ws" / "checkpoints"))
    assert names == ["df_ep0002.meta.json", "df_ep0002.pth",
                     "df_ep0003.meta.json", "df_ep0003.pth"]
    ref = tr._payload(st)
    tr2 = Trainer(cfg, "cpu")
    st2, ok = tr2.load_checkpoint(tr2.init_state(1), "latest")
    assert ok and st2.step == 6
    got = tr2._payload(st2)
    for k in ("module", "ema", "extra"):
        for n in ref[k]:
            assert torch.equal(ref[k][n], got[k][n]), (k, n)
    for n in ("m", "diff", "n", "prev_grad"):
        for a, b in zip(ref["opt"][n], got["opt"][n]):
            assert torch.equal(a, b)
    assert torch.equal(ref["opt"]["count"], got["opt"]["count"])

    # the EMA-only df snapshot keeps the better eval metric
    tr.save_checkpoint(st, full=False, metric=20.0)
    best = {k: v.clone() for k, v in st.ema_params.items()}
    tr.run_step(st, gen)
    tr.save_checkpoint(st, full=False, metric=10.0)      # worse: kept
    tr3 = Trainer(cfg, "cpu")
    st3, ok = tr3.load_checkpoint(tr3.init_state(2), "best")
    assert ok and tr3.best_result == 20.0
    for n, p in st3.renderer.named_parameters():
        assert torch.equal(p.detach(), best[n])
        assert torch.equal(st3.ema_params[n], best[n])
    tr.save_checkpoint(st, full=False, metric=30.0)      # better: replaced
    st4, _ = tr3.load_checkpoint(tr3.init_state(2), "best")
    assert tr3.best_result == 30.0
    assert torch.equal(st4.ema_params["field.triplanes.0"],
                       st.ema_params["field.triplanes.0"])


def _outputs_of(ws):
    v = os.listdir(os.path.join(ws, "validation"))
    r = os.listdir(os.path.join(ws, "results"))
    assert any(n.endswith("_rgb.png") for n in v), v
    assert "df_rgb.mp4" in r or "df_rgb_0000.png" in r, r
    verts, tris, uv, tex = pexport.read_obj(os.path.join(ws, "mesh",
                                                         "mesh.obj"))
    assert len(tris) > 0 and uv is not None and os.path.exists(tex)
    return len(tris)


def test_two_stage_cli_run(tmp_path):
    _two_stage(tmp_path, ["--backbone", "triplane", "--triplane_resolution",
                          "32", "--triplane_channels", "8"])


def test_two_stage_cli_run_grid_backbone(tmp_path):
    """Stage 1 and the DMTet stage on the hash grid (K6's plain version)."""
    s1, s2 = _two_stage(tmp_path, [
        "--backbone", "grid", "--grid_log2_hashmap_size", "12",
        "--grid_desired_resolution", "128"])
    assert all(g > 0 for g in s1["grid_grad_max"])
    assert all(g > 0 for g in s2["grid_grad_max"])


def _two_stage(tmp_path, model_flags):
    common = ["--guidance", "oracle", *model_flags,
              "--hidden_dim", "32", "--grid_size", "32", "--H", "24",
              "--W", "24", "--dataset_size_test", "3", "--device", "cpu",
              "--lambda_3d_normal_smooth", "0", "--ckpt", "scratch",
              "--save_mesh", "--seed", "0", "--decimate_target", "2000"]
    ws1, ws2 = str(tmp_path / "stage1"), str(tmp_path / "stage2")
    s1 = main(common + ["--workspace", ws1, "--iters", "40", "--w", "16",
                        "--h", "16", "--dataset_size_train", "20", "--lr",
                        "0.01", "--mcubes_resolution", "48"])
    assert s1["grad_ok"] and s1["all_losses_finite"]
    assert s1["mesh_path"].endswith("mesh.obj")
    assert set(s1["export_phases"]) >= {"query", "mc", "unwrap_uv",
                                        "bake_texture", "write"}
    _outputs_of(ws1)
    assert sorted(os.listdir(os.path.join(ws1, "checkpoints")))[0] == \
        "df.meta.json"
    s2 = main(common + ["--workspace", ws2, "--iters", "4", "--w", "4",
                        "--h", "4", "--dataset_size_train", "2", "--lr",
                        "0.002", "--dmtet", "--init_with",
                        os.path.join(ws1, "checkpoints"), "--tet_grid_size",
                        "16"])
    assert s2["grad_ok"] and s2["all_losses_finite"]
    assert all(0 < n < s2["max_tris"] for n in s2["n_faces"])
    assert all(g > 0 for g in s2["sdf_grad_max"] + s2["deform_grad_max"])
    assert "dmtet" in s2["export_phases"]
    _outputs_of(ws2)
    return s1, s2


def test_test_mode_renders_from_the_checkpoint(tmp_path):
    """``--test`` trains nothing: it resumes the newest checkpoint and
    renders; with ``--six_views`` the six axis views as PNGs."""
    ws = str(tmp_path / "ws")
    common = ["--guidance", "oracle", "--backbone", "triplane",
              "--triplane_resolution", "16", "--triplane_channels", "4",
              "--hidden_dim", "16", "--grid_size", "16", "--w", "8", "--h",
              "8", "--H", "16", "--W", "16", "--dataset_size_train", "2",
              "--dataset_size_test", "2", "--device", "cpu",
              "--lambda_3d_normal_smooth", "0", "--workspace", ws]
    main(common + ["--iters", "4", "--ckpt", "scratch", "--eval_interval",
                   "0"])
    out = main(common + ["--iters", "4", "--test", "--six_views"])
    assert set(out["phases"]) == {"test"} and "losses" not in out
    names = sorted(os.listdir(os.path.join(ws, "results")))
    assert [f"df_{i:04d}_rgb.png" for i in range(6)] == \
        [n for n in names if n.startswith("df_0")]
    with open(os.path.join(ws, "log_df.txt")) as f:
        assert "[ckpt] resumed from step 4" in f.read()
