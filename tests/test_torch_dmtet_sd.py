"""The DMTet stage under SD guidance against the JAX package, the DMTet
face cap, and the port's flagship script.

One tiny DMTet SD step (tiny SD 2.1 towers holding the same weights, the
render at the VAE's own size, so the resize is the identity) against the
jitted JAX ``DMTetTrainer`` step with the same parameters and draws; the
CLI at tiny size, with and without Perp-Neg and from an oracle stage 1;
the marching tets' true face count and K7's fullest tile in the plain
versions; the caps sized from the init surface (the faces equal to JAX's
marching tets at the chosen cap) and grown when the surface outgrows them
mid-run; ``run_flagship``'s mode → flags mapping.

Tolerances: as tests/test_torch_dmtet.py's step, loss 1e-5 rel, gradients
rtol 1e-4 with a floor of 1e-4 of each tensor's largest entry, updated
parameters and EMA 1e-5 where the gradient is clearly nonzero; faces,
masks and counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_dmtet, finalize
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.ops import marching_tets as jmt
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JTrainer
from dreamfusion_tpu_torch import run_flagship
from dreamfusion_tpu_torch.guidance.embeddings import prepare_text_embeddings
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.main import build_parser, config_from_args, main
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.models.dmtet import DMTetParams
from dreamfusion_tpu_torch.ops import marching_tets as pmt
from dreamfusion_tpu_torch.ops import raster as K7
from dreamfusion_tpu_torch.training.dmtet_trainer import (DMTetTrainer,
                                                          face_cap)
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import (jax_dmtet_step_draws, port_cfg, random_flax_params,
                          uncut_jax_tile_cap)

torch.set_num_threads(2)
TINY = dict(tiny=True, image_size=16, latent_size=8)


def _cfg(tmp_path, **kw):
    """A tiny DMTet SD run: the 2² training size times the preset's 8 is
    the tiny VAE's 16²."""
    base = dict(text="a hamburger", guidance=("SD",),
                workspace=str(tmp_path / "ws"), backbone="triplane", w=2,
                h=2, iters=100, batch_size=1, triplane_resolution=32,
                triplane_channels=8, hidden_dim=32, num_layers=3,
                fp16=False, seed=0, eval_interval=-1, tet_grid_size=12,
                lambda_3d_normal_smooth=0.0, use_tensorboard=False, lr=2e-3)
    base.update(kw)
    return finalize(apply_dmtet(Config(**base)))


def _geometry(grid, seed):
    """A lumpy sphere sdf (no exact zeros) and a small deformation."""
    rng = np.random.default_rng(seed)
    v = grid.vertices
    sdf = np.clip((0.55 - np.linalg.norm(v, axis=-1) + 0.05 * np.sin(
        5 * v[:, 0]) * np.cos(4 * v[:, 1])).astype(np.float32) * 4, -1, 1)
    sdf[np.abs(sdf) < 1e-4] = 1e-3
    pos = (v + rng.normal(scale=0.02, size=v.shape)).astype(np.float32)
    return pos, sdf


def test_one_dmtet_sd_step_matches_jax(tmp_path, monkeypatch):
    """One DMTet step under SD (the VAE encode of the 16² raster render with
    gradient, the UNet at CFG) against the jitted JAX step."""
    STEP = 7
    cfg = _cfg(tmp_path)
    assert cfg.h == cfg.w == 16 and cfg.t_range == (0.02, 0.5)
    assert cfg.latent_iter_ratio == 0.0
    grid = jtets.generate_tet_grid(8)
    jg = JSD(JSDConfig(t_range=cfg.t_range, **TINY))
    zeros = jnp.zeros
    jp = {"unet": random_flax_params(jg.unet.init, zeros((1, 8, 8, 4)),
                                     zeros((1,)), zeros((1, 16, 32)), seed=7),
          "vae": random_flax_params(jg.vae.init, zeros((1, 16, 16, 3)),
                                    jax.random.PRNGKey(1), seed=8),
          "text": random_flax_params(jg.text_encoder.init,
                                     zeros((1, 16), jnp.int32), seed=9)}
    pg = StableDiffusionGuidance(SDConfig(t_range=cfg.t_range, **TINY), "cpu")
    pg.load_state_dicts(params_from_jax(jax.tree.map(np.asarray, jp)))
    emb = prepare_text_embeddings(pg, cfg.text, "")
    jemb = {k: jnp.asarray(v.numpy()) for k, v in emb.items()}
    jt = JTrainer(cfg, tet_grid=grid, guidances={"SD": jg},
                  guidance_params={"SD": jp}, embeddings={"SD": jemb})
    pt = DMTetTrainer(port_cfg(cfg), "cpu", pg, emb,
                      tet_grid=ptets.generate_tet_grid(8))
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0))
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
    ps.tet_scale = sd.pop("tet_scale")
    ps.model.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = STEP
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
    draws = jax_dmtet_step_draws(cfg, base, STEP, latent_size=8)
    assert draws.posterior_noise.shape == (1, 8, 8, 4)
    pm, pgrads = pt.train_step(ps, draws)

    for k in ("loss", "loss_sds"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    assert int(pm["n_faces"]) == int(pm["n_faces_true"]) > 0
    assert 512 < int(pm["tile_max"]) <= jt.dmtet_renderer.tile_cap
    names = [n for n, _ in ps.model.named_parameters()]
    jgr = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    ema_j = params_from_jax(jax.tree.map(np.asarray, js2.ema_params))
    pparams = dict(ps.model.named_parameters())
    for name, grad in zip(names, pgrads):
        if not (name.startswith("geo.") or "triplanes" in name):
            continue
        ref = jgr[name].numpy()
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


TINY_FLAGS = ["--backbone", "triplane", "--seed", "0",
              "--lambda_3d_normal_smooth", "0", "--dmtet", "--tet_grid_size",
              "16", "--w", "2", "--h", "2", "--triplane_resolution", "32",
              "--triplane_channels", "8", "--grid_size", "32",
              "--hidden_dim", "32", "--dataset_size_train", "1",
              "--dataset_size_test", "2", "--H", "16", "--W", "16",
              "--lr", "0.002", "--device", "cpu", "--ckpt", "scratch"]


@pytest.mark.parametrize("init", ["sphere", "perpneg", "oracle stage 1"])
def test_cli_runs_dmtet_under_sd_on_the_cpu(tmp_path, init):
    """``--text … --dmtet --tiny_guidance`` through the entry point, from
    the sphere init (with Perp-Neg too), or from an oracle stage 1's
    checkpoint (its field has no background MLP; two steps leave it no
    surface): the towers are built, the steps are finite, the surface and
    K7's tiles are reported and nothing is dropped."""
    extra = ["--perpneg"] if init == "perpneg" else []
    if init == "oracle stage 1":
        s1 = str(tmp_path / "s1")
        main(["--guidance", "oracle", "--iters", "2", "--workspace", s1] +
             [f for f in TINY_FLAGS if f != "--dmtet"])
        extra = ["--init_with", s1 + "/checkpoints"]
    out = main(["--text", "a hamburger", "--iters", "2", "--workspace",
                str(tmp_path / "ws"), "--tiny_guidance"] + TINY_FLAGS + extra)
    assert out["grad_ok"] and out["all_losses_finite"]
    assert len(out["losses"]) == 2 and out["steps_run"] == 2
    assert out["n_faces"] == out["n_faces_true"]
    assert out["faces_dropped_steps"] == [] and out["faces_dropped"] == 0
    assert out["max_tris_at"] == [out["max_tris"]] * 2
    assert out["tile_cut_steps"] == [] and out["tile_cap"] >= max(
        out["tile_max"])
    log = (tmp_path / "ws" / "log_df.txt").read_text()
    assert "SD 2.1 guidance (tiny" in log and "DMTet state" in log
    if init == "oracle stage 1":
        assert "loaded the stage-1 field" in log
        return
    assert out["n_faces"][0] > 0
    assert all(0 < t <= out["n_faces"][0] for t in out["tile_max"])
    assert all(g > 0 for g in out["sdf_grad_max"])


def test_true_face_count_and_fullest_tile():
    """The plain marching tets count every face of the surface, also past
    max_tris (JAX's mask before its cut); the plain raster reports the most
    triangles whose box touches each tile, also past tile_cap."""
    grid = jtets.generate_tet_grid(8)
    pos, sdf = _geometry(grid, 1)
    t = torch.from_numpy
    full = jmt.marching_tets(jnp.asarray(pos), jnp.asarray(sdf),
                             jnp.asarray(grid.indices),
                             jnp.asarray(grid.tet_edges),
                             jnp.asarray(grid.unique_edges), 6144)
    n = int(np.asarray(full.face_mask).sum())
    for cap in (6144, 200):
        m = pmt.marching_tets(t(pos), t(sdf), t(grid.indices),
                              t(grid.tet_edges), t(grid.unique_edges), cap)
        assert int(m.n_faces) == n and int(m.face_mask.sum()) == min(n, cap)
    # the fullest tile: the boxes of the surface, a 64² view in 16² tiles
    rng = np.random.default_rng(0)
    V, T = 60, 90
    sx, sy = (t(rng.uniform(0, 64, V).astype(np.float32)) for _ in range(2))
    sz = t(rng.uniform(-0.5, 0.5, V).astype(np.float32))
    faces = t(rng.integers(0, V, (T, 3)).astype(np.int32))
    valid = torch.ones(T, dtype=torch.bool)
    _, _, _, _, bmin, bmax = K7._face_coeffs(sx, sy, sz, faces.long())
    want = K7.tile_overlap(bmin, bmax, valid, 64, 64, 16, 1.0).sum(1)
    for cap in (T, 8):
        out = K7.raster_plain(sx, sy, sz, faces, valid, 64, 64, 16, cap)
        assert torch.equal(out.tile_counts, want.to(torch.int32))
    assert int(want.max()) > 8


def test_face_cap_follows_the_init_surface(tmp_path, monkeypatch):
    """An init surface above JAX's fixed cap (8·size² at tet grid 24,
    raised to JAX's floor 2^13) keeps every face: the cap is sized from
    it, and the port's faces equal JAX's marching tets run at that cap;
    a surface under half of JAX's cap keeps JAX's cap."""
    cfg = _cfg(tmp_path, guidance=("oracle",), oracle_scene="two_sphere",
               tet_grid_size=24)
    grid = jtets.generate_tet_grid(12)
    pt = DMTetTrainer(port_cfg(cfg), "cpu",
                      tet_grid=ptets.generate_tet_grid(12))
    dmr = pt.dmtet_renderer
    jax_cap = max(1 << 13, 8 * 24 ** 2)
    assert face_cap(jax_cap // 2, 24, grid.num_tets) == jax_cap
    assert face_cap(jax_cap // 2 + 1, 24, grid.num_tets) == 2 * jax_cap
    assert dmr.tile_cap == K7.MAX_TILE_CAP == 65535
    # a surface through most tets: random signs at the grid's vertices
    sdf = np.random.default_rng(5).choice([-0.5, 0.5], len(grid.vertices))
    geo = DMTetParams(torch.from_numpy(sdf.astype(np.float32)),
                      torch.zeros(len(grid.vertices), 3), torch.ones(3))
    monkeypatch.setattr(dmr, "init_params_sphere", lambda radius: geo)
    state = pt.init_state(0)
    mesh = dmr.extract_mesh(pt.geo_params(state.model, state.tet_scale))
    n = int(mesh.n_faces)
    assert n > jax_cap and dmr.max_tris == min(1 << (2 * n - 1).bit_length(),
                                               2 * grid.num_tets)
    assert int(mesh.face_mask.sum()) == n
    jm = jmt.marching_tets(jnp.asarray(grid.vertices), jnp.asarray(sdf),
                           jnp.asarray(grid.indices),
                           jnp.asarray(grid.tet_edges),
                           jnp.asarray(grid.unique_edges), dmr.max_tris)
    np.testing.assert_array_equal(mesh.faces.numpy(), np.asarray(jm.faces))
    np.testing.assert_array_equal(mesh.face_mask.numpy(),
                                  np.asarray(jm.face_mask))
    # JAX's own cap would have dropped the rest
    jm = jmt.marching_tets(jnp.asarray(grid.vertices), jnp.asarray(sdf),
                           jnp.asarray(grid.indices),
                           jnp.asarray(grid.tet_edges),
                           jnp.asarray(grid.unique_edges), jax_cap)
    assert int(np.asarray(jm.face_mask).sum()) == jax_cap < n


def test_caps_grow_when_the_surface_outgrows_them(tmp_path, monkeypatch):
    """Caps below the surface (max_tris 64 and tile_cap 8 here): the steps
    before each log step drop faces or cut a tile's list, each log step
    says so and doubles max_tris (tile_cap is the kernel's most, so it
    stays), and the summary names every step that dropped faces (and how
    many) or cut a tile's list."""
    monkeypatch.setattr(DMTetTrainer, "_face_cap", lambda self, n: 64)
    fit = DMTetTrainer.fit_caps

    def fit_small(self, geo):
        fit(self, geo)
        self.dmtet_renderer.tile_cap = 8

    monkeypatch.setattr(DMTetTrainer, "fit_caps", fit_small)
    flags = list(TINY_FLAGS)
    flags[flags.index("--dataset_size_train") + 1] = "2"   # a log each 2
    out = main(["--guidance", "oracle", "--oracle_scene", "two_sphere",
                "--iters", "6", "--workspace", str(tmp_path / "ws")] + flags)
    true = out["n_faces_true"]
    assert all(256 < n <= 512 for n in true), true
    assert out["max_tris_at"] == [64, 64, 128, 128, 256, 256]
    assert out["max_tris"] == 512
    assert out["faces_dropped_steps"] == list(range(6))
    assert out["faces_dropped"] == sum(n - c for n, c in zip(
        true, out["max_tris_at"]))
    assert out["n_faces"] == out["max_tris_at"]
    assert all(t > 8 for t in out["tile_max"]), out["tile_max"]
    assert out["tile_cap"] == 8 and out["tile_cut_steps"] == list(range(6))
    log = (tmp_path / "ws" / "log_df.txt").read_text()
    for step, cap in ((2, 128), (4, 256), (6, 512)):
        assert f"faces dropped before step {step}" in log
        assert f"max_tris {cap} from step {step} on" in log
        assert f"tile lists cut before step {step}" in log
    assert "6 steps dropped" in log and "6 steps cut a tile's list" in log


@pytest.mark.parametrize("mode,argv,want", [
    ("oracle", ["--oracle"], ["--guidance", "oracle", "--oracle_scene",
                              "two_sphere", "--guidance_scale", "1.0",
                              "--lr", "0.01"]),
    ("sd", [], ["--text", run_flagship.TEXT]),
    ("perpneg", ["--mode", "perpneg"], ["--text", run_flagship.TEXT,
                                        "--perpneg", "--fp16", "true"]),
    ("image_oracle", ["--mode", "image_oracle"],
     ["--image", "analytic:two_sphere", "--guidance", "image_oracle",
      "--guidance_scale", "1.0", "--lr", "0.01"]),
    ("dmtet_oracle", ["--mode", "dmtet_oracle", "--init_with", "ck"],
     ["--dmtet", "--init_with", "ck", "--guidance", "oracle",
      "--oracle_scene", "two_sphere", "--guidance_scale", "1.0", "--lr",
      "0.002"]),
    ("dmtet_sd", ["--mode", "dmtet_sd", "--init_with", "ck"],
     ["--dmtet", "--init_with", "ck", "--text", run_flagship.TEXT, "--lr",
      "0.002"]),
    ("if", ["--mode", "if"], ["--text", run_flagship.TEXT, "--IF", "--fp16",
                              "true"]),
])
def test_flagship_script_modes(mode, argv, want):
    """Each mode's ``main`` flags: the JAX script's common flags, then the
    mode's (no run); ``if`` parses to IF guidance at fp16 with no warm-up
    (its full-width run is the card's: chip_smoke.py)."""
    args, extra = run_flagship.build_parser().parse_known_args(
        argv + ["--iters", "7", "--device", "cpu"])
    assert run_flagship.run_name(args) == mode
    flags = run_flagship.main_flags(args, extra)
    assert flags[:4] == ["--iters", "7", "--workspace",
                         str(run_flagship.ROOT) + f"/build/runs/{mode}"]
    assert flags[4:-2][-len(want):] == want and flags[-2:] == ["--device",
                                                              "cpu"]
    assert "--save_mesh" in flags and "--dataset_size_test" in flags
    if mode == "if":
        cfg = config_from_args(build_parser().parse_args(flags))
        assert cfg.guidance == ("IF",) and cfg.fp16
        assert cfg.latent_iter_ratio == 0.0
    if mode.startswith("dmtet"):
        args.init_with = ""
        with pytest.raises(ValueError, match="needs --init_with"):
            run_flagship.main_flags(args)
