"""The image-conditioned pipeline against the JAX package: each piece
(``scene_views_full``, ``default_view_batch``, ``progressive_view_ranges``,
``pose_angle_grad_scale``, the image oracle's ``sds_loss_rays_pose``,
``masked_pearson``, K5's clamped gradient and the renderer's normal-perturb
loss with its gradient), then whole steps from the same parameters with the
JAX step's own random draws: one image-oracle SDS step (progressive view,
the 3-D normal smoothness and ``--grad_clip_rgb``), known-view steps on the
triplane and on the hash grid, and one known-view DMTet step at tet grid 16.

Tolerances: the analytic views, the known-view cameras and the reference
images 1e-5; the ranges 1e-6; the pose-angle scale 1e-5 rel (1e-4 abs:
arccos near 1 loses digits); SDS loss and image gradient 1e-5 rel; Pearson
1e-5; the clamp exact (NaN where NaN); the normal-perturb loss 1e-4 rel and
its gradients rtol 1e-4 with a floor of 1e-4 of each tensor's largest entry
(of 1e-3 of the largest of all for a tensor whose gradient is rounding
noise), with two samples' encoder entries exempt (see WHOLE below); the
whole steps as tests/test_torch_slice.py: loss 1e-5 rel, gradients as
above, updated parameters and EMA 1e-5 where the gradient is clearly
nonzero.  The known view is 24², grid_size 30 (probe midpoints off the
cell boundaries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_dmtet, apply_image_mode, \
    finalize
from dreamfusion_tpu.core.math import clip_grad as j_clip_grad
from dreamfusion_tpu.evaluation.analytic import scene_views_full as j_views
from dreamfusion_tpu.guidance.oracle import ImageOracleGuidance as JImage
from dreamfusion_tpu.guidance.sd import SDConfig
from dreamfusion_tpu.guidance.zero123 import \
    pose_angle_grad_scale as j_angle_scale
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.models.renderer import RenderFlags as JFlags
from dreamfusion_tpu.training import data as jdata
from dreamfusion_tpu.training import schedules as jsched
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JDMTet
from dreamfusion_tpu.training.image_data import \
    analytic_ref_images as j_ref_images
from dreamfusion_tpu.training.image_data import masked_pearson as j_pearson
from dreamfusion_tpu_torch.evaluation.analytic import scene_views_full
from dreamfusion_tpu_torch.guidance.oracle import ImageOracleGuidance
from dreamfusion_tpu_torch.guidance.zero123 import pose_angle_grad_scale
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.models.renderer import RenderFlags
from dreamfusion_tpu_torch.ops.clip_grad import clip_grad
from dreamfusion_tpu_torch.training import data as pdata
from dreamfusion_tpu_torch.training import schedules as psched
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
from dreamfusion_tpu_torch.training.image_data import (RefImages,
                                                       analytic_ref_images,
                                                       masked_pearson)
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from test_torch_dmtet import _geometry
from torch_parity import (jax_dmtet_known_view_draws, jax_dmtet_step_draws,
                          jax_grid_draws, jax_known_view_draws,
                          jax_render_keys, jax_step_draws, port_cfg, tt,
                          uncut_jax_tile_cap)

torch.set_num_threads(2)
STEP = 48
# the triplane entries one sample touches: 4 texels x 3 planes x 8 channels
TIE_ENTRIES = 4 * 3 * 8


def _close(a, b, rtol=1e-6, atol=1e-6, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, **kw)


def _image_cfg(tmp_path, dmtet=False, **kw):
    base = dict(guidance=("image_oracle",), image="analytic:two_sphere",
                workspace=str(tmp_path / "ws"), w=16, h=16, iters=400,
                batch_size=1, triplane_resolution=32, triplane_channels=8,
                triplane_scales=2, hidden_dim=32, num_layers=3, grid_size=30,
                grid_coarse_steps=24, grid_fine_steps=24, fp16=False, seed=0,
                eval_interval=-1, use_tensorboard=False, guidance_scale=1.0,
                lr=1e-2, backbone="triplane")
    base.update(kw)
    cfg = apply_image_mode(Config(**base))
    if "lambda_3d_normal_smooth" in kw:      # past the preset's 10
        cfg = dataclasses.replace(
            cfg, lambda_3d_normal_smooth=kw["lambda_3d_normal_smooth"])
    return finalize(apply_dmtet(cfg) if dmtet else cfg)


# The normal-perturb loss is an unweighted mean of |n - n2| over every
# sample, empty space included, and far more sensitive to the samples'
# positions than the weighted terms: the JAX step under jit (fused
# multiply-adds) and the same JAX render run eagerly differ by 7e-5 in it on
# the grid.  The triplane's normal (-∇σ of a bilinear field) jumps at cell
# boundaries, so a position that rounds 1 ulp apart moves a sample's normal
# by O(1); the hash grid's normal drops to 0 outside the box, where the
# perturbed query of a sample near a box face can land on either side.  So
# the whole steps run with its weight 0, and the term is checked alone on
# the triplane (the image run's backbone) against the eager JAX render in
# the march's mask mode (no resampled CDF to round apart), allowing two
# samples whose normal jumps: the loss to 1e-4 (one sample is 2.4e-5 of the
# mean of 24²·24·3 terms) and those samples' entries of the planes'
# gradient.  The grid's whole steps march in mask mode, where its resampled
# CDF rounds apart.
GRID = dict(backbone="grid", grid_levels=4, grid_features_per_level=8,
            grid_log2_hashmap_size=12, grid_desired_resolution=128)
WHOLE = {"triplane": dict(lambda_3d_normal_smooth=0.0),
         "grid": dict(GRID, lambda_3d_normal_smooth=0.0,
                      lambda_2d_normal_smooth=0.5, occupancy_mode="mask"),
         # a reference normal image and its loss (known-view step only)
         "normal": dict(lambda_3d_normal_smooth=0.0, lambda_normal=2.0,
                        ref_normals=True)}


def _port_ref(ref) -> RefImages:
    """The JAX reference images as the port's (the same arrays)."""
    return RefImages(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(RefImages)})


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["sphere", "two_sphere"])
def test_scene_views_full_matches_jax(scene):
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(4000, 3)).astype(np.float32)
    ro = ro / np.linalg.norm(ro, axis=-1, keepdims=True) * 3.2
    rd = (-ro + rng.normal(scale=0.6, size=ro.shape)).astype(np.float32)
    jo = j_views(jnp.asarray(ro), jnp.asarray(rd), scene)
    po = scene_views_full(torch.from_numpy(ro), torch.from_numpy(rd), scene)
    np.testing.assert_array_equal(po[1].numpy(), np.asarray(jo[1]))
    assert 0.1 < float(po[1].float().mean()) < 0.9
    for a, b in zip(po[:1] + po[2:], jo[:1] + jo[2:]):
        _close(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_default_view_batch_and_reference_images_match_jax(tmp_path):
    cfg = _image_cfg(tmp_path)
    refs = ((3.2, 3.0), (90.0, 60.0), (0.0, 45.0))
    jb = jdata.default_view_batch(cfg, *refs, cfg.h, cfg.w)
    pb = pdata.default_view_batch(port_cfg(cfg), *refs, cfg.h, cfg.w)
    assert pb.rays_o.shape == (2, 24 * 24, 3)
    for k in ("rays_o", "rays_d", "mvp", "delta_polar", "delta_azimuth",
              "delta_radius"):
        _close(getattr(pb, k).numpy(), getattr(jb, k), rtol=1e-5,
               atol=1e-5, err_msg=k)
    jr = j_ref_images(cfg, cfg.h, cfg.w, "two_sphere")
    pr = analytic_ref_images(port_cfg(cfg), cfg.h, cfg.w, "two_sphere")
    np.testing.assert_array_equal(pr.mask, jr.mask)
    _close(pr.rgb, jr.rgb, rtol=1e-5, atol=1e-5)
    _close(pr.depth, jr.depth, rtol=1e-5, atol=1e-5)
    assert pr.normal is None and pr.radii == jr.radii


@pytest.mark.parametrize("r_exp", [0.0, 0.1, 0.3, 0.7])
def test_progressive_view_ranges_match_jax(tmp_path, r_exp):
    cfg = _image_cfg(tmp_path)
    j = jsched.progressive_view_ranges(cfg, jnp.float32(r_exp))
    p = psched.progressive_view_ranges(port_cfg(cfg), r_exp)
    for a, b in zip(p, j):
        _close(a, [float(x) for x in b], rtol=1e-6)
    assert p[2] == ((-180.0, 180.0) if r_exp >= 0.4 else p[2])


@pytest.mark.parametrize("K", [1, 3])
def test_pose_angle_grad_scale_matches_jax(K):
    rng = np.random.default_rng(K)
    refs = [rng.uniform(60, 120, K), rng.uniform(-180, 180, K),
            rng.uniform(3.0, 3.5, K)]
    refs = [r.astype(np.float32) for r in refs]
    deltas = [rng.uniform(-40, 40, 6), rng.uniform(-180, 180, 6),
              rng.uniform(-0.2, 0.3, 6)]
    deltas = [d.astype(np.float32) for d in deltas]
    jg, ja = j_angle_scale(*map(jnp.asarray, refs + deltas), "angle", 2.0, 6)
    pg, pa = pose_angle_grad_scale(*map(torch.from_numpy, refs + deltas),
                                   "angle", 2.0, 6)
    _close(pa.numpy(), ja, rtol=1e-5, atol=1e-3)
    _close(pg.numpy(), jg, rtol=1e-5, atol=1e-4)
    ones, _ = pose_angle_grad_scale(*map(torch.from_numpy, refs + deltas),
                                    "None", 2.0, 6)
    assert torch.equal(ones, torch.ones(6))


def test_image_oracle_sds_matches_jax(tmp_path):
    """Loss and gradient into the rendered image, with JAX's t and noise."""
    cfg = _image_cfg(tmp_path)
    B, H, W = 2, 16, 16
    rng = np.random.default_rng(0)
    jg = JImage(SDConfig(tiny=True, t_range=cfg.t_range), scene="two_sphere")
    pg = ImageOracleGuidance("two_sphere", cfg.t_range)
    jb = jdata.default_view_batch(cfg, (3.2, 3.4), (70.0, 100.0),
                                  (30.0, -120.0), H, W)
    pred = rng.uniform(size=(B, 24, 24, 3)).astype(np.float32)
    bg = rng.uniform(size=3).astype(np.float32)
    emb = {k: np.asarray(v, np.float32) for k, v in pg.refs.items()}
    key = jax.random.PRNGKey(3)

    def jloss(img):
        return jg.sds_loss_rays_pose(
            key, jb.rays_o, jb.rays_d, jnp.asarray(bg), img, emb,
            jb.delta_polar, jb.delta_azimuth, jb.delta_radius,
            grad_scale=1.5)

    jl, jgrad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    k_t, k_noise = jax.random.split(key)
    t = tt(jax.random.randint(k_t, (B,), jg.cfg.min_step,
                              jg.cfg.max_step + 1)).long()
    noise = tt(jax.random.normal(k_noise, pred.shape))
    x = torch.from_numpy(pred).requires_grad_()
    pl = pg.sds_loss_rays_pose(
        t, noise, tt(jb.rays_o), tt(jb.rays_d), torch.from_numpy(bg), x,
        tt(jb.delta_polar), tt(jb.delta_azimuth), tt(jb.delta_radius),
        grad_scale=1.5)
    (pgrad,) = torch.autograd.grad(pl, [x])
    _close(float(pl), float(jl), rtol=1e-5, atol=0)
    _close(pgrad.numpy(), jgrad, rtol=1e-5,
           atol=1e-5 * float(np.abs(jgrad).max()))


def test_masked_pearson_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(24, 24)).astype(np.float32)
    gt = (0.7 * pred + 0.3 * rng.normal(size=pred.shape)).astype(np.float32)
    mask = rng.uniform(size=pred.shape) > 0.4
    j = j_pearson(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    p = masked_pearson(*map(torch.from_numpy, (pred, gt, mask)))
    _close(float(p), float(j), rtol=1e-5, atol=1e-6)
    assert 0.5 < float(p) < 1.0


@pytest.mark.parametrize("limit", [0.3, 0.0])
def test_clip_grad_backward_matches_jax(limit):
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(1, 8, 8, 3)).astype(np.float32)
    g = rng.normal(scale=0.5, size=x.shape).astype(np.float32)
    g.reshape(-1)[:2] = np.nan
    _, vjp = jax.vjp(lambda v: j_clip_grad(v, limit), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = clip_grad(xt, limit)
    assert torch.equal(y.detach(), xt.detach())
    (pg,) = torch.autograd.grad(y, [xt], torch.from_numpy(g))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    clipped = np.abs(g) > limit
    assert 0 < clipped.sum() < g.size


def _pair(tmp_path, ref_normals=False, **overrides):
    """The JAX and the port trainers of one image config, with the same
    parameters at STEP after one density-grid update; ``ref_normals`` adds
    the analytic normals (as a normal PNG holds them) to the reference."""
    cfg = _image_cfg(tmp_path, **overrides)
    ref = j_ref_images(cfg, cfg.h, cfg.w, "two_sphere")
    if ref_normals:
        jb = jdata.default_view_batch(cfg, ref.radii, ref.polars,
                                      ref.azimuths, cfg.h, cfg.w)
        n = np.asarray(j_views(jb.rays_o[0], jb.rays_d[0], "two_sphere")[3])
        ref = dataclasses.replace(
            ref, normal=((1.0 - n) / 2.0).reshape(ref.rgb.shape))
    jg = JImage(SDConfig(tiny=True, t_range=cfg.t_range), scene="two_sphere")
    emb = {"ref_polars": np.asarray(ref.polars, np.float32),
           "ref_azimuths": np.asarray(ref.azimuths, np.float32),
           "ref_radii": np.asarray(ref.radii, np.float32)}
    jt = jtrainer.Trainer(cfg, guidances={"image_oracle": jg},
                          guidance_params={"image_oracle": {}},
                          embeddings={"image_oracle": emb}, ref_images=ref)
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(STEP, jnp.int32))
    if cfg.backbone == "grid":
        # as tests/test_torch_slice.py: the init table ±1e-4 → ±0.1
        def scale(tree):
            f = tree["field"]
            return {**tree,
                    "field": {**f, "grid_table": f["grid_table"] * 1e3}}
        js = js.replace(params=scale(js.params),
                        ema_params=scale(js.ema_params))
    pt = Trainer(port_cfg(cfg), "cpu", ref_images=_port_ref(ref))
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = STEP
    js = jt._make_update_grid()(js, base)
    pt.update_grid(ps, jax_grid_draws(cfg, base, STEP))
    np.testing.assert_array_equal(ps.occ_grid.numpy(),
                                  np.asarray(js.occ_grid))
    return cfg, jt, js, pt, ps, base


def _capture(monkeypatch):
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    return captured


def _mostly_close(got, want, name, n_out=0, floor=0.0):
    """rtol 1e-4 with a floor of 1e-4 of the largest entry (and of
    ``floor``) on all but ``n_out`` elements."""
    scale = max(np.abs(want).max(), 1e-3 * floor)
    ok = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-4 * scale
    assert (~ok).sum() <= n_out, (name, int((~ok).sum()), ok.size)
    return ok


def _check_update(pm, jm, pgrads, captured, js2, module, ema, names=None):
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jg = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    ema_j = params_from_jax(jax.tree.map(np.asarray, js2.ema_params))
    pparams = dict(module.named_parameters())
    checked = 0
    for name, grad in zip(pparams, pgrads):
        if names is not None and not any(n in name for n in names):
            continue
        ref, got = jg[name].numpy(), grad.numpy()
        scale = np.abs(ref).max()
        if scale == 0:              # a scale masked by the progressive level
            assert not got.any(), name
            continue
        ok = _mostly_close(got, ref, name)
        clear = (np.abs(ref) > 1e-2 * scale) & ok
        assert clear.sum() > 0
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ema[name].numpy()[clear],
                                   ema_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def test_normal_perturb_loss_and_gradient_match_jax(tmp_path):
    cfg, jt, js, pt, ps, _ = _pair(tmp_path, occupancy_mode="mask")
    ties = 2 * TIE_ENTRIES
    jb = jdata.default_view_batch(cfg, (3.2,), (80.0,), (40.0,), cfg.h,
                                  cfg.w)
    ro, rd = jb.rays_o[0], jb.rays_d[0]
    R, S = ro.shape[0], cfg.grid_fine_steps
    k_render = jax.random.PRNGKey(9)
    flags = JFlags(perturb=True, need_normal_perturb=True)

    def jloss(params):
        out = jt.renderer.apply(
            {"params": params}, flags, ro, rd, occ_grid=js.occ_grid,
            light_d=ro, ambient_ratio=1.0, shading=1, bg_color=None,
            rngs={"render": k_render}, method=jt.renderer.render)
        return out["loss_normal_perturb"]

    jl, jg = jax.value_and_grad(jloss)(js.params)
    k_march, k_perturb = jax_render_keys(jt.renderer, k_render, 2)
    march_u = tt((jnp.arange(S) + jax.random.uniform(k_march, (R, S))) / S)
    noise = tt(jax.random.normal(k_perturb, (R, S, 3))).reshape(-1, 3)
    out = ps.renderer.render_grid(
        RenderFlags(perturb=True, need_normal_perturb=True), tt(ro),
        tt(rd), ps.occ_grid, light_d=tt(ro), ambient_ratio=1.0, shading=1,
        march_u=march_u, perturb_noise=noise)
    pl = out["loss_normal_perturb"]
    assert float(pl) > 0
    _close(float(pl), float(jl), rtol=1e-4, atol=0)
    params = dict(ps.renderer.named_parameters())
    pg = torch.autograd.grad(pl, list(params.values()), allow_unused=True)
    jgt = params_from_jax(jax.tree.map(np.asarray, jg))
    top = max(float(np.abs(v.numpy()).max()) for v in jgt.values())
    for (name, _), g in zip(params.items(), pg):
        ref = jgt[name].numpy()
        scale = np.abs(ref).max()
        if scale == 0:
            assert g is None or not g.any(), name
            continue
        _mostly_close(g.numpy(), ref, name, ties if "triplanes" in name
                      else 0, floor=top)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["triplane", "grid"])
def test_image_oracle_sds_step_matches_jax(tmp_path, monkeypatch, backbone):
    """Progressive view at r = 0.44 of the full ranges, K5 at a limit that
    clamps part of the image gradient and, on the grid, the 3-D and 2-D
    normal smoothness."""
    cfg, jt, js, pt, ps, base = _pair(tmp_path, grad_clip_rgb=0.01,
                                      **WHOLE[backbone])
    assert cfg.progressive_view
    captured = _capture(monkeypatch)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_step_draws(cfg, jt.renderer, base,
                                                  STEP))
    np.testing.assert_allclose(float(pm["loss_sds"]), float(jm["loss_sds"]),
                               rtol=1e-5)
    _check_update(pm, jm, pgrads, captured, js2, ps.renderer, ps.ema_params)


@pytest.mark.parametrize("case", list(WHOLE))
def test_known_view_step_matches_jax(tmp_path, monkeypatch, case):
    cfg, jt, js, pt, ps, base = _pair(tmp_path, grad_clip_rgb=0.01,
                                      **WHOLE[case])
    assert (pt.gt["normal"] is not None) == (case == "normal")
    captured = _capture(monkeypatch)
    js2, jm = jt._make_known_view_step()(js, base)
    jax.block_until_ready(js2)
    R = pt.kv_batch.rays_o.shape[1]
    assert R == 24 * 24
    pm, pgrads = pt.known_view_step(ps, jax_known_view_draws(
        cfg, jt.renderer, base, STEP, 1, R))
    assert ps.step == int(js2.step) == STEP + 1
    _check_update(pm, jm, pgrads, captured, js2, ps.renderer, ps.ema_params)


def _dmtet_pair(tmp_path, uncut=True, **kw):
    """The JAX and the port DMTet trainers of one image config at tet grid
    16 (a cube lattice of 8), with the same lumpy-sphere geometry and field
    at step 7; ``uncut``: every triangle of a tile listed on both sides,
    else JAX's tile cap on both."""
    cfg = _image_cfg(tmp_path, dmtet=True, w=4, h=4, tet_grid_size=16,
                     lr=2e-3, **kw)
    assert cfg.h == 32 and cfg.known_view_scale == 1.0
    assert not cfg.progressive_view
    grid = jtets.generate_tet_grid(8)
    ref = j_ref_images(cfg, cfg.h, cfg.w, "two_sphere")
    jg = JImage(SDConfig(tiny=True, t_range=cfg.t_range), scene="two_sphere")
    emb = {"ref_polars": np.asarray(ref.polars, np.float32),
           "ref_azimuths": np.asarray(ref.azimuths, np.float32),
           "ref_radii": np.asarray(ref.radii, np.float32)}
    jt = JDMTet(cfg, tet_grid=grid, guidances={"image_oracle": jg},
                guidance_params={"image_oracle": {}},
                embeddings={"image_oracle": emb}, ref_images=ref)
    pt = DMTetTrainer(port_cfg(cfg), "cpu",
                      tet_grid=ptets.generate_tet_grid(8),
                      ref_images=_port_ref(ref))
    js = jt.init_state(jax.random.PRNGKey(0))
    pos, sdf = _geometry(grid, 3)
    geo = {"sdf": jnp.asarray(sdf),
           "deform": jnp.asarray(np.arctanh(np.clip(
               (pos - grid.vertices) * 2 * grid.resolution, -0.9, 0.9)))}
    params = {**js.params, "geo": geo}
    js = js.replace(step=jnp.asarray(7, jnp.int32), params=params,
                    ema_params=params)
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, {
        **js.params, "tet_scale": js.tet_scale}))
    ps.tet_scale = sd.pop("tet_scale")
    ps.model.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = 7
    if uncut:
        # the port lists every triangle of a tile, JAX its first 512, which
        # the step's one tile exceeds: JAX lists every one too
        uncut_jax_tile_cap(jt, pt, ps)
    else:
        # both list a tile's first 512 triangles (JAX's cap)
        pt.dmtet_renderer.tile_cap = jt.dmtet_renderer.tile_cap
    return cfg, jt, js, pt, ps


def test_known_view_dmtet_step_matches_jax(tmp_path, monkeypatch):
    """rgb + mask of the 32² reference view through K7, plus the mesh
    regularizers."""
    cfg, jt, js, pt, ps = _dmtet_pair(tmp_path)
    base = jax.random.PRNGKey(0)
    captured = _capture(monkeypatch)
    js2, jm = jt._make_known_view_step()(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.known_view_step(ps, jax_dmtet_known_view_draws(base, 7,
                                                                   1))
    assert 0 < int(pm["n_faces"]) < pt.dmtet_renderer.max_tris
    assert 512 < int(pm["tile_max"]) <= jt.dmtet_renderer.tile_cap
    _check_update(pm, jm, pgrads, captured, js2, ps.model, ps.ema_params,
                  names=("geo.", "triplanes"))


def test_image_oracle_dmtet_step_matches_jax(tmp_path, monkeypatch):
    """The DMTet main step under the image oracle, K5 on its render, at
    JAX's tile cap on both sides: uncut, one sdf gradient of 729 lies
    1.1e-4 of the largest from JAX's, where JAX's float32 lies 7.9e-5 and
    the port's 3.1e-5 from the float64 step (ROADMAP's recorded
    differences; ``tests/f64_witness_dmtet.py``)."""
    cfg, jt, js, pt, ps = _dmtet_pair(tmp_path, uncut=False,
                                      grad_clip_rgb=0.01)
    base = jax.random.PRNGKey(0)
    captured = _capture(monkeypatch)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_dmtet_step_draws(cfg, base, 7))
    assert int(pm["tile_max"]) > pt.dmtet_renderer.tile_cap == 512
    np.testing.assert_allclose(float(pm["loss_sds"]), float(jm["loss_sds"]),
                               rtol=1e-5)
    _check_update(pm, jm, pgrads, captured, js2, ps.model, ps.ema_params,
                  names=("geo.", "triplanes"))
