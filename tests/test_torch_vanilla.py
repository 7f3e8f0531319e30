"""Port parity of the vanilla backbone and the -O2 path against the JAX
package, on tiny shapes with inputs from a numpy seed.

* The vanilla field (frequency encoding at degree 12 → ResMLP → K4's head)
  with JAX's init carried across by ``params_from_jax``: sigma, albedo,
  the closed-form normals against ``jax.value_and_grad``'s and the shaded
  colour, through ``NeRFField.__call__``.  fp32: 1e-5 (sigma, albedo,
  colour), 1e-4 (normals).  bf16 (the port rounds where flax does, but
  f32 sin/cos of up to 2^11·x differ by ulps between XLA and torch, and a
  bf16 rounding that flips compounds over five layers): log sigma 6e-2
  (~4 bf16 ulps of h0), albedo and colour 2e-2; the normals by cosine
  ≥ 0.99 (JAX's are reverse-mode in bf16, the port's forward-mode).
* ``freq_encode`` with ``max_level`` (values 2e-7: XLA's and torch's f32
  sin and cos differ by an ulp; the masked bands exactly 0; the jacobian
  against ``jax.jacfwd`` at 1e-6 rel, and along the field's [0, 1]
  coordinate exactly twice it), and at a boundary step (step 50
  of 300: the float32 band count is 8, the float64 one 7).
* The plain resample against JAX's ``stratified_zs`` + coarse weights +
  ``sample_pdf`` + sort, deterministic and perturbed with the same draws:
  z, deltas and positions at 2e-5 of the ray's span.
* ``render_vanilla`` through ``_shade_and_composite`` (perturbed, the
  JAX render's own keys): image, depth, weights sum 1e-5, orient loss
  1e-4 rel.
* Adam, the vanilla decay of Adan and Adam and ``optax.clip`` against
  ``build_optimizer`` over four updates: 1e-6 (times the update scale).
* One whole tiny ``-O2`` oracle step against the jitted JAX step (fp32):
  loss 1e-5 rel, gradients 1e-4 rel of each tensor's largest entry,
  updated parameters and EMA 1e-5 where the gradient is clearly nonzero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_O2, finalize
from dreamfusion_tpu.core.sampling import near_far_from_bound as j_near_far
from dreamfusion_tpu.core.sampling import sample_pdf as j_sample_pdf
from dreamfusion_tpu.core.sampling import stratified_zs as j_stratified
from dreamfusion_tpu.guidance.oracle import PixelOracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig
from dreamfusion_tpu.models.nerf import NeRFField as JField
from dreamfusion_tpu.models.renderer import NeRFRenderer as JRenderer
from dreamfusion_tpu.models.renderer import RenderFlags as JFlags
from dreamfusion_tpu.ops.composite import compute_deltas as j_deltas
from dreamfusion_tpu.ops.freq import freq_encode as j_freq
from dreamfusion_tpu.training import schedules as jsched
from dreamfusion_tpu.training.optimizer import build_optimizer as j_build
from dreamfusion_tpu_torch.core.sampling import det_u, linspace, stratified_u
from dreamfusion_tpu_torch.models.nerf import NeRFField
from dreamfusion_tpu_torch.models.renderer import NeRFRenderer, RenderFlags
from dreamfusion_tpu_torch.ops.freq import active_count, freq_encode
from dreamfusion_tpu_torch.ops.resample import (vanilla_coarse,
                                                vanilla_resample)
from dreamfusion_tpu_torch.training import schedules as psched
from dreamfusion_tpu_torch.training.optimizer import build_optimizer
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import jax_render_keys, jax_step_draws, port_cfg, tt

torch.set_num_threads(2)


def _strip(sd, prefix="field."):
    return {k[len(prefix):]: v for k, v in sd.items()}


def _vanilla_fields(dtype, seed=0, n=96):
    jdt, pdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jf = JField(backbone="vanilla", hidden_dim=32, bg_radius=-1.0,
                compute_dtype=jdt)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     method=jf.density)["params"]
    pf = NeRFField(backbone="vanilla", hidden_dim=32, compute_dtype=pdt)
    pf.load_state_dict(_strip(params_from_jax(
        {"field": jax.tree.map(np.asarray, params)})))
    light = rng.normal(size=(n, 3)).astype(np.float32)
    light /= np.linalg.norm(light, axis=-1, keepdims=True)
    return jf, params, pf, x, light


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vanilla_field_matches_jax(dtype):
    jf, params, pf, x, light = _vanilla_fields(dtype)
    assert "res_1" in params["sigma_net"] and "skip" not in \
        params["sigma_net"]["res_1"]
    ml = 0.75

    @jax.jit
    def jax_field(p, xx, ll):
        return (jf.apply({"params": p}, xx, jnp.float32(ml),
                         method=jf.common),
                jf.apply({"params": p}, xx, xx, ll, 0.3, 1, jnp.float32(ml)))

    (js, ja), (jsig, jcol, jn) = jax_field(params, jnp.asarray(x),
                                           jnp.asarray(light))
    with torch.no_grad():
        ps, pa = pf.common(tt(x), ml)
        psig, pcol, pn = pf(tt(x), tt(light), 0.3, torch.tensor(1), ml)
    if dtype == "fp32":
        for a, b in ((ps, js), (pa, ja), (psig, jsig), (pcol, jcol)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-4)
        return
    # sigma = exp(h0 + blob): h0's absolute error is log sigma's
    np.testing.assert_allclose(np.log(ps.numpy()), np.log(np.asarray(js)),
                               atol=6e-2)
    for a, b in ((pa, ja), (pcol, jcol)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-2)
    cos = (pn.numpy() * np.asarray(jn)).sum(-1)
    assert cos.min() >= 0.99, cos.min()


@pytest.mark.parametrize("max_level", [None, 0.3, 0.5, 1.0])
def test_freq_encode_max_level_and_jacobian(max_level):
    x = np.random.default_rng(1).uniform(-1, 1, (20, 3)).astype(np.float32)
    ml = None if max_level is None else jnp.float32(max_level)
    ref = j_freq(jnp.asarray(x), 12, max_level=ml)
    enc, jac = freq_encode(tt(x), 12, max_level, need_jacobian=True)
    # sin and cos of XLA and torch may differ by an ulp
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), atol=2e-7)
    n = active_count(max_level, 12)
    assert (enc[:, 3 + 6 * n:] == 0).all() and \
        (n == 0 or (enc[:, 3 + 6 * (n - 1):3 + 6 * n] != 0).any())
    jj = jax.vmap(jax.jacfwd(lambda p: j_freq(p[None], 12, ml)[0]))(
        jnp.asarray(x))                                  # [N, 75, 3]
    for a in range(3):
        np.testing.assert_allclose(jac[a].numpy(), np.asarray(jj[..., a]),
                                   rtol=1e-6, atol=1e-6)
    # along u = (x + 1) / 2, the field's unit at bound 1: twice, exactly
    _, ju = freq_encode(tt(x), 12, max_level, need_jacobian=True, unit=2.0)
    for a in range(3):
        assert torch.equal(ju[a], 2 * jac[a])


def test_max_level_in_float32_at_a_boundary_step():
    """Step 50 of 300: (0.25 + 2·r)·12 is 7.0000005 in float32 (8 bands)
    and 7 in float64 (7 bands); the port counts JAX's 8."""
    cfg = finalize(apply_O2(Config(iters=300)))
    r = jsched.iter_ratio(jnp.int32(50), 0, 300)
    jml = jsched.encoder_max_level(cfg, r)
    pml = psched.encoder_max_level(port_cfg(cfg),
                                   psched.iter_ratio(50, 0, 300))
    assert float(jml) == pml
    assert int(jnp.ceil(jml * 12)) == active_count(pml, 12) == 8
    assert int(np.ceil(min(1.0, 0.25 + 2.0 * 50 / 300) * 12)) == 7
    x = np.random.default_rng(2).uniform(-1, 1, (8, 3)).astype(np.float32)
    enc = freq_encode(tt(x), 12, pml).numpy()
    np.testing.assert_allclose(
        enc, np.asarray(j_freq(jnp.asarray(x), 12, max_level=jml)),
        atol=2e-7)
    assert (enc[:, 3 + 6 * 7:3 + 6 * 8] != 0).all()      # band 8 kept
    assert (enc[:, 3 + 6 * 8:] == 0).all()


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o *= (rng.uniform(0.5, 3.5, (R, 1)) / np.linalg.norm(o, axis=-1,
                                                         keepdims=True))
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True) +
         0.2 * rng.normal(size=(R, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("perturb", [False, True], ids=["det", "perturbed"])
def test_resample_matches_jax(perturb):
    R, S, n, bound = 64, 64, 32, 1.0
    o, d = _rays(R, 3)               # some origins inside: near < 0
    k_strat, k_pdf = jax.random.split(jax.random.PRNGKey(7))
    near, far = j_near_far(jnp.asarray(o), jnp.asarray(d), bound,
                           kind="sphere", min_near=0.01)
    z = j_stratified(k_strat if perturb else None, near, far, S,
                     perturb=perturb)
    sigma = np.random.default_rng(4).gamma(0.5, 20.0, (R, S)) \
        .astype(np.float32)
    dist = (far - near) / S
    deltas = j_deltas(z, dist)
    alphas = 1.0 - jnp.exp(-deltas * jnp.asarray(sigma))
    T = jnp.cumprod(jnp.concatenate([jnp.ones_like(alphas[..., :1]),
                                     1.0 - alphas + 1e-15], -1), -1)[..., :-1]
    z_mid = z[..., :-1] + 0.5 * deltas[..., :-1]
    new_z = j_sample_pdf(k_pdf if perturb else None, z_mid,
                         (alphas * T)[:, 1:-1], n, det=not perturb)
    jz = jnp.sort(jnp.concatenate([z, new_z], -1), -1)
    jd = j_deltas(jz, dist)
    jx = jnp.clip(jnp.asarray(o)[:, None] + jnp.asarray(d)[:, None] *
                  jz[..., None], -bound, bound)

    lin = linspace(0.0, 1.0, S)
    u_c = tt(jax.random.uniform(k_strat, (R, S))) if perturb else None
    u_p = stratified_u(tt(jax.random.uniform(k_pdf, (R, n)))) if perturb \
        else det_u(1, n)[0]
    pz, _, _ = vanilla_coarse(tt(o), tt(d), bound, lin, u_c)
    np.testing.assert_allclose(pz.numpy(), np.asarray(z), atol=1e-6)
    pz, pd, px = vanilla_resample(tt(o), tt(d), bound, pz, tt(sigma), u_p)
    span = np.asarray(far - near)
    assert (np.diff(pz.numpy(), axis=-1) >= 0).all()
    assert np.array_equal(pz.numpy(), np.sort(pz.numpy(), -1))
    for got, want in ((pz, jz), (pd, jd)):
        err = np.abs(got.numpy() - np.asarray(want)) / span
        assert err.max() <= 2e-5, err.max()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=2e-5 * 4)


def _renderers(seed=5):
    kw = dict(bound=1.0, hidden_dim=32, num_steps=16, upsample_steps=8)
    jr = JRenderer(backbone="vanilla", bg_radius=-1.0,
                   compute_dtype=jnp.float32, **kw)
    R = 24
    o, d = _rays(R, seed)
    o = 3.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (-o / 3.2 + 0.05 * np.random.default_rng(seed).normal(size=(R, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    params = jr.init(k, jnp.asarray(o), method=jr.density)["params"]
    pr = NeRFRenderer(backbone="vanilla", compute_dtype=torch.float32, **kw)
    pr.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jr, params, pr, o, d


def test_render_vanilla_matches_jax():
    jr, params, pr, o, d = _renderers()
    R = o.shape[0]
    flags = dict(perturb=True, need_loss_orient=True)
    k_render = jax.random.PRNGKey(11)
    light = np.tile(np.array([[0.0, 0.6, 0.8]], np.float32), (R, 1))
    bg = np.full((R, 3), 0.25, np.float32)
    jo = jax.jit(lambda p, oo, dd, ll, bb: jr.apply(
        {"params": p}, JFlags(**flags), oo, dd, light_d=ll,
        ambient_ratio=0.2, shading=jnp.asarray(1), bg_color=bb,
        max_level=jnp.float32(0.5), rngs={"render": k_render},
        method=jr.render))(params, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(light), jnp.asarray(bg))
    (k_march,) = jax_render_keys(jr, k_render, 1)
    k_strat, k_pdf = jax.random.split(k_march)
    with torch.no_grad():
        po = pr(RenderFlags(**flags), tt(o), tt(d), None,
                light_d=tt(light), ambient_ratio=0.2,
                shading=torch.tensor(1), bg_color=tt(bg), max_level=0.5,
                march_u=tt(jax.random.uniform(k_strat, (R, 16))),
                pdf_u=tt((jnp.arange(8) +
                          jax.random.uniform(k_pdf, (R, 8))) / 8))
    assert po["weights"].shape == (R, 24)
    for key in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(po[key].numpy(), np.asarray(jo[key]),
                                   atol=1e-5, err_msg=key)
    assert float(po["weights_sum"].max()) > 0.1
    np.testing.assert_allclose(float(po["loss_orient"]),
                               float(jo["loss_orient"]), rtol=1e-4,
                               atol=1e-9)


@pytest.mark.parametrize("name,vanilla,clip", [
    ("adam", True, 0.05), ("adam", False, -1.0), ("adan", True, 0.05)])
def test_optimizer_matches_build_optimizer(name, vanilla, clip):
    """Four updates (iters 3: Adam's decay runs past iters, Adan's stops
    there), triplanes at the encoder's 10x."""
    rng = np.random.default_rng(6)
    tree = {"field": {
        "triplanes": [rng.normal(size=(3, 8, 8, 4)).astype(np.float32)],
        "sigma_net": {"dense_0": {
            "kernel": rng.normal(size=(12, 6)).astype(np.float32),
            "bias": rng.normal(size=(6,)).astype(np.float32)}}}}
    opt = j_build(name, 1e-2, 3, "vanilla" if vanilla else "triplane", clip)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    names = ["field.triplanes.0", "field.sigma_net.layers.0.weight",
             "field.sigma_net.layers.0.bias"]
    pd = params_from_jax(tree)
    pp = [pd[k] for k in names]
    popt = build_optimizer(name, 1e-2, 3, [10.0, 1.0, 1.0], vanilla=vanilla,
                           grad_clip=clip)
    ps = popt.init(pp)
    for step in range(4):
        gtree = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) *
            (3.0 if step == 1 else 0.03), tree)
        upd, js = opt.update(jax.tree.map(jnp.asarray, gtree), js, jp)
        jp = optax.apply_updates(jp, upd)
        gd = params_from_jax(gtree)
        pp, ps = popt.step(pp, [gd[k] for k in names], ps)
        ref = params_from_jax(jax.tree.map(np.asarray, jp))
        for k, p, scale in zip(names, pp, popt.scales):
            np.testing.assert_allclose(p.numpy(), ref[k].numpy(),
                                       atol=1e-6 * scale, rtol=1e-6,
                                       err_msg=f"{k} step {step}")


def test_o2_oracle_step_matches_jax(tmp_path, monkeypatch):
    """One -O2 oracle step (vanilla field, progressive levels, no density
    grid) at step 5 of 100 (max_level 0.25 + 2·0.05 = 0.35: 5 of the 12
    bands), in fp32.  The sample positions o + d·z round differently
    under XLA's fused multiply-adds, and band i multiplies that ulp by
    2^i: at 11 bands the first layer's weight gradient differs by 3.5e-3
    of its largest entry, so the step is held where the bands are few
    (``test_vanilla_field_matches_jax`` holds all 12 at equal
    positions)."""
    step = 5
    cfg = finalize(apply_O2(Config(
        guidance=("oracle",), oracle_scene="two_sphere",
        workspace=str(tmp_path / "ws"), w=8, h=8, iters=100, batch_size=1,
        hidden_dim=32, num_steps=16, upsample_steps=8, seed=0,
        eval_interval=-1, lambda_3d_normal_smooth=0.0, use_tensorboard=False,
        guidance_scale=1.0, lr=1e-2)))
    cfg = dataclasses.replace(cfg, fp16=False)
    g = JOracle(SDConfig(tiny=True), scene=cfg.oracle_scene)
    jt = jtrainer.Trainer(cfg, guidances={"oracle": g},
                          guidance_params={"oracle": {}},
                          embeddings={"oracle": jnp.zeros(())})
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(step, jnp.int32))
    assert not jt.needs_density_grid

    pt = Trainer(port_cfg(cfg), "cpu")
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = step
    assert active_count(psched.encoder_max_level(pt.cfg, 0.05), 12) == 5

    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    draws = jax_step_draws(cfg, jt.renderer, base, step)
    assert draws.march_u.shape == (64, 16) and draws.pdf_u.shape == (64, 8)
    pm, pgrads = pt.train_step(ps, draws)

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    names = [n for n, _ in ps.renderer.named_parameters()]
    jg = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    ema_j = params_from_jax(jax.tree.map(np.asarray, js2.ema_params))
    pparams = dict(ps.renderer.named_parameters())
    for name, grad in zip(names, pgrads):
        ref = jg[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ps.ema_params[name].numpy()[clear],
                                   ema_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
