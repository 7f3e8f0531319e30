"""Guidance sets and reference images that the port once refused, against
the JAX package on the CPU.

One tiny stage-1 SDS step of ``--image_config refs.csv --text ...
--guidance SD zero123 clip`` (three priors summed in sorted name order,
each on its own key of the guide key's split: SD's and zero123's draws,
none for CLIP) against the jitted JAX step with the same weights and
draws (``tests/test_torch_lifted_steps.py`` holds SD with
``--image_config`` and the pixel oracle with a file image); the draws'
layout, and a set's loss as the sum of its priors' terms.

Tolerances as ``tests/test_torch_clip.py`` holds its steps: the loss and
its SDS part 1e-5 rel; the field's gradients rtol 1e-3 with a floor of
1e-3 of the largest entry; the updated parameters 1e-5 where the gradient
is clearly nonzero.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, finalize
from dreamfusion_tpu.guidance import clip as jclip
from dreamfusion_tpu.guidance import zero123 as jz
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.training.image_data import \
    load_ref_images as j_load_ref_images
from dreamfusion_tpu_torch.guidance import clip as pclip
from dreamfusion_tpu_torch.guidance import zero123 as pz
from dreamfusion_tpu_torch.guidance.embeddings import prepare_text_embeddings
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.training.image_data import load_ref_images
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax
from dreamfusion_tpu_torch.utils.image import save_image

from torch_parity import (jax_sd_draws, jax_set_draws, jax_step_draws,
                          jax_train_state, port_cfg, random_flax_params)

torch.set_num_threads(2)
TINY = dict(tiny=True, image_size=16, latent_size=8)
PROMPT = "a hamburger"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _refs(tmp_path, K=2):
    """K RGBA reference PNGs (a disc on black, alpha its mask) and an
    ``--image_config`` CSV of config/example.csv's form."""
    yy, xx = np.mgrid[0:40, 0:40]
    rows = ["image, polar, azimuth, radius, zero123_weight"]
    for k in range(K):
        alpha = np.clip(1.5 - np.hypot(xx - 20 - 4 * k, yy - 18) / 9, 0, 1)
        rgb = np.stack([0.8 - 0.3 * k + 0 * xx, 0.3 + 0.2 * k + 0 * xx,
                        0.5 + 0.01 * yy], -1) * alpha[..., None]
        path = tmp_path / f"ref{k}_rgba.png"
        save_image(str(path), np.concatenate([rgb, alpha[..., None]], -1))
        rows.append(f"{path}, {90 - 20 * k}, {150 * k}, {3.2 + 0.2 * k}, "
                    f"{1.0 - 0.5 * k}")
    csv = tmp_path / "refs.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv), str(tmp_path / "ref0_rgba.png")


def _cfg(tmp_path, preset=None, **kw):
    base = dict(text=PROMPT, workspace=str(tmp_path / "ws"), w=16, h=16,
                iters=400, batch_size=1, triplane_resolution=32,
                triplane_channels=8, triplane_scales=2, hidden_dim=32,
                grid_size=30, grid_coarse_steps=24, grid_fine_steps=24,
                fp16=False, seed=0, eval_interval=-1, use_tensorboard=False,
                lr=1e-2, backbone="triplane", lambda_3d_normal_smooth=0.0)
    base.update(kw)
    cfg = Config(**base)
    return finalize(preset(cfg) if preset else cfg)


def _port_ref(ref):
    from dreamfusion_tpu_torch.training.image_data import RefImages
    return RefImages(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(RefImages)})


def _sd_pair(t_range):
    jg = JSD(JSDConfig(t_range=t_range, **TINY))
    z = jnp.zeros
    jp = _np({
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 4)), z((1,)),
                                   z((1, 16, 32)), seed=7),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=8),
        "text": random_flax_params(jg.text_encoder.init,
                                   z((1, 16), jnp.int32), seed=9)})
    pg = StableDiffusionGuidance(SDConfig(t_range=t_range, **TINY), "cpu")
    pg.load_state_dicts(params_from_jax(jp))
    emb = prepare_text_embeddings(pg, PROMPT, "")
    return jg, jp, pg, emb, {k: jnp.asarray(v.numpy())
                             for k, v in emb.items()}


def _zero123_pair(t_range, vae_params):
    """The tiny zero123 towers (their VAE holding SD's weights)."""
    jg = jz.Zero123Guidance(jz.Zero123Config(t_range=t_range, tiny=True))
    z = jnp.zeros
    vis = jg.cfg.vision_config()
    ctx = jg.unet.cfg.context_dim
    rng = np.random.default_rng(3)
    jp = _np({
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 8)), z((1,)),
                                   z((1, 1, ctx)), seed=0),
        "vae": vae_params,
        "vision": random_flax_params(
            jg.vision.init, z((1, vis.image_size, vis.image_size, 3)),
            seed=2),
        "cc_projection": {
            "kernel": (rng.standard_normal((ctx + 4, ctx)) / math.sqrt(ctx))
            .astype(np.float32),
            "bias": 0.05 * rng.standard_normal(ctx).astype(np.float32)}})
    pg = pz.Zero123Guidance(pz.Zero123Config(t_range=t_range, tiny=True),
                            "cpu")
    for name, state in params_from_jax(jp).items():
        pg.towers()[name].load_state_dict(state, strict=True)
    return jg, jp, pg


def _clip_pair():
    jc = jclip.CLIPGuidance(jclip.CLIPConfig(tiny=True))
    vc, tc = jc.cfg.vision_config(), jc.cfg.text_config()
    rng = np.random.default_rng(2)
    jp = _np({
        "vision": random_flax_params(
            jc.vision.init, jnp.zeros((1, vc.image_size, vc.image_size, 3)),
            seed=0),
        "text": random_flax_params(jc.text.init, jnp.zeros(
            (1, tc.max_len), jnp.int32), seed=1),
        "text_projection": (rng.standard_normal(
            (tc.hidden_size, vc.projection_dim)) / np.sqrt(tc.hidden_size))
        .astype(np.float32)})
    pc = pclip.CLIPGuidance(pclip.CLIPConfig(tiny=True), "cpu")
    pc.load_state_dicts(params_from_jax(jp))
    return jc, jp, pc


def _capture(monkeypatch):
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    return captured


def _states(jt, pt, step, real_init=False):
    """JAX's initial state at `step` (``jax_train_state``, or with
    `real_init` the field's own init, run eagerly) and the port's holding
    its field."""
    js = jt.init_state(jax.random.PRNGKey(0)).replace(
        step=jnp.asarray(step, jnp.int32)) if real_init else \
        jax_train_state(jt, step)
    ps = pt.init_state(0)
    state = params_from_jax(_np(js.params))
    ps.renderer.load_state_dict(state)
    for k, v in ps.ema_params.items():
        v.copy_(state[k])
    ps.step = step
    return js, ps


def _check_step(pm, jm, pgrads, captured, js2, module):
    for k in ("loss", "loss_sds"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jgr = params_from_jax(_np(captured["grads"]))
    new_j = params_from_jax(_np(js2.params))
    params = dict(module.named_parameters())
    checked = 0
    for name, grad in zip(params, pgrads):
        ref = jgr[name].numpy()
        scale = np.abs(ref).max()
        if scale == 0:
            assert not grad.numpy().any(), name
            continue
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(params[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def test_one_sd_zero123_clip_step_matches_jax(tmp_path, monkeypatch):
    """``--image_config`` (K = 2) with ``--text`` and ``--guidance SD
    zero123 clip``: SD's SDS through the tiny VAE, zero123's over both
    references (one UNet call at batch 4), CLIP's term toward the prompt
    and the first reference, summed; each diffusion prior on its own key."""
    csv, _ = _refs(tmp_path)
    cfg = _cfg(tmp_path, image_config=csv, guidance=("SD", "zero123", "clip"))
    step = 101
    jg, jp, pg, emb, jemb = _sd_pair(cfg.t_range)
    zg, zp, pzg = _zero123_pair(cfg.t_range, jp["vae"])
    jc, jcp, pc = _clip_pair()
    ref = j_load_ref_images(cfg, cfg.h, cfg.w)
    assert ref.rgb.shape[0] == 2 and ref.polars == (90.0, 70.0)
    pref = load_ref_images(port_cfg(cfg), cfg.h, cfg.w)
    np.testing.assert_array_equal(pref.rgb, ref.rgb)
    # the port's embeddings (each held to JAX's in its own test file),
    # handed to JAX: its eager towers would compile op by op
    ze = pzg.prepare_image_embeddings(pref.rgb, pref.polars, pref.azimuths,
                                      pref.radii, pref.weights)
    cz = pc.prepare_embeddings(cfg.text, pref.rgb[0])
    jax_emb = lambda e: {k: jnp.asarray(v.numpy()) for k, v in e.items()}
    jt = jtrainer.Trainer(
        cfg, guidances={"SD": jg, "zero123": zg, "clip": jc},
        guidance_params={"SD": jp, "zero123": zp, "clip": jcp},
        embeddings={"SD": jemb, "zero123": jax_emb(ze),
                    "clip": jax_emb(cz)}, ref_images=ref)
    pt = Trainer(port_cfg(cfg), "cpu", ref_images=_port_ref(pref), priors={
        "SD": (pg, emb), "zero123": (pzg, ze), "clip": (pc, cz)})
    assert list(pt.priors) == ["SD", "clip", "zero123"]
    assert [n for n, _ in pt.noise_specs] == ["SD", "zero123"]
    assert not pt.is_known_view_step(step) and not pt.latent_phase(step)
    captured = _capture(monkeypatch)
    base = jax.random.PRNGKey(0)
    js, ps = _states(jt, pt, step)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    latent = lambda k: jax_sd_draws(k, 1, 8, cfg.t_range)
    draws = jax_set_draws(jax_step_draws(cfg, jt.renderer, base, step, 8),
                          base, step, {"SD": latent, "clip": None,
                                       "zero123": latent})
    assert set(draws.extra) == {"zero123"}
    pm, pgrads = pt.train_step(ps, draws)
    _check_step(pm, jm, pgrads, captured, js2, ps.renderer)
    # the generator's draws have the same layout
    own = pt.draw_step(torch.Generator().manual_seed(0))
    assert own.noise.shape == own.extra["zero123"].noise.shape == (1, 8, 8,
                                                                   4)


@pytest.mark.parametrize("guidance", [("oracle", "SD"), ("IF", "clip")])
def test_priors_sum_in_sorted_order_with_their_own_draws(tmp_path, guidance):
    """The trainer's priors and draws in JAX's order; a set's loss is the
    sum of its priors' terms on their own draws."""
    cfg = port_cfg(_cfg(tmp_path, guidance=guidance))
    if "SD" in guidance:
        prior = ("SD", StableDiffusionGuidance(SDConfig(**TINY), "cpu"))
    else:
        from dreamfusion_tpu_torch.guidance.deepfloyd import (IFConfig,
                                                              IFGuidance)
        prior = ("IF", IFGuidance(IFConfig(tiny=True), "cpu"))
        pc = pclip.CLIPGuidance(pclip.CLIPConfig(tiny=True), "cpu")
        pc.init_params(torch.Generator().manual_seed(1))
    name, g = prior
    g.init_params(torch.Generator().manual_seed(0))
    emb = prepare_text_embeddings(g, PROMPT) if name == "SD" else \
        g.prepare_embeddings(PROMPT)
    priors = {name: (g, emb)}
    if "clip" in guidance:
        priors["clip"] = (pc, pc.prepare_embeddings(PROMPT))
    pt = Trainer(dataclasses.replace(cfg, latent_iter_ratio=0.0), "cpu",
                 priors=priors)
    assert list(pt.priors) == sorted(guidance)
    ps = pt.init_state(0)
    draws = pt.draw_step(torch.Generator().manual_seed(3))
    pred, _, batch, bg = pt.render_part(ps, draws, False)
    pred = pred.detach()
    total = pt.guidance_loss(pred, batch, draws, bg, False)
    terms = [pt.prior_loss(n, pred, batch, draws, bg, False)
             for n in pt.priors]
    torch.testing.assert_close(total, sum(terms[1:], terms[0]))
    if "oracle" in guidance:
        assert pt.prior_draws(draws, "SD").noise.shape == (1, 8, 8, 4)
        assert pt.prior_draws(draws, "oracle").noise.shape == (1, 16, 16, 3)
        assert pt.scene == cfg.oracle_scene
