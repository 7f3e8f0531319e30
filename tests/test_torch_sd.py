"""The SD 2.1 guidance path against the JAX package on the CPU, at tiny
size in f32 (``UNetConfig.tiny()``, ``VAEConfig.tiny()``,
``CLIPTextConfig.tiny()``), with the JAX towers' weights carried over by
``params_from_jax`` and JAX's own random draws handed to the port.

Tolerances: tower outputs 1e-4 of the largest magnitude (f32, sums in
another order); the SDS loss 1e-4 relative and its image gradient 1e-4 of
the largest entry; in the whole step, loss 1e-4 relative, gradients 1e-3
of each tensor's largest entry (guidance scale 100 magnifies the towers'
rounding) and updated parameters 1e-5 where the gradient is clearly
nonzero (Adan's first step is ≈ lr·sign(g)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, finalize
from dreamfusion_tpu.guidance.embeddings import HashTokenizer as JTok
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu_torch.guidance.embeddings import (HashTokenizer,
                                                       prepare_text_embeddings)
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.main import main
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import jax_sd_draws, jax_step_draws, port_cfg

torch.set_num_threads(2)
TINY = dict(tiny=True, image_size=16, latent_size=8)


@pytest.fixture(scope="module")
def towers():
    """The JAX tiny towers and the port's, holding the same weights."""
    jg = JSD(JSDConfig(**TINY))
    jp = jax.jit(jg.init_params)(jax.random.PRNGKey(0))
    pg = StableDiffusionGuidance(SDConfig(**TINY), "cpu")
    pg.load_state_dicts(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jg, jp, pg


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_unet_eps_matches_jax(towers):
    jg, jp, pg = towers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([20, 731])
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    want = jax.jit(jg.unet.apply)({"params": jp["unet"]}, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx))
    got = pg.unet(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(ctx))
    _close(got, want)


def test_vae_encode_moments_and_decode_match_jax(towers):
    jg, jp, pg = towers
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jm = jax.jit(lambda p, a: jg.vae.apply(p, a, method=jg.vae.encode))(
        {"params": jp["vae"]}, jnp.asarray(x))
    pm = pg.vae.encode(torch.from_numpy(x))
    _close(pm.mean, jm.mean)
    _close(pm.logvar, jm.logvar)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jax.jit(lambda p, a: jg.vae.apply(p, a, method=jg.vae.decode))(
        {"params": jp["vae"]}, jnp.asarray(z))
    _close(pg.vae.decode(torch.from_numpy(z)), want)


def test_clip_text_embeddings_match_jax(towers):
    jg, jp, pg = towers
    cfg = pg.text_encoder.cfg
    assert (HashTokenizer(cfg.vocab_size, cfg.max_len)("a hamburger") ==
            JTok(cfg.vocab_size, cfg.max_len)("a hamburger")).all()
    emb = prepare_text_embeddings(pg, "a hamburger", "")
    for name, prompt in (("default", "a hamburger"), ("uncond", ""),
                         ("back", "a hamburger, back view")):
        ids = JTok(cfg.vocab_size, cfg.max_len)(prompt)
        want = jg.get_text_embeds(jp, jnp.asarray(ids))
        _close(emb[name], want)


@pytest.mark.parametrize("as_latent,perpneg", [(False, False), (True, False),
                                               (False, True)])
def test_sds_loss_and_image_gradient_match_jax(towers, as_latent, perpneg):
    jg, jp, pg = towers
    rng = np.random.default_rng(3)
    B, L, D = 1, 16, 32
    rgb = rng.uniform(0, 1, (B, 16, 16, 4 if as_latent else 3)).astype(
        np.float32)
    uncond = rng.standard_normal((B, L, D)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    t, noise, post = jax_sd_draws(jax.random.split(key, 1)[0], B, 8,
                                  (0.02, 0.98))
    kw = dict(guidance_scale=100.0, as_latent=as_latent, grad_scale=1.0)
    if perpneg:
        text_z = rng.standard_normal((3 * B, L, D)).astype(np.float32)
        w = np.array([1.0, -1.3, -0.4], np.float32)

        def jloss(img):
            return jg.sds_loss_perpneg(jp, jax.random.split(key, 1)[0],
                                       jnp.asarray(text_z), jnp.asarray(w),
                                       jnp.asarray(uncond), img, **kw)

        def ploss(img):
            return pg.sds_loss_perpneg(torch.from_numpy(text_z),
                                       torch.from_numpy(w),
                                       torch.from_numpy(uncond), img, t,
                                       noise, post, **kw)
    else:
        cond = rng.standard_normal((B, L, D)).astype(np.float32)

        def jloss(img):
            return jg.sds_loss(jp, jax.random.split(key, 1)[0],
                               jnp.asarray(cond), jnp.asarray(uncond), img,
                               **kw)

        def ploss(img):
            return pg.sds_loss(torch.from_numpy(cond),
                               torch.from_numpy(uncond), img, t, noise, post,
                               **kw)

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(rgb))
    img = torch.from_numpy(rgb).requires_grad_()
    got = ploss(img)
    (grad,) = torch.autograd.grad(got, img)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    _close(grad, jgrad)


def _step_cfg(tmp_path):
    return finalize(Config(
        text="a hamburger", guidance=("SD",), workspace=str(tmp_path / "ws"),
        backbone="triplane", w=16, h=16, iters=100, batch_size=1,
        triplane_resolution=32, triplane_channels=8, hidden_dim=32,
        grid_size=30, grid_coarse_steps=24, grid_fine_steps=24, fp16=False,
        seed=0, eval_interval=-1, lambda_3d_normal_smooth=0.0,
        use_tensorboard=False))


@pytest.mark.parametrize("phase", ["latent", "main"])
def test_one_sd_train_step_matches_jax(towers, tmp_path, monkeypatch, phase):
    """One tiny SD step (warm-up at step 10; main phase at the first step
    after 40 that draws the background MLP), loss and updated parameters
    against the jitted JAX step with the same weights and draws."""
    jg, jp, pg = towers
    cfg = _step_cfg(tmp_path)
    base = jax.random.PRNGKey(0)
    emb = prepare_text_embeddings(pg, cfg.text, "")
    jemb = {k: jnp.asarray(v.numpy()) for k, v in emb.items()}
    jt = jtrainer.Trainer(cfg, guidances={"SD": jg},
                          guidance_params={"SD": jp}, embeddings={"SD": jemb})
    pt = Trainer(port_cfg(cfg), "cpu", pg, emb)
    if phase == "latent":
        step = 10
    else:
        step = next(s for s in range(40, 80) if float(jax_step_draws(
            cfg, jt.renderer, base, s, 8).choice.bg_net_u) > 0.5)
    assert pt.latent_phase(step) == (phase == "latent")
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(step, jnp.int32))
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    assert any("bg_net" in k for k in sd)
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = step

    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    js2, jm = jt._make_train_step(phase)(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_step_draws(cfg, jt.renderer, base,
                                                  step, 8))

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jgrads = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    pparams = dict(ps.renderer.named_parameters())
    names = [n for n, _ in ps.renderer.named_parameters()]
    for name, grad in zip(names, pgrads):
        ref = jgrads[name].numpy()
        scale = np.abs(ref).max()
        if "bg_net" in name and phase == "latent":
            assert scale == 0 and float(grad.abs().max()) == 0, name
            continue
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)


def test_cli_runs_the_tiny_sd_path_on_the_cpu(tmp_path):
    """Warm-up then main phase through the entry point, plain versions."""
    out = main(["--text", "a hamburger", "--backbone", "triplane",
                "--seed", "0", "--lambda_3d_normal_smooth", "0",
                "--iters", "5", "--w", "16", "--h", "16",
                "--triplane_resolution", "32", "--triplane_channels", "8",
                "--grid_size", "32", "--hidden_dim", "32",
                "--dataset_size_train", "1", "--workspace",
                str(tmp_path / "ws"), "--device", "cpu", "--tiny_guidance",
                "--eval_interval", "0", "--H", "16", "--W", "16",
                "--dataset_size_test", "2", "--ckpt", "scratch"])
    assert out["grad_ok"] and out["all_losses_finite"]
    assert len(out["losses"]) == 5 and "psnr_final" not in out
