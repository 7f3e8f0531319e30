"""The ``--save_guidance`` snapshot and txt2img against the JAX package on
the CPU.

Tiny towers holding the JAX weights (``params_from_jax``; the JAX params
from ``random_flax_params``) and the JAX draws: SD's, IF's and zero123's
``guidance_eval`` (the noised render and the one-step x0, decoded);
two DDIM steps of SD's ``produce_latents`` and its ``prompt_to_img``, two
of IF's ``produce_imgs``; the latent ``OracleGuidance`` loss and its
gradient into the render (through the VAE encoder); the triptych PNGs of
one stage-1 snapshot (SD and IF, the panels resized 16² → 12² by Pillow's
bicubic filter) and one DMTet snapshot (SD through the rasterizer) written
by the trainers against JAX's ``save_guidance_snapshot``; the two txt2img
CLIs with ``--tiny --device cpu``; the flags against JAX's parser.

Tolerances: decoded panels, latents and pixels 1e-4 of the largest
magnitude (float32, sums in another order); the oracle loss 1e-5 rel and
its gradient 1e-4 rel with a floor of 1e-4 of the largest entry; the
snapshot PNGs within one uint8 level (a float a rounding off a level
boundary truncates to the level below), the render panel exactly equal in
most pixels.
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_dmtet, finalize
from dreamfusion_tpu.guidance import zero123 as jz
from dreamfusion_tpu.guidance.deepfloyd import IFConfig as JIFConfig
from dreamfusion_tpu.guidance.deepfloyd import IFGuidance as JIF
from dreamfusion_tpu.guidance.oracle import OracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.main import build_parser as j_build_parser
from dreamfusion_tpu.main import config_from_args as j_config_from_args
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.models import if_unet as jif
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JDMTet
from dreamfusion_tpu_torch.guidance import deepfloyd as pdf
from dreamfusion_tpu_torch.guidance import sd as psd
from dreamfusion_tpu_torch.guidance import zero123 as pz
from dreamfusion_tpu_torch.guidance.deepfloyd import IFConfig, IFGuidance
from dreamfusion_tpu_torch.guidance.embeddings import prepare_text_embeddings
from dreamfusion_tpu_torch.guidance.oracle import OracleGuidance
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.main import build_parser, config_from_args
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
from dreamfusion_tpu_torch.training.trainer import PriorDraws, Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax
from dreamfusion_tpu_torch.utils.image import load_image

from torch_parity import (jax_pixel_draws, jax_sd_draws, jax_train_state,
                          port_cfg, random_flax_params, tt,
                          uncut_jax_tile_cap)

torch.set_num_threads(2)
TINY = dict(tiny=True, image_size=16, latent_size=8)
PROMPT = "a hamburger"


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _Jitted:
    """A Flax module whose ``apply`` runs jitted, one program per method:
    the JAX guidance code calls its towers eagerly, and eager Flax compiles
    every op apart (the module's fixtures share the programs)."""

    def __init__(self, mod):
        self._mod, self._fns = mod, {}

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def apply(self, variables, *args, method=None):
        name = getattr(method, "__name__", None)
        if name not in self._fns:
            self._fns[name] = jax.jit(self._mod.apply if method is None else
                                      functools.partial(self._mod.apply,
                                                        method=method))
        return self._fns[name](variables, *args)


def _jit_towers(g, *names):
    for n in names:
        setattr(g, n, _Jitted(getattr(g, n)))
    return g


def _sd_params(jg, seed=7):
    z = jnp.zeros
    return _np({
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 4)), z((1,)),
                                   z((1, 16, 32)), seed=seed),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=seed + 1),
        "text": random_flax_params(jg.text_encoder.init,
                                   z((1, 16), jnp.int32), seed=seed + 2)})


@pytest.fixture(scope="module")
def sd():
    """JAX's and the port's tiny SD with the same weights, and the
    prompt's embeddings (the port's, handed to JAX)."""
    jg = _jit_towers(JSD(JSDConfig(**TINY)), "unet", "vae")
    jp = _sd_params(jg)
    pg = StableDiffusionGuidance(SDConfig(**TINY), "cpu")
    pg.load_state_dicts(params_from_jax(jp))
    emb = prepare_text_embeddings(pg, PROMPT, "")
    return jg, jp, pg, emb, {k: jnp.asarray(v.numpy())
                             for k, v in emb.items()}


@pytest.fixture(scope="module")
def ifg():
    """JAX's and the port's tiny IF with the same UNet, and md5 prompt
    embeddings (the port's, handed to JAX)."""
    jg = _jit_towers(JIF(JIFConfig(tiny=True)), "unet")
    ucfg = jg.unet.cfg
    z = jnp.zeros
    jp = _np({"unet": random_flax_params(
        jif.IFUNet(ucfg).init, z((1, 16, 16, 3)), z((1,)),
        z((1, 77, ucfg.encoder_hid_dim)), seed=11)})
    pg = IFGuidance(IFConfig(tiny=True), "cpu")
    pg.unet.load_state_dict(params_from_jax(jp)["unet"])
    emb = pg.prepare_embeddings(PROMPT)
    return jg, jp, pg, emb, {k: jnp.asarray(v.numpy())
                             for k, v in emb.items()}


def _render(seed=3, size=12):
    return np.random.default_rng(seed).random((1, size, size, 3)).astype(
        np.float32)


def test_sd_guidance_eval_matches_jax(sd):
    """The noised latents and the one-step x0 of a 12² render (resized to
    the VAE's 16², encoded with the posterior draw), decoded."""
    jg, jp, pg, emb, jemb = sd
    key = jax.random.PRNGKey(5)
    x = _render()
    want = jg.guidance_eval(jp, key, jemb["default"], jemb["uncond"],
                            jnp.asarray(x), 50.0)
    t, noise, post = jax_sd_draws(key, 1, 8, (0.02, 0.98))
    got = pg.guidance_eval(emb["default"], emb["uncond"],
                           torch.from_numpy(x), t, noise, post, 50.0)
    for g, w in zip(got, want):
        assert g.shape == (1, 16, 16, 3)
        _close(g, w)


def test_if_guidance_eval_matches_jax(ifg):
    """The noised 16² pixels and the one-step x0 (the 6-channel output's
    eps half) of a 12² render."""
    jg, jp, pg, emb, jemb = ifg
    key = jax.random.PRNGKey(6)
    x = _render(4)
    want = jg.guidance_eval(jp, key, jemb["default"], jemb["uncond"],
                            jnp.asarray(x), 20.0)
    t, noise = jax_pixel_draws(key, SimpleNamespace(
        t_range=(0.02, 0.98), batch_size=1), 16)
    got = pg.guidance_eval(emb["default"], emb["uncond"],
                           torch.from_numpy(x), t, noise,
                           guidance_scale=20.0)
    for g, w in zip(got, want):
        assert g.shape == (1, 16, 16, 3)
        _close(g, w)


def _zero123_pair(sd_vae, sd_vae_params):
    """The tiny zero123 pair; its VAE is SD's fixture's (the same tiny
    tower: the jitted programs are shared)."""
    jg = _jit_towers(jz.Zero123Guidance(jz.Zero123Config(tiny=True)),
                     "unet", "vision")
    jg.vae = sd_vae
    z = jnp.zeros
    vis = jg.cfg.vision_config()
    ctx = jg.unet.cfg.context_dim
    rng = np.random.default_rng(3)
    jp = _np({
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 8)), z((1,)),
                                   z((1, 1, ctx)), seed=0),
        "vae": sd_vae_params,
        "vision": random_flax_params(
            jg.vision.init, z((1, vis.image_size, vis.image_size, 3)),
            seed=2),
        "cc_projection": {
            "kernel": (rng.standard_normal((ctx + 4, ctx)) / np.sqrt(ctx))
            .astype(np.float32),
            "bias": 0.05 * rng.standard_normal(ctx).astype(np.float32)}})
    pg = pz.Zero123Guidance(pz.Zero123Config(tiny=True), "cpu")
    for name, state in params_from_jax(jp).items():
        pg.towers()[name].load_state_dict(state, strict=True)
    return jg, jp, pg


def test_zero123_guidance_eval_matches_jax(sd):
    """Conditioned on the first of two references at pose deltas (-10°,
    200°, 0.1): the render through the 16² VAE, noised, denoised in one
    step, both decoded."""
    jg, jp, pg = _zero123_pair(sd[0].vae, sd[1]["vae"])
    refs = ((90.0, 70.0), (0.0, 150.0), (3.2, 3.4), (1.0, 0.5))
    imgs = np.random.default_rng(7).random((2, 16, 16, 3)).astype(np.float32)
    je = jg.prepare_image_embeddings(jp, jnp.asarray(imgs), *refs)
    pe = pg.prepare_image_embeddings(imgs, *refs)
    pose = [np.array([v], np.float32) for v in (-10.0, 200.0, 0.1)]
    key = jax.random.PRNGKey(8)
    x = _render(5)
    want = jg.guidance_eval(jp, key, je, jnp.asarray(x),
                            *map(jnp.asarray, pose), guidance_scale=5.0)
    t, noise, post = jax_sd_draws(key, 1, 8, (0.02, 0.98))
    got = pg.guidance_eval(pe, torch.from_numpy(x),
                           *map(torch.from_numpy, pose), t, noise, post,
                           guidance_scale=5.0)
    for g, w in zip(got, want):
        assert g.shape == (1, 16, 16, 3)
        _close(g, w)


def test_sd_produce_latents_and_prompt_to_img_match_jax(sd):
    """Two DDIM steps (t = 999, 499, then x0) from JAX's start latents,
    then the decode."""
    jg, jp, pg, emb, jemb = sd
    key = jax.random.PRNGKey(9)
    kw = dict(num_inference_steps=2, guidance_scale=7.5)
    want = jg.produce_latents(jp, key, jemb["default"], jemb["uncond"], **kw)
    _, k0 = jax.random.split(key)
    lat = tt(jax.random.normal(k0, (1, 8, 8, 4)))
    got = pg.produce_latents(emb["default"], emb["uncond"], lat, **kw)
    _close(got, want)
    img = pg.prompt_to_img(emb["default"], emb["uncond"], lat, **kw)
    assert img.shape == (1, 16, 16, 3)
    _close(img, jg.decode_latents(jp, want))


def test_if_produce_imgs_matches_jax(ifg):
    """Two DDIM steps on the cosine schedule from JAX's start pixels."""
    jg, jp, pg, emb, jemb = ifg
    key = jax.random.PRNGKey(10)
    want = jg.produce_imgs(jp, key, jemb["default"], jemb["uncond"],
                           num_inference_steps=2, guidance_scale=7.0)
    _, k0 = jax.random.split(key)
    got = pg.produce_imgs(emb["default"], emb["uncond"],
                          tt(jax.random.normal(k0, (1, 16, 16, 3))),
                          num_inference_steps=2, guidance_scale=7.0)
    assert got.shape == (1, 16, 16, 3)
    _close(got, want)


def test_latent_oracle_loss_and_gradient_match_jax(sd):
    """The latent oracle toward a target image: the render and the target
    through the same encoder and posterior draw, the closed-form noise,
    the reparameterized loss, and its gradient into the 12² render
    through the VAE encoder's backward."""
    _, jp, _, _, _ = sd
    jo = _jit_towers(JOracle(JSDConfig(**TINY)), "vae")
    po = OracleGuidance(SDConfig(**TINY), "cpu")
    po.load_state_dicts(params_from_jax(jp))
    x, tgt = _render(11), _render(12)
    key = jax.random.PRNGKey(13)
    jl, jgrad = jax.value_and_grad(lambda r: jo.sds_loss(
        jp, key, jnp.asarray(tgt), None, r, grad_scale=0.5))(jnp.asarray(x))
    t, noise, post = jax_sd_draws(key, 1, 8, (0.02, 0.98))
    xr = torch.from_numpy(x).requires_grad_()
    loss = po.sds_loss(torch.from_numpy(tgt), None, xr, t, noise, post,
                       grad_scale=0.5)
    (grad,) = torch.autograd.grad(loss, xr)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(jnp.abs(jgrad).max()) > 0
    _close(grad, jgrad)


# ---------------------------------------------------------------------------
# the trainers' triptychs
# ---------------------------------------------------------------------------

def _triptych_close(got_path, want_path, H, W):
    got, want = (np.asarray(Image.open(p)).astype(int)
                 for p in (got_path, want_path))
    assert got.shape == want.shape == (H, 3 * W, 3)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() > 0.9
    assert (got[:, W:2 * W] != got[:, :W]).any()     # noised != render


def _load_field(ps, js):
    state = params_from_jax(_np(js.params))
    ps.renderer.load_state_dict(state)
    for k, v in ps.ema_params.items():
        v.copy_(state[k])


def test_stage1_snapshot_png_matches_jax(tmp_path, sd, ifg):
    """One stage-1 snapshot of SD and IF together (each prior's draws from
    the step's key, as JAX's ``save_guidance_snapshot`` draws them): the
    default view at 12², and the 16² panels resized by Pillow's bicubic
    filter as JAX resizes them."""
    jg, jp, pg, emb, jemb = sd
    ig, ip, pi, iemb, jiemb = ifg
    cfg = finalize(Config(
        text=PROMPT, guidance=("SD", "IF"), workspace=str(tmp_path / "j"),
        backbone="triplane", w=12, h=12, iters=10, batch_size=1,
        triplane_resolution=32, triplane_channels=8, hidden_dim=32,
        grid_size=30, grid_coarse_steps=24, grid_fine_steps=24, fp16=False,
        seed=0, use_tensorboard=False, guidance_scale=20.0,
        save_guidance=True))
    jt = jtrainer.Trainer(cfg, guidances={"SD": jg, "IF": ig},
                          guidance_params={"SD": jp, "IF": ip},
                          embeddings={"SD": jemb, "IF": jiemb})
    js = jax_train_state(jt)
    step = 6
    jt.global_step = step
    jt.save_guidance_snapshot(js)
    pcfg = dataclasses.replace(port_cfg(cfg), workspace=str(tmp_path / "p"))
    pt = Trainer(pcfg, "cpu", priors={"SD": (pg, emb), "IF": (pi, iemb)})
    ps = pt.init_state(0)
    _load_field(ps, js)
    ps.step = step
    key = jax.random.PRNGKey(step)
    draws = {"SD": PriorDraws(*jax_sd_draws(key, 1, 8, cfg.t_range)),
             "IF": PriorDraws(*jax_pixel_draws(key, SimpleNamespace(
                 t_range=cfg.t_range, batch_size=1), 16))}
    paths = pt.save_guidance_snapshot(ps, draws)
    assert [os.path.basename(p) for p in paths] == [
        "step_000006_IF.png", "step_000006_SD.png"]
    for p in paths:
        _triptych_close(p, os.path.join(cfg.workspace, "guidance",
                                        os.path.basename(p)), 12, 12)


def _geometry(grid, seed):
    """A lumpy sphere sdf (no exact zeros) and a small deformation, as
    ``tests/test_torch_dmtet_sd.py`` draws them."""
    rng = np.random.default_rng(seed)
    v = grid.vertices
    sdf = np.clip((0.55 - np.linalg.norm(v, axis=-1) + 0.05 * np.sin(
        5 * v[:, 0]) * np.cos(4 * v[:, 1])).astype(np.float32) * 4, -1, 1)
    sdf[np.abs(sdf) < 1e-4] = 1e-3
    pos = (v + rng.normal(scale=0.02, size=v.shape)).astype(np.float32)
    return {"sdf": jnp.asarray(sdf),
            "deform": jnp.asarray(np.arctanh(np.clip(
                (pos - v) * 2 * grid.resolution, -0.9, 0.9)))}


def test_dmtet_snapshot_png_matches_jax(tmp_path, sd):
    """One DMTet snapshot under SD: the default view rasterized at 16²
    (``circle_view_batch(cfg, 0, 4, h, w)``), its SD panels at the tiny
    VAE's 16² (no resize)."""
    jg, jp, pg, emb, jemb = sd
    cfg = finalize(apply_dmtet(Config(
        text=PROMPT, guidance=("SD",), workspace=str(tmp_path / "j"),
        backbone="triplane", w=2, h=2, iters=10, batch_size=1,
        triplane_resolution=32, triplane_channels=8, hidden_dim=32,
        num_layers=3, tet_grid_size=12, fp16=False, seed=0,
        use_tensorboard=False, save_guidance=True)))
    assert (cfg.h, cfg.w) == (16, 16)
    grid = jtets.generate_tet_grid(8)
    jt = JDMTet(cfg, tet_grid=grid, guidances={"SD": jg},
                guidance_params={"SD": jp}, embeddings={"SD": jemb})
    pcfg = dataclasses.replace(port_cfg(cfg), workspace=str(tmp_path / "p"))
    pt = DMTetTrainer(pcfg, "cpu", pg, emb,
                      tet_grid=ptets.generate_tet_grid(8))
    js = jt.init_state(jax.random.PRNGKey(0))
    params = {**js.params, "geo": _geometry(grid, 3)}
    js = js.replace(params=params, ema_params=params)
    ps = pt.init_state(0)
    state = params_from_jax(_np({**js.params, "tet_scale": js.tet_scale}))
    ps.tet_scale = state.pop("tet_scale")
    ps.model.load_state_dict(state)
    for k, v in ps.ema_params.items():
        v.copy_(state[k])
    uncut_jax_tile_cap(jt, pt, ps)
    step = 4
    jt.global_step = step
    jt.save_guidance_snapshot(js)
    ps.step = step
    key = jax.random.PRNGKey(step)
    # JAX draws t in its guidance's range (main builds it from the run's;
    # the fixture's is the default)
    (path,) = pt.save_guidance_snapshot(
        ps, {"SD": PriorDraws(*jax_sd_draws(key, 1, 8, (0.02, 0.98)))})
    _triptych_close(path, os.path.join(cfg.workspace, "guidance",
                                       "step_000004_SD.png"), 16, 16)


# ---------------------------------------------------------------------------
# the CLIs and the flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", ["sd", "deepfloyd"])
def test_txt2img_cli_writes_a_png_on_the_cpu(tmp_path, cli):
    """``python -m dreamfusion_tpu_torch.guidance.{sd,deepfloyd} prompt
    --tiny --device cpu --steps 2``: a finite PNG at the tiny towers'
    side."""
    out = str(tmp_path / f"{cli}.png")
    mod = psd if cli == "sd" else pdf
    assert mod._main([PROMPT, "--tiny", "--steps", "2", "--device", "cpu",
                      "--out", out]) == out
    img = load_image(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_save_guidance_flags_parse_as_jax():
    flags = ["--text", PROMPT, "--save_guidance", "--save_guidance_interval",
             "3"]
    p = config_from_args(build_parser().parse_args(flags))
    j = j_config_from_args(j_build_parser().parse_args(flags))
    assert (p.save_guidance, p.save_guidance_interval) == \
        (j.save_guidance, j.save_guidance_interval) == (True, 3)
    d = config_from_args(build_parser().parse_args(["--text", PROMPT]))
    assert (d.save_guidance, d.save_guidance_interval) == (False, 10)
