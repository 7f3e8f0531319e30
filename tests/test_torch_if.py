"""DeepFloyd-IF guidance against the JAX package on the CPU: the cosine
schedule, the T5 encoder, the IF UNet and its blocks, the prompt
embeddings, the pixel-space SDS losses and one IF stage-1 and one DMTet
step, at tiny size with the JAX towers' weights carried over by
``params_from_jax`` (random Flax params from ``jax.eval_shape``: nothing
of the towers is compiled for their init) and JAX's own random draws
handed to the port; then the full-width towers on the meta device (IF-I-XL
and T5-XXL: parameter counts, K10/K12 routes, checkpoint keys), the
converters, and the CLI at tiny size.

Tolerances: the ᾱ table 1e-7 (both cast one float64 table); the bucket ids
and the md5 stand-in embeddings exact; fp32 towers and blocks 1e-4 of the
output's largest magnitude (sums in another order), the bf16 UNet 3e-2 of
it (bf16 activations rounded at other points); the SDS losses 1e-4
relative and their image gradients 1e-4 of the largest entry; the steps
as tests/test_torch_sd.py's and tests/test_torch_dmtet_sd.py's; converted
weights bit for bit.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_dmtet, apply_IF, finalize
from dreamfusion_tpu.guidance import schedule as jsched
from dreamfusion_tpu.guidance.deepfloyd import IFConfig as JIFConfig
from dreamfusion_tpu.guidance.deepfloyd import IFGuidance as JIF
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.models import if_unet as jif
from dreamfusion_tpu.models import t5 as jt5
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JDMTet
from dreamfusion_tpu.utils import convert as C
from dreamfusion_tpu.utils.params import save_params_npz
from dreamfusion_tpu_torch.guidance import schedule as psched
from dreamfusion_tpu_torch.guidance.deepfloyd import IFConfig, IFGuidance
from dreamfusion_tpu_torch.main import main
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.models import if_unet as pif
from dreamfusion_tpu_torch.models import t5 as pt5
from dreamfusion_tpu_torch.models.unet import Conv2d
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.ops import conv as K12
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils import raw_weights as R
from dreamfusion_tpu_torch.utils.convert import (_flat, _leaf, if_unet_key,
                                                 params_from_jax, t5_key)

from torch_parity import (float64_port, float64_state,
                          jax_dmtet_step_draws, jax_pixel_draws,
                          jax_step_draws, port_cfg, random_flax_params,
                          uncut_jax_tile_cap, widened)

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CTX = 32                 # the tiny T5's d_model, the tiny UNet's context


def _close(got, want, rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _unet_params(cfg, seed):
    z = jnp.zeros
    return _np(random_flax_params(jif.IFUNet(cfg).init, z((1, 16, 16, 3)),
                                  z((1,)), z((1, 77, cfg.encoder_hid_dim)),
                                  seed=seed))


def _t5_params(seed):
    return _np(random_flax_params(jt5.T5Encoder(jt5.T5Config.tiny()).init,
                                  jnp.zeros((1, 8), jnp.int32), seed=seed))


def _port_guidance(jp, t_range=(0.02, 0.98)):
    """The tiny port IF guidance holding `jp`'s UNet (and T5)."""
    pg = IFGuidance(IFConfig(t_range=t_range, tiny=True), "cpu")
    state = params_from_jax(jp)
    pg.unet.load_state_dict(state["unet"])
    if "t5" in state:
        pg.t5 = pg.build_t5()
        pg.t5.load_state_dict(state["t5"])
    return pg


@pytest.fixture(scope="module")
def towers():
    jg = JIF(JIFConfig(tiny=True))
    jp = {"unet": _unet_params(jg.unet.cfg, 11)}
    return jg, jp, _port_guidance(jp)


# ---------------------------------------------------------------------------
# schedule and T5
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_jax():
    want = jsched.make_schedule("squaredcos_cap_v2", 1000)
    got = psched.make_schedule("squaredcos_cap_v2", 1000)
    assert got.alphas_cumprod.dtype == np.float32
    np.testing.assert_allclose(got.alphas_cumprod, want.alphas_cumprod,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.betas, want.betas, rtol=0, atol=1e-7)
    assert psched.make_schedule("if").betas.shape == (1000,)
    # the table goes to a device once
    t = torch.tensor([20, 980])
    assert got.table(t.device) is got.table(t.device)
    np.testing.assert_allclose(got.alphas_cumprod_at(t).numpy(),
                               want.alphas_cumprod[[20, 980]], atol=1e-7)


@pytest.mark.parametrize("L", [8, 77, 300])
def test_relative_position_buckets_match_jax(L):
    want = np.asarray(jt5.relative_position_buckets(L, L, 32, 128))
    got = pt5.relative_position_buckets(L, L, 32, 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_t5_encoder_with_a_padded_mask_matches_jax():
    jp = _t5_params(3)
    enc = pt5.T5Encoder(pt5.T5Config.tiny())
    enc.load_state_dict(params_from_jax({"t5": jp})["t5"])
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    want = jt5.T5Encoder(jt5.T5Config.tiny()).apply(
        {"params": jp}, jnp.asarray(ids), jnp.asarray(mask))
    got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(got, want)


# ---------------------------------------------------------------------------
# the UNet and its blocks
# ---------------------------------------------------------------------------

def _block_state(tree, top: str, prefix: str):
    """A standalone Flax block's params under the IF UNet's key map, as
    the port block's state dict (`prefix` stripped)."""
    out = {}
    for path, leaf in _flat(tree):
        key = if_unet_key(f"{top}/{path}", 1)
        assert key.startswith(prefix), key
        out[key[len(prefix):]] = _leaf(path, leaf, True)
    return out


def test_text_time_embedding_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 77, 64)).astype(np.float32)
    jm = jif.TextTimeEmbedding(96, 4)
    jp = _np(random_flax_params(jm.init, jnp.zeros((1, 77, 64)), seed=6))
    pm = pif.TextTimeEmbedding(64, 96, 4, torch.float32)
    pm.load_state_dict(_block_state(jp, "add_embedding", "add_embedding."))
    _close(pm(torch.from_numpy(x)), jm.apply({"params": jp}, jnp.asarray(x)))


def test_if_attention_at_head_dim_64_matches_jax():
    """Two heads of 64 over [77 text + 16 spatial] keys (K10's plain
    version), the text group-normalised over tokens and channels."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 4, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    jm = jif.IFAttention(2, 64, dtype=jnp.float32)
    jp = _np(random_flax_params(jm.init, jnp.zeros((1, 4, 4, 128)),
                                jnp.zeros((1, 77, 48)), seed=8))
    pm = pif.IFAttention(128, 48, 2, 64, 1e-5, torch.float32, torch.float32)
    pm.load_state_dict(_block_state(jp, "mid_attn",
                                    "mid_block.attentions.0."))
    _close(pm(torch.from_numpy(x), torch.from_numpy(ctx)),
           jm.apply({"params": jp}, jnp.asarray(x), jnp.asarray(ctx)))


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
            np.array([20, 731]),
            rng.standard_normal((2, 77, CTX)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_if_unet_matches_jax(towers, dtype):
    """The tiny UNet in fp32, and a narrow one computing in bf16 (fp32
    params, as JAX's IF-XL preset computes)."""
    jg, jp, pg = towers
    x, t, ctx = _unet_inputs(9)
    if dtype == "fp32":
        jcfg, unet, rel = jg.unet.cfg, pg.unet, 1e-4
        params = jp["unet"]
    else:
        jcfg = dataclasses.replace(jif.IFUNetConfig.tiny(),
                                   block_out_channels=(16, 32),
                                   dtype=jnp.bfloat16)
        params = _unet_params(jcfg, 12)
        unet = pif.IFUNet(pif.IFUNetConfig(
            **{**dataclasses.asdict(pif.IFUNetConfig.tiny()),
               "block_out_channels": (16, 32), "dtype": torch.bfloat16}),
            torch.float32)
        unet.load_state_dict(params_from_jax({"unet": params})["unet"])
        rel = 3e-2
    want = jax.jit(jif.IFUNet(jcfg).apply)({"params": params},
                                          jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(ctx))
    got = unet(torch.from_numpy(x), torch.from_numpy(t),
               torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 6)
    _close(got, want, rel)


# ---------------------------------------------------------------------------
# embeddings and SDS
# ---------------------------------------------------------------------------

def test_prepare_embeddings_fallback_is_jax_bit_for_bit(towers):
    jg, jp, pg = towers
    want = jg.prepare_embeddings({"unet": jp["unet"]}, "a hamburger", "ugly")
    got = pg.prepare_embeddings("a hamburger", "ugly")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_prepare_embeddings_through_t5_match_jax():
    """With T5 weights the prompts' hash tokens go through the encoder (as
    JAX's main gives them: no tokenizer files); freed after."""
    jg = JIF(JIFConfig(tiny=True))
    jp = {"unet": _unet_params(jg.unet.cfg, 13), "t5": _t5_params(14)}
    pg = _port_guidance(jp)
    want = jg.prepare_embeddings(jp, "a hamburger", "")
    got = pg.prepare_embeddings("a hamburger", "")
    for k in want:
        _close(got[k], want[k], 1e-5)
    pg.free_t5()
    assert pg.t5 is None and "t5" not in pg.towers()


@pytest.mark.parametrize("perpneg", [False, True])
def test_sds_loss_and_image_gradient_match_jax(towers, perpneg):
    """A 32² render shrunk to the UNet's 16² (the antialiased resize), the
    same t and noise: the loss and its gradient into the render."""
    jg, jp, pg = towers
    rng = np.random.default_rng(15)
    B, L = 1, 77
    rgb = rng.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32)
    uncond = rng.standard_normal((B, L, CTX)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    t, noise = jax_pixel_draws(key, SimpleNamespace(
        t_range=(0.02, 0.98), batch_size=B, h=32, w=32), 16)
    kw = dict(guidance_scale=100.0, grad_scale=1.0)
    if perpneg:
        text_z = rng.standard_normal((3 * B, L, CTX)).astype(np.float32)
        w = np.array([1.0, -1.3, -0.4], np.float32)

        def jloss(img):
            return jg.sds_loss_perpneg(jp, key, jnp.asarray(text_z),
                                       jnp.asarray(w), jnp.asarray(uncond),
                                       img, **kw)

        def ploss(img):
            return pg.sds_loss_perpneg(torch.from_numpy(text_z),
                                       torch.from_numpy(w),
                                       torch.from_numpy(uncond), img, t,
                                       noise, **kw)
    else:
        cond = rng.standard_normal((B, L, CTX)).astype(np.float32)

        def jloss(img):
            return jg.sds_loss(jp, key, jnp.asarray(cond),
                               jnp.asarray(uncond), img, **kw)

        def ploss(img):
            return pg.sds_loss(torch.from_numpy(cond),
                               torch.from_numpy(uncond), img, t, noise, **kw)

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(rgb))
    img = torch.from_numpy(rgb).requires_grad_()
    got = ploss(img)
    (grad,) = torch.autograd.grad(got, img)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    _close(grad, jgrad)


# ---------------------------------------------------------------------------
# one stage-1 step and one DMTet step
# ---------------------------------------------------------------------------

def _capture_grads(monkeypatch):
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    return captured


def _check_step(pm, jm, pgrads, names, captured, new_params, new_j, rtol,
                floor, only=None):
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4 if floor > 1e-4 else 1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jgrads = params_from_jax(_np(captured["grads"]))
    new_j = params_from_jax(_np(new_j))
    for name, grad in zip(names, pgrads):
        if only and not only(name):
            continue
        ref = jgrads[name].numpy()
        scale = np.abs(ref).max()
        if scale == 0:
            assert float(grad.abs().max()) == 0, name
            continue
        np.testing.assert_allclose(grad.numpy(), ref, rtol=rtol,
                                   atol=floor * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(new_params[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)


def test_one_if_train_step_matches_jax(towers, tmp_path, monkeypatch):
    """One tiny IF stage-1 step (the 16² render at the tiny UNet's side),
    loss, gradients and updated parameters against the jitted JAX step."""
    jg, jp, pg = towers
    cfg = finalize(apply_IF(Config(
        text="a hamburger", workspace=str(tmp_path / "ws"),
        backbone="triplane", w=16, h=16, iters=100, batch_size=1,
        triplane_resolution=32, triplane_channels=8, hidden_dim=32,
        grid_size=30, grid_coarse_steps=24, grid_fine_steps=24, fp16=False,
        seed=0, eval_interval=-1, lambda_3d_normal_smooth=0.0,
        use_tensorboard=False)))
    assert cfg.guidance == ("IF",) and cfg.latent_iter_ratio == 0.0
    base = jax.random.PRNGKey(0)
    emb = pg.prepare_embeddings(cfg.text, "")
    jemb = {k: jnp.asarray(v.numpy()) for k, v in emb.items()}
    jt = jtrainer.Trainer(cfg, guidances={"IF": jg},
                          guidance_params={"IF": jp}, embeddings={"IF": jemb})
    pt = Trainer(port_cfg(cfg), "cpu", pg, emb)
    step = next(s for s in range(40, 80) if float(jax_step_draws(
        cfg, jt.renderer, base, s, pixel_size=16).choice.bg_net_u) > 0.5)
    assert not pt.latent_phase(step)
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(step, jnp.int32))
    ps = pt.init_state(0)
    sd = params_from_jax(_np(js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = step
    captured = _capture_grads(monkeypatch)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    draws = jax_step_draws(cfg, jt.renderer, base, step, pixel_size=16)
    assert draws.noise.shape == (1, 16, 16, 3) and draws.posterior_noise is None
    pm, pgrads = pt.train_step(ps, draws)
    names = [n for n, _ in ps.renderer.named_parameters()]
    _check_step(pm, jm, pgrads, names, captured,
                dict(ps.renderer.named_parameters()), js2.params, 1e-3, 1e-3)


def _geometry(grid, seed):
    rng = np.random.default_rng(seed)
    v = grid.vertices
    sdf = np.clip((0.55 - np.linalg.norm(v, axis=-1) + 0.05 * np.sin(
        5 * v[:, 0]) * np.cos(4 * v[:, 1])).astype(np.float32) * 4, -1, 1)
    sdf[np.abs(sdf) < 1e-4] = 1e-3
    pos = (v + rng.normal(scale=0.02, size=v.shape)).astype(np.float32)
    return pos, sdf


DMTET_STEP = 5


def dmtet_if_pair(tmp_path, jp):
    """The JAX and port DMTet trainers under the tiny IF with ``jp``'s UNet,
    both at one perturbed surface of tet grid 8 (the 16² raster render at
    the tiny UNet's side), JAX's tile cap raised so neither side cuts →
    (cfg, JAX trainer, JAX state, port trainer, port state)."""
    cfg = finalize(apply_dmtet(apply_IF(Config(
        text="a hamburger", workspace=str(tmp_path / "ws"),
        backbone="triplane", w=2, h=2, iters=100, batch_size=1,
        triplane_resolution=32, triplane_channels=8, hidden_dim=32,
        num_layers=3, fp16=False, seed=0, eval_interval=-1,
        tet_grid_size=12, lambda_3d_normal_smooth=0.0,
        use_tensorboard=False, lr=2e-3))))
    assert cfg.h == cfg.w == 16 and cfg.guidance == ("IF",)
    grid = jtets.generate_tet_grid(8)
    jg = JIF(JIFConfig(t_range=cfg.t_range, tiny=True))
    pg = _port_guidance(jp, cfg.t_range)
    if torch.get_default_dtype() == torch.float64:
        pg.unet.double()
    emb = pg.prepare_embeddings(cfg.text, "")
    jemb = {k: jnp.asarray(v.float().numpy()) for k, v in emb.items()}
    jt = JDMTet(cfg, tet_grid=grid, guidances={"IF": jg},
                guidance_params={"IF": jp}, embeddings={"IF": jemb})
    pt = DMTetTrainer(port_cfg(cfg), "cpu", pg, emb,
                      tet_grid=ptets.generate_tet_grid(8))
    js = jt.init_state(jax.random.PRNGKey(0))
    pos, sdf = _geometry(grid, 3)
    geo = {"sdf": jnp.asarray(sdf),
           "deform": jnp.asarray(np.arctanh(np.clip(
               (pos - grid.vertices) * 2 * grid.resolution, -0.9, 0.9)))}
    params = {**js.params, "geo": geo}
    js = js.replace(step=jnp.asarray(DMTET_STEP, jnp.int32), params=params,
                    ema_params=params)
    ps = pt.init_state(0)
    sd = params_from_jax(_np({**js.params, "tet_scale": js.tet_scale}))
    ps.tet_scale = sd.pop("tet_scale")
    ps.model.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = DMTET_STEP
    uncut_jax_tile_cap(jt, pt, ps)
    return cfg, jt, js, pt, ps


def test_one_dmtet_if_step_matches_jax(towers, tmp_path, monkeypatch):
    """One DMTet step under IF (the 16² raster render at the tiny UNet's
    side) against the jitted JAX DMTet step.  The loss, the field's
    gradients and the updated parameters are held to JAX's as the other
    steps are; the geometry's gradients are held, each side apart, to the
    port's step in float64.  The rasterizer's backward multiplies the
    image gradient's float32 rounding (~1e-5 of its largest entry on
    either side) by up to ~10 at this surface's 1-4 px² triangles, so each
    float32 side lies up to ~1.6e-4 of the largest from float64 and the two
    sides' roundings add up (tests/f64_witness_dmtet_if.py)."""
    jp = towers[1]
    cfg, jt, js, pt, ps = dmtet_if_pair(tmp_path, jp)
    base = jax.random.PRNGKey(0)
    captured = _capture_grads(monkeypatch)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    draws = jax_dmtet_step_draws(cfg, base, DMTET_STEP, pixel_size=16)
    pm, pgrads = pt.train_step(ps, draws)
    np.testing.assert_allclose(float(pm["loss_sds"]), float(jm["loss_sds"]),
                               rtol=1e-5)
    assert int(pm["n_faces"]) == int(pm["n_faces_true"]) > 0
    names = [n for n, _ in ps.model.named_parameters()]
    geo = ("geo.sdf", "geo.deform")
    _check_step(pm, jm, pgrads, names, captured,
                dict(ps.model.named_parameters()), js2.params, 1e-4, 1e-4,
                only=lambda n: "triplanes" in n)
    with float64_port():
        _, _, _, pt64, ps64 = dmtet_if_pair(tmp_path / "f64", jp)
        _, g64 = pt64.train_step(float64_state(ps64), widened(draws))
    g64 = dict(zip(names, g64))
    jgrads = params_from_jax(_np(captured["grads"]))
    for name, grad in zip(names, pgrads):
        if name not in geo:
            continue
        ref = g64[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        for side, got in (("port", grad.numpy()),
                          ("JAX", jgrads[name].numpy())):
            np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4 * scale,
                                       err_msg=f"{name}: {side} f32 - f64")
    new_p, new_j = dict(ps.model.named_parameters()), \
        params_from_jax(_np(js2.params))
    for name in geo:
        ref = jgrads[name].numpy()
        clear = np.abs(ref) > 1e-2 * np.abs(ref).max()
        np.testing.assert_allclose(new_p[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# full width on the meta device, and the converters
# ---------------------------------------------------------------------------

def _fixture(name):
    with open(os.path.join(FIX, name + ".json")) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


def test_if_xl_on_meta_has_jax_count_keys_and_card_routes():
    """IF-I-XL built on the meta device: JAX's pinned parameter count
    (tests/test_convert_fixtures.py), the published checkpoint's keys and
    shapes (conv [O, I, kh, kw] as the port's [O, kh, kw, I]), and the
    route every conv (K12) and attention (K10) takes on the card."""
    with torch.device("meta"):
        unet = pif.IFUNet(pif.IFUNetConfig.xl(), torch.bfloat16)
    assert sum(p.numel() for p in unet.parameters()) == 4_225_193_478
    inv = _fixture("if_xl_unet_keys")
    state = unet.state_dict()
    assert set(state) == set(inv)
    for k, v in state.items():
        want = inv[k]
        if len(want) == 4:
            want = (want[0], want[2], want[3], want[1])
        assert tuple(v.shape) == want, k
    routes = {}
    for name, m in unet.named_modules():
        if isinstance(m, Conv2d):
            O, kh, kw, I = m.weight.shape
            r = K12.conv_route(m.compute_dtype, I, O, (m.stride,) * 2,
                               kh * kw)
            routes[r] = routes.get(r, 0) + 1
            assert r == {"conv_in": "conv_fwd_wgmma_i8",
                         "conv_out": "conv_fwd_fp32"}.get(
                name, "conv_fwd_wgmma"), name
        elif isinstance(m, pif.IFAttention):
            assert K10.attention_route(m.head_dim) == "attention_fwd_wgmma"
            routes["attention"] = routes.get("attention", 0) + 1
    # 9 down, 1 mid and 12 up attentions; two 3x3 convs in each of the 36
    # resnets (15 down, 2 mid, 19 up, samplers included) and 18 1x1
    # shortcuts (2 down, every up resnet's), conv_in, conv_out
    assert routes == {"conv_fwd_wgmma": 90, "conv_fwd_wgmma_i8": 1,
                      "conv_fwd_fp32": 1, "attention": 22}


def test_t5_xxl_shapes_match_jax_eval_shape():
    jm = jt5.T5Encoder(jt5.T5Config.xxl())
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 8), jnp.int32)),
                            jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        enc = pt5.T5Encoder(pt5.T5Config.xxl())
    state = enc.state_dict()
    seen = set()
    for path, leaf in _flat(shapes):
        k = t5_key(path)
        want = leaf.shape[::-1] if path.endswith("kernel") else leaf.shape
        assert tuple(state[k].shape) == tuple(want), k
        assert state[k].dtype == torch.float32
        seen.add(k)
    assert seen == set(state)
    n = sum(p.numel() for p in enc.parameters())
    assert n == sum(int(np.prod(l.shape)) for l in
                    jax.tree_util.tree_leaves(shapes))
    assert round(n / 1e9, 2) == 4.76


def test_full_width_if_checkpoint_keys_fill_the_port():
    """Every key of the published IF-I-XL UNet and T5-XXL encoder
    inventories fills the port's towers on the meta device (T5's tied
    ``encoder.embed_tokens.weight`` aside, as in JAX)."""
    with torch.device("meta"):
        unet = pif.IFUNet(pif.IFUNetConfig.xl(), torch.bfloat16)
        enc = pt5.T5Encoder(pt5.T5Config.xxl())
    for module, name, extra in ((unet, "if_xl_unet_keys", set()),
                                (enc, "t5_encoder_keys",
                                 {"encoder.embed_tokens.weight"})):
        inv = {k: torch.empty(v, device="meta")
               for k, v in _fixture(name).items()}
        assert R.fill_tower(module, inv, name) == len(inv) - len(extra)
        assert set(inv) - {k for k, _ in module.named_parameters()} == extra


def _write_if_dir(root, jg, src):
    """A diffusers IF directory: the UNet sharded over two safetensors
    files behind an index with its config.json, the T5 encoder with
    ``encoder.embed_tokens.weight`` for its embedding."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(21)

    def state(tree, mapper):
        out = {}
        for path, leaf in C._flax_paths(tree):
            a = rng.standard_normal(leaf.shape).astype(np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2 and path.endswith("kernel"):
                a = a.T
            out[mapper(path)] = np.ascontiguousarray(a)
        return out

    unet = state(src["unet"], C.if_unet_mapper(jg.unet.cfg))
    t5 = state(src["t5"], C.t5_mapper())
    t5["encoder.embed_tokens.weight"] = t5.pop("shared.weight")
    os.makedirs(root / "unet")
    keys = sorted(unet)
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": keys[::2],
              "diffusion_pytorch_model-00002-of-00002.safetensors":
                  keys[1::2]}
    for fname, ks in shards.items():
        save_file({k: unet[k] for k in ks}, str(root / "unet" / fname))
    (root / "unet" / "diffusion_pytorch_model.safetensors.index.json"
     ).write_text(json.dumps({"weight_map": {
         k: f for f, ks in shards.items() for k in ks}}))
    c = jg.unet.cfg
    (root / "unet" / "config.json").write_text(json.dumps({
        "in_channels": 3, "out_channels": 6,
        "block_out_channels": list(c.block_out_channels),
        "layers_per_block": c.layers_per_block,
        "down_block_types": ["ResnetDownsampleBlock2D",
                             "SimpleCrossAttnDownBlock2D"],
        "attention_head_dim": c.head_dim,
        "cross_attention_dim": c.cross_attention_dim,
        "encoder_hid_dim": c.encoder_hid_dim,
        "addition_embed_type_num_heads": c.addition_num_heads}))
    os.makedirs(root / "text_encoder")
    save_file(t5, str(root / "text_encoder" / "model.safetensors"))


def test_convert_if_of_a_diffusers_dir_is_jax_bit_for_bit(tmp_path,
                                                         monkeypatch):
    jg = JIF(JIFConfig(tiny=True))
    template = {"unet": _unet_params(jg.unet.cfg, 17), "t5": _t5_params(18)}
    _write_if_dir(tmp_path / "if", jg, template)
    # JAX's converter inits a T5 template eagerly; hand it the shapes
    monkeypatch.setattr(jt5.T5Encoder, "init",
                        lambda self, *a, **k: {"params": template["t5"]})
    want = params_from_jax(_np(C.convert_if(str(tmp_path / "if"), jg,
                                            {"unet": template["unet"]})))
    pg = IFGuidance(IFConfig(tiny=True), "cpu")
    logs = []
    pg.load_pretrained(str(tmp_path / "if"), torch.Generator().manual_seed(0),
                       logs.append)
    assert pg.t5 is not None and any("T5 encoder" in m for m in logs)
    for name in ("unet", "t5"):
        got = pg.towers()[name].state_dict()
        assert set(got) == set(want[name]), name
        for k, v in want[name].items():
            assert torch.equal(got[k], v), f"{name}.{k}"


def test_npz_weights_load_by_jax_rule(tmp_path):
    """``root/unet.npz`` and ``root/t5.npz`` (JAX's save_params_npz): the
    towers hold them; a UNet key the file lacks keeps the init; a shape
    that does not fit raises."""
    jg = JIF(JIFConfig(tiny=True))
    src = {"unet": _unet_params(jg.unet.cfg, 19), "t5": _t5_params(20)}
    lacking = dict(src["unet"])
    del lacking["conv_out"]
    save_params_npz(str(tmp_path / "unet.npz"), lacking)
    save_params_npz(str(tmp_path / "t5.npz"), src["t5"])
    pg = IFGuidance(IFConfig(tiny=True), "cpu")
    pg.load_pretrained(str(tmp_path), torch.Generator().manual_seed(0))
    init = IFGuidance(IFConfig(tiny=True), "cpu")
    init.init_params(torch.Generator().manual_seed(0))
    want = params_from_jax(src)
    for name in ("unet", "t5"):
        for k, v in pg.towers()[name].state_dict().items():
            ref = init.unet.state_dict()[k] if k.startswith("conv_out") \
                else want[name][k]
            assert torch.equal(v, ref), f"{name}.{k}"
    bad = dict(src["unet"])
    bad["conv_in"] = {"kernel": np.zeros((3, 3, 3, 8), np.float32),
                      "bias": np.zeros(8, np.float32)}
    save_params_npz(str(tmp_path / "unet.npz"), bad)
    with pytest.raises(ValueError, match="does not fit"):
        pg.load_pretrained(str(tmp_path), torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

FLAGS = ["--text", "a hamburger", "--IF", "--backbone", "triplane",
         "--seed", "0", "--lambda_3d_normal_smooth", "0",
         "--triplane_resolution", "32", "--triplane_channels", "8",
         "--grid_size", "32", "--hidden_dim", "32", "--dataset_size_train",
         "1", "--dataset_size_test", "2", "--H", "16", "--W", "16",
         "--eval_interval", "0", "--device", "cpu", "--ckpt", "scratch",
         "--tiny_guidance"]


@pytest.mark.parametrize("mode", ["plain", "perpneg", "dmtet"])
def test_cli_runs_if_on_the_cpu(tmp_path, mode):
    """``--IF --tiny_guidance``: stage 1 (with Perp-Neg too) and the DMTet
    stage from an oracle stage 1's checkpoint (2² x 8 = the tiny UNet's
    16²), through the entry point on the plain versions."""
    extra = ["--w", "16", "--h", "16"]
    if mode == "perpneg":
        extra.append("--perpneg")
    if mode == "dmtet":
        s1 = str(tmp_path / "s1")
        main(["--guidance", "oracle", "--iters", "2", "--workspace", s1,
              "--w", "16", "--h", "16"] + FLAGS[3:-1])
        extra = ["--dmtet", "--init_with", s1 + "/checkpoints", "--w", "2",
                 "--h", "2", "--tet_grid_size", "16", "--lr", "0.002"]
    out = main(FLAGS + extra + ["--iters", "3", "--workspace",
                                str(tmp_path / "ws")])
    assert out["grad_ok"] and out["all_losses_finite"]
    assert out["steps_run"] == 3 and not any(out["latent_phase"])
    log = (tmp_path / "ws" / "log_df.txt").read_text()
    assert "DeepFloyd-IF guidance (tiny" in log and "md5 stand-in" in log
    if mode == "dmtet":
        assert out["faces_dropped_steps"] == [] and out["tile_cut_steps"] == []
