"""Zero-1-to-3 guidance against the JAX package on the CPU.

The CLIP vision tower and ``clip_preprocess``, ``cc_projection``'s identity
init, the relative camera (azimuths above 180° wrapped), the reference
embeddings, ``sds_loss`` and its gradient into the render (K = 1 and 2
references, grad-scale mode ``angle`` and ``None``, through the VAE and as
latents), two DDIM steps of ``novel_view``, and one tiny image-mode train
step (SDS, then known-view) against the jitted JAX step, all with the test
towers holding the JAX weights (``params_from_jax``) and the JAX draws;
K10's plain version at one key (zero123's cross-attention) against JAX's
``attention``, JAX's chunked-branch predicate at K = 4 and 5 references;
and the full-width towers' parameter shapes (from ``jax.eval_shape``) and
kernel routes.

Tolerances: towers and embeddings 1e-4 of the largest magnitude (float32,
sums in another order); the SDS loss 1e-5 rel and its gradient 1e-4 rel
with a floor of 1e-4 of the largest entry; the decoded novel views 1e-4;
the whole step as ``tests/test_torch_image.py`` holds the image steps
(loss 1e-5 rel, gradients rtol 1e-3 with a floor of 1e-3 of the largest,
the updated parameters 1e-5 where the gradient is clearly nonzero).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, apply_image_mode, finalize
from dreamfusion_tpu.guidance import zero123 as jz
from dreamfusion_tpu.models import clip as jclip
from dreamfusion_tpu.ops.attention import attention as jattention
from dreamfusion_tpu.training.image_data import \
    analytic_ref_images as j_ref_images
from dreamfusion_tpu_torch.guidance import zero123 as pz
from dreamfusion_tpu_torch.models import clip as pclip
from dreamfusion_tpu_torch.models import unet as punet
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.training.image_data import RefImages
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import (jax_known_view_draws, jax_sd_draws,
                          jax_step_draws, port_cfg, random_flax_params, tt)

torch.set_num_threads(2)
STEP = 48


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the towers and the embeddings
# ---------------------------------------------------------------------------

def _jax_params(jg, seed=0):
    """The tiny towers' Flax params (``random_flax_params``) and a random
    cc_projection, as numpy."""
    z = jnp.zeros
    vis = jg.cfg.vision_config()
    ctx = jg.unet.cfg.context_dim
    p = {"unet": random_flax_params(jg.unet.init, z((1, 8, 8, 8)), z((1,)),
                                    z((1, 1, ctx)), seed=seed),
         "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                   jax.random.PRNGKey(1), seed=seed + 1),
         "vision": random_flax_params(
             jg.vision.init, z((1, vis.image_size, vis.image_size, 3)),
             seed=seed + 2)}
    rng = np.random.default_rng(seed + 3)
    p["cc_projection"] = {
        "kernel": (rng.standard_normal((ctx + 4, ctx)) / math.sqrt(ctx))
        .astype(np.float32),
        "bias": 0.05 * rng.standard_normal(ctx).astype(np.float32)}
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's tiny zero123 guidance with the same weights."""
    jg = jz.Zero123Guidance(jz.Zero123Config(tiny=True))
    jp = _jax_params(jg)
    pg = pz.Zero123Guidance(pz.Zero123Config(tiny=True), "cpu")
    for name, sd in params_from_jax(jp).items():
        pg.towers()[name].load_state_dict(sd, strict=True)
    return jg, jp, pg


def _images(K, size=20, seed=5):
    return np.random.default_rng(seed).random((K, size, size, 3)).astype(
        np.float32)


def test_vision_tower_and_preprocess_match_jax():
    """The ViT at test width (32², patches of 8, 2 layers) over two images
    resized from 40² by ``clip_preprocess``: the projection and the last
    hidden state."""
    cfg = jclip.CLIPVisionConfig.tiny()
    jenc = jclip.CLIPVisionEncoder(cfg)
    jp = random_flax_params(jenc.init, jnp.zeros((1, 32, 32, 3)), seed=11)
    penc = pclip.CLIPVisionEncoder(pclip.CLIPVisionConfig.tiny())
    penc.load_state_dict(params_from_jax({"vision": jp})["vision"],
                         strict=True)
    x = _images(2, 40)
    jpx = jclip.clip_preprocess(jnp.asarray(x), 32)
    ppx = pclip.clip_preprocess(torch.from_numpy(x), 32)
    _close(ppx, jpx, 1e-5)
    jproj, jh = jax.jit(jenc.apply)({"params": jp}, jpx)
    pproj, ph = penc(torch.from_numpy(np.asarray(jpx)))
    assert pproj.dtype == torch.float32 and pproj.shape == (2, 16)
    _close(pproj, jproj)
    _close(ph, jh)


def test_cc_projection_init_and_camera_T_match_jax():
    """``cc_projection`` starts as [I | 0] (the CLIP embedding through, the
    pose ignored), and the relative camera wraps azimuths above 180°."""
    jg = jz.Zero123Guidance(jz.Zero123Config(tiny=True))
    real = jg.unet, jg.vae, jg.vision

    class _NoInit:                 # the towers' Flax init is not under test
        def __init__(self, mod):
            self.cfg = mod.cfg

        def init(self, *args, **kwargs):
            return {"params": {}}

    jg.unet, jg.vae, jg.vision = map(_NoInit, real)
    jcc = jg.init_params(jax.random.PRNGKey(0))["cc_projection"]
    jg.unet, jg.vae, jg.vision = real
    pg = pz.Zero123Guidance(pz.Zero123Config(tiny=True), "cpu")
    seconds = pg.init_params(torch.Generator().manual_seed(0))
    assert set(seconds) == {"unet", "vae", "vision", "cc_projection"}
    want = params_from_jax({"cc_projection": jax.tree.map(np.asarray, jcc)})
    for k, v in want["cc_projection"].items():
        np.testing.assert_array_equal(
            pg.cc_projection.state_dict()[k].numpy(), v.numpy())
    assert pg.cc_projection.weight.shape == (32, 36)
    polar = np.array([-20.0, 0.0, 35.5, 10.0], np.float32)
    azimuth = np.array([190.0, -30.0, 359.0, 180.0], np.float32)
    radius = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    want = jg._camera_T(*map(jnp.asarray, (polar, azimuth, radius)))
    got = pz.camera_T(*map(torch.from_numpy, (polar, azimuth, radius)))
    assert got.shape == (4, 1, 4)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("K", [1, 2])
def test_image_embeddings_match_jax(pair, K):
    """``get_img_embeds`` (CLIP projection; the VAE posterior's mode,
    unscaled) and ``prepare_image_embeddings`` (resized to the VAE's 16²
    first) with the references' poses and weights."""
    jg, jp, pg = pair
    x = _images(K, 16)
    jc, jcat = jax.jit(jg.get_img_embeds)(jp, jnp.asarray(x))
    pc, pcat = pg.get_img_embeds(torch.from_numpy(x))
    assert pc.shape == (K, 1, 32) and pcat.shape == (K, 8, 8, 4)
    _close(pc, jc)
    _close(pcat, jcat)
    poses = dict(ref_polars=(90.0, 80.0)[:K], ref_azimuths=(0.0, 200.0)[:K],
                 ref_radii=(3.2, 3.0)[:K], zero123_ws=(1.0, 0.5)[:K])
    x = _images(K, 24)
    je = _jax_embeddings(jg, jp, x, *poses.values())
    pe = pg.prepare_image_embeddings(x, *poses.values())
    for k in ("c_crossattn", "c_concat"):
        _close(pe[k], je[k])
    for k, v in poses.items():
        np.testing.assert_array_equal(pe[k].numpy(),
                                      np.asarray(je[k], np.float32))
        np.testing.assert_array_equal(pe[k].numpy(),
                                      np.asarray(v, np.float32))


def _jax_embeddings(jg, jp, images, polars, azimuths, radii, ws):
    """JAX's ``prepare_image_embeddings``, jitted (its eager ops would
    compile one by one)."""
    out = jax.jit(lambda p, x: jg.prepare_image_embeddings(
        p, x, polars, azimuths, radii, ws))(jp, jnp.asarray(images))
    return {k: tuple(float(a) for a in v) if isinstance(v, tuple) else v
            for k, v in out.items()}


def _embeddings(jg, jp, K):
    """JAX's embeddings of K references, and the same arrays as the
    port's."""
    refs = dict(ref_polars=(90.0, 70.0)[:K], ref_azimuths=(0.0, 150.0)[:K],
                ref_radii=(3.2, 3.4)[:K], zero123_ws=(1.0, 0.5)[:K])
    je = _jax_embeddings(jg, jp, _images(K, 16, seed=7), *refs.values())
    pe = {k: tt(np.asarray(v, np.float32)) for k, v in je.items()}
    return je, pe


MODES = ("angle", "None")
SDS_POSE = [np.array(v, np.float32) for v in ([-10.0], [200.0], [0.1])]


@pytest.fixture(scope="module")
def sds_jax(pair):
    """Per K: JAX's SDS loss and gradient for both grad-scale modes,
    through the VAE and as latents, in one jitted call (XLA shares the
    modes' UNet), with the port's embeddings and the renders."""
    jg, jp, _ = pair
    cache = {}

    def get(K):
        if K not in cache:
            je, pe = _embeddings(jg, jp, K)
            guides = {m: jz.Zero123Guidance(jz.Zero123Config(
                tiny=True, grad_scale_mode=m)) for m in MODES}
            rng = np.random.default_rng(K)
            preds = {al: rng.random((1, 12, 12, 4 if al else 3)).astype(
                np.float32) for al in (False, True)}
            key = jax.random.PRNGKey(3 + K)
            pose = [jnp.asarray(v) for v in SDS_POSE]

            def losses(p3, p4):
                return {(m, al): jax.value_and_grad(
                    lambda x, g=guides[m], al=al: g.sds_loss(
                        jp, key, je, x, *pose, guidance_scale=5.0,
                        as_latent=al, grad_scale=0.7))(
                            p4 if al else p3)
                        for m in MODES for al in (False, True)}

            out = jax.jit(losses)(preds[False], preds[True])
            cache[K] = (pe, preds, key, out)
        return cache[K]

    return get


@pytest.mark.parametrize("as_latent", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [1, 2])
def test_sds_loss_and_gradient_match_jax(pair, sds_jax, monkeypatch, K,
                                         mode, as_latent):
    """The batched 2·K·B UNet call, the closeness weights over the
    references, the CFG mix and the pose grad scale: the loss and its
    gradient into the render with JAX's own draws."""
    _, _, pg = pair
    pe, preds, key, out = sds_jax(K)
    monkeypatch.setattr(pg, "cfg", dataclasses.replace(
        pg.cfg, grad_scale_mode=mode))
    jl, jgrad = out[mode, as_latent]
    t, noise, post = jax_sd_draws(key, 1, 8, pg.cfg.t_range)
    x = torch.from_numpy(preds[as_latent]).requires_grad_()
    pl = pg.sds_loss(pe, x, *map(torch.from_numpy, SDS_POSE), t, noise,
                     post, guidance_scale=5.0, as_latent=as_latent,
                     grad_scale=0.7)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    (pgrad,) = torch.autograd.grad(pl, [x])
    assert float(np.abs(jgrad).max()) > 0
    _close(pgrad, jgrad)


def test_closeness_weights_match_jax_formula():
    """ws over three references (weights 1, 1, 0.5) for views near each:
    the cut below 0.1 and the normalisation by the largest."""
    angles = np.array([[1.0, 170.0, 89.0], [60.0, 120.0, 30.0],
                       [0.0, 180.0, 90.0]], np.float32)
    w = np.array([1.0, 1.0, 0.5], np.float32)
    inv = np.minimum(1 / np.maximum(angles, 1e-6), 100.0)
    inv = inv / inv.max(-1, keepdims=True)
    inv = np.where(inv < 0.1, 0.0, inv)
    want = w[None] * inv
    want = want / want.max(-1, keepdims=True)
    want = np.where(want < 0.1, 0.0, want)
    got = pz.closeness_weights(torch.from_numpy(angles), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got.numpy() == 0).any()
    one = pz.closeness_weights(torch.from_numpy(angles[:, :1]),
                               torch.from_numpy(w[:1]))
    np.testing.assert_array_equal(one.numpy(), np.ones((3, 1), np.float32))


def test_novel_view_two_ddim_steps_match_jax(pair):
    """Two DDIM steps from JAX's start latents, conditioned on the first
    reference, decoded."""
    jg, jp, pg = pair
    je, pe = _embeddings(jg, jp, 1)
    pose = [np.array([v], np.float32) for v in (-20.0, 220.0, 0.2)]
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p, k: jg.novel_view(
        p, k, je, *map(jnp.asarray, pose), num_inference_steps=2,
        guidance_scale=3.0))(jp, key)
    _, k0 = jax.random.split(key)
    latents = tt(jax.random.normal(k0, (1, 8, 8, 4)))
    got = pg.novel_view(pe, *map(torch.from_numpy, pose), latents,
                        num_inference_steps=2, guidance_scale=3.0)
    assert got.shape == (1, 16, 16, 3)
    _close(got, want)


def test_schedule_ddim_and_x0_match_jax():
    from dreamfusion_tpu.guidance.schedule import make_schedule as jsched
    from dreamfusion_tpu_torch.guidance.schedule import make_schedule
    js, ps = jsched("zero123"), make_schedule("zero123")
    rng = np.random.default_rng(2)
    x, e = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
            for _ in range(2))
    t = np.array([999, 500, 19])
    tp = np.array([979, 0, -1])
    _close(ps.predict_start_from_noise(*map(torch.from_numpy, (x, t, e))),
           js.predict_start_from_noise(*map(jnp.asarray, (x, t, e))), 1e-6)
    _close(ps.ddim_step(*map(torch.from_numpy, (x, e, t, tp))),
           js.ddim_step(*map(jnp.asarray, (x, e, t, tp))), 1e-6)


# ---------------------------------------------------------------------------
# one tiny image-mode step against the jitted JAX step
# ---------------------------------------------------------------------------

def _check_step(pm, jm, pgrads, captured, js2, module):
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jgr = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    pparams = dict(module.named_parameters())
    checked = 0
    for name, grad in zip(pparams, pgrads):
        ref = jgr[name].numpy()
        scale = np.abs(ref).max()
        if scale == 0:                # a scale masked by the progressive level
            assert not grad.numpy().any(), name
            continue
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def test_one_zero123_image_step_matches_jax(tmp_path, monkeypatch, pair):
    """``--image`` without ``--text`` (the image preset: zero123 guidance,
    progressive view) on the analytic reference, from the same field: an
    SDS step through the tiny VAE (step 49), then a known-view step (step
    52)."""
    jg, jp, pg = pair
    cfg = finalize(apply_image_mode(Config(
        image="analytic:two_sphere", workspace=str(tmp_path / "ws"), w=16,
        h=16, iters=400, batch_size=1, triplane_resolution=32,
        triplane_channels=8, triplane_scales=2, hidden_dim=32, grid_size=30,
        grid_coarse_steps=24, grid_fine_steps=24, fp16=False, seed=0,
        eval_interval=-1, use_tensorboard=False, lr=1e-2,
        backbone="triplane")))
    cfg = dataclasses.replace(cfg, lambda_3d_normal_smooth=0.0)
    assert cfg.guidance == ("zero123",) and cfg.progressive_view
    ref = j_ref_images(cfg, cfg.h, cfg.w, "two_sphere")
    je = _jax_embeddings(jg, jp, ref.rgb, ref.polars, ref.azimuths,
                         ref.radii, ref.weights)
    jt = jtrainer.Trainer(cfg, guidances={"zero123": jg},
                          guidance_params={"zero123": jp},
                          embeddings={"zero123": je}, ref_images=ref)
    pref = RefImages(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(RefImages)})
    pe = {k: tt(np.asarray(v, np.float32)) for k, v in je.items()}
    pt = Trainer(port_cfg(cfg), "cpu", pg, pe, ref_images=pref)
    assert pt.latent_size == 8
    base = jax.random.PRNGKey(0)
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    for step, kind in ((STEP + 1, "SDS"), (STEP + 4, "known-view")):
        # each from a fresh state: a second Adan step would mix the first
        # step's rounding into its moments
        js = jt.init_state(jax.random.PRNGKey(0))
        ps = pt.init_state(0)
        js = js.replace(step=jnp.asarray(step, jnp.int32))
        sd = params_from_jax(jax.tree.map(np.asarray, js.params))
        ps.renderer.load_state_dict(sd)
        for k, v in ps.ema_params.items():
            v.copy_(sd[k])
        ps.step = step
        assert pt.is_known_view_step(step) == (kind == "known-view")
        if kind == "SDS":
            js2, jm = jt._make_train_step("main")(js, base)
            pm, pgrads = pt.train_step(ps, jax_step_draws(
                cfg, jt.renderer, base, step, 8))
            np.testing.assert_allclose(float(pm["loss_sds"]),
                                       float(jm["loss_sds"]), rtol=1e-5)
            assert float(pm["loss_sds"]) > 0
        else:
            js2, jm = jt._make_known_view_step()(js, base)
            R = pt.kv_batch.rays_o.shape[1]
            pm, pgrads = pt.known_view_step(ps, jax_known_view_draws(
                cfg, jt.renderer, base, step, 1, R))
        jax.block_until_ready(js2)
        _check_step(pm, jm, pgrads, captured, js2, ps.renderer)


# ---------------------------------------------------------------------------
# K10 at one key, JAX's branch at K references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,h,d", [(64, 2, 40), (16, 2, 80), (4, 3, 160)])
def test_attention_over_one_key_matches_jax(N, h, d, dtype):
    """zero123's cross-attention: one context token, so P = 1 and the
    output is v (bit for bit in bf16); float32 with the VJP."""
    rng = np.random.default_rng(N + d)
    q = rng.standard_normal((2, N, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 1, h, d)).astype(np.float32)
            for _ in range(2))
    assert not K10.chunked_branch(2, N, 1, h)
    if dtype == "float32":
        o_j, vjp = jax.vjp(jattention, *map(jnp.asarray, (q, k, v)))
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = K10.attention(*qkv)
        _close(o, o_j, 1e-6)
        go = rng.standard_normal(o_j.shape).astype(np.float32)
        for g, gj in zip(torch.autograd.grad(o, qkv, torch.from_numpy(go)),
                         vjp(jnp.asarray(go))):
            _close(g, gj, 1e-5)
        return
    qkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    o = K10.attention(*qkv)
    o_j = jattention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert torch.equal(o, qkv[2].expand_as(o))
    np.testing.assert_array_equal(o.float().numpy(),
                                  np.asarray(o_j.astype(jnp.float32)))


@pytest.mark.parametrize("K,chunked", [(1, False), (4, False), (5, True)])
def test_chunked_branch_at_k_references(K, chunked):
    """The UNet's 32² self-attention at CFG batch 2K (8 heads, 1024
    tokens): JAX's chunked branch from K = 5 on (2K·8·1024² > 64·2²⁰), the
    one-key cross-attention never."""
    assert K10.chunked_branch(2 * K, 1024, 1024, 8) == chunked
    assert not K10.chunked_branch(2 * K, 1024, 1, 8)


# ---------------------------------------------------------------------------
# the full-width towers: shapes and routes
# ---------------------------------------------------------------------------

def _port_shape(path, shape):
    if not path.endswith("kernel"):
        return tuple(shape)
    if len(shape) == 4 and shape[:2] == (1, 1):
        return (shape[3], shape[2])
    if len(shape) == 4:
        return (shape[3], shape[0], shape[1], shape[2])
    return tuple(reversed(shape))


def test_full_width_zero123_towers_take_the_jax_parameters():
    """``jax.eval_shape`` of JAX's zero123 UNet (8 input channels) and
    ViT-L/14 init: every Flax parameter has a port key in the port's
    layout, one for one with the port's state_dicts (859.5M and 304.0M
    parameters); cc_projection [772, 768] becomes [768, 772]."""
    from dreamfusion_tpu_torch.utils import convert

    jg = jz.Zero123Guidance(jz.Zero123Config())
    u = jax.eval_shape(jg.unet.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,)),
                       jnp.zeros((1, 1, 768)))["params"]
    v = jax.eval_shape(jg.vision.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 224, 224, 3)))["params"]
    cc = {"kernel": jax.ShapeDtypeStruct((772, 768), jnp.float32),
          "bias": jax.ShapeDtypeStruct((768,), jnp.float32)}
    with torch.device("meta"):
        pg = pz.Zero123Guidance.__new__(pz.Zero123Guidance)
        pg.cfg = pz.Zero123Config()
        unet = punet.UNet2DCondition(pg.cfg.unet_config())
        vision = pclip.CLIPVisionEncoder(pg.cfg.vision_config())
        ccp = punet.Dense(772, 768, dtype=torch.bfloat16)
    counts = {}
    for tower, tree, mod in (("unet", u, unet), ("vision", v, vision),
                             ("cc_projection", cc, ccp)):
        L = convert._levels(tree) if tower == "unet" else 0
        key = convert.tower_key(tower, L)
        got = {key(p): _port_shape(p, leaf.shape)
               for p, leaf in convert._flat(tree)}
        want = {k: tuple(t.shape) for k, t in mod.state_dict().items()}
        assert got == want, tower
        counts[tower] = sum(math.prod(s) for s in got.values()) / 1e6
    assert round(counts["unet"], 1) == 859.5
    assert round(counts["vision"], 1) == 304.0
    assert unet.conv_in.weight.shape == (320, 3, 3, 8)
    assert vision.embeddings.patch_embedding.weight.shape == (1024, 14, 14,
                                                              3)


def test_full_width_zero123_routes():
    """At full width: the conv_in (8 channels) on K12's narrow wgmma
    route, the ViT's 14x14 stride-14 patch embedding on conv_fwd_mma, the
    UNet's attention at SD 1.5's head dims (10, 10 and 12 calls a step at d
    = 40, 80, 160: chip_smoke's counts), half of them over one key, and
    chip_smoke's zero123 rows at half of SD's sides."""
    import importlib.util
    from pathlib import Path

    from dreamfusion_tpu_torch.ops.conv import conv_route

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = pz.Zero123Config()
    with torch.device("meta"):
        unet = punet.UNet2DCondition(cfg.unet_config())
        vision = pclip.CLIPVisionEncoder(cfg.vision_config())
    assert conv_route(torch.bfloat16, 8, 320, (1, 1), 9) == \
        "conv_fwd_wgmma_i8"
    pe = vision.embeddings.patch_embedding
    assert (pe.stride, pe.padding, pe.bias) == (14, 0, None)
    assert conv_route(torch.bfloat16, 3, 1024, (14, 14), 196) == \
        "conv_fwd_mma"
    assert smoke.PATCH_CONV == (1, 224, 224, 3, 1024, 14, 14, 0, "bf16",
                                False)
    routes = [K10.attention_route(m.head_dim) for m in unet.modules()
              if isinstance(m, punet.CrossAttention)]
    assert {r: routes.count(r) for r in set(routes)} == \
        smoke.SD15_UNET_ATTNS
    cross = [m for name, m in unet.named_modules()
             if isinstance(m, punet.CrossAttention) and
             name.endswith("attn2")]
    assert len(cross) == 16 and {m.to_k.weight.shape[1] for m in cross} \
        == {768}
    rows = {(N, M, h, d) for B, N, M, h, d, _ in smoke.ZERO123_ATTNS}
    for s, d in ((32, 40), (16, 80), (8, 160), (4, 160)):
        assert {(s * s, s * s, 8, d), (s * s, 1, 8, d)} <= rows
    assert (1024, 1024, 1, 512) in rows
    assert [r[:3] for r in smoke.zero123_groupnorms(3)[:2]] == [
        (6, 32, 32), (6, 32, 32)]
    assert {r[1] for r in smoke.zero123_groupnorms(1) if r[7]} == {
        256, 128, 64, 32}
