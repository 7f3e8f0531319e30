"""The SD 1.5 guidance path against the JAX package on the CPU.

K10's plain version at SD 1.5's head dims (40, 80, 160) against JAX's
``attention`` on both of its branches, a narrow UNet of the sd15 form
(``head_dim=None``, fixed heads: head dims 40 and 80) and a quick-GELU CLIP
text tower with the JAX weights carried over by ``params_from_jax``, one
tiny SD 1.5 train step against the jitted JAX step (each package's
``SDConfig`` subclassed here to give that narrow UNet), and the
full-width towers' routes and parameter shapes without running them.

Tolerances: float32 attention 1e-5 of the largest output (sums in another
order); bf16 attention ``BF16_TOL`` of the largest output (the dense
branch rounds the normalised P to bf16 as JAX does, the chunked branch
rounds q·scale as JAX does, but JAX's chunked scan rounds each chunk's
unnormalised P: a few bf16 ulps); towers 1e-4 of the largest magnitude
(float32); the step as ``tests/test_torch_sd.py`` holds SD 2.1's.
"""

import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, finalize
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.models import clip as jclip
from dreamfusion_tpu.models import unet as junet
from dreamfusion_tpu.ops.attention import attention as jattention
from dreamfusion_tpu_torch.guidance.embeddings import prepare_text_embeddings
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.models import clip as pclip
from dreamfusion_tpu_torch.models import unet as punet
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import jax_step_draws, port_cfg, random_flax_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2 ** -6
# the sd15 form at test width: 8 heads become 2, so 80 and 160 channels
# give head dims 40 and 80 (the mid-block's 80 too)
NARROW = dict(model_channels=80, channel_mult=(1, 2), num_res_blocks=1,
              attn_levels=(True, True), num_heads=2, head_dim=None)


def _chip_smoke():
    """chip_smoke.py at the root of the repo, loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# K10 at d = 40, 80, 160: the plain version against JAX's attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch,N,M,h,d", [
    ("dense", 12, 77, 2, 40),        # a 77-token cross-attention
    ("dense", 10, 9, 3, 80),
    ("dense", 6, 77, 2, 160),
    ("chunked", 16, 24, 2, 40),      # chunks of 8: 3 of them
    ("chunked", 9, 32, 1, 80),
    ("chunked", 8, 16, 2, 160),
])
def test_attention_plain_matches_jax_at_sd15_head_dims(branch, N, M, h, d,
                                                       dtype):
    """JAX's ``attention`` pushed onto a branch by its own arguments
    (``logits_threshold``, ``chunk``) against ``attention_plain`` with the
    rounding of that branch; float32 with the VJP, bf16 forward."""
    rng = np.random.default_rng(d + N)
    q, k, v = (rng.standard_normal((2, n, h, d)).astype(np.float32)
               for n in (N, M, M))
    chunked = branch == "chunked"

    def fn(a, b, c):
        return jattention(a, b, c, logits_threshold=0 if chunked else 2 ** 40,
                          chunk=8)

    scale = 1.0 / math.sqrt(d)
    if dtype == "float32":
        o_j, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        go = rng.standard_normal(o_j.shape).astype(np.float32)
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = K10.attention_plain(*qkv, scale, chunked)
        _close(o, o_j, 1e-5)
        for g, gj in zip(torch.autograd.grad(o, qkv, torch.from_numpy(go)),
                         vjp(jnp.asarray(go))):
            _close(g, gj, 1e-5)
        return
    o_j = fn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    qkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    o = K10.attention_plain(*qkv, scale, chunked)
    assert o.dtype == torch.bfloat16
    _close(o, np.asarray(o_j.astype(jnp.float32)), BF16_TOL)


def test_attention_follows_jax_dispatch(monkeypatch):
    """``chunked_branch`` is JAX's criterion (logits above 64·2²⁰
    elements, M % 512 == 0), and ``attention`` rounds q·scale exactly on
    that branch: with the threshold lowered on both sides, a [1, 8, 2, 40]
    query over 512 keys in bf16 matches JAX's chunked result as closely as
    the plain version with the rounding, and differs from the one
    without."""
    assert K10.chunked_branch(2, 4096, 4096, 8)       # SD 1.5 64² self
    assert K10.chunked_branch(2, 4096, 4096, 5)       # SD 2.1 64² self
    assert not K10.chunked_branch(2, 4096, 77, 8)     # cross: dense
    assert not K10.chunked_branch(2, 1024, 1024, 8)   # 16.8M: dense
    assert not K10.chunked_branch(1, 4096, 4096, 1)   # the VAE mid-block
    assert not K10.chunked_branch(2, 8192, 8000, 8)   # M % 512 != 0
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, n, 2, 40)).astype(np.float32) * 2
               for n in (8, 512, 512))
    want = np.asarray(jattention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)),
                                 logits_threshold=1).astype(jnp.float32))
    monkeypatch.setattr(K10, "LOGITS_THRESHOLD", 1)
    qkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = K10.attention(*qkv)
    torch.testing.assert_close(got, K10.attention_plain(*qkv, 40 ** -0.5,
                                                        True))
    _close(got, want, BF16_TOL)


# ---------------------------------------------------------------------------
# the towers at test width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_unet():
    """The sd15-form UNet at test width, context 768 (CLIP-L's), f32: the
    JAX module, its params, and the port's UNet holding them."""
    jcfg = junet.UNetConfig(**NARROW, dtype=jnp.float32)
    jnet = junet.UNet2DCondition(jcfg)
    jp = random_flax_params(jnet.init, jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, 768)), seed=3)
    pnet = punet.UNet2DCondition(punet.UNetConfig(**NARROW,
                                                  dtype=torch.float32))
    pnet.load_state_dict(params_from_jax({"unet": jp})["unet"], strict=True)
    return jnet, {"params": jp}, pnet


def test_narrow_sd15_unet_eps_matches_jax(narrow_unet):
    """Head dims 40 (64 tokens) and 80 (16 tokens and the mid-block), the
    768-wide K/V projections over 77 context tokens."""
    jnet, jp, pnet = narrow_unet
    heads = {m.head_dim for m in pnet.modules()
             if isinstance(m, punet.CrossAttention)}
    assert heads == {40, 80}
    for m in pnet.modules():
        if isinstance(m, punet.CrossAttention) and m.to_k.weight.shape[1] \
                != m.to_q.weight.shape[1]:
            assert m.to_k.weight.shape[1] == 768
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([20, 731])
    ctx = rng.standard_normal((2, 77, 768)).astype(np.float32)
    want = jax.jit(jnet.apply)(jp, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx))
    got = pnet(torch.from_numpy(x), torch.from_numpy(t),
               torch.from_numpy(ctx))
    _close(got, want)


def test_quick_gelu_clip_matches_jax():
    """CLIP-L's form (quick GELU, causal, final layer norm) at test width
    over its 77 tokens."""
    kw = dict(vocab_size=300, hidden_size=48, num_layers=2, num_heads=4,
              max_len=77, use_quick_gelu=True)
    jenc = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**kw,
                                                      dtype=jnp.float32))
    ids = np.random.default_rng(4).integers(0, 300, (2, 77)).astype(np.int32)
    jp = random_flax_params(jenc.init, jnp.asarray(ids), seed=5)
    penc = pclip.CLIPTextEncoder(pclip.CLIPTextConfig(**kw,
                                                      dtype=torch.float32))
    penc.load_state_dict(params_from_jax({"text": jp})["text"], strict=True)
    want = jax.jit(jenc.apply)({"params": jp}, jnp.asarray(ids))
    _close(penc(torch.from_numpy(ids).long()), want)


# ---------------------------------------------------------------------------
# one tiny SD 1.5 train step against the jitted JAX step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _JSD15(JSDConfig):
    def unet_config(self):
        return junet.UNetConfig(**NARROW, context_dim=32, dtype=jnp.float32)


@dataclasses.dataclass(frozen=True)
class _PSD15(SDConfig):
    def unet_config(self):
        return punet.UNetConfig(**NARROW, context_dim=32,
                                dtype=torch.float32)


def test_one_sd15_train_step_matches_jax(tmp_path, monkeypatch):
    """The main phase (through the VAE) at the first step after 40 that
    draws the background MLP, with the narrow sd15 UNet and the tiny
    quick-GELU CLIP: loss, gradients and updated parameters against the
    jitted JAX step, with the same weights and draws."""
    tiny = dict(sd_version="1.5", tiny=True, image_size=16, latent_size=8)
    jg = JSD(_JSD15(**tiny))
    zeros = jnp.zeros
    jp = {"unet": random_flax_params(jg.unet.init, zeros((1, 8, 8, 4)),
                                     zeros((1,)), zeros((1, 16, 32)), seed=7),
          "vae": random_flax_params(jg.vae.init, zeros((1, 16, 16, 3)),
                                    jax.random.PRNGKey(1), seed=8),
          "text": random_flax_params(jg.text_encoder.init,
                                     zeros((1, 16), jnp.int32), seed=9)}
    pg = StableDiffusionGuidance(_PSD15(**tiny), "cpu")
    pg.load_state_dicts(params_from_jax(jax.tree.map(np.asarray, jp)))
    assert pg.text_encoder.cfg.use_quick_gelu
    cfg = finalize(Config(
        text="a hamburger", guidance=("SD",), sd_version="1.5",
        workspace=str(tmp_path / "ws"), backbone="triplane", w=16, h=16,
        iters=100, batch_size=1, triplane_resolution=32,
        triplane_channels=8, hidden_dim=32, grid_size=30,
        grid_coarse_steps=24, grid_fine_steps=24, fp16=False, seed=0,
        eval_interval=-1, lambda_3d_normal_smooth=0.0,
        use_tensorboard=False))
    base = jax.random.PRNGKey(0)
    emb = prepare_text_embeddings(pg, cfg.text, "")
    jemb = {k: jnp.asarray(v.numpy()) for k, v in emb.items()}
    jt = jtrainer.Trainer(cfg, guidances={"SD": jg},
                          guidance_params={"SD": jp}, embeddings={"SD": jemb})
    pt = Trainer(port_cfg(cfg), "cpu", pg, emb)
    step = next(s for s in range(40, 80) if float(jax_step_draws(
        cfg, jt.renderer, base, s, 8).choice.bg_net_u) > 0.5)
    assert not pt.latent_phase(step)
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(step, jnp.int32))
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
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
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_step_draws(cfg, jt.renderer, base,
                                                  step, 8))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    jgrads = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    pparams = dict(ps.renderer.named_parameters())
    for name, grad in zip(pparams, pgrads):
        ref = jgrads[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the full-width towers: routes and shapes (meta device, eval_shape)
# ---------------------------------------------------------------------------

def _full_towers(version):
    with torch.device("meta"):
        cfg = SDConfig(sd_version=version)
        return (punet.UNet2DCondition(cfg.unet_config()),
                pclip.CLIPTextEncoder(cfg.text_config()))


def _attention_calls(unet, B=2, size=64):
    """(head dim, N, M, h) of each K10 call of one UNet forward at CFG
    batch B on size² latents: each transformer's self- then
    cross-attention (77 tokens), in module order."""
    calls = []
    for name, m in unet.named_modules():
        if isinstance(m, punet.SpatialTransformer):
            blk = re.match(r"(down|up)_blocks\.(\d)|mid_block", name)
            lvl = 3 if blk.group(0) == "mid_block" else int(blk.group(2))
            if blk.group(1) == "up":
                lvl = len(unet.cfg.channel_mult) - 1 - lvl
            N = (size >> lvl) ** 2
            for t in m.transformer_blocks:
                calls.append((t.attn1.head_dim, N, N, t.attn1.num_heads))
                calls.append((t.attn2.head_dim, N, 77, t.attn2.num_heads))
    return calls


def test_sd15_unet_attentions_take_the_new_routes():
    """At full width the sd15 UNet's 32 attentions a step take K10's d = 40
    (10), 80 (10) and 160 (12) routes, chip_smoke's per-step counts; the
    five 64² self-attentions take JAX's chunked branch; SD 2.1's 32 take
    d = 64; any other head dim still raises."""
    chip_smoke = _chip_smoke()
    unet, _ = _full_towers("1.5")
    calls = _attention_calls(unet)
    assert len(calls) == 32 and {c[3] for c in calls} == {8}
    routes = [K10.attention_route(d) for d, *_ in calls]
    assert {r: routes.count(r) for r in set(routes)} == \
        chip_smoke.SD15_UNET_ATTNS
    chunked = [c for c in calls if K10.chunked_branch(2, c[1], c[2], c[3])]
    assert chunked == [(40, 4096, 4096, 8)] * 5
    # chip_smoke's K10 rows hold every SD 1.5 shape but the 8² cross
    rows = {(N, M, h, d) for B, N, M, h, d, _ in chip_smoke.SD_ATTNS
            if d in chip_smoke.SD15_HEAD_DIMS}
    assert {(N, M, h, d) for d, N, M, h in calls} - rows == {(64, 77, 8,
                                                               160)}
    sd21 = [K10.attention_route(d) for d, *_ in
            _attention_calls(_full_towers("2.1")[0])]
    assert {r: sd21.count(r) for r in set(sd21)} == \
        chip_smoke.SD21_UNET_ATTNS
    for d in (32, 48, 128, 256):
        with pytest.raises(ValueError):
            K10.attention_route(d)


def test_sd15_convs_and_groupnorms_take_sd21_routes():
    """Every conv and GroupNorm of the SD 1.5 UNet has SD 2.1's name,
    shape and route (K11's route is a function of the shape alone): only
    the attention projections and the text tower differ."""
    from dreamfusion_tpu_torch.ops.conv import conv_route

    def layers(unet):
        out = []
        for name, m in unet.named_modules():
            if isinstance(m, punet.Conv2d):
                O, kh, kw, I = m.weight.shape
                out.append((name, tuple(m.weight.shape), conv_route(
                    m.compute_dtype, I, O, (m.stride, m.stride), kh * kw)))
            elif isinstance(m, punet.GroupNorm32):
                out.append((name, tuple(m.weight.shape), m.eps))
        return out

    u15, u21 = _full_towers("1.5")[0], _full_towers("2.1")[0]
    assert layers(u15) == layers(u21)
    assert sum(len(x) == 3 and isinstance(x[2], float)
               for x in layers(u15)) == 61
    k15 = {n: tuple(p.shape) for n, p in u15.named_parameters()}
    k21 = {n: tuple(p.shape) for n, p in u21.named_parameters()}
    assert k15.keys() == k21.keys()
    assert {n for n in k15 if k15[n] != k21[n]} == {
        n for n in k15 if ".attn2.to_k." in n or ".attn2.to_v." in n}


def test_full_width_sd15_towers_take_the_jax_parameters():
    """``jax.eval_shape`` of the JAX sd15 UNet's and CLIP-L's init: every
    Flax parameter has a port key, in the port's layout ([kh, kw, I, O] →
    [O, kh, kw, I], 1x1 → [O, I], Dense → [out, in]), and the keys and
    shapes are the port's state_dict's, one for one (859.5M and 123.1M
    parameters)."""
    from dreamfusion_tpu_torch.utils import convert

    def port_shape(path, shape):
        if not path.endswith("kernel"):
            return tuple(shape)
        if len(shape) == 4 and shape[:2] == (1, 1):
            return (shape[3], shape[2])
        if len(shape) == 4:
            return (shape[3], shape[0], shape[1], shape[2])
        return tuple(reversed(shape))

    jg = JSD(JSDConfig(sd_version="1.5"))
    u = jax.eval_shape(jg.unet.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 4)), jnp.zeros((1,)),
                       jnp.zeros((1, 77, 768)))["params"]
    t = jax.eval_shape(jg.text_encoder.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 77), jnp.int32))["params"]
    levels = convert._levels(u)
    got = {"unet": {}, "text": {}}
    for tower, tree, key in (("unet", u, lambda p: convert.unet_key(
            p, levels)), ("text", t, convert.clip_text_key)):
        for path, leaf in convert._flat(tree):
            got[tower][key(path)] = port_shape(path, leaf.shape)
    punet_, ptext = _full_towers("1.5")
    for tower, mod in (("unet", punet_), ("text", ptext)):
        want = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        assert got[tower] == want, tower
    assert round(sum(math.prod(s) for s in got["unet"].values()) / 1e6,
                 1) == 859.5
    assert round(sum(math.prod(s) for s in got["text"].values()) / 1e6,
                 1) == 123.1
