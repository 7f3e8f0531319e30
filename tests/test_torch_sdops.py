"""The SD path's ops against the JAX package on the CPU, in f32: K12 conv
(forward and dx, every padding and stride form of the UNet and VAE), K11
GroupNorm ± SiLU (forward and VJP), K10 attention (forward and VJP), the
bilinear resize, Perp-Neg and the numeric traps (tanh gelu in GEGLU,
[cos | sin] timestep embedding, the GroupNorm epsilons, the conv layout).
Inputs come from a numpy seed; each comparison states its tolerance
(~1e-4 relative: f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance import perpneg as jperp
from dreamfusion_tpu.guidance.schedule import make_schedule as jsched
from dreamfusion_tpu.models import unet as junet
from dreamfusion_tpu.ops.attention import chunked_attention, dense_attention
from dreamfusion_tpu.ops.conv import mm_conv
from dreamfusion_tpu.ops.resize import resize_bilinear as jresize
from dreamfusion_tpu_torch.guidance import perpneg as pperp
from dreamfusion_tpu_torch.guidance.schedule import make_schedule as psched
from dreamfusion_tpu_torch.models import unet as punet
from dreamfusion_tpu_torch.ops.attention import attention
from dreamfusion_tpu_torch.ops.conv import conv2d
from dreamfusion_tpu_torch.ops.groupnorm import group_norm, groups_for
from dreamfusion_tpu_torch.ops.resize import resize_bilinear
from dreamfusion_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)
RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    """Within rtol of the reference's largest magnitude, elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-12))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K12 conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,I,O,k,stride,pad", [
    (9, 11, 5, 7, 3, 1, 1),                     # UNet / VAE 3x3
    (8, 10, 6, 4, 3, 2, 1),                     # UNet downsample
    (9, 8, 4, 6, 3, 2, ((0, 1), (0, 1))),       # VAE (0, 1) pad + VALID
    (6, 6, 5, 3, 1, 1, 0),                      # 1x1
    (7, 7, 3, 8, 3, 1, 1),                      # 3-channel conv_in
    (7, 7, 4, 8, 3, 1, 1),                      # 4-channel conv_in
    (9, 11, 6, 5, 3, 2, 1),                     # odd stride-2 input
    (9, 11, 6, 5, 3, 2, ((0, 1), (0, 1))),      # the same, the VAE's pad
])
def test_conv_matches_mm_conv_and_its_vjp(rng, H, W, I, O, k, stride, pad):
    x = _rand(rng, 2, H, W, I)
    kern = _rand(rng, k, k, I, O, scale=0.3)
    gy = None

    def jconv(xx):
        if isinstance(pad, int):
            return mm_conv(xx, jnp.asarray(kern), (stride, stride), pad)
        xp = jnp.pad(xx, ((0, 0), *pad, (0, 0)))
        return mm_conv(xp, jnp.asarray(kern), (stride, stride), "VALID")

    y_j, vjp = jax.vjp(jconv, jnp.asarray(x))
    gy = _rand(rng, *y_j.shape)
    (dx_j,) = vjp(jnp.asarray(gy))

    xt = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 0, 1, 2)))
    y = conv2d(xt, w, None, stride, pad)
    _close(y, y_j)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    _close(dx, dx_j)


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad", [
    (2, 9, 11, 5, 7, 3, 1, 1),                  # odd sizes, stride 1
    (1, 9, 8, 4, 6, 3, 2, ((0, 1), (0, 1))),    # the VAE's (0, 1) down
    (2, 10, 9, 6, 6, 3, 2, ((0, 1), (0, 1))),   # the same, even H
    (1, 9, 11, 6, 5, 3, 2, 1),                  # symmetric pad at stride 2
    (2, 7, 7, 3, 8, 3, 1, 1),                   # the conv_in's 3-channel dx
    (1, 6, 6, 5, 3, 1, 1, 0),                   # 1x1
    (1, 7, 9, 4, 6, 1, 2, 0),                   # classes without taps
    (1, 11, 10, 3, 5, 3, 1, ((0, 2), (2, 0))),  # asymmetric at stride 1
])
def test_dgrad_by_classes_matches_mm_conv_vjp(rng, B, H, W, I, O, k, stride,
                                              pad):
    """dx the kernels' way (``conv2d_dgrad_plain``: per parity class a
    stride-1 conv of dy with the flipped, transposed sub-kernel, written
    to dx[:, py::s, px::s]; at stride 1 one class, padding k - 1 - p)
    against jax.vjp of mm_conv, fp32, within 1e-5 of the largest |dx|."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_plain,
                                                norm_padding, out_size)

    x = _rand(rng, B, H, W, I)
    kern = _rand(rng, k, k, I, O, scale=0.3)
    pads = norm_padding(pad)

    def jconv(xx):
        xp = jnp.pad(xx, ((0, 0), *pads, (0, 0)))
        return mm_conv(xp, jnp.asarray(kern), (stride, stride), "VALID")

    y_j, vjp = jax.vjp(jconv, jnp.asarray(x))
    assert y_j.shape[1:3] == out_size(H, W, k, k, (stride, stride), pads)
    gy = _rand(rng, *y_j.shape)
    (dx_j,) = vjp(jnp.asarray(gy))
    w = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 0, 1, 2)))
    dx = conv2d_dgrad_plain(torch.from_numpy(gy), w, x.shape,
                            (stride, stride), pads, torch.float32)
    _close(dx, dx_j, rtol=1e-5)


def test_dgrad_weight_packs_the_flipped_sub_kernels(rng):
    """The dgrad weight [classes*I, kmax]: at stride 1 the flipped,
    transposed weight; at the VAE's stride 2 with pad (0, 1), the four
    classes' sub-kernels (2x2, 2x1, 1x2 and 1x1 taps), flipped, zero past
    their taps, kmax rounded up to 64."""
    from dreamfusion_tpu_torch.ops.conv import (dgrad_classes, norm_padding,
                                                pack_dgrad_weight)

    O, I = 6, 5
    w = torch.from_numpy(_rand(rng, O, 3, 3, I))
    pk = pack_dgrad_weight(w, (1, 1), norm_padding(1))
    assert pk.shape == (I, 64)
    want = w.flip(1, 2).permute(3, 1, 2, 0).reshape(I, 9 * O)
    torch.testing.assert_close(pk[:, :9 * O], want, rtol=0, atol=0)
    assert not pk[:, 9 * O:].any()
    pads = norm_padding(((0, 1), (0, 1)))
    cls = dgrad_classes(9, 8, 3, 3, (2, 2), pads)
    assert [(c["nt"], c["nu"]) for c in cls] == [(2, 2), (2, 1), (1, 2),
                                                 (1, 1)]
    assert [(c["Hc"], c["Wc"]) for c in cls] == [(5, 4), (5, 4), (4, 4),
                                                 (4, 4)]
    assert [(c["pt"], c["pl"]) for c in cls] == [(1, 1), (1, 0), (0, 1),
                                                 (0, 0)]
    pk = pack_dgrad_weight(w, (2, 2), pads).reshape(4, I, 64)
    taps = {0: [2, 0], 1: [1]}                # class parity → flipped taps
    for c, (py, px) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        rows, cols = taps[py], taps[px]
        sub = w[:, rows][:, :, cols].permute(3, 1, 2, 0).reshape(I, -1)
        n = sub.shape[1]
        torch.testing.assert_close(pk[c, :, :n], sub, rtol=0, atol=0)
        assert not pk[c, :, n:].any()


def test_dgrad_narrow_weight_is_mma_b_fragments(rng):
    """The narrow dgrad's weight as mma.sync m16n8k16 B fragments per tap,
    group p of 32 dy channels and lane (n = lane / 4: a dx channel, zero
    past I; q = lane % 4): the 8 channels 32p + 8q + j, j < 8, that lane q
    loads from dy, in the kernel's K order."""
    from dreamfusion_tpu_torch.ops.conv import pack_dgrad_narrow_weight

    O, I = 64, 3
    w = torch.from_numpy(_rand(rng, O, 3, 3, I))
    pk = pack_dgrad_narrow_weight(w)
    assert pk.shape == (9, 2, 32, 8)
    for tap in range(9):
        for p in range(2):
            for lane in range(32):
                n, q = lane // 4, lane % 4
                want = [float(w[32 * p + 8 * q + j, tap // 3, tap % 3, n])
                        if n < I else 0.0 for j in range(8)]
                assert pk[tap, p, lane].tolist() == want


def test_dgrad_weight_is_packed_once_per_version(rng):
    """The wgmma dgrad's packed weight is made once per weight, stride and
    class layout, and made afresh after an in-place update."""
    from dreamfusion_tpu_torch.ops.conv import (_packed_dgrad_weight,
                                                norm_padding,
                                                pack_dgrad_weight)

    w = torch.from_numpy(_rand(rng, 64, 3, 3, 8))
    p1, p01 = norm_padding(1), norm_padding(((0, 1), (0, 1)))
    first = _packed_dgrad_weight(w, (1, 1), p1)
    assert _packed_dgrad_weight(w, (1, 1), p1) is first
    strided = _packed_dgrad_weight(w, (2, 2), p01)
    assert strided.shape == (4 * 8, 4 * 64)
    torch.testing.assert_close(strided, pack_dgrad_weight(w, (2, 2), p01))
    assert _packed_dgrad_weight(w, (2, 2), p01) is strided
    with torch.no_grad():
        w.mul_(2.0)
    again = _packed_dgrad_weight(w, (2, 2), p01)
    assert again is not strided
    torch.testing.assert_close(again, 2 * strided)


# ---------------------------------------------------------------------------
# K11 GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,eps,silu", [(64, 1e-5, True), (32, 1e-6, False),
                                        (40, 1e-6, True),
                                        (320, 1e-5, True),    # Cg = 10
                                        (96, 1e-6, False)])   # Cg = 3
def test_group_norm_matches_group_norm_fused_and_its_vjp(rng, C, eps, silu):
    G = groups_for(C)
    x = _rand(rng, 2, 5, 6, C, scale=2.0) + 0.5
    scale, bias = _rand(rng, C) + 1.0, _rand(rng, C)

    def jgn(xx):
        y = junet.group_norm_fused(xx, jnp.asarray(scale), jnp.asarray(bias),
                                   G, eps)
        return jax.nn.silu(y) if silu else y

    y_j, vjp = jax.vjp(jgn, jnp.asarray(x))
    gy = _rand(rng, *y_j.shape)
    (dx_j,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    y = group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), G,
                   eps, silu)
    _close(y, y_j)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    _close(dx, dx_j)


@pytest.mark.parametrize("C,eps", [(64, 1e-5), (16, 1e-6), (8, 1e-6)])
def test_group_norm_matches_groupnorm32(rng, C, eps):
    """The flax module the towers use (including its narrow-channel group
    fallback), on a low-variance input where the epsilon shows."""
    x = _rand(rng, 2, 4, 4, C, scale=3e-3)
    mod = junet.GroupNorm32(dtype=jnp.float32, epsilon=eps)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), params)
    y_j = mod.apply(params, jnp.asarray(x))
    gn = params["params"]["GroupNorm_0"]
    y = punet.GroupNorm32(C, eps)
    y.weight.data = torch.from_numpy(np.array(gn["scale"]))
    y.bias.data = torch.from_numpy(np.array(gn["bias"]))
    _close(y(torch.from_numpy(x)), y_j)


# ---------------------------------------------------------------------------
# K10 attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref,N,M,h,d", [
    ("dense", 12, 12, 2, 8), ("dense", 10, 7, 3, 16),
    ("chunked", 16, 24, 2, 8), ("chunked", 9, 32, 1, 32),
    ("dense", 6, 9, 1, 512)])                   # the VAE mid-block's width
def test_attention_matches_jax_and_its_vjp(rng, ref, N, M, h, d):
    q, k, v = _rand(rng, 2, N, h, d), _rand(rng, 2, M, h, d), \
        _rand(rng, 2, M, h, d)
    fn = dense_attention if ref == "dense" else \
        (lambda a, b, c: chunked_attention(a, b, c, chunk=8))
    o_j, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    go = _rand(rng, *o_j.shape)
    grads_j = vjp(jnp.asarray(go))
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = attention(*qkv)
    _close(o, o_j)
    for g, gj in zip(torch.autograd.grad(o, qkv, torch.from_numpy(go)),
                     grads_j):
        _close(g, gj)


# ---------------------------------------------------------------------------
# small ops and traps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((2, 16, 16, 4), (64, 64)),
                                       ((1, 64, 48, 3), (16, 12)),
                                       ((1, 20, 20, 3), (7, 30))])
def test_resize_bilinear_matches_jax(rng, shape, out):
    x = _rand(rng, *shape)
    _close(resize_bilinear(torch.from_numpy(x), out),
           jresize(jnp.asarray(x), out), rtol=1e-5)


def test_perpneg_embeddings_and_aggregator_match_jax(rng):
    emb = {k: _rand(rng, 1, 6, 8) for k in ("front", "side", "back")}
    az = np.array([-170.0, -90.0, -10.0, 0.0, 45.0, 89.9, 90.0, 135.0],
                  np.float32)
    jemb = {k: jnp.asarray(v) for k, v in emb.items()}
    pemb = {k: torch.from_numpy(v) for k, v in emb.items()}
    _close(pperp.interpolate_view_embedding(pemb, torch.from_numpy(az)),
           jperp.interpolate_view_embedding(jemb, jnp.asarray(az)), 1e-6)
    pn = pperp.adjust_text_embeddings(pemb, torch.from_numpy(az), -2.0, 2.0,
                                      10.0)
    jn = jperp.adjust_text_embeddings(jemb, jnp.asarray(az), -2.0, 2.0, 10.0)
    _close(pn.text_z, jn.text_z, 1e-6)
    _close(pn.weights, jn.weights, 1e-5)
    B = az.shape[0]
    delta = _rand(rng, 3 * B, 4, 4, 4)
    _close(pperp.weighted_perpendicular_aggregator(
        torch.from_numpy(delta), pn.weights, B),
        jperp.weighted_perpendicular_aggregator(jnp.asarray(delta),
                                                jn.weights, B), 1e-5)


def _geglu_pair(rng):
    dim, out = 8, 6
    mod = junet.GEGLU(out, dtype=jnp.float32)
    x = _rand(rng, 3, dim, scale=2.0)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = punet.GEGLU(dim, out, torch.float32)
    k = np.array(params["params"]["proj"]["kernel"])
    p.proj.weight.data = torch.from_numpy(np.ascontiguousarray(k.T))
    p.proj.bias.data = torch.from_numpy(
        np.array(params["params"]["proj"]["bias"]))
    return p(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x))


def _temb_pair(rng):
    t = np.array([0, 1, 20, 500, 980], np.int32)
    return (punet.timestep_embedding(torch.from_numpy(t).long(), 32),
            junet.timestep_embedding(jnp.asarray(t), 32))


def _conv_layout_pair(rng):
    """A Flax MMConv's kernel through params_from_jax's conv layout."""
    mod = junet.MMConv(5, (3, 3), strides=2, padding=1, dtype=jnp.float32)
    x = _rand(rng, 1, 7, 6, 4)
    params = mod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    sd = params_from_jax({"unet": {"conv_in": jax.tree.map(
        np.asarray, params["params"]), "down_0_res_0": {}}})["unet"]
    p = punet.Conv2d(4, 5, stride=2)
    p.weight.data, p.bias.data = sd["conv_in.weight"], sd["conv_in.bias"]
    return p(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x))


def _add_noise_pair(rng):
    x, n = _rand(rng, 2, 4, 4, 4), _rand(rng, 2, 4, 4, 4)
    t = np.array([20, 970])
    return (psched("sd").add_noise(torch.from_numpy(x), torch.from_numpy(n),
                                   torch.from_numpy(t)),
            jsched("sd").add_noise(jnp.asarray(x), jnp.asarray(n),
                                   jnp.asarray(t)))


@pytest.mark.parametrize("pair", [_geglu_pair, _temb_pair, _conv_layout_pair,
                                  _add_noise_pair])
def test_numeric_traps_match_jax(rng, pair):
    """GEGLU's gelu is flax's tanh approximation; the timestep embedding is
    [cos | sin]; the Flax conv kernel [kh, kw, I, O] lands in K12's
    [O, kh, kw, I]; the latents are noised with SD's schedule at t."""
    got, want = pair(rng)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# K10 / K12 routes on the card, chosen by shape alone (no device needed)
# ---------------------------------------------------------------------------

def test_sd_step_convs_and_attentions_take_their_routes():
    """Every K12 conv of the SD 2.1 UNet and VAE encoder (built on the meta
    device: shapes only) takes the route the kernels' rule gives it: the
    wgmma route for bf16 3x3 convs with I % 64 == 0 at stride 1 and the
    stride-2 downsamplers, its narrow-input form for the 4- and 3-channel
    conv_in, the fp32 route for the conv_outs, mma.sync for none; the
    UNet's attention (d = 64) and the VAE mid-block's (d = 512) their wgmma
    kernels; and the split-K factors, N tiles and pixel boxes of the
    UNet's levels at CFG batch 2 and of the VAE's."""
    from dreamfusion_tpu_torch.models.unet import (Conv2d, UNet2DCondition,
                                                   UNetConfig)
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dreamfusion_tpu_torch.ops.attention import (attention_route,
                                                     kv_splits)
    from dreamfusion_tpu_torch.ops.conv import (conv_route, pixel_box, split_k,
                                                wgmma_tiling)

    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd21())
        vae = AutoencoderKL(VAEConfig.sd())
    routes = {}
    for tower, mod in (("unet", unet), ("vae", vae.encoder)):
        for name, m in mod.named_modules():
            if isinstance(m, Conv2d):
                O, kh, kw, I = m.weight.shape
                routes[tower, name] = conv_route(m.compute_dtype, I, O,
                                                 (m.stride, m.stride),
                                                 kh * kw)
    for (tower, name), route in routes.items():
        if name == "conv_in":
            assert route == "conv_fwd_wgmma_i8", (tower, name)
        elif name == "conv_out":
            assert route == "conv_fwd_fp32", (tower, name)
        else:
            assert route == "conv_fwd_wgmma", (tower, name)
    counts = {r: sum(v == r for v in routes.values())
              for r in set(routes.values())}
    assert counts == {"conv_fwd_wgmma": 47 + 20 + 3 + 3,
                      "conv_fwd_wgmma_i8": 1 + 1, "conv_fwd_fp32": 2}
    # what still reaches mma.sync: the towers' test widths, wide strides
    assert conv_route(torch.bfloat16, 16, 16, (1, 1), 9) == "conv_fwd_mma"
    assert conv_route(torch.bfloat16, 3, 16, (2, 2), 9) == "conv_fwd_mma"
    assert conv_route(torch.bfloat16, 64, 64, (3, 3), 9) == "conv_fwd_mma"
    assert conv_route(torch.bfloat16, 4, 8, (1, 1), 25) == "conv_fwd_mma"
    assert conv_route(torch.float32, 64, 64, (1, 1), 9) == \
        "conv_fwd_fp32_tiled"
    assert conv_route(torch.float32, 3, 8, (1, 1), 9) == \
        "conv_fwd_fp32_tiled"
    assert attention_route(64) == "attention_fwd_wgmma"
    assert attention_route(512) == "attention_fwd_wgmma_d512"
    with pytest.raises(ValueError):
        attention_route(32)
    # d = 512's KV splits: (query tiles, KV tiles of 64) on 132 SMs
    assert kv_splits(4096 // 64, 4096 // 64, 132) == 2     # VAE mid-block
    assert kv_splits(16, 2, 132) == 2                      # N 1000, M 77
    assert kv_splits(1, 64, 132) == 4
    assert kv_splits(200, 64, 132) == 1
    # pixel boxes (bw, bh, bb) and split-K at the UNet's levels, B = 2
    assert [pixel_box(2, s, s) for s in (64, 32, 16, 8)] == [
        (64, 2, 1), (32, 4, 1), (16, 8, 1), (8, 8, 2)]
    assert pixel_box(1, 512, 512) == (128, 1, 1)
    assert pixel_box(1, 9, 11) == (16, 8, 1)
    # (output tiles, 64-wide K blocks) on 132 SMs
    assert split_k(64 * 3, 9 * 320 // 64, 132, 4) == 1       # 64², 320
    assert split_k(16 * 5, 9 * 640 // 64, 132, 4) == 3       # 32², 640
    assert split_k(4 * 10, 9 * 1280 // 64, 132, 4) == 6      # 16², 1280
    assert split_k(1 * 10, 9 * 2560 // 64, 132, 4) == 16     # 8², 2560
    assert split_k(2048, 9 * 128 // 64, 132, 4) == 1         # VAE 512²
    # (pixel box, N tile, splits) as the wgmma routes call it: stride 1 as
    # above; the downsamplers' outputs (UNet 32², 16², 8²; VAE 256², 128²,
    # 64²) and the conv_ins take 64-wide N tiles below 66 tiles of 128
    assert wgmma_tiling(2, 64, 64, 320, 45, 132, False) == ((64, 2, 1),
                                                            128, 1)
    assert wgmma_tiling(2, 8, 8, 1280, 180, 132, False) == ((8, 8, 2),
                                                            128, 16)
    assert [wgmma_tiling(2, s, s, c, 9 * c // 64, 132, True)
            for s, c in ((32, 320), (16, 640), (8, 1280))] == [
        ((32, 4, 1), 64, 1), ((16, 8, 1), 64, 3), ((8, 8, 2), 64, 6)]
    assert [wgmma_tiling(1, s, s, c, 9 * c // 64, 132, True)
            for s, c in ((256, 128), (128, 256), (64, 512))] == [
        ((128, 1, 1), 128, 1), ((128, 1, 1), 128, 1), ((64, 2, 1), 128, 1)]
    assert wgmma_tiling(1, 512, 512, 128, 1, 132, True) == ((128, 1, 1),
                                                            128, 1)
    assert wgmma_tiling(2, 64, 64, 320, 1, 132, True) == ((64, 2, 1),
                                                          128, 1)


# K11's route, slab (channels; streaming: C) and cluster (CTAs; streaming:
# 0) at each shape of chip_smoke.SD_GROUPNORMS on 132 SMs: forward, and
# backward for the VAE's
_GN_ROUTES = {
    (2, 64, 64, 320): ("resident", 40, 16),
    (2, 64, 64, 640): ("resident", 40, 8),
    (2, 64, 64, 960): ("resident", 120, 16),
    (2, 32, 32, 320): ("resident", 40, 16),
    (2, 32, 32, 640): ("resident", 40, 8),
    (2, 32, 32, 960): ("resident", 120, 16),
    (2, 32, 32, 1280): ("resident", 40, 4),
    (2, 32, 32, 1920): ("resident", 120, 8),
    (2, 16, 16, 640): ("resident", 40, 4),
    (2, 16, 16, 1280): ("resident", 40, 4),
    (2, 16, 16, 1920): ("resident", 120, 4),
    (2, 16, 16, 2560): ("resident", 80, 4),
    (2, 8, 8, 1280): ("resident", 40, 1),
    (2, 8, 8, 2560): ("resident", 80, 1),
    (1, 512, 512, 128): ("stream", 128, 0, "stream", 128, 0),
    (1, 256, 256, 128): ("stream", 128, 0, "stream", 128, 0),
    (1, 256, 256, 256): ("stream", 256, 0, "stream", 256, 0),
    (1, 128, 128, 256): ("resident", 16, 16, "stream", 256, 0),
    (1, 128, 128, 512): ("stream", 512, 0, "stream", 512, 0),
    (1, 64, 64, 512): ("resident", 16, 8, "resident", 16, 8),
}


def test_sd_step_groupnorms_take_their_routes():
    """Every K11 call of one SD 2.1 step: chip_smoke.SD_GROUPNORMS holds
    the UNet's 61 calls and the VAE encoder's 22 (the towers built on the
    meta device have exactly those GroupNorm32 modules, channels and
    epsilons), and each shape takes the route, slab and cluster of
    _GN_ROUTES: every UNet norm is resident (clusters of 1-16 CTAs, slabs
    of 4 groups at Cg = 10 and 30, 2 at Cg = 20 and 60, 1 at Cg = 40 and
    80), the VAE's forward up to 8 MB too, its larger forwards and every
    backward above 4 MiB stream; the routes' counts per run are what the
    SD runs of chip_smoke.py check."""
    from dreamfusion_tpu_torch.models.unet import (GroupNorm32,
                                                   UNet2DCondition,
                                                   UNetConfig)
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dreamfusion_tpu_torch.ops import groupnorm as K11

    smoke = _load_root_script("chip_smoke")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd21())
        vae = AutoencoderKL(VAEConfig.sd())

    def norms(mod):
        return sorted((m.weight.shape[0], m.eps) for m in mod.modules()
                      if isinstance(m, GroupNorm32))

    def calls(rows):
        return sorted((r[3], r[4]) for r in rows for _ in range(r[6]))

    rows = smoke.SD_GROUPNORMS
    unet_rows = [r for r in rows if not r[7]]
    vae_rows = [r for r in rows if r[7]]
    assert {r[0] for r in unet_rows} == {2} and {r[0] for r in vae_rows} \
        == {1}
    assert calls(unet_rows) == norms(unet) and len(norms(unet)) == 61
    assert calls(vae_rows) == norms(vae.encoder) and len(vae_rows) == 7
    assert sum(r[6] for r in vae_rows) == 22
    assert {(r[0], r[1], r[2], r[3]) for r in rows} == set(_GN_ROUTES)
    for B, H, W, C, eps, silu, per_step, bwd in rows:
        want = _GN_ROUTES[B, H, W, C]
        for back in ((False, True) if bwd else (False,)):
            r = K11.group_norm_route((B, H, W, C), torch.bfloat16, back,
                                     K11.groups_for(C), 132)
            kind, slab, cluster = want[3:] if back else want[:3]
            way = "bwd" if back else "fwd"
            assert (r.name, r.slab, r.cluster) == (
                f"groupnorm_{way}_{kind}", slab, cluster), (B, H, W, C, back)
    assert smoke.sd_groupnorm_launches(torch, K11, 132, 25, 19) == {
        "groupnorm_fwd_resident": 61 * 25 + 11 * 19,
        "groupnorm_fwd_stream": 11 * 19, "groupnorm_bwd_resident": 10 * 19,
        "groupnorm_bwd_stream": 12 * 19}
    # shapes no kernel takes: no 16-byte run of whole groups, a dtype
    with pytest.raises(ValueError):
        K11.group_norm_route((1, 8, 8, 12), torch.bfloat16, False, 4)
    with pytest.raises(ValueError):
        K11.group_norm_route((1, 8, 8, 64), torch.float16, False, 32)


def test_chip_smoke_groupnorm_rows_cover_every_route():
    """chip_smoke.py holds every K11 route against its plain version: its
    SD rows reach all four (resident and streaming, forward and backward),
    with and without SiLU, at Cg = 10 and 30, and its kernels line lists
    each of them, as the SD runs' required kernels."""
    from dreamfusion_tpu_torch.ops.groupnorm import (group_norm_route,
                                                     groups_for)

    smoke = _load_root_script("chip_smoke")
    routes = set()
    for B, H, W, C, eps, silu, per_step, bwd in smoke.SD_GROUPNORMS:
        for back in ((False, True) if bwd else (False,)):
            routes.add(group_norm_route((B, H, W, C), torch.bfloat16, back,
                                        groups_for(C)).name)
    assert routes == {"groupnorm_fwd_resident", "groupnorm_fwd_stream",
                      "groupnorm_bwd_resident", "groupnorm_bwd_stream"}
    assert routes <= set(smoke.KERNELS) and routes <= set(smoke.SD_KERNELS)
    assert all(smoke.KERNELS[r][:2] == (
        "cuda", "dreamfusion_tpu_torch/csrc/groupnorm.cu") for r in routes)
    assert {r[5] for r in smoke.SD_GROUPNORMS} == {True, False}
    assert {r[5] for r in smoke.SD_GROUPNORMS if r[7]} == {True, False}
    assert {10, 30} <= {r[3] // groups_for(r[3]) for r in smoke.SD_GROUPNORMS}
    assert "attention_bwd_wgmma" in smoke.SD_KERNELS
    assert not any(k in smoke.KERNELS for k in ("groupnorm_fwd",
                                                "groupnorm_bwd",
                                                "attention_bwd"))


def test_vae_encoder_dgrads_take_their_routes():
    """Every input gradient of the SD VAE encoder (built on the meta
    device: shapes only) takes a Hopper route, none the mma.sync
    ``conv_dgrad``: 23 on the wgmma route (20 at stride 1, the 3 downs),
    the 3-channel conv_in's on the narrow one, the fp32 conv_out's on the
    fp32 one, as chip_smoke.py's SD run counts them per step; and the
    wgmma dgrad's tiling at the 64² level (split-K 2) and the 512² down
    (4 classes of 256²)."""
    from dreamfusion_tpu_torch.models.unet import Conv2d
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dreamfusion_tpu_torch.ops.conv import (dgrad_classes, dgrad_route,
                                                norm_padding, wgmma_tiling)

    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.sd())
    routes = {}
    for name, m in vae.encoder.named_modules():
        if isinstance(m, Conv2d):
            O, kh, kw, I = m.weight.shape
            routes[name] = dgrad_route(m.compute_dtype, I, O,
                                       (m.stride, m.stride), (kh, kw))
    assert routes.pop("conv_in") == "conv_dgrad_narrow"
    assert routes.pop("conv_out") == "conv_dgrad_fp32"
    assert set(routes.values()) == {"conv_dgrad_wgmma"}
    assert len(routes) == 23
    strided = [n for n, m in vae.encoder.named_modules()
               if isinstance(m, Conv2d) and m.stride == 2]
    assert len(strided) == 3
    smoke = _load_root_script("chip_smoke")
    assert smoke.SD_DGRADS == {"conv_dgrad_wgmma": 23,
                               "conv_dgrad_narrow": 1, "conv_dgrad_fp32": 1}
    assert "conv_dgrad" not in smoke.SD_KERNELS
    assert set(smoke.SD_DGRADS) <= set(smoke.SD_KERNELS)
    # stride 1 at 64²x512: 32 pixel tiles x 4 N tiles → split-K 2
    assert wgmma_tiling(1, 64, 64, 512, 9 * 512 // 64, 132, False) == (
        (64, 2, 1), 128, 2)
    cls = dgrad_classes(512, 512, 3, 3, (2, 2), norm_padding(((0, 1),
                                                              (0, 1))))
    assert {(c["Hc"], c["Wc"]) for c in cls} == {(256, 256)}
    assert wgmma_tiling(1, 256, 256, 128, 4 * 128 // 64, 132, False, 4) == (
        (128, 1, 1), 128, 1)


def _load_root_script(name):
    """A script at the root of the repo, loaded by its path."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_conv_rows_take_their_routes():
    """chip_smoke.py holds every forward route of K12 against its plain
    version: its SD rows never reach the mma.sync forward, its MMA_CONVS
    rows all do, its FP32_TILED_CONVS rows all take the tiled fp32 route,
    and the kernels line lists those kernels; the same for the dgrad's
    routes."""
    from dreamfusion_tpu_torch.ops.conv import conv_route, dgrad_route

    smoke = _load_root_script("chip_smoke")

    def route(row):
        B, H, W, I, O, k, st, pad, dt, dgrad = row
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        return conv_route(dtype, I, O, (st, st), k * k)

    def dgrad(row):
        B, H, W, I, O, k, st, pad, dt, dgrad = row
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        return dgrad_route(dtype, I, O, (st, st), (k, k))

    sd = {route(r) for r in smoke.SD_CONVS}
    assert sd == {"conv_fwd_wgmma", "conv_fwd_wgmma_i8", "conv_fwd_fp32"}
    assert [route(r) for r in smoke.MMA_CONVS] == \
        ["conv_fwd_mma"] * len(smoke.MMA_CONVS)
    # every dgrad shape of the SD step is checked, each on a Hopper route;
    # the mma.sync dgrad at the off-path rows
    sd_dgrads = [r for r in smoke.SD_CONVS if r[9]]
    assert len(sd_dgrads) == 11
    assert {dgrad(r) for r in sd_dgrads} == set(smoke.SD_DGRADS)
    assert all(r[9] for r in smoke.MMA_CONVS)
    assert {dgrad(r) for r in smoke.MMA_CONVS} == {"conv_dgrad"}
    assert set(smoke.SD_DGRADS) | {"conv_dgrad"} <= set(smoke.KERNELS)
    assert {r[8] for r in smoke.MMA_CONVS} == {"bf16"}
    assert {r[6] for r in smoke.MMA_CONVS} == {1, 2}
    # the fp32 rows of no path: the tiled forward, the tiled fp32 dgrad
    assert {route(r) for r in smoke.FP32_TILED_CONVS} == \
        {"conv_fwd_fp32_tiled"}
    assert {dgrad(r) for r in smoke.FP32_TILED_CONVS} == \
        {"conv_dgrad_fp32_tiled"}
    assert {r[8] for r in smoke.FP32_TILED_CONVS} == {"fp32"}
    assert sd | {"conv_fwd_mma", "conv_fwd_fp32_tiled"} <= \
        set(smoke.KERNELS)
    assert "conv_fwd_mma" not in smoke.SD_KERNELS


def test_bench_hashes_sources_and_compares_outputs(tmp_path, capsys):
    """bench_sd_kernels.py's provenance and parity tools: the sources'
    hash moves with any byte of csrc/ or ops/ and ignores caches; the
    comparison of two --outputs files reports each shape bit for bit."""
    import json

    from dreamfusion_tpu_torch import bench_sd_kernels as bench

    root = tmp_path / "tree"
    for sub, name in (("csrc", "conv.cu"), ("ops", "conv.py")):
        d = root / "dreamfusion_tpu_torch" / sub
        d.mkdir(parents=True)
        (d / name).write_text(f"// {name}\n")
    first = bench.sources_sha256(str(root))
    cache = root / "dreamfusion_tpu_torch" / "ops" / "__pycache__"
    cache.mkdir()
    (cache / "conv.cpython-312.pyc").write_bytes(b"\0")
    assert bench.sources_sha256(str(root)) == first
    (root / "dreamfusion_tpu_torch" / "csrc" / "conv.cu").write_text("//\n")
    assert bench.sources_sha256(str(root)) != first

    y = torch.randn(2, 3, 4).to(torch.bfloat16)
    bumped = y.clone()
    bumped[0, 0, 0] += 1.0
    torch.save({"a": y, "b": y, "c": y}, tmp_path / "p.pt")
    torch.save({"a": y.clone(), "b": bumped}, tmp_path / "c.pt")
    capsys.readouterr()
    bench.main(["--compare", str(tmp_path / "p.pt"), str(tmp_path / "c.pt")])
    rows = [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line]
    assert [(r["row"], r["bitwise_equal"]) for r in rows] == [
        ("a", True), ("b", False)]
    assert rows[0]["max_abs_diff"] == 0.0 and rows[1]["max_abs_diff"] > 0.5


def test_narrow_weight_is_packed_once_per_version(rng):
    """The conv_ins' weight [O, 3, 3, I] in the narrow-input route's layout
    [O / bn, 10, bn, 8] (per N tile, tap-major; zero past the taps, the
    channels and O), packed once per weight and N tile and made afresh
    after an in-place update."""
    from dreamfusion_tpu_torch.ops.conv import (_packed_narrow_weight,
                                                pack_narrow_weight)

    w = torch.from_numpy(_rand(rng, 5, 3, 3, 3))
    pk = pack_narrow_weight(w, 4)
    assert pk.shape == (2, 10, 4, 8)
    for n in range(5):
        for r in range(3):
            for s in range(3):
                torch.testing.assert_close(pk[n // 4, 3 * r + s, n % 4, :3],
                                           w[n, r, s])
    assert not pk[:, 9].any() and not pk[:, :, :, 3:].any()
    assert not pk[1, :, 1:].any()
    first = _packed_narrow_weight(w, 64)
    assert first.shape == (1, 10, 64, 8)
    assert _packed_narrow_weight(w, 64) is first
    assert _packed_narrow_weight(w, 128).shape == (1, 10, 128, 8)
    with torch.no_grad():
        w.mul_(2.0)
    again = _packed_narrow_weight(w, 64)
    assert again is not first
    torch.testing.assert_close(again, 2 * first)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::attn_bwd_flash_kernel<40>((anonymous "
     "namespace)::FlashMaps, float const*, float const*, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int, int, int, "
     "float, float)", "K10 attention"),
    ("void (anonymous namespace)::attn_bwd_flash_kernel<160>((anonymous "
     "namespace)::FlashMaps, float const*, float const*, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int, int, int, "
     "float, float)", "K10 attention"),
    ("(anonymous namespace)::attn_bwd_rows_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, float*, float*, int, int, int, "
     "int, int)", "K10 attention"),
    ("(anonymous namespace)::attn_bwd_split_reduce_kernel(float const*, "
     "__nv_bfloat16*, __nv_bfloat16*, long, int, float)", "K10 attention"),
    ("(anonymous namespace)::conv_wgrad_wgmma_i8_kernel(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::WgradNarrow)", "K12 conv"),
    ("(anonymous namespace)::conv_wgrad_i8_reduce_kernel(float const*, "
     "void*, int, int, int, int, int)", "K12 conv"),
])
def test_profile_groups_name_the_backward_kernels(name, group):
    """profile_step files K10's flash backward (the launch of both passes,
    the rows' lse and D, the split reduce) under K10 and the conv_ins' narrow weight
    gradient (and its reduce) under K12, not among the input gradients."""
    from dreamfusion_tpu_torch.profile_step import group_of, part_of

    assert group_of(name) == group
    assert group == "K10 attention" or part_of(name) is None


def test_profile_groups_name_the_new_kernels():
    """profile_step files the Hopper kernels (as the profiler names them)
    under K12 and K10, not under the library's matrix products."""
    from dreamfusion_tpu_torch.profile_step import group_of, part_of

    k12 = ["void (anonymous namespace)::conv_wgmma_kernel<false, 128>("
           "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous "
           "namespace)::WgConv)",
           "void (anonymous namespace)::conv_wgmma_kernel<true, 64>("
           "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous "
           "namespace)::WgConv)",
           "(anonymous namespace)::conv_narrow_kernel((anonymous "
           "namespace)::ConvParams)",
           "(anonymous namespace)::conv_splitk_reduce((anonymous "
           "namespace)::ConvParams)",
           "(anonymous namespace)::pad_channels8_kernel(__nv_bfloat16 "
           "const*, uint4*, long, int)",
           "void (anonymous namespace)::conv_mma_kernel<false>((anonymous "
           "namespace)::ConvParams)",
           "void (anonymous namespace)::conv_wgrad_fp32_tiled_kernel<8, "
           "true>((anonymous namespace)::WgradParams)",
           "(anonymous namespace)::conv_wgrad_wgmma_kernel(CUtensorMap_st, "
           "CUtensorMap_st, (anonymous namespace)::WgradBoxes)",
           "void (anonymous namespace)::conv_wgrad_mma_kernel<true, false>("
           "(anonymous namespace)::WgradParams)",
           "(anonymous namespace)::conv_wgrad_reduce(float const*, void*, "
           "long, int, int)",
           "void (anonymous namespace)::conv_fp32_tiled_kernel<64, true>("
           "(anonymous namespace)::ConvParams)",
           "void (anonymous namespace)::conv_simple_kernel<true>("
           "(anonymous namespace)::ConvParams)",
           "void (anonymous namespace)::conv_wgmma_kernel<false, 128, true>"
           "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::"
           "WgStoreMaps<4>, (anonymous namespace)::WgConv)",
           "void (anonymous namespace)::conv_dgrad_narrow_kernel<3>("
           "__nv_bfloat16 const*, __nv_bfloat16 const*, void*, int, int, "
           "int, int, int, int, int, int, int, int, int)",
           "(anonymous namespace)::conv_dgrad_fp32_kernel(float const*, "
           "float const*, float*, int, int, int, int, int, int, int, int, "
           "int, int, int, int, int)",
           "void (anonymous namespace)::conv_dgrad_fp32_tiled_kernel<32, "
           "false>((anonymous namespace)::ConvParams, int)"]
    k10 = ["(anonymous namespace)::attn_fwd_wgmma_kernel(CUtensorMap_st, "
           "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, int, "
           "int, int, float)",
           "(anonymous namespace)::attn_fwd_d512_kernel(CUtensorMap_st, "
           "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, float*, "
           "float*, int, int, int, int, int, float)",
           "(anonymous namespace)::attn_fwd_combine_kernel(float const*, "
           "float const*, __nv_bfloat16*, float*, int, int, int, int)"]
    assert [group_of(n) for n in k12] == ["K12 conv"] * len(k12)
    # the input gradients apart within K12: the dgrad instantiation of the
    # wgmma kernel, the narrow, fp32 and tiled fp32 dgrads, mma.sync's and
    # the one-thread dgrads; not the forwards, the weight gradients (the
    # wgmma, mma.sync and tiled fp32 routes) or the split-K reduces
    dgrads = [part_of(n) is not None for n in k12]
    assert dgrads == [False] * 11 + [True] * 5
    k5 = ["(anonymous namespace)::clip_f32_kernel(float const*, float*, "
          "long, float)",
          "(anonymous namespace)::clip_bf16_kernel(__nv_bfloat16 const*, "
          "__nv_bfloat16*, long, float)"]
    assert [group_of(n) for n in k5] == ["K5 clip_grad"] * 2
    assert [group_of(n) for n in k10] == ["K10 attention"] * len(k10)
    k10_bwd = ["(anonymous namespace)::attn_bwd_dot_kernel(__nv_bfloat16 "
               "const*, __nv_bfloat16 const*, float*, int, int, int, int)",
               "(anonymous namespace)::attn_bwd_scores_kernel(CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
               "int, int, int, int, float)",
               "void (anonymous namespace)::attn_bwd_gemm_kernel<true>("
               "(anonymous namespace)::GemmMaps, int, int, int, int, int, "
               "float, float)",
               "(anonymous namespace)::attn_bwd_fp32_dot_kernel(float const*, "
               "float const*, float*, int, int, long)",
               "void (anonymous namespace)::attn_bwd_fp32_kernel<true>(float "
               "const*, float const*, float const*, float const*, float "
               "const*, float const*, float*, float*, int, int, int, float)"]
    assert [group_of(n) for n in k10_bwd] == ["K10 attention"] * 5
    # the forward's template at each head dim; SD 1.5's apart within K10
    k10_dims = [f"void (anonymous namespace)::attn_fwd_wgmma_kernel<{d}>("
                "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                "__nv_bfloat16*, float*, int, int, int, float, int)"
                for d in (40, 64, 80, 160)]
    assert [group_of(n) for n in k10_dims] == ["K10 attention"] * 4
    assert [part_of(n) is not None for n in k10_dims] == [True, False, True,
                                                           True]
    # K11: the parent's Triton kernels and the CUDA routes group alike
    k11 = ["fwd_stats", "fwd_apply", "bwd_sums", "bwd_apply",
           "void (anonymous namespace)::gn_resident_kernel<__nv_bfloat16, "
           "false>((anonymous namespace)::GnParams)",
           "void (anonymous namespace)::gn_stream_kernel<__nv_bfloat16, "
           "true>((anonymous namespace)::GnParams)",
           "void (anonymous namespace)::gn_resident_kernel<float, true>("
           "(anonymous namespace)::GnParams)"]
    assert [group_of(n) for n in k11] == ["K11 groupnorm"] * len(k11)
    assert group_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "matrix products"
    # K3, and K4: the parent's Triton head and the CUDA head and shade
    k34 = ["(anonymous namespace)::composite_fwd_kernel(float const*, "
           "float const*, float const*, float const*, unsigned char const*,"
           " int, int, float, int, (anonymous namespace)::Background, float "
           "const*, float const*, float*, float*, float*, float*, float*, "
           "unsigned int*, float*)", "fwd", "bwd",
           "void (anonymous namespace)::field_head_fwd_kernel<__nv_bfloat16>"
           "(__nv_bfloat16 const*, float const*, long, (anonymous "
           "namespace)::Blob, float*, float*)",
           "void (anonymous namespace)::field_shade_bwd_kernel<float>(float "
           "const*, float const*, float const*, long, (anonymous namespace)"
           "::Shading, (anonymous namespace)::Blob, float, float const*, "
           "float const*, float const*, float*, float*)"]
    assert [group_of(n) for n in k34] == ["K3 composite"] + \
        ["K4 field head"] * 4
