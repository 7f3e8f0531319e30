"""The towers' backward to their weights against the JAX package on the
CPU: K12's weight and bias gradients (``mm_conv``'s custom_vjp, its ``dk``),
K11's affine gradients (``group_norm_fused``'s ``dscale`` and ``dbias``),
K10's dQ, dK, dV at head dims 40, 80 and 160 on both of JAX's branches,
and the tiny SD UNet's and VAE encoder's gradient with respect to every
parameter and the input (``jax.grad`` of JAX's ``apply`` against the
port's autograd, the weights carried by ``params_from_jax`` and the
gradients mapped back by ``tower_to_flax``).  Then, on the meta device,
the routes the full-width towers' backward takes on the card.

Inputs come from a numpy seed.  Tolerances, each relative to the largest
entry of the output it checks: 1e-4 in float32 (sums in another order);
bf16 attention ``BF16_TOL`` (both packages round P, or q·scale on the
chunked branch, to bf16, at other places in the backward).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import unet as junet
from dreamfusion_tpu.models import vae as jvae
from dreamfusion_tpu.ops.attention import attention as jattention
from dreamfusion_tpu.ops.conv import mm_conv
from dreamfusion_tpu_torch.models import unet as punet
from dreamfusion_tpu_torch.models import vae as pvae
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.ops import conv as K12
from dreamfusion_tpu_torch.ops import groupnorm as K11
from dreamfusion_tpu_torch.utils.convert import (_flat, _port_levels,
                                                 params_from_jax,
                                                 tower_to_flax)

from torch_parity import float64_port, random_flax_params

torch.set_num_threads(2)
RTOL = 1e-4
BF16_TOL = 2 ** -6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, dtype=np.float64)


def _close(got, want, rtol=RTOL, what="", ref=0.0):
    """Within rtol of the reference's largest magnitude (or of `ref`, the
    largest entry of the call's other outputs, where this one is 0 in exact
    arithmetic), elementwise."""
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), ref,
                                               1e-12),
                               err_msg=what)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K12: the weight and bias gradients
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
def test_conv_weight_gradient_matches_mm_conv_vjp(rng, H, W, I, O, k,
                                                  stride, pad):
    """jax.vjp of ``mm_conv`` + bias (JAX adds it outside) with respect to
    (x, kernel, bias) against the port's autograd with respect to (x, w,
    bias): dW is the transposed shifted einsum, the bias's gradient Σ dy,
    1e-4 of each gradient's largest entry (float32)."""
    x = _rand(rng, 2, H, W, I)
    kern = _rand(rng, k, k, I, O, scale=0.3)
    bias = _rand(rng, O)

    def jconv(xx, kk, bb):
        if isinstance(pad, int):
            return mm_conv(xx, kk, (stride, stride), pad) + bb
        xp = jnp.pad(xx, ((0, 0), *pad, (0, 0)))
        return mm_conv(xp, kk, (stride, stride), "VALID") + bb

    y_j, vjp = jax.vjp(jconv, *map(jnp.asarray, (x, kern, bias)))
    gy = _rand(rng, *y_j.shape)
    dx_j, dk_j, db_j = vjp(jnp.asarray(gy))

    xt = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 0, 1, 2))) \
        .requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = K12.conv2d(xt, w, b, stride, pad)
    _close(y, y_j)
    dx, dw, db = torch.autograd.grad(y, (xt, w, b), torch.from_numpy(gy))
    _close(dx, dx_j, what="dx")
    _close(dw.permute(1, 2, 3, 0), dk_j, what="dW")
    _close(db, db_j, what="dbias")
    # the plain version alone, from x and dy
    dw_plain = K12.conv2d_wgrad_plain(torch.from_numpy(x),
                                      torch.from_numpy(gy), w.shape,
                                      (stride, stride), K12.norm_padding(pad))
    _close(dw_plain.permute(1, 2, 3, 0), dk_j, what="conv2d_wgrad_plain")


def _narrow_wgrad_twin(x, dy, kh, kw, pt, pl, sms=132):
    """``conv_wgrad_wgmma_i8``'s layout in plain torch: x padded to 8
    channels, the [pixels][72] operand (tap t's 8 channels at columns 8t
    .., zero outside the image and past the taps), the products summed
    over the 64-pixel boxes of each split in the kernel's order and the
    splits' [O][72] partials in split order, then the compaction to [O,
    kh, kw, I] without the padded channels."""
    B, H, W, I = x.shape
    _, Ho, Wo, O = dy.shape
    x8 = torch.nn.functional.pad(x, (0, 8 - I))
    xz = torch.nn.functional.pad(
        x8, (0, 0, pl, max(0, Wo + kw - 1 - pl - W), pt,
             max(0, Ho + kh - 1 - pt - H)))
    tap = torch.zeros(B, Ho, Wo, 72)
    for t in range(kh * kw):
        r, u = divmod(t, kw)
        tap[..., 8 * t:8 * t + 8] = xz[:, r:r + Ho, u:u + Wo]
    bw, bh, bb = K12.wgrad_box(B, Ho, Wo)
    tx, ty = -(-Wo // bw), -(-Ho // bh)
    steps = K12.wgrad_boxes(B, Ho, Wo)
    splits = K12.narrow_wgrad_splits(O, steps, sms)
    dw72 = torch.zeros(O, 72)
    for sp in range(splits):
        part = torch.zeros(O, 72)
        for st in range(steps * sp // splits, steps * (sp + 1) // splits):
            row = st // tx
            x0, y0, b0 = (st % tx) * bw, (row % ty) * bh, row // ty * bb
            a = dy[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw].reshape(-1, O)
            bm = tap[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw].reshape(-1, 72)
            part += a.T @ bm
        dw72 += part
    return dw72.reshape(O, 9, 8)[:, :kh * kw, :I].reshape(O, kh, kw, I), \
        splits


@pytest.mark.parametrize("B,H,W,I,O", [
    (2, 20, 20, 3, 16),             # the VAE's 3 channels; 5 splits
    (2, 9, 11, 4, 8),               # the UNets' 4, ragged boxes
    (1, 12, 17, 8, 24),             # zero123's 8, read unpadded
])
def test_narrow_wgrad_layout_matches_mm_conv_vjp(rng, B, H, W, I, O):
    """The narrow weight gradient's layout (``_narrow_wgrad_twin``: the
    8-channel padding, the [pixels][72] tap operand, the box and split
    order, the compaction) against ``jax.vjp`` of ``mm_conv``'s kernel
    gradient at a 3x3 stride-1 pad-1 conv_in, 1e-5 of its largest entry
    (float32); its route is the narrow one."""
    assert K12.wgrad_route(torch.bfloat16, I, O, (1, 1), 9) == \
        "conv_wgrad_wgmma_i8"
    x = _rand(rng, B, H, W, I)
    kern = _rand(rng, 3, 3, I, O, scale=0.3)
    y_j, vjp = jax.vjp(lambda kk: mm_conv(jnp.asarray(x), kk, (1, 1), 1),
                       jnp.asarray(kern))
    gy = _rand(rng, *y_j.shape)
    (dk_j,) = vjp(jnp.asarray(gy))
    dw, splits = _narrow_wgrad_twin(torch.from_numpy(x),
                                    torch.from_numpy(gy), 3, 3, 1, 1)
    assert splits == (5 if H == 20 else 1)
    _close(dw.permute(1, 2, 3, 0), dk_j, rtol=1e-5, what="narrow twin dW")


# the conv_ins' (O, 64-pixel boxes) → narrow_wgrad_splits on 132 SMs
NARROW_SPLITS = {
    (128, 4096): 132,       # the VAE's [1, 512², 3 -> 128]: one wave
    (320, 128): 32,         # the SD UNets' [2, 64², 4 -> 320]: 4 boxes each
    (320, 32): 8,           # zero123's [2, 32², 8 -> 320]
    (64, 3): 1,             # too few boxes to split
}


@pytest.mark.parametrize("shape", sorted(NARROW_SPLITS))
def test_narrow_wgrad_splits_stay_in_bounds(shape):
    """The narrow route's splits: a block a (128-channel tile, split), at
    most one wave of them, each split at least 4 boxes where there are
    enough to split."""
    O, steps = shape
    splits = K12.narrow_wgrad_splits(O, steps, 132)
    assert splits == NARROW_SPLITS[shape]
    assert splits >= 1 and -(-O // 128) * splits <= 132
    assert splits == 1 or 4 * splits <= steps
    # the towers' real boxes
    assert K12.wgrad_boxes(1, 512, 512) == 4096
    assert K12.wgrad_boxes(2, 64, 64) == 128 and K12.wgrad_boxes(2, 32, 32) \
        == 32


def test_conv_saves_x_only_for_a_weight_gradient():
    """A frozen weight's conv keeps no x for its backward (the SD step's
    memory), a trainable one does; with only x asking, the backward gives
    dx alone, and with only the weight, dW alone."""
    x = torch.randn(1, 5, 5, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 8)
    y = K12.conv2d(x, w, None, 1, 1)
    assert y.grad_fn.saved_tensors[1] is None
    wt = w.clone().requires_grad_()
    y2 = K12.conv2d(x.detach(), wt, None, 1, 1)
    assert y2.grad_fn.saved_tensors[1] is not None
    (dw,) = torch.autograd.grad(y2.sum(), wt)
    assert dw.shape == wt.shape and dw.dtype == wt.dtype
    (dx,) = torch.autograd.grad(y.sum(), x)
    assert dx.shape == x.shape


def test_bf16_weight_gradient_keeps_the_weights_dtype(rng):
    """bf16 x and w: dW comes back bf16 (the towers' parameters'), within
    one bf16 rounding of the float32 transpose; a bf16 bias's gradient is
    bf16 too."""
    x = torch.from_numpy(_rand(rng, 2, 6, 7, 16)).to(torch.bfloat16)
    w = torch.from_numpy(_rand(rng, 8, 3, 3, 16, scale=0.2)) \
        .to(torch.bfloat16).requires_grad_()
    b = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    y = K12.conv2d(x, w, b, 1, 1)
    gy = torch.from_numpy(_rand(rng, *y.shape)).to(torch.bfloat16)
    dw, db = torch.autograd.grad(y, (w, b), gy)
    assert dw.dtype == torch.bfloat16 and db.dtype == torch.bfloat16
    want = K12.conv2d_wgrad_plain(x, gy, w.shape, (1, 1),
                                  K12.norm_padding(1))
    _close(dw, want, rtol=2 ** -8)
    _close(db, gy.float().sum((0, 1, 2)), rtol=2 ** -8)


def test_packed_weight_cache_follows_a_trainable_weight():
    """``_cached_pack`` on a weight that requires grad: the pack holds no
    autograd graph, and an in-place update under no_grad (an optimizer
    step) bumps the version and repacks; the same version hits."""
    w = torch.randn(64, 3, 3, 4, requires_grad=True)
    made = []

    def make():
        made.append(1)
        return K12.pack_narrow_weight(w, 64)

    pk = K12._cached_pack(w, ("test", 64), make)
    assert not pk.requires_grad and pk.grad_fn is None
    assert K12._cached_pack(w, ("test", 64), make) is pk and len(made) == 1
    with torch.no_grad():
        w.add_(1.0)
    pk2 = K12._cached_pack(w, ("test", 64), make)
    assert len(made) == 2 and pk2 is not pk
    torch.testing.assert_close(pk2, K12.pack_narrow_weight(w.detach(), 64))


def test_wgrad_routes_and_splits():
    """bf16 with I % 64 == 0, O % 8 == 0 at strides 1 and 2 takes wgmma,
    bf16 with I <= 8, O % 8 == 0 at stride 1 and at most 9 taps the
    narrow-input wgmma route (the conv_ins), the other bf16 shapes
    mma.sync, fp32 the tiled CUDA-core GEMM; mma.sync's splits over the
    pixels: none where dW's tiles fill two blocks an SM, two blocks an SM
    of them otherwise, at least 16 steps of 32 pixels a split, at most 64;
    the fp32 route's N tile and split."""
    bf, f32 = torch.bfloat16, torch.float32
    assert K12.wgrad_route(bf, 320, 320, (1, 1), 9) == "conv_wgrad_wgmma"
    assert K12.wgrad_route(bf, 128, 128, (2, 2), 9) == "conv_wgrad_wgmma"
    assert K12.wgrad_route(bf, 64, 72, (1, 1), 1) == "conv_wgrad_wgmma"
    for I, O, taps in ((4, 320, 9), (3, 128, 9), (8, 320, 9), (1, 8, 1),
                       (5, 64, 4)):
        assert K12.wgrad_route(bf, I, O, (1, 1), taps) == \
            "conv_wgrad_wgmma_i8"
    for I, O, st, taps in ((4, 320, 2, 9), (3, 12, 1, 9), (3, 128, 1, 25),
                           (9, 128, 1, 9), (64, 12, 1, 9), (96, 128, 1, 9),
                           (128, 128, 3, 9)):
        assert K12.wgrad_route(bf, I, O, (st, st), taps) == \
            "conv_wgrad_mma"
    for I, O in ((320, 4), (512, 8), (3, 64), (256, 256)):
        assert K12.wgrad_route(f32, I, O, (1, 1), 9) == \
            "conv_wgrad_fp32_tiled"
    with pytest.raises(ValueError):
        K12.wgrad_route(torch.float16, 64, 64, (1, 1), 9)
    # 9 tiles of dW (the VAE's 512² level 0's shape), 8,192 steps
    assert K12.wgrad_splits(128, 1152, 512 * 512, 132) == 29
    # the VAE conv_in's 512² (mma.sync): 1 tile of dW, 8,192 steps
    assert K12.wgrad_splits(128, 27, 512 * 512, 132) == 64
    # a 64² level on mma.sync: 69 tiles, 256 steps
    assert K12.wgrad_splits(320, 2880, 2 * 64 * 64, 132) == 3
    # 900 tiles, no split
    assert K12.wgrad_splits(1280, 11520, 128, 132) == 1
    # one tile: as many splits as 16-step shares of the pixels allow
    assert K12.wgrad_splits(8, 72, 1000, 132) == 2
    assert K12.wgrad_splits(8, 72, 500, 132) == 1
    # the UNet's fp32 conv_out: N tiles of 8 over 6 x 512 columns, 512
    # steps of 16 pixels: 43 splits (258 blocks of 264 places)
    assert K12.fp32_wgrad_tiling(4, 2880, 8192, 132) == (8, 43)
    assert K12.fp32_wgrad_tiling(8, 4608, 4096, 132) == (8, 29)


@pytest.mark.parametrize("B,H,W,I,O,k,st,pad", [
    (1, 12, 10, 8, 16, 3, 2, ((0, 1), (0, 1))),   # the VAE's down, ragged
    (2, 8, 8, 16, 8, 3, 1, ((1, 1), (1, 1))),
    (1, 9, 9, 3, 8, 7, 2, ((2, 3), (2, 3))),      # the DPT stem's TF-SAME
])
def test_bench_wgrad_case_times_cudnn_on_the_same_function(B, H, W, I, O,
                                                           k, st, pad):
    """``bench_sd_kernels.py --only wgrad``'s row calls at small shapes:
    the checkout's weight gradient, and cuDNN's weight gradient alone on
    the same x and dy (padded outside the call where the pads are
    asymmetric) equal to the plain version's dW (1e-5 of the largest)."""
    from dreamfusion_tpu_torch import bench_sd_kernels as bench
    g = torch.Generator().manual_seed(3)
    fn, lib, gflop = bench._wgrad_case("cpu", g, B, H, W, I, O, k, st, pad,
                                       torch.float32)
    x, dy, w_shape, stride, pads, dt = fn.args
    assert fn.func is K12.conv2d_wgrad_cuda and w_shape == (O, k, k, I)
    Ho, Wo = K12.out_size(H, W, k, k, (st, st), pad)
    assert dy.shape == (B, Ho, Wo, O)
    assert gflop == 2 * B * Ho * Wo * O * k * k * I / 1e9
    _close(lib()[1].permute(0, 2, 3, 1),
           K12.conv2d_wgrad_plain(x, dy, w_shape, stride, pads), 1e-5)


# the towers' bf16 and fp32 wgrad shapes (chip_smoke's recorded calls: B,
# Ho, Wo, I, O, k, stride) → (box, boxes, splits) of the wgmma route
TOWER_WGMMA = {
    (2, 64, 64, 320, 320, 3, 1): ((64, 1, 1), 128, 3),
    (2, 64, 64, 640, 640, 3, 1): ((64, 1, 1), 128, 1),
    (2, 32, 32, 320, 320, 3, 2): ((32, 2, 1), 32, 1),   # the downsampler
    (2, 32, 32, 1280, 1280, 3, 1): ((32, 2, 1), 32, 1),
    (2, 8, 8, 1280, 1280, 3, 1): ((8, 8, 1), 2, 1),
    (2, 8, 8, 2560, 1280, 3, 1): ((8, 8, 1), 2, 1),
    (2, 4, 4, 1280, 1280, 3, 1): ((4, 4, 4), 1, 1),      # zero123's 4²
    (1, 512, 512, 128, 128, 3, 1): ((64, 1, 1), 4096, 14),
    (1, 256, 256, 128, 128, 3, 2): ((64, 1, 1), 1024, 14),
    (1, 128, 128, 512, 512, 3, 1): ((64, 1, 1), 256, 4),
    (1, 64, 64, 512, 512, 3, 1): ((64, 1, 1), 64, 1),
}


@pytest.mark.parametrize("shape", sorted(TOWER_WGMMA))
def test_wgmma_wgrad_tiling_at_the_towers_shapes(shape):
    """``conv_wgrad_wgmma``'s pixel box, steps and split at the towers'
    real shapes: 64 pixels a box, as wide as the output row allows, the
    steps covering every pixel, each split at least one box; the split of
    least modelled time (4 at the VAE's 128²: 144 tiles alone would leave
    a second round of 12 on 132 SMs)."""
    B, Ho, Wo, I, O, k, st = shape
    assert K12.wgrad_route(torch.bfloat16, I, O, (st, st), k * k) == \
        "conv_wgrad_wgmma"
    box, steps, splits = TOWER_WGMMA[shape]
    bw, bh, bb = K12.wgrad_box(B, Ho, Wo)
    assert (bw, bh, bb) == box and bw * bh * bb == 64
    assert bw * st <= 256 and bh * st <= 256
    assert K12.wgrad_boxes(B, Ho, Wo) == steps
    assert steps * 64 >= B * Ho * Wo
    K = k * k * I
    assert K12.wgmma_wgrad_splits(O, K, steps, 132) == splits <= steps


# the DPT's 17 fp32 wgrad shapes at 384² (B, H, W, I, O, k, stride) →
# fp32_wgrad_tiling's (N tile, splits)
DPT_FP32 = {
    (1, 384, 384, 128, 32, 3, 1): (32, 64),
    (1, 192, 192, 256, 128, 3, 1): (64, 14),
    (1, 96, 96, 256, 256, 3, 1): (64, 7),
    (1, 48, 48, 256, 256, 3, 1): (64, 7),
    (1, 24, 24, 256, 256, 3, 1): (64, 4),
    (1, 12, 12, 256, 256, 3, 1): (64, 1),
    (1, 12, 12, 768, 256, 3, 1): (64, 1),
    (1, 24, 24, 768, 256, 3, 1): (64, 2),
    (1, 48, 48, 512, 256, 3, 1): (64, 3),
    (1, 24, 24, 768, 768, 3, 2): (64, 1),
    (1, 48, 48, 256, 256, 3, 2): (64, 4),
    (1, 48, 48, 512, 1024, 1, 2): (64, 4),
    (1, 48, 48, 128, 128, 3, 1): (64, 18),
    (1, 96, 96, 128, 128, 3, 2): (64, 18),
    (1, 96, 96, 256, 512, 1, 2): (64, 18),
    (1, 96, 96, 64, 64, 3, 1): (64, 64),
    (1, 384, 384, 3, 64, 7, 2): (64, 64),
}


@pytest.mark.parametrize("shape", sorted(DPT_FP32))
def test_fp32_wgrad_tiling_at_the_dpt_shapes(shape):
    """``conv_wgrad_fp32_tiled``'s N tile and split at the DPT's 17 shapes
    (TF-SAME pads): 32 where O fits, else 64; each split at least 8 steps
    of 16 pixels where the pixels allow more than one, at most 64; the
    modelled cost of the chosen split no more than one split's."""
    B, H, W, I, O, k, st = shape
    assert K12.wgrad_route(torch.float32, I, O, (st, st), k * k) == \
        "conv_wgrad_fp32_tiled"
    Ho, Wo = -(-H // st), -(-W // st)
    K, P = k * k * I, B * Ho * Wo
    bn, splits = K12.fp32_wgrad_tiling(O, K, P, 132)
    assert (bn, splits) == DPT_FP32[shape]
    steps = -(-P // 16)
    assert 1 <= splits <= 64 and (splits == 1 or steps // splits >= 8)
    tiles = -(-K // 128) * -(-O // bn)
    waves = -(-tiles * splits // (4 * 132))
    assert waves * -(-steps // splits) + splits * O * K / 5e5 * \
        (splits > 1) <= -(-tiles // (4 * 132)) * steps


# ---------------------------------------------------------------------------
# K11: the affine gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("C,G", [(8, 8), (24, 8), (320, 32)])   # Cg 1, 3, 10
def test_group_norm_affine_gradients_match_jax(rng, silu, C, G):
    """jax.vjp of ``group_norm_fused`` (then SiLU, as the towers apply it)
    with respect to (x, scale, bias) against the port's autograd: dscale =
    Σ dy'·x̂ and dbias = Σ dy' over batch and pixels, dy' after SiLU's
    derivative; 1e-4 of each gradient's largest entry (float32)."""
    x = _rand(rng, 2, 5, 3, C, scale=2.0) + 0.5
    sc = 1 + _rand(rng, C, scale=0.3)
    bs = _rand(rng, C, scale=0.3)
    eps = 1e-5

    def jgn(xx, s, b):
        y = junet.group_norm_fused(xx, s, b, G, eps)
        return jax.nn.silu(y) if silu else y

    y_j, vjp = jax.vjp(jgn, *map(jnp.asarray, (x, sc, bs)))
    gy = _rand(rng, *y_j.shape)
    dx_j, ds_j, db_j = vjp(jnp.asarray(gy))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, sc, bs)]
    y = K11.group_norm(*ins, G, eps, silu)
    _close(y, y_j)
    dx, ds, db = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    _close(dx, dx_j, what="dx")
    _close(ds, ds_j, what="dscale")
    _close(db, db_j, what="dbias")
    # one of the two alone: the other's gradient is not formed
    (ds2,) = torch.autograd.grad(K11.group_norm(ins[0].detach(), ins[1],
                                                ins[2].detach(), G, eps,
                                                silu),
                                 ins[1], torch.from_numpy(gy))
    _close(ds2, ds_j, what="dscale alone")


# ---------------------------------------------------------------------------
# K10: dQ, dK, dV at SD 1.5's head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("M", [1, 77])
def test_attention_vjp_at_sd15_head_dims_dense(rng, d, M):
    """JAX's dense branch (the text cross-attention's 77 keys, zero123's
    one key): jax.vjp of ``attention`` against the port's autograd, in
    float32, 1e-4 of each gradient's largest entry."""
    B, N, h = 2, 24, 2
    q, k, v = (_rand(rng, B, n, h, d) for n in (N, M, M))
    assert not K10.chunked_branch(B, N, M, h)
    o_j, vjp = jax.vjp(jattention, *map(jnp.asarray, (q, k, v)))
    do = _rand(rng, *o_j.shape)
    grads_j = vjp(jnp.asarray(do))
    # over one key the output is v and dQ is 0 in exact arithmetic: its
    # rounding is held to the call's other gradients
    ref = max(float(np.abs(np.asarray(g)).max()) for g in grads_j)
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = K10.attention(*qkv)
    _close(o, o_j)
    for name, got, want in zip("qkv", torch.autograd.grad(
            o, qkv, torch.from_numpy(do)), grads_j):
        _close(got, want, what=f"d{name}", ref=ref)
    # the kernels' arithmetic in torch (the card's reference) agrees too
    for name, got, want in zip("qkv", K10.attention_bwd_plain(
            *map(torch.from_numpy, (q, k, v)), o.detach(),
            torch.from_numpy(do), d ** -0.5), grads_j):
        _close(got, want, what=f"attention_bwd_plain d{name}", ref=ref)


@pytest.mark.parametrize("d,M,dtype", [
    (40, 512, "float32"), (40, 1024, "bfloat16"), (80, 512, "float32"),
    (160, 512, "float32")])
def test_attention_vjp_on_the_chunked_branch(rng, monkeypatch, d, M, dtype):
    """JAX's chunked branch (its logits threshold lowered to 0 on both
    sides): at d = 40 in bf16 the logits are bf16(q·scale)·kᵀ, whose
    derivative passes straight through the rounding; dQ, dK, dV against
    jax.vjp within 1e-4 (float32) or ``BF16_TOL`` (bf16) of their largest
    entries, and, in bf16, the kernels' torch arithmetic
    (``attention_bwd_plain`` with the rounded q·scale) as close."""
    B, N, h = 1, 16, 2
    monkeypatch.setattr(K10, "LOGITS_THRESHOLD", 0)
    assert K10.chunked_branch(B, N, M, h)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v = (_rand(rng, B, n, h, d, scale=2.0) for n in (N, M, M))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    o_j, vjp = jax.vjp(lambda a, b, c: jattention(a, b, c,
                                                  logits_threshold=0),
                       jq, jk, jv)
    do = _rand(rng, *o_j.shape)
    grads_j = vjp(jnp.asarray(do).astype(jdt))
    tol = BF16_TOL if dtype == "bfloat16" else RTOL
    qkv = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    o = K10.attention(*qkv)
    _close(o, np.asarray(o_j.astype(jnp.float32)), tol)
    dot = torch.from_numpy(do).to(tdt)
    for name, got, want in zip("qkv", torch.autograd.grad(o, qkv, dot),
                               grads_j):
        _close(got, np.asarray(want.astype(jnp.float32)), tol,
               what=f"d{name}")
    if dtype == "bfloat16":
        plain = K10.attention_bwd_plain(*(t.detach() for t in qkv),
                                        o.detach(), dot, d ** -0.5, True)
        for name, got, want in zip("qkv", plain, grads_j):
            _close(got, np.asarray(want.astype(jnp.float32)), tol,
                   what=f"attention_bwd_plain d{name}")


def test_attention_backward_routes():
    """The backward's entry point by head dim: the UNets' 40, 64, 80 and
    160 each their own flash-style one, the VAE's 512 the four-kernel one;
    fp32 the CUDA-core one at 64 only; any other raises."""
    assert {d: K10.attention_bwd_route(d) for d in (40, 64, 80, 160, 512)} \
        == {40: "attention_bwd_flash_d40", 64: "attention_bwd_flash",
            80: "attention_bwd_flash_d80", 160: "attention_bwd_flash_d160",
            512: "attention_bwd_wgmma"}
    assert K10.attention_bwd_route(64, torch.float32) == "attention_bwd_fp32"
    for d in (32, 48, 100, 128):
        with pytest.raises(ValueError):
            K10.attention_bwd_route(d)
    for d in (40, 512):
        with pytest.raises(ValueError):
            K10.attention_bwd_route(d, torch.float32)


# (B·h, N, M, d) → the flash backward's query splits on 132 SMs
FLASH_SPLITS = {
    (16, 4096, 4096, 40): 1,        # SD 1.5's 64² self-attention: 512 blocks
    (16, 4096, 77, 40): 4,          # its text cross-attention: 16 blocks
    (16, 1024, 1024, 80): 1,        # 128 blocks, 16 query tiles each
    (16, 256, 256, 160): 2,         # 32 blocks, 8 query tiles
    (16, 256, 77, 160): 2,          # 16 blocks, 8 query tiles: 4 a split
    (16, 1024, 1, 40): 4,           # zero123's one key
    (10, 4096, 4096, 64): 1,        # SD 2.1's [2, 4096, 5, 64]
    (10, 4096, 77, 64): 6,          # 10 blocks: 60 fill half the card
    (2, 257, 77, 64): 1,            # 5 query tiles: fewer than 4 a split
    (1, 1000, 77, 40): 4,           # 16 query tiles, the last ragged
    (1, 70, 200, 160): 1,           # 3 tiles of 32
}


@pytest.mark.parametrize("shape", sorted(FLASH_SPLITS))
def test_flash_backward_splits_stay_in_bounds(shape):
    """The dK/dV pass's query splits: as many as bring its blocks (a head
    and 128 keys) to half the card (the dQ blocks of the same launch take
    the rest), at most 16 and with at least 4 query tiles (64 queries, 32
    at d = 160) a split."""
    Z, N, M, d = shape
    splits = K10.flash_bwd_splits(Z, N, M, d, 132)
    assert splits == FLASH_SPLITS[shape]
    tiles = -(-N // (32 if d == 160 else 64))
    assert 1 <= splits <= min(16, max(1, tiles // 4))
    assert splits == 1 or Z * -(-M // 128) * splits <= 66


# ---------------------------------------------------------------------------
# the tiny towers: every parameter's gradient and the input's
# ---------------------------------------------------------------------------

def _port_tower_grads(tower, build, run, f64):
    """Build the port tower (`build()`, every parameter trainable) and run
    `run(module, dtype)`, which returns its input and the loss; backward →
    (the input's gradient, {Flax path: gradient}).  With `f64`, the whole
    plain path in float64 (``float64_port``): the witness the float32
    sides' rounding is measured against."""
    with float64_port() if f64 else contextlib.nullcontext():
        module = build()
        if f64:
            module.double()
        module.requires_grad_(True)
        x, loss = run(module, torch.float64 if f64 else torch.float32)
        loss.backward()
        grads = {n: p.grad for n, p in module.named_parameters()
                 if p.grad is not None}
        state = module.state_dict()
    return x.grad, tower_to_flax(tower, grads, _port_levels(tower, state))


def _check_tower_grads(got, truth, jgrads, rtol=RTOL):
    """Every JAX gradient with a nonzero entry has the port's; each within
    rtol of its largest entry, or, where JAX's own float32 rounding is
    larger (a gradient that is 0 in exact arithmetic: a conv's bias before
    a GroupNorm of one channel a group), within 4x JAX's distance from the
    float64 witness → (tensors, tensors held by the witness)."""
    flat = {p: _np(a) for p, a in _flat(jgrads)}
    live = {p for p, a in flat.items() if np.abs(a).max() > 0}
    assert live <= set(got), sorted(live - set(got))[:5]
    witnessed = 0
    for path, g in got.items():
        want, exact = flat[path], _np(truth[path])
        floor = rtol * np.abs(want).max()
        jax_err = np.abs(want - exact).max()
        witnessed += int(4 * jax_err > floor)
        err = np.abs(_np(g) - want).max()
        assert err <= max(floor, 4 * jax_err), (path, err, floor, jax_err)
    return len(got), witnessed


def test_tiny_unet_gradients_match_jax():
    """``jax.grad`` of JAX's tiny UNet ``apply`` (f32; self- and
    cross-attention at its one attention level, head dim 32) with respect
    to every parameter and the input, against the port's autograd of the
    same module with the weights carried over; each gradient within 1e-4
    of its largest entry, or within 4x of JAX's own distance from the
    port's float64 gradient where that is larger."""
    cfg_j = junet.UNetConfig.tiny()
    net_j = junet.UNet2DCondition(cfg_j)
    args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 5, 32)))
    jp = random_flax_params(net_j.init, *args, seed=11)
    rng = np.random.default_rng(12)
    x = _rand(rng, 2, 8, 8, 4)
    t = np.array([20, 731])
    ctx = _rand(rng, 2, 5, 32)
    ct = _rand(rng, 2, 8, 8, 4)

    def loss(p, xx):
        out = net_j.apply({"params": p}, xx, jnp.asarray(t),
                          jnp.asarray(ctx))
        return jnp.sum(out * ct)

    gp_j, gx_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    state = params_from_jax({"unet": jp})["unet"]

    def build():
        net = punet.UNet2DCondition(punet.UNetConfig.tiny())
        net.load_state_dict(state, strict=True)
        return net

    def run(net, dt):
        xt = torch.from_numpy(x).to(dt).requires_grad_()
        out = net(xt, torch.from_numpy(t), torch.from_numpy(ctx).to(dt))
        return xt, (out * torch.from_numpy(ct).to(dt)).sum()

    gx, got = _port_tower_grads("unet", build, run, False)
    gx64, truth = _port_tower_grads("unet", build, run, True)
    _close(gx, gx_j, what="input")
    _close(gx64, gx_j, what="input, float64")
    n, witnessed = _check_tower_grads(got, truth, gp_j)
    assert n == len(state) and witnessed <= n // 4


def test_tiny_vae_encoder_gradients_match_jax():
    """``jax.grad`` of JAX's tiny VAE ``encode`` (the moments' mean and
    log-variance, quant_conv included; f32) with respect to every encoder
    parameter and the image, against the port's autograd, as the UNet's;
    the decoder's gradients are JAX's zeros and the port's None."""
    cfg_j = jvae.VAEConfig.tiny()
    vae_j = jvae.AutoencoderKL(cfg_j)
    jp = random_flax_params(vae_j.init, jnp.zeros((1, 16, 16, 3)),
                            jax.random.PRNGKey(0), seed=13)
    rng = np.random.default_rng(14)
    x = np.tanh(_rand(rng, 1, 16, 16, 3))
    zc = 2 * cfg_j.z_channels
    ct = _rand(rng, 1, 8, 8, zc)

    def loss(p, xx):
        m = vae_j.apply({"params": p}, xx, method=vae_j.encode)
        return jnp.sum(jnp.concatenate([m.mean, m.logvar], -1) * ct)

    gp_j, gx_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    state = params_from_jax({"vae": jp})["vae"]

    def build():
        vae = pvae.AutoencoderKL(pvae.VAEConfig.tiny())
        vae.load_state_dict(state, strict=True)
        return vae

    def run(vae, dt):
        xt = torch.from_numpy(x).to(dt).requires_grad_()
        m = vae.encode(xt)
        mom = torch.cat([m.mean, m.logvar], -1)
        return xt, (mom * torch.from_numpy(ct).to(dt)).sum()

    gx, got = _port_tower_grads("vae", build, run, False)
    gx64, truth = _port_tower_grads("vae", build, run, True)
    _close(gx, gx_j, what="input")
    _close(gx64, gx_j, what="input, float64")
    n, witnessed = _check_tower_grads(got, truth, gp_j)
    assert n == sum(1 for k in state
                    if k.startswith(("encoder.", "quant_conv.")))
    assert witnessed <= n // 4


# ---------------------------------------------------------------------------
# the full-width towers' backward routes (meta device: shapes only)
# ---------------------------------------------------------------------------

def _full_width(kind):
    with torch.device("meta"):
        if kind == "vae":
            return pvae.AutoencoderKL(pvae.VAEConfig.sd()).encoder
        cfg = {"sd21": punet.UNetConfig.sd21, "sd15": punet.UNetConfig.sd15,
               "zero123": punet.UNetConfig.zero123}[kind]()
        return punet.UNet2DCondition(cfg)


@pytest.mark.parametrize("kind", ["sd21", "sd15", "zero123", "vae"])
def test_full_width_convs_take_a_wgrad_route(kind):
    """Every conv of the full-width towers has a weight-gradient route:
    the bf16 convs wgmma's (the stride-2 downsamplers among them) but the
    conv_in's 3-, 4- and 8-channel inputs, on its narrow-input form; the
    fp32 conv_out the tiled CUDA-core one; none on mma.sync."""
    tower = _full_width(kind)
    routes = {}
    for name, m in tower.named_modules():
        if isinstance(m, punet.Conv2d):
            O, kh, kw, I = m.weight.shape
            routes[name] = K12.wgrad_route(m.compute_dtype, I, O,
                                           (m.stride, m.stride), kh * kw)
    assert routes.pop("conv_out") == "conv_wgrad_fp32_tiled"
    assert routes.pop("conv_in") == "conv_wgrad_wgmma_i8"
    assert set(routes.values()) == {"conv_wgrad_wgmma"}
    convs = {n: m for n, m in tower.named_modules()
             if isinstance(m, punet.Conv2d)}
    assert convs["conv_in"].weight.shape[-1] == {
        "sd21": 4, "sd15": 4, "zero123": 8, "vae": 3}[kind]
    assert any(m.stride == 2 for m in convs.values())
    assert len(convs) == {"sd21": 52, "sd15": 52, "zero123": 52,
                          "vae": 25}[kind]


# chip_smoke.py's towers → the new backward routes' launches a forward and
# backward of each (the conv_in's narrow wgrad, K10's flash routes)
TOWER_GRAD_LAUNCHES = {
    "SD 2.1 UNet": {"conv_wgrad_wgmma_i8": 1, "attention_bwd_flash": 32},
    "SD 1.5 UNet": {"conv_wgrad_wgmma_i8": 1, "attention_bwd_flash_d40": 10,
                    "attention_bwd_flash_d80": 10,
                    "attention_bwd_flash_d160": 12},
    "zero123 UNet": {"conv_wgrad_wgmma_i8": 1,
                     "attention_bwd_flash_d40": 10,
                     "attention_bwd_flash_d80": 10,
                     "attention_bwd_flash_d160": 12},
    "SD VAE encoder": {"conv_wgrad_wgmma_i8": 1, "attention_bwd_wgmma": 1},
}


@pytest.mark.parametrize("tower", sorted(TOWER_GRAD_LAUNCHES))
def test_chip_smoke_tower_launches_take_the_new_routes(tower):
    """``chip_smoke.tower_launches`` derives each full-width tower's
    backward launches from its forward on the meta device (a card of 132
    SMs stubbed): the conv_in's weight gradient on the narrow wgmma route,
    the attentions' backward on the flash routes at the UNets' head dims
    and the four-kernel one at the VAE's 512, mma.sync's wgrad and the
    old per-head-dim entry points nowhere; ``GRAD_KERNELS`` lists them."""
    import importlib.util
    import pathlib
    import types

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = types.SimpleNamespace(sm_count=lambda dev: 132)
    prior, part = smoke.GRAD_TOWERS[tower]
    want = smoke.tower_launches(
        torch, card, prior, **({"unet": 1, "unet_grad": 1} if part == "unet"
                               else {"encode": 1, "encode_grad": 1}))
    new = {k: v for k, v in want.items()
           if k == "conv_wgrad_wgmma_i8" or k.startswith("attention_bwd")}
    assert new == TOWER_GRAD_LAUNCHES[tower]
    assert "conv_wgrad_mma" not in want
    assert set(new) <= set(smoke.GRAD_KERNELS) | {"attention_bwd_wgmma"}
    assert not any(k.startswith("attention_bwd_wgmma_d") for k in want)


@pytest.mark.parametrize("kind", ["sd21", "sd15", "zero123", "vae"])
def test_full_width_norms_and_attentions_take_backward_routes(kind):
    """Every GroupNorm of the full-width towers has a backward route whose
    affine entry point the kernels export, and every attention's head dim a
    backward entry point: SD 1.5's and zero123's 40, 80 and 160, SD 2.1's
    64, the VAE's 512."""
    from dreamfusion_tpu_torch.ops import kernels

    tower = _full_width(kind)
    heads = set()
    for m in tower.modules():
        if isinstance(m, punet.CrossAttention):
            heads.add(m.head_dim)
        if isinstance(m, punet.GroupNorm32):
            assert m.groups == 32
    want = {"sd21": {64}, "sd15": {40, 80, 160}, "zero123": {40, 80, 160},
            "vae": set()}[kind]
    assert heads == want
    for d in heads | ({512} if kind == "vae" else set()):
        assert K10.attention_bwd_route(d) in kernels.LAUNCHES
    for name in ("groupnorm_bwd_resident", "groupnorm_bwd_stream"):
        assert name + "_affine" in kernels.LAUNCHES
        assert name + "_affine" in kernels._SIGNATURES
