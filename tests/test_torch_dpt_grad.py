"""The DPT's backward (``models/dpt.py::DPTDepthModel.forward_grad``) and
the kernels' plain versions it runs on against ``jax.grad`` / ``jax.vjp``
of the JAX package on the CPU, where the wrappers take their plain
versions:

* the tiny DPT (``test_torch_dpt._tiny_pair``: vit_depth 2, ResNet stages
  of one block, 64² input with the pos embed resized 6 → 4, the normals
  head) with every parameter and the input wanting gradients, against
  ``jax.grad`` of JAX's ``apply`` for a seeded cotangent, JAX's run in
  float64 the witness: the port's float64 gradients within 1e-5 of each
  one's largest entry, its float32 ones within 1e-4;
* K10's fp32 vjp (``attention_bwd_plain``, the card's reference, and
  autograd of ``attention``) against ``jax.vjp(dense_attention)`` over a
  query count that is not a multiple of 32: 1e-5 of the largest;
* K12's fp32 dgrad and wgrad plain versions (``conv2d_dgrad_plain``,
  ``conv2d_wgrad_plain``) against ``jax.vjp(mm_conv)`` at k = 1, 3, 7,
  strides 1 and 2, TF-SAME pads (asymmetric at stride 2), I = 3 and one
  case at 256² pixels, where JAX takes ``_emitter_conv``: 1e-5 of the
  largest;
* the full-width DPT's backward on the meta device (``chip_smoke``'s
  ``dpt_grad_calls``): every conv's input and weight gradient and every
  attention's backward, and the routes they take on the card.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dreamfusion_tpu.ops.attention import dense_attention
from dreamfusion_tpu.ops.conv import mm_conv
from dreamfusion_tpu_torch.models import dpt as pdpt
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.ops import conv as K12
from dreamfusion_tpu_torch.utils import convert as PC

from test_torch_dpt import TINY, _tiny_pair
from torch_parity import float64_port

torch.set_num_threads(2)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


# JAX's modules on the DPT's path, whose float32 casts and accumulations
# `_F64Numpy` widens
JAX_DPT_MODULES = ("dreamfusion_tpu.models.dpt", "dreamfusion_tpu.ops.conv",
                   "dreamfusion_tpu.ops.attention", "dreamfusion_tpu.ops.resize")


class _F64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: set as the ``jnp``
    of `JAX_DPT_MODULES` under ``jax.enable_x64``, it runs JAX's own DPT
    and its ``jax.grad`` in float64, the witness both float32 sides are
    measured against."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_grads(jm, params, x, ct, f64):
    """``jax.grad`` of Σ ct·DPT(x) in JAX → {name: numpy}, the input's as
    "input", in float32 or, with `f64`, in float64 throughout."""

    def loss(p, xx, c):
        return (jm.apply({"params": p}, xx) * c).sum()

    def run():
        dt = np.float64 if f64 else np.float32
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dt)), params)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            p, jnp.asarray(x.astype(dt)), jnp.asarray(ct.astype(dt)))
        assert gx.dtype == dt
        return jax.tree.map(lambda a: np.asarray(a, np.float64), gp), gx

    if f64:
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            for name in JAX_DPT_MODULES:
                mp.setattr(importlib.import_module(name), "jnp", _F64Numpy())
            gp, gx = run()
    else:
        gp, gx = run()
    out = {k: v.double().numpy()
           for k, v in PC.params_from_jax({"params": gp}).items()}
    out["input"] = np.asarray(gx, np.float64)
    return out


class _Branches:
    """The port DPT's ``F.relu``, recording on which side of 0 each input
    lies (a first run) or, with `replay`, taking the recorded sides: the
    gradient is then the recorded mask.  `flips` keeps, for each input a
    replay finds on the other side, its size against its tensor's
    largest."""

    def __init__(self):
        self.masks, self.flips, self.replay, self.at = [], [], False, 0

    def relu(self, z):
        if not self.replay:
            self.masks.append(z.detach() > 0)
            return F.relu(z)
        mask = self.masks[self.at]
        self.at += 1
        flip = (z.detach() > 0) != mask
        if flip.any():
            self.flips.append(float(z.detach()[flip].abs().max()
                                    / z.detach().abs().max()))
        return z * mask.to(z.dtype)

    def __getattr__(self, name):
        return getattr(F, name)


def _port_grads(pm, x, ct, f64, branches):
    """The port's gradients of Σ ct·DPT(x) → {name: numpy}, the input's as
    "input", in float32 or, with `f64`, the whole plain path in float64
    (``float64_port``); its ReLUs through `branches`."""
    with float64_port() if f64 else contextlib.nullcontext(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdpt, "F", branches)
        m = pdpt.DPTDepthModel(pdpt.DPTConfig(**TINY))
        m.load_state_dict(pm.state_dict())
        if f64:
            m.double()
        m.requires_grad_(True)
        dt = torch.float64 if f64 else torch.float32
        xt = torch.from_numpy(x).to(dt).requires_grad_()
        (m.forward_grad(xt) * torch.from_numpy(ct).to(dt)).sum().backward()
        assert xt.grad.dtype == dt
    out = {n: p.grad for n, p in m.named_parameters()}
    out["input"] = xt.grad
    return {n: None if g is None else g.double().numpy()
            for n, g in out.items()}


def test_tiny_dpt_gradients_match_jax():
    """Every parameter's gradient and the input's, from one cotangent on
    the normals head, against ``jax.grad`` of JAX's forward, with JAX's
    own float64 gradient (`_F64Numpy`) as the witness:

    * the port in float64 (``float64_port``) within 1e-5 of each
      gradient's largest entry: the rules of the backward, weight
      standardisation, norms, max pool and resizes included;
    * the port in float32 within 1e-4 of it, for every tensor;
    * the port in float32 within 1e-4 of JAX's float32 gradient, or of 4x
      JAX's own distance from float64 where that is larger (JAX's float32
      lies up to ~2e-3 of the largest from its float64 in the ResNet's
      gradients, so this widens 40 of the 126).

    The float32 run takes the float64 run's ReLU branches: a ReLU whose
    input lies within float32 rounding of 0 branches by rounding (here one
    pre-activation ~1e-7 of its tensor's largest, on the port's side), and
    that one decision moves every gradient upstream of it by up to ~5e-2
    of its largest.  At most four inputs may lie on the other side, each
    within 1e-6 of its tensor's largest (two here, 2.7e-8 and 3.5e-8)."""
    jm, params, pm = _tiny_pair()
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = _jax_grads(jm, params, x, ct, False)
    truth = _jax_grads(jm, params, x, ct, True)
    branches = _Branches()
    port64 = _port_grads(pm, x, ct, True, branches)
    branches.replay = True
    got = _port_grads(pm, x, ct, False, branches)
    assert branches.at == len(branches.masks)
    assert len(branches.flips) <= 4 and max(branches.flips, default=0) <= 1e-6
    assert set(got) == set(want) == set(truth) == set(port64)
    for name, w64 in truth.items():
        g, w, t = got[name], want[name], port64[name]
        scale = np.abs(w64).max()
        if not scale:                 # the unused final LayerNorm
            assert g is None or not g.any(), name
            continue
        assert np.abs(t - w64).max() <= 1e-5 * scale, name
        assert np.abs(g - w64).max() <= 1e-4 * scale, name
        own = 4 * np.abs(w - w64).max()
        assert np.abs(g - w).max() <= max(1e-4 * scale, own), name


def test_dpt_forward_stays_frozen_for_inference():
    """``forward`` (``preprocess_image``'s) records no graph, even with
    trainable weights; ``forward_grad`` gives the same output."""
    _, _, pm = _tiny_pair()
    pm.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32))
    y = pm(x)
    assert not y.requires_grad
    yg = pm.forward_grad(x)
    assert yg.requires_grad
    assert torch.equal(y, yg.detach())


@pytest.mark.parametrize("N, M", [(45, 45), (77, 20)])
def test_fp32_attention_vjp_matches_jax(N, M):
    rng = np.random.default_rng(N + M)
    B, h, d = 2, 3, 64
    q, do = (rng.standard_normal((B, N, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, M, h, d)).astype(np.float32)
            for _ in range(2))
    o, vjp = jax.vjp(dense_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    assert K10.attention_bwd_route(d, torch.float32) == "attention_bwd_fp32"
    assert not K10.chunked_branch(B, N, M, h)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    got = K10.attention_bwd_plain(qt, kt, vt, torch.from_numpy(
        np.array(o)), dot, d ** -0.5)
    ins = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    auto = torch.autograd.grad(K10.attention(*ins), ins, dot)
    for a, b, w in zip(got, auto, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), w, 1e-5)
        _close(b.numpy(), w, 1e-5)


# (B, H, W, I, O, k, stride): the stem's 7x7 s2 on 3 channels, 1x1 at both
# strides, 3x3 at both, and one map of 256² where JAX's mm_conv takes XLA's
# conv emitter
CONV_CASES = [(2, 18, 18, 3, 8, 7, 2), (1, 12, 14, 8, 6, 1, 2),
              (1, 10, 10, 8, 6, 1, 1), (2, 11, 13, 5, 7, 3, 2),
              (1, 9, 9, 6, 10, 3, 1), (1, 20, 17, 3, 12, 7, 1),
              (1, 256, 256, 3, 4, 3, 1)]


@pytest.mark.parametrize("case", CONV_CASES)
def test_fp32_conv_dgrad_and_wgrad_plain_match_jax(case):
    B, H, W, I, O, k, st = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((B, H, W, I)).astype(np.float32)
    kern = rng.standard_normal((k, k, I, O)).astype(np.float32)
    pads = (pdpt.same_pads(H, k, st), pdpt.same_pads(W, k, st))
    conv = lambda xx, kk: mm_conv(xx, kk, (st, st), pads)
    Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
    dy = rng.standard_normal((B, Ho, Wo, O)).astype(np.float32)
    jdx, jdk = jax.jit(lambda xx, kk, g: jax.vjp(conv, xx, kk)[1](g))(
        jnp.asarray(x), jnp.asarray(kern), jnp.asarray(dy))
    w = torch.from_numpy(kern.transpose(3, 0, 1, 2).copy())
    dyt = torch.from_numpy(dy)
    dx = K12.conv2d_dgrad_plain(dyt, w, x.shape, (st, st), pads,
                                torch.float32)
    dw = K12.conv2d_wgrad_plain(torch.from_numpy(x), dyt, w.shape, (st, st),
                                pads)
    _close(dx.numpy(), jdx, 1e-5)
    _close(dw.permute(1, 2, 3, 0).numpy(), jdk, 1e-5)
    assert K12.dgrad_route(torch.float32, I, O, (st, st), (k, k)) in (
        "conv_dgrad_fp32", "conv_dgrad_fp32_tiled")


def test_dgrad_route_sends_fp32_to_the_tiled_route():
    """Every fp32 dgrad the narrow route (O <= 8, I % 4 == 0) does not take
    goes to the tiled fp32 route, at any stride and I; bf16 keeps its
    routes."""
    for I, O, st, k in ((3, 64, 2, 7), (64, 256, 2, 1), (256, 256, 2, 3),
                        (16, 16, 1, 3), (3, 8, 1, 3), (768, 256, 1, 3)):
        assert K12.dgrad_route(torch.float32, I, O, (st, st), (k, k)) == \
            "conv_dgrad_fp32_tiled"
    assert K12.dgrad_route(torch.float32, 64, 8, (1, 1), (3, 3)) == \
        "conv_dgrad_fp32"
    assert K12.dgrad_route(torch.bfloat16, 32, 48, (2, 2), (3, 3)) == \
        "conv_dgrad"
    assert K12.dgrad_route(torch.bfloat16, 128, 128, (1, 1), (3, 3)) == \
        "conv_dgrad_wgmma"


@pytest.mark.parametrize("task", ["depth", "normal"])
def test_full_dpt_backward_routes_on_meta(task):
    """vitb_rn50_384 at 384² on the meta device, every weight and the input
    wanting gradients: the backward asks 40 input gradients (the stem's
    3-channel dx included) and 40 weight gradients of K12, all on the
    fp32 routes (``conv_dgrad_fp32_tiled``, ``conv_wgrad_fp32_tiled``; none on
    ``conv_dgrad``), and 12 fp32 attention backwards; ``dpt_grad_launches``
    gives them beside the forward's."""
    import chip_smoke
    cfg = getattr(pdpt.DPTConfig, task)()
    calls = chip_smoke.dpt_grad_calls(cfg, 384)
    kinds = {}
    for kind, *_ in calls:
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds == {"conv": 40, "dgrad": 40, "wgrad": 40, "attn": 12,
                     "attn_bwd": 12}
    assert ("dgrad", (1, 384, 384, 3), (64, 7, 7, 3), 2,
            ((2, 3), (2, 3))) in calls
    launches = chip_smoke.dpt_grad_launches(torch, cfg)
    assert launches == {"conv_fwd_fp32_tiled": 40, "attention_fwd_fp32": 12,
                        "conv_dgrad_fp32_tiled": 40,
                        "conv_wgrad_fp32_tiled": 40,
                        "attention_bwd_fp32": 12}
    # the 17 distinct shapes of the forward, each with its backward
    shapes = {c[1:] for c in calls if c[0] == "dgrad"}
    assert len(shapes) == 17
    for (B, H, W, I), (O, kh, kw, _), st, pads in shapes:
        classes = K12.dgrad_classes(H, W, kh, kw, (st, st), pads)
        assert len(classes) == st * st
        if kh == 1 and st == 2:            # the ResNet's downsample
            assert [c["nt"] * c["nu"] for c in classes] == [1, 0, 0, 0]


def test_bench_dpt_dgrad_rows_time_cudnn_on_the_same_function():
    """``bench_sd_kernels.py --only dpt_dgrad``'s rows (the full-width DPT
    at 64² here): one a distinct conv, 40 in a backward, the stem's
    3-channel dx among them; cuDNN's call (``aten.convolution_backward``
    on the TF-SAME padded input) gives, cropped to the input, the dx of the
    plain version from the row's own dy and w (1e-5 of the largest)."""
    import types

    import chip_smoke
    from dreamfusion_tpu_torch import bench_sd_kernels as bench

    smoke = types.SimpleNamespace(dpt_calls=chip_smoke.dpt_calls, DPT_HW=64)
    cases = bench.dpt_dgrad_cases(smoke, "cpu")
    assert sum(row["per_backward"] for row, _, _ in cases) == 40
    assert any(row["shape"][3] == 3 and row["k"] == 7 for row, _, _ in cases)
    for row, fn, lib in cases:
        dy, w, x_shape, stride, pads, dt = fn.args
        assert fn.func is K12.conv2d_dgrad_cuda and dt == torch.float32
        B, H, W, I = x_shape
        (pt, _), (pl, _) = pads
        dx = lib()[0][:, :, pt:pt + H, pl:pl + W].permute(0, 2, 3, 1)
        _close(dx.numpy(), K12.conv2d_dgrad_plain(
            dy, w, x_shape, stride, pads, torch.float32).numpy(), 1e-5)


def test_bench_dpt_wgrad_rows_time_cudnn_on_the_same_function():
    """``bench_sd_kernels.py --only dpt_wgrad``'s rows (the full-width DPT
    at 64² here): one a distinct conv, 40 in a backward, the stem among
    them; the row's call is the checkout's weight gradient, and cuDNN's
    (``aten.convolution_backward`` with the weight mask, on the TF-SAME
    padded input) gives the plain version's dW from the same x and dy
    (1e-5 of the largest)."""
    import types

    import chip_smoke
    from dreamfusion_tpu_torch import bench_sd_kernels as bench

    smoke = types.SimpleNamespace(dpt_calls=chip_smoke.dpt_calls, DPT_HW=64)
    cases = bench.dpt_wgrad_cases(smoke, "cpu")
    assert sum(row["per_backward"] for row, _, _ in cases) == 40
    assert any(row["shape"][3] == 3 and row["k"] == 7 for row, _, _ in cases)
    for row, fn, lib in cases:
        x, dy, w_shape, stride, pads, dt = fn.args
        assert fn.func is K12.conv2d_wgrad_cuda and dt == torch.float32
        dw = lib()[1].permute(0, 2, 3, 1)
        _close(dw.numpy(), K12.conv2d_wgrad_plain(
            x, dy, w_shape, stride, pads).numpy(), 1e-5)
