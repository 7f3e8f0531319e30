#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Fails at once without a CUDA device; prints the card's name and power
   limit (nvidia-smi).
2. Builds the port's CUDA kernels from dreamfusion_tpu_torch/csrc into
   build/torch_kernels (set-up time; one nvcc call, sm_90a).
3. For each kernel, at the shapes of the flagship training step (K1-K4)
   and of the SD 2.1 towers (K10-K12), compares the kernel with its plain
   PyTorch version on the same inputs and times both, and the one PyTorch
   call that computes the same function where there is one (CUDA events,
   median after warm-up).  Each kernel's bound is the larger of its bytes
   (each input read once, each output written once) at 3.35 TB/s and its
   operations at the H100's peak for their type (989 TFLOP/s bf16 tensor
   core, 67 TFLOP/s fp32).
4. Resets the launch counters and trains the flagship-width oracle path
   through dreamfusion_tpu_torch.main for 300 steps; requires a finite
   loss at every logged step, finite gradients, a launch of K1-K4, and an
   analytic-scene PSNR at least 3 dB above the initial one.
5. Resets the counters and trains the SD 2.1 path (full SD 2.1 width,
   random weights from the seed) through dreamfusion_tpu_torch.main for 25
   steps: 6 warm-up steps (render as latent) and 19 through the VAE;
   requires finite losses and gradients, a launch of every kernel and a
   non-zero triplane gradient in both phases; logs s/step and peak memory.
6. Prints one JSON line with every kernel's route, source, the TPU function
   it replaces, launches on the SD path, error, times and bound; the last
   line is the result object.  Any failure exits non-zero and prints no
   result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 300
FLAGSHIP = ["--guidance", "oracle", "--backbone", "triplane",
            "--oracle_scene", "two_sphere", "--lr", "0.01", "--seed", "0",
            "--lambda_3d_normal_smooth", "0"]
SD_STEPS = 25
SD_FLAGS = ["--text", "a hamburger", "--backbone", "triplane", "--seed", "0",
            "--lambda_3d_normal_smooth", "0", "--dataset_size_train", "5"]

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK = {"bf16": 989e12, "fp32": 67e12}    # dense tensor-core bf16, fp32

# kernel → (route, source, the TPU function it replaces)
KERNELS = {
    "triplane_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/triplane.cu",
                     "dreamfusion_tpu/ops/triplane.py:178"),
    "triplane_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/triplane.cu",
                     "dreamfusion_tpu/ops/triplane.py:178"),
    "march_rays": ("cuda", "dreamfusion_tpu_torch/csrc/occupancy.cu",
                   "dreamfusion_tpu/ops/occupancy.py:71"),
    "composite_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/composite.cu",
                      "dreamfusion_tpu/ops/composite.py:39"),
    "composite_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/composite.cu",
                      "dreamfusion_tpu/ops/composite.py:39"),
    "field_head_fwd": ("triton", "dreamfusion_tpu_torch/ops/activation.py",
                       "dreamfusion_tpu/ops/activation.py:9"),
    "field_head_bwd": ("triton", "dreamfusion_tpu_torch/ops/activation.py",
                       "dreamfusion_tpu/ops/activation.py:9"),
    "attention_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
                      "dreamfusion_tpu/ops/attention.py:27"),
    "attention_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
                      "dreamfusion_tpu/ops/attention.py:72"),
    "groupnorm_fwd": ("triton", "dreamfusion_tpu_torch/ops/groupnorm.py",
                      "dreamfusion_tpu/models/unet.py:100"),
    "groupnorm_bwd": ("triton", "dreamfusion_tpu_torch/ops/groupnorm.py",
                      "dreamfusion_tpu/models/unet.py:143"),
    "conv_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                 "dreamfusion_tpu/ops/conv.py:58"),
    "conv_dgrad": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                   "dreamfusion_tpu/ops/conv.py:95"),
}
ORACLE_KERNELS = ("triplane_fwd", "triplane_bwd", "march_rays",
                  "composite_fwd", "composite_bwd", "field_head_fwd",
                  "field_head_bwd")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, flops: float, kind: str):
    """(least ms, "bytes" or "operations") for the card's peaks."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK[kind] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def assert_close(name, got, want, atol, rtol) -> float:
    """Every pair within atol + rtol·|want|; returns the max abs error."""
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        bad = (x - y).abs() > atol + rtol * y.abs()
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} of {y.numel()} values outside "
              f"atol {atol} + rtol {rtol} (max err {max_err([x], [y]):.3e})")
    return max_err(got, want)


def record_kernel(results, name, err, ms, plain_ms, tol, n_bytes, flops,
                  kind, library_ms, where=""):
    """Log one comparison; the first one of a kernel fills its JSON entry
    (the representative shape of the main path)."""
    b_ms, b_by = bound(n_bytes, flops, kind)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"{name}{where}: max_abs_err {err:.3e} (tolerance {tol}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, bound "
        f"{b_ms:.4f} ms ({b_by}; {n_bytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    results.setdefault(name, {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": library_ms})


def kernel_phases(torch, results):
    """Each kernel against its plain version at the flagship step's shapes:
    4096 rays x 24 samples (N = 98,304 field samples), a 3x256²x16 triplane,
    a 128³ occupancy grid, 32 probes."""
    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.core.sampling import (near_far_from_bound,
                                                     stratified_u)
    from dreamfusion_tpu_torch.ops import activation as K4
    from dreamfusion_tpu_torch.ops import composite as K3
    from dreamfusion_tpu_torch.ops import occupancy as K2
    from dreamfusion_tpu_torch.ops import triplane as K1
    from dreamfusion_tpu_torch.training.data import sample_train_batch
    from dreamfusion_tpu_torch.training.trainer import draw_step

    dev = torch.device("cuda")
    cfg = finalize(Config(guidance=("oracle",), backbone="triplane"))
    g = torch.Generator(device=dev).manual_seed(1)
    draws = draw_step(g, cfg, dev)
    batch = sample_train_batch(draws.pose, draws.fov, cfg, cfg.h, cfg.w)
    ro = batch.rays_o.reshape(-1, 3).contiguous()
    rd = batch.rays_d.reshape(-1, 3).contiguous()
    R, S, P, G = ro.shape[0], cfg.grid_fine_steps, cfg.grid_coarse_steps, \
        cfg.grid_size

    def record(name, err, ms, plain_ms, tol, n_bytes, flops):
        # fp32 CUDA-core arithmetic, a few operations per byte
        record_kernel(results, name, err, ms, plain_ms, tol, n_bytes, flops,
                      "fp32", None)

    # ---- K2 march: a sphere-shaped occupancy grid ----------------------
    ax = (torch.arange(G, device=dev) + 0.5) / G * 2 - 1
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((X - 0.2) ** 2 + Y ** 2 + Z ** 2 < 0.25)[None].contiguous()
    near, far = near_far_from_bound(ro, rd, cfg.bound, "cube", cfg.min_near)
    edges = K2.probe_edges(P, device=dev)
    u = stratified_u(torch.rand(R, S, device=dev, generator=g)).contiguous()
    mk = K2.march_cuda(ro, rd, near, far, occ, cfg.bound, edges, u)
    torch.cuda.synchronize()
    mp = K2.march_plain(ro, rd, near, far, occ, cfg.bound, edges, u)
    same = (mk.mask == mp.mask).all(-1)
    check(float(same.float().mean()) >= 0.999,
          f"march_rays: masks differ on {int((~same).sum())} of {R} rays")
    check(bool(mp.mask.any()), "march_rays: no occupied sample")
    err = assert_close("march_rays", [mk.z_vals[same], mk.deltas[same]],
                       [mp.z_vals[same], mp.deltas[same]], 1e-5, 1e-6)
    record("march_rays", err,
           median_ms(lambda: K2.march_cuda(ro, rd, near, far, occ, cfg.bound,
                                           edges, u)),
           median_ms(lambda: K2.march_plain(ro, rd, near, far, occ,
                                            cfg.bound, edges, u)),
           "z, deltas 1e-5 on rays whose masks agree (>= 99.9%)",
           nbytes(ro, rd, near, far, occ, edges, u, *mk),
           R * (P * 20 + S * 30))

    # sample positions of the step, in the encoder's [0, 1] coordinates
    xyz = torch.clamp(ro[:, None] + rd[:, None] * mk.z_vals[..., None],
                      -cfg.bound, cfg.bound).reshape(-1, 3).contiguous()
    N = xyz.shape[0]
    x01 = ((xyz + cfg.bound) / (2 * cfg.bound)).contiguous()

    # ---- K1 triplane, bf16 outputs as in the fp16 step ------------------
    planes = torch.randn(3, cfg.triplane_resolution, cfg.triplane_resolution,
                         cfg.triplane_channels, device=dev, generator=g) * 0.1
    bf = torch.bfloat16
    out_k = K1.triplane_fwd_cuda(x01, planes, True, bf)
    torch.cuda.synchronize()
    out_p = [o.to(bf) for o in K1.triplane_fwd_plain(x01, planes, True)]
    # both round the same fp32 sums to bf16: one bf16 ulp at most
    err = assert_close("triplane_fwd", out_k, out_p, 1e-6, 2 ** -7)
    record("triplane_fwd", err,
           median_ms(lambda: K1.triplane_fwd_cuda(x01, planes, True, bf)),
           median_ms(lambda: K1.triplane_fwd_plain(x01, planes, True)),
           "1 bf16 ulp", nbytes(x01, planes, *out_k),
           N * 3 * 4 * cfg.triplane_channels * 3 * 2)
    D = 3 * cfg.triplane_channels
    cots = [torch.randn(N, D, device=dev, generator=g).to(bf)
            for _ in range(4)]
    dk = K1.triplane_bwd_cuda(x01, planes.shape, cots[0], cots[1:])
    torch.cuda.synchronize()
    dp = K1.triplane_bwd_plain(x01, planes.shape, cots[0], cots[1:])
    scale = float(dp.abs().max())
    err = assert_close("triplane_bwd", [dk], [dp], 1e-5 * scale, 1e-5)
    record("triplane_bwd", err,
           median_ms(lambda: K1.triplane_bwd_cuda(x01, planes.shape, cots[0],
                                                  cots[1:])),
           median_ms(lambda: K1.triplane_bwd_plain(x01, planes.shape,
                                                   cots[0], cots[1:])),
           "1e-5 of max |dplanes| (fp32 atomics in any order)",
           nbytes(x01, *cots, dk), N * 3 * 4 * cfg.triplane_channels * 3 * 2)

    # ---- K4 field head, bf16 MLP output ---------------------------------
    h = (torch.randn(N, 4, device=dev, generator=g) * 2).to(bf)
    bd, br = cfg.blob_density, cfg.blob_radius
    fk = K4.field_head_fwd_triton(h, xyz, bd, br)
    torch.cuda.synchronize()
    fp = K4.field_head_fwd_plain(h, xyz, bd, br)
    err = assert_close("field_head_fwd", fk, fp, 1e-6, 1e-5)
    record("field_head_fwd", err,
           median_ms(lambda: K4.field_head_fwd_triton(h, xyz, bd, br)),
           median_ms(lambda: K4.field_head_fwd_plain(h, xyz, bd, br)),
           "1e-5 rel", nbytes(h, xyz, *fk), N * 20)
    gc = [torch.randn_like(o) for o in fp]
    bk = K4.field_head_bwd_triton(h, xyz, bd, br, *gc)
    torch.cuda.synchronize()
    bp = K4.field_head_bwd_plain(h, xyz, bd, br, *gc)
    # dh0 = g_sigma·e + g_dsig·e' sums two terms up to e^15 that can cancel:
    # hold each value to 1e-5 of the sum of its terms' magnitudes
    mag = K4.field_head_bwd_plain(h, xyz, bd, br, *(c.abs() for c in gc))
    bad = (bk - bp).abs() > 1e-5 * mag + 1e-6
    check(not bool(bad.any()), f"field_head_bwd: {int(bad.sum())} values "
          f"outside 1e-5 of their terms' magnitude")
    err = max_err([bk], [bp])
    record("field_head_bwd", err,
           median_ms(lambda: K4.field_head_bwd_triton(h, xyz, bd, br, *gc)),
           median_ms(lambda: K4.field_head_bwd_plain(h, xyz, bd, br, *gc)),
           "1e-5 of the terms' magnitude", nbytes(h, xyz, *gc, bk), N * 25)

    # ---- K3 composite ----------------------------------------------------
    sigma = fp[0].reshape(R, S).contiguous()
    rgb = fp[1].reshape(R, S, 3).contiguous()
    z, dl, m = mk.z_vals, mk.deltas, mk.mask
    ck = K3._composite_fwd_cuda(sigma, rgb, z, dl, m, 1e-4, False)
    torch.cuda.synchronize()
    cp = K3.composite_fwd_plain(sigma, rgb, z, dl, m, 1e-4, False)
    err = assert_close("composite_fwd", ck, cp, 1e-5, 1e-5)
    record("composite_fwd", err,
           median_ms(lambda: K3._composite_fwd_cuda(sigma, rgb, z, dl, m,
                                                    1e-4, False)),
           median_ms(lambda: K3.composite_fwd_plain(sigma, rgb, z, dl, m,
                                                    1e-4, False)),
           "1e-5", nbytes(sigma, rgb, z, dl, m, *ck), R * S * 20)
    cc = [torch.randn(R, 3, device=dev, generator=g),
          torch.randn(R, device=dev, generator=g),
          torch.randn(R, S, device=dev, generator=g),
          torch.randn(R, device=dev, generator=g)]
    gk = K3._composite_bwd_cuda(sigma, rgb, z, dl, m, cp.weights, *cc, 1e-4,
                                False)
    torch.cuda.synchronize()
    gp = K3.composite_bwd_plain(sigma, rgb, z, dl, m, cp.weights, *cc, 1e-4)
    scale = max(float(x.abs().max()) for x in gp)
    err = assert_close("composite_bwd", gk, gp, 1e-5 * scale, 1e-4)
    record("composite_bwd", err,
           median_ms(lambda: K3._composite_bwd_cuda(sigma, rgb, z, dl, m,
                                                    cp.weights, *cc, 1e-4,
                                                    False)),
           median_ms(lambda: K3.composite_bwd_plain(sigma, rgb, z, dl, m,
                                                    cp.weights, *cc, 1e-4)),
           "1e-4 rel (sums in another order)",
           nbytes(sigma, rgb, z, dl, m, cp.weights, *cc, *gk), R * S * 30)


def sd_kernel_phases(torch, results):
    """K10-K12 against their plain versions at the SD 2.1 towers' shapes
    (bf16 unless stated): the UNet at CFG batch 2 on 64² latents, the VAE
    encoder at 512², forward and backward where the path has one."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input

    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import groupnorm as K11

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    def close(name, got, want, rel, floor):
        """|got - want| <= rel*|want| + floor*max|want| everywhere."""
        scale = float(want.float().abs().max())
        return assert_close(name, [got], [want], floor * scale, rel)

    # ---- K12 conv: forward, then dgrad -----------------------------------
    convs = [  # B, H, W, I, O, stride, padding, dtype, with dgrad
        (1, 512, 512, 128, 128, 1, 1, bf, True),              # VAE level 0
        (1, 512, 512, 128, 128, 2, ((0, 1), (0, 1)), bf, True),  # VAE down
        (2, 64, 64, 320, 320, 1, 1, bf, False),               # UNet level 0
        (2, 64, 64, 320, 320, 2, 1, bf, False),               # UNet down
        (2, 64, 64, 320, 4, 1, 1, torch.float32, False),      # UNet conv_out
    ]
    for B, H, W, I, O, st, pad, dt, dgrad in convs:
        pads = K12.norm_padding(pad)
        where = f" [{B},{H},{W},{I}->{O}] 3x3 s{st} pad {pads} {dt}"
        x = randn(B, H, W, I, dtype=dt)
        w = randn(O, 3, 3, I, scale=(9 * I) ** -0.5, dtype=dt)
        bias = randn(O, dtype=torch.float32)
        yk = K12.conv2d_fwd_cuda(x, w, bias, (st, st), pads, dt)
        torch.cuda.synchronize()
        yp = K12.conv2d_plain(x, w, bias, (st, st), pads, dt)
        fp32 = dt == torch.float32
        # same bf16 products, fp32 sums in another order, one rounding
        err = close("conv_fwd", yk, yp, 1e-5 if fp32 else 2 ** -7, 1e-4)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        lib = None
        if pads[0][0] == pads[0][1]:      # one F.conv2d call: symmetric pad
            lib = median_ms(lambda: F.conv2d(xc, wc, bias.to(dt), st,
                                             pads[0][0]), 10)
        flops = 2 * yk.numel() * 9 * I
        record_kernel(results, "conv_fwd", err, median_ms(
            lambda: K12.conv2d_fwd_cuda(x, w, bias, (st, st), pads, dt), 10),
            median_ms(lambda: K12.conv2d_plain(x, w, bias, (st, st), pads,
                                               dt), 5),
            "1e-5 rel" if fp32 else "1 bf16 ulp + 1e-4 of max",
            nbytes(x, w, bias, yk), flops, "fp32" if fp32 else "bf16", lib,
            where)
        if not dgrad:
            continue
        dy = randn(*yk.shape)
        dk = K12.conv2d_dgrad_cuda(dy, w, x.shape, (st, st), pads, dt)
        torch.cuda.synchronize()
        xr = torch.zeros(x.shape, device=dev, requires_grad=True)
        (dp,) = torch.autograd.grad(K12.conv2d_plain(
            xr, w, None, (st, st), pads, torch.float32), xr, dy.float())
        err = close("conv_dgrad", dk, dp, 2 ** -7, 1e-4)
        dyc = dy.permute(0, 3, 1, 2)
        lib = None
        if pads[0][0] == pads[0][1]:
            lib = median_ms(lambda: conv2d_input(xc.shape, wc, dyc, st,
                                                 pads[0][0]), 10)

        def plain_dgrad():
            xr = torch.zeros(x.shape, device=dev, requires_grad=True)
            torch.autograd.grad(K12.conv2d_plain(
                xr, w, None, (st, st), pads, torch.float32), xr, dy.float())

        record_kernel(results, "conv_dgrad", err, median_ms(
            lambda: K12.conv2d_dgrad_cuda(dy, w, x.shape, (st, st), pads,
                                          dt), 10),
            median_ms(plain_dgrad, 3), "1 bf16 ulp + 1e-4 of max",
            nbytes(dy, w, dk), flops, "bf16", lib, where)

    # ---- K10 attention ---------------------------------------------------
    attns = [  # B, N, M, h, d, with backward
        (2, 4096, 4096, 5, 64, False),    # UNet level-0 self-attention
        (1, 4096, 4096, 1, 512, True),    # VAE mid-block
        (2, 4096, 77, 5, 64, False),      # UNet level-0 cross-attention
    ]
    for B, N, M, h, d, bwd in attns:
        where = f" q [{B},{N},{h},{d}] kv [{B},{M},{h},{d}]"
        q, k, v = randn(B, N, h, d), randn(B, M, h, d), randn(B, M, h, d)
        scale = d ** -0.5
        ok_, lse = K10.attention_fwd_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        op = K10.attention_plain(q, k, v, scale)
        # P rounded to bf16 before (plain) or after (kernel) normalising
        err = close("attention_fwd", ok_, op, 2 ** -7, 1e-2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        10)
        flops = 4 * B * h * N * M * d
        record_kernel(results, "attention_fwd", err, median_ms(
            lambda: K10.attention_fwd_cuda(q, k, v, scale), 10),
            median_ms(lambda: K10.attention_plain(q, k, v, scale), 5),
            "1 bf16 ulp + 1e-2 of max", nbytes(q, k, v, ok_, lse), flops,
            "bf16", lib, where)
        if not bwd:
            continue
        do = randn(B, N, h, d)
        gk = K10.attention_bwd_cuda(q, k, v, ok_, lse, do, scale)
        torch.cuda.synchronize()
        qkv = [t.float().requires_grad_() for t in (q, k, v)]
        gp = torch.autograd.grad(K10.attention_plain(*qkv, scale), qkv,
                                 do.float())
        # P and dS pass through bf16 between the kernel's products
        err = max(close("attention_bwd", a, b, 2 ** -7, 3e-2)
                  for a, b in zip(gk, gp))

        def plain_bwd():
            qkv = [t.float().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(K10.attention_plain(*qkv, scale), qkv,
                                do.float())

        # the library's backward alone: SDPA's graph is built once
        qkvt = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        ot, dot = F.scaled_dot_product_attention(*qkvt), do.transpose(1, 2)
        lib = median_ms(lambda: torch.autograd.grad(ot, qkvt, dot,
                                                    retain_graph=True), 10)
        record_kernel(results, "attention_bwd", err, median_ms(
            lambda: K10.attention_bwd_cuda(q, k, v, ok_, lse, do, scale), 10),
            median_ms(plain_bwd, 3), "1 bf16 ulp + 3e-2 of max",
            nbytes(q, k, v, ok_, lse, do, *gk), 10 * B * h * N * M * d,
            "bf16", lib, where)

    # ---- K11 GroupNorm + SiLU --------------------------------------------
    for B, H, W, C, eps, bwd in [(1, 512, 512, 128, 1e-6, True),
                                 (2, 64, 64, 320, 1e-5, False)]:
        where = f" [{B},{H},{W},{C}] + SiLU"
        G = K11.groups_for(C)
        x = randn(B, H, W, C, scale=3.0)
        wt, bs = randn(C, dtype=torch.float32), randn(C, dtype=torch.float32)
        yk, stats = K11.group_norm_fwd_triton(x, wt, bs, G, eps, True)
        torch.cuda.synchronize()
        yp = K11.group_norm_plain(x, wt, bs, G, eps, True)
        err = close("groupnorm_fwd", yk, yp, 2 ** -7, 1e-3)
        xc = x.permute(0, 3, 1, 2)
        lib = median_ms(lambda: F.silu(F.group_norm(xc, G, wt.to(bf),
                                                    bs.to(bf), eps)), 10)
        record_kernel(results, "groupnorm_fwd", err, median_ms(
            lambda: K11.group_norm_fwd_triton(x, wt, bs, G, eps, True), 10),
            median_ms(lambda: K11.group_norm_plain(x, wt, bs, G, eps, True),
                      5), "1 bf16 ulp + 1e-3 of max", nbytes(x, wt, bs, yk),
            10 * x.numel(), "fp32", lib, where)
        if not bwd:
            continue
        dy = randn(B, H, W, C)
        dk = K11.group_norm_bwd_triton(x, wt, bs, stats, dy, G, True)
        torch.cuda.synchronize()
        x32 = x.float().requires_grad_()
        (dp,) = torch.autograd.grad(K11.group_norm_plain(
            x32, wt, bs, G, eps, True), x32, dy.float())
        err = close("groupnorm_bwd", dk, dp, 2 ** -7, 2e-2)

        def plain_gn_bwd():
            x32 = x.float().requires_grad_()
            torch.autograd.grad(K11.group_norm_plain(x32, wt, bs, G, eps,
                                                     True), x32, dy.float())

        # the library's backward alone: the graph is built once
        xl = xc.detach().requires_grad_()
        yl = F.silu(F.group_norm(xl, G, wt.to(bf), bs.to(bf), eps))
        dyc = dy.permute(0, 3, 1, 2)
        lib = median_ms(lambda: torch.autograd.grad(yl, xl, dyc,
                                                    retain_graph=True), 10)
        record_kernel(results, "groupnorm_bwd", err, median_ms(
            lambda: K11.group_norm_bwd_triton(x, wt, bs, stats, dy, G, True),
            10), median_ms(plain_gn_bwd, 3), "1 bf16 ulp + 2e-2 of max",
            nbytes(x, dy, wt, bs, dk), 20 * x.numel(), "fp32", lib, where)


def run() -> dict:
    try:
        import torch
    except ImportError as e:
        raise SmokeFailure(f"torch is not importable: {e}")
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    try:
        from dreamfusion_tpu_torch import main as port_main
        from dreamfusion_tpu_torch.ops import kernels
    except ImportError as e:
        raise SmokeFailure(f"the port is not next to chip_smoke.py: {e}")

    t0 = time.time()
    kernels.cuda_lib()
    log(f"CUDA kernels built and loaded in {time.time() - t0:.1f} s "
        f"(build/torch_kernels)")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    results = {}
    kernel_phases(torch, results)
    sd_kernel_phases(torch, results)

    # ---- the oracle path (slice 1) ----------------------------------------
    kernels.reset_launch_counts()
    ws = os.path.join(ROOT, "build", "chip_smoke_ws")
    summary = port_main.main(FLAGSHIP + ["--iters", str(STEPS),
                                         "--workspace", ws])
    launches = dict(kernels.LAUNCHES)
    log(f"oracle path: {STEPS} steps, steady {summary['steady_its']:.3f} "
        f"it/s, PSNR {summary['psnr_init']:.3f} -> "
        f"{summary['psnr_final']:.3f} dB, launches {launches}")
    check(summary["all_losses_finite"],
          f"non-finite loss: {summary['losses']}")
    check(summary["grad_ok"], "a step had non-finite gradients")
    for name in ORACLE_KERNELS:
        check(launches[name] > 0, f"the oracle path never launched {name}")
    gain = summary["psnr_final"] - summary["psnr_init"]
    check(gain >= 3.0, f"PSNR rose only {gain:.3f} dB (bar: 3 dB)")

    # ---- the SD 2.1 path (slice 2), full width ------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_sd = time.time()
    sd = port_main.main(SD_FLAGS + ["--iters", str(SD_STEPS), "--workspace",
                                    os.path.join(ROOT, "build",
                                                 "chip_smoke_sd_ws")])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    main_blocks = sd["blocks"][2:]        # steps 11-25: all after warm-up
    s_step = sum(t for _, t in main_blocks) / sum(n for n, _ in main_blocks)
    blocks_ms = [round(1e3 * t / n, 2) for n, t in main_blocks]
    log(f"SD path: {SD_STEPS} steps in {time.time() - t_sd:.1f} s "
        f"(start-up included), losses {sd['losses']}, steady "
        f"{s_step:.4f} s/step over steps 11-{SD_STEPS} (VAE phase; "
        f"ms/step by 5-step block {blocks_ms}), peak "
        f"device memory {peak_gib:.2f} GiB, on {smi_line}, launches "
        f"{launches}")
    check(sd["all_losses_finite"], f"non-finite SD loss: {sd['losses']}")
    check(sd["grad_ok"], "an SD step had non-finite gradients")
    for name, n in launches.items():
        check(n > 0, f"the SD path never launched {name}")
    for latent in (True, False):
        gm = [gr for gr, ph in zip(sd["triplane_grad_max"],
                                   sd["latent_phase"]) if ph == latent]
        phase = "warm-up" if latent else "VAE"
        check(len(gm) > 0 and all(g > 0 for g in gm),
              f"zero triplane gradient in the {phase} phase: {gm}")

    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (route, src, rep) in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    try:
        result = run()
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)
