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
   K7 (rasterize + interpolate, forward and backward) and K8 (marching
   tets and the three mesh regularizers, forward and backward) run at the
   DMTet stage's shapes: tet_grid_size 128 (274,625 grid vertices,
   1,572,864 tets, ~1.9M edge slots, 131,072 triangle slots) and 512²
   renders; K7's forward also at the texture bake's 1024² (after step 4,
   on the mesh it exported).
4. Resets the launch counters and trains the flagship-width oracle path
   (stage 1) through dreamfusion_tpu_torch.main for 300 steps, with one
   eval (validation PNGs at 800²), rolling checkpoints, an 8-frame 800²
   turntable (cut from 100 frames) and the textured mesh export; requires
   a finite loss at every logged step, finite gradients, a launch of
   K1-K4, an analytic-scene PSNR at least 3 dB above the initial one, and
   the PNGs, checkpoint, mesh.obj (> 0 faces) and albedo PNG on disk; logs
   each phase's time.
5. Resets the counters and trains the SD 2.1 path (full SD 2.1 width,
   random weights from the seed) through dreamfusion_tpu_torch.main for 25
   steps: 6 warm-up steps (render as latent) and 19 through the VAE;
   requires finite losses and gradients, a launch of every kernel and a
   non-zero triplane gradient in both phases; logs s/step and peak memory.
6. Resets the counters and trains the DMTet stage from the stage-1
   checkpoint (--dmtet --init_with, oracle guidance, lr 0.002, tet grid
   128, 512² renders) for 100 steps (cut from thousands) with --save_mesh;
   requires finite losses and gradients, a launch of every K7/K8 kernel
   and of K1 and K4, non-zero sdf and deform gradients, a face count in
   (0, max_tris) and a written mesh.obj; logs s/step, peak memory and the
   analytic PSNR of the albedo render at the first and last step.
7. Prints one JSON line with every kernel's route, source, the TPU function
   it replaces, launches on its path (K1-K4 and K10-K12: the SD run; K7
   and K8: the DMTet run), error, times and bound; the last line is the
   result object.  Any failure exits non-zero and prints no result.
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
# the run's end: one eval at step 300, a checkpoint per 100-step epoch, an
# 8-frame turntable at the default 800², the textured mesh
STAGE1_END = ["--eval_interval", "3", "--dataset_size_test", "8",
              "--save_mesh", "--ckpt", "scratch"]
SD_STEPS = 25
SD_FLAGS = ["--text", "a hamburger", "--backbone", "triplane", "--seed", "0",
            "--lambda_3d_normal_smooth", "0", "--dataset_size_train", "5",
            "--eval_interval", "0", "--H", "64", "--W", "64",
            "--dataset_size_test", "2", "--ckpt", "scratch"]
DMTET_STEPS = 100
DMTET_FLAGS = ["--guidance", "oracle", "--backbone", "triplane",
               "--oracle_scene", "two_sphere", "--seed", "0",
               "--lambda_3d_normal_smooth", "0", "--dmtet", "--lr", "0.002",
               "--tet_grid_size", "128", "--dataset_size_test", "8",
               "--save_mesh", "--ckpt", "scratch",
               # 10-step blocks: the rate leaves out the first; one eval
               "--dataset_size_train", "10", "--eval_interval", "10"]

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
for _n, _f in (("raster", "raster.cu"), ("interpolate", "raster.cu")):
    for _d in ("fwd", "bwd"):
        KERNELS[f"{_n}_{_d}"] = ("cuda", f"dreamfusion_tpu_torch/csrc/{_f}",
                                 "dreamfusion_tpu/ops/raster.py:" +
                                 ("44" if _n == "raster" else "205"))
for _n, _line in (("marching_tets", 59), ("vertex_normals", 103),
                  ("laplacian", 122), ("normal_consistency", 142)):
    for _d in ("fwd", "bwd"):
        KERNELS[f"{_n}_{_d}"] = (
            "cuda", "dreamfusion_tpu_torch/csrc/marching_tets.cu",
            f"dreamfusion_tpu/ops/marching_tets.py:{_line}")
ORACLE_KERNELS = ("triplane_fwd", "triplane_bwd", "march_rays",
                  "composite_fwd", "composite_bwd", "field_head_fwd",
                  "field_head_bwd")
DMTET_KERNELS = tuple(k for k in KERNELS if k.split("_")[0] in
                      ("raster", "interpolate", "marching", "vertex",
                       "laplacian", "normal")) + (
    "triplane_fwd", "triplane_bwd", "field_head_fwd", "field_head_bwd")


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
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


def assert_close(name, got, want, atol, rtol) -> float:
    """Every pair within atol + rtol·|want|; returns the max abs error."""
    for x, y in zip(got, want):
        x, y = x.detach().float(), y.detach().float()
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


def _geometry_tet128(torch, dev, g):
    """The DMTet stage's grid at tet_grid_size 128 with a two-sphere sdf
    (the oracle scene's shape) and a small deformation."""
    from dreamfusion_tpu_torch.mesh.tets import CACHE_DIR, load_cached_tet_grid
    grid = load_cached_tet_grid(CACHE_DIR / "cube_64.npz", 64)
    t = lambda a: torch.from_numpy(a).to(dev)
    v = t(grid.vertices)
    d1 = 0.36 - torch.linalg.norm(v - torch.tensor([0.26, 0, 0.08],
                                                   device=dev), dim=-1)
    d2 = 0.24 - torch.linalg.norm(v - torch.tensor([-0.3, 0, -0.14],
                                                   device=dev), dim=-1)
    sdf = torch.clamp(4 * torch.maximum(d1, d2), -1, 1)
    sdf = torch.where(sdf.abs() < 1e-4, 1e-3, sdf)
    pos = v + torch.randn(v.shape, device=dev, generator=g) * 2e-3
    return grid, pos.contiguous(), sdf.contiguous(), t(grid.indices), \
        t(grid.tet_edges), t(grid.unique_edges)


def _raster_ops(ids_listed, T, P):
    """Operations of the tile sweep for this run's data: ~20 fp32 per
    (pixel, listed triangle) plus 4 per (tile, scanned triangle)."""
    counts = ids_listed.sum(1)
    return float(counts.sum()) * P * 20 + ids_listed.shape[0] * T * 4


def record_raster(torch, results, sx, sy, sz, faces, valid, H, W, cap, soft,
                  where, backward):
    """K7 rasterize (and interpolate of the positions) against the plain
    version; forward, and backward when asked."""
    from dreamfusion_tpu_torch.ops import raster as K7
    dev = sx.device
    g = torch.Generator(device=dev).manual_seed(3)
    ins_k = [x.clone().requires_grad_(backward) for x in (sx, sy, sz)]
    ins_p = [x.clone().requires_grad_(backward) for x in (sx, sy, sz)]
    ok = K7.raster_cuda(*ins_k, faces, valid, H, W, 32, cap, soft)
    torch.cuda.synchronize()
    op = K7.raster_plain(*ins_p, faces, valid, H, W, 32, cap, soft)
    same = ok.tri_id == op.tri_id
    frac = float(same.float().mean())
    check(frac >= 0.9999, f"raster_fwd{where}: tri_id differs on "
          f"{int((~same).sum())} of {same.numel()} pixels")
    hit = same & (op.tri_id >= 0)
    check(float(hit.float().mean()) > 0.01, f"raster_fwd{where}: no hit")
    err = assert_close("raster_fwd", [ok.bary[hit], ok.depth[same],
                                      ok.alpha[same]],
                       [op.bary[hit], op.depth[same], op.alpha[same]],
                       1e-5, 1e-5)
    T = faces.shape[0]
    with torch.no_grad():
        _, _, _, _, bmin, bmax = K7._face_coeffs(sx, sy, sz, faces.long())
        _, listed = K7.tile_lists(bmin, bmax, valid, H, W, 32, cap, soft)
    P = 32 * 32
    det = [x.detach() for x in (sx, sy, sz)]
    outs = nbytes(*ok) + nbytes(ok.tri_id)        # + the margin winner ids
    record_kernel(results, "raster_fwd", err, median_ms(
        lambda: K7.raster_cuda(*det, faces, valid, H, W, 32, cap, soft)),
        median_ms(lambda: K7.raster_plain(*det, faces, valid, H, W, 32, cap,
                                          soft), 5, 1),
        "tri_id on >= 99.99% of pixels; bary, depth, alpha 1e-5",
        nbytes(sx, sy, sz, faces, valid) + outs,
        _raster_ops(listed, T, P), "fp32", None,
        f" [{H}x{W}, {T} faces, cap {cap}, soft {soft}]")
    log(f"raster{where}: {float((op.tri_id >= 0).float().mean()):.3f} of "
        f"pixels covered, {float(listed.sum(1).float().mean()):.1f} "
        f"triangles listed per tile (max {int(listed.sum(1).max())})")

    # interpolate the surface positions through the kernel's bary
    V = sx.shape[0]
    attrs = torch.randn(V, 3, device=dev, generator=g)
    bk = ok.bary.detach().contiguous()
    ik = K7.interpolate(attrs, ok._replace(bary=bk), faces)
    torch.cuda.synchronize()
    ip = K7.interpolate_plain(attrs, bk, ok.tri_id, faces)
    err = assert_close("interpolate_fwd", [ik], [ip], 1e-6, 1e-5)
    Pn = H * W
    record_kernel(results, "interpolate_fwd", err, median_ms(
        lambda: K7.interpolate(attrs, ok._replace(bary=bk), faces)),
        median_ms(lambda: K7.interpolate_plain(attrs, bk, ok.tri_id, faces)),
        "1e-5 rel", nbytes(attrs, bk, ok.tri_id, faces, ik), Pn * 3 * 6,
        "fp32", None, where)
    if not backward:
        return
    cots = [torch.randn(o.shape, device=dev, generator=g)
            for o in (ok.bary, ok.depth, ok.alpha)]

    def loss(o):
        return sum((x * c).sum() for x, c in zip((o.bary, o.depth, o.alpha),
                                                  cots))
    gk = torch.autograd.grad(loss(ok), ins_k, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(loss(op), ins_p, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    # fp32 atomics in any order; pixels whose winner differs are excluded
    # above only for the forward, so hold the sums to 1e-4 of the largest
    err = assert_close("raster_bwd", gk, gp, 1e-4 * scale, 1e-4)
    saved = [ok.tri_id, ok.alpha]
    hits = float((ok.tri_id >= 0).sum())
    record_kernel(results, "raster_bwd", err, median_ms(
        lambda: torch.autograd.grad(loss(ok), ins_k, retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(loss(op), ins_p,
                                              retain_graph=True), 5, 1),
        "1e-4 of max |grad| + 1e-4 rel (atomics)",
        nbytes(sx, sy, sz, faces, *saved, ok.tri_id, *cots, *gk),
        hits * 100 + Pn * 120, "fp32", None, where)
    a1 = attrs.clone().requires_grad_()
    b1 = bk.clone().requires_grad_()
    a2 = attrs.clone().requires_grad_()
    b2 = bk.clone().requires_grad_()
    yk = K7.interpolate(a1, ok._replace(bary=b1), faces)
    yp = K7.interpolate_plain(a2, b2, ok.tri_id, faces)
    c = torch.randn(yk.shape, device=dev, generator=g)
    gk = torch.autograd.grad(yk, [a1, b1], c, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(yp, [a2, b2], c, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    err = assert_close("interpolate_bwd", gk, gp, 1e-5 * scale, 1e-5)
    record_kernel(results, "interpolate_bwd", err, median_ms(
        lambda: torch.autograd.grad(yk, [a1, b1], c, retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(yp, [a2, b2], c,
                                              retain_graph=True)),
        "1e-5 of max + 1e-5 rel (atomics)",
        nbytes(attrs, bk, ok.tri_id, faces, c, *gk), Pn * 3 * 8, "fp32",
        None, where)


def dmtet_kernel_phases(torch, results):
    """K8 and K7 against their plain versions at the DMTet stage's shapes:
    tet_grid_size 128, max_tris 131,072, a 512² view of the surface."""
    from dreamfusion_tpu_torch.config import Config, apply_dmtet, finalize
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    from dreamfusion_tpu_torch.ops.raster import project_verts, screen_coords
    from dreamfusion_tpu_torch.training.data import circle_view_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    grid, pos, sdf, tets, te, ue = _geometry_tet128(torch, dev, g)
    max_tris = 8 * 128 ** 2
    V, F, E = pos.shape[0], tets.shape[0], ue.shape[0]
    where = f" [V {V}, F {F}, E {E}, max_tris {max_tris}]"

    # ---- marching tets --------------------------------------------------
    p1, s1 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    p2, s2 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    mk = K8.marching_tets(p1, s1, tets, te, ue, max_tris)
    torch.cuda.synchronize()
    mp = K8.marching_tets_plain(p2, s2, tets, te, ue, max_tris)
    check(bool(torch.equal(mk.faces, mp.faces)) and
          bool(torch.equal(mk.face_mask, mp.face_mask)),
          "marching_tets_fwd: faces or mask differ from the plain version")
    n_faces = int(mk.face_mask.sum())
    check(0 < n_faces < max_tris, f"marching_tets_fwd: {n_faces} faces")
    err = assert_close("marching_tets_fwd", [mk.verts], [mp.verts], 1e-6, 0)
    mt_bytes = nbytes(pos, sdf, tets, te, ue, mk.verts, mk.vert_valid,
                      mk.faces, mk.face_mask)
    record_kernel(results, "marching_tets_fwd", err, median_ms(
        lambda: K8.marching_tets(pos, sdf, tets, te, ue, max_tris)),
        median_ms(lambda: K8.marching_tets_plain(pos, sdf, tets, te, ue,
                                                 max_tris), 5),
        "faces and mask equal, verts 1e-6", mt_bytes, E * 12 + F * 12,
        "fp32", None, f"{where}, {n_faces} faces")
    c = torch.randn(mk.verts.shape, device=dev, generator=g)
    gk = torch.autograd.grad(mk.verts, [p1, s1], c, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(mp.verts, [p2, s2], c, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    err = assert_close("marching_tets_bwd", gk, gp, 1e-5 * scale, 1e-5)
    record_kernel(results, "marching_tets_bwd", err, median_ms(
        lambda: torch.autograd.grad(mk.verts, [p1, s1], c,
                                    retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(mp.verts, [p2, s2], c,
                                              retain_graph=True), 5),
        "1e-5 of max + 1e-5 rel (atomics)", nbytes(pos, sdf, ue, c, *gk),
        E * 20, "fp32", None, where)

    # ---- the three regularizers on that surface ---------------------------
    mesh = K8.TetMesh(mk.verts.detach(), mk.vert_valid, mk.faces,
                      mk.face_mask)
    T = max_tris
    cn = torch.randn(mesh.verts.shape, device=dev, generator=g)
    regs = {
        "vertex_normals": (lambda m: K8.vertex_normals(m),
                           lambda m: K8.vertex_normals_plain(
                               m.verts, m.faces, m.face_mask),
                           T * 30 + E * 10, T * 40 + E * 15),
        "laplacian": (K8.laplacian_smooth_loss,
                      lambda m: K8.laplacian_plain(m.verts, m.faces,
                                                   m.face_mask),
                      T * 30 + E * 12, T * 20 + E * 15),
        "normal_consistency": (K8.normal_consistency_loss,
                               lambda m: K8.normal_consistency_plain(
                                   m.verts, m.faces, m.face_mask),
                               T * 60, T * 70),
    }
    for name, (kern, plain, fops, bops) in regs.items():
        v1 = mesh.verts.clone().requires_grad_()
        v2 = mesh.verts.clone().requires_grad_()
        yk = kern(mesh._replace(verts=v1))
        torch.cuda.synchronize()
        yp = plain(mesh._replace(verts=v2))
        out_bytes = nbytes(yk)
        err = assert_close(f"{name}_fwd", [yk], [yp],
                           1e-5 * float(yp.abs().max()), 1e-5)
        record_kernel(results, f"{name}_fwd", err, median_ms(
            lambda: kern(mesh)), median_ms(lambda: plain(mesh), 5),
            "1e-5 rel", nbytes(mesh.verts, mesh.faces, mesh.face_mask) +
            out_bytes, fops, "fp32", None, f"{where}, {n_faces} faces")
        cot = cn if name == "vertex_normals" else torch.ones((), device=dev)
        gk = torch.autograd.grad(yk, v1, cot, retain_graph=True)
        torch.cuda.synchronize()
        gp = torch.autograd.grad(yp, v2, cot, retain_graph=True)
        scale = float(gp[0].abs().max())
        check(scale > 0, f"{name}_bwd: zero gradient")
        err = assert_close(f"{name}_bwd", gk, gp, 1e-4 * scale, 1e-4)
        record_kernel(results, f"{name}_bwd", err, median_ms(
            lambda: torch.autograd.grad(yk, v1, cot, retain_graph=True)),
            median_ms(lambda: torch.autograd.grad(yp, v2, cot,
                                                  retain_graph=True), 5),
            "1e-4 of max + 1e-4 rel (atomics)",
            nbytes(mesh.verts, mesh.faces, mesh.face_mask, *gk) +
            (nbytes(cn) if name == "vertex_normals" else 0), bops, "fp32",
            None, where)

    # ---- K7 at the DMTet view: 512², cap 512, soft edge 1 ------------------
    cfg = finalize(apply_dmtet(Config(guidance=("oracle",),
                                      backbone="triplane")))
    b = circle_view_batch(cfg, 1, 4, cfg.h, cfg.w, dev)
    clip = project_verts(mesh.verts, b.mvp[0])
    sx, sy, sz, valid = screen_coords(clip, mesh.faces, mesh.face_mask,
                                      cfg.h, cfg.w)
    record_raster(torch, results, sx.contiguous(), sy.contiguous(),
                  sz.contiguous(), mesh.faces, valid, cfg.h, cfg.w, 512, 1.0,
                  " (DMTet view)", True)


def bake_kernel_phase(torch, results, obj_path):
    """K7 forward at the texture bake's shape: the UV atlas of the mesh the
    oracle run exported, 1024², soft edge 0, cap min(1024, T)."""
    from dreamfusion_tpu_torch.mesh.export import read_obj
    from dreamfusion_tpu_torch.ops.raster import screen_coords
    dev = torch.device("cuda")
    _, tris, uv, _ = read_obj(obj_path)
    u = torch.from_numpy(uv).to(dev)
    clip = torch.stack([u[:, 0] * 2 - 1, -(u[:, 1] * 2 - 1),
                        torch.zeros_like(u[:, 0]),
                        torch.ones_like(u[:, 0])], -1)
    faces = torch.from_numpy(tris).to(dev)
    T = faces.shape[0]
    sx, sy, sz, valid = screen_coords(
        clip, faces, torch.ones(T, dtype=torch.bool, device=dev), 1024, 1024)
    record_raster(torch, results, sx.contiguous(), sy.contiguous(),
                  sz.contiguous(), faces, valid, 1024, 1024, min(1024, T),
                  0.0, " (texture bake)", False)


def _rounded(d) -> dict:
    return {k: round(v, 3) for k, v in d.items()}


def _check_outputs(ws, summary, what) -> None:
    """Validation PNGs, the turntable (mp4 or PNG frames) and a mesh.obj
    with faces and its albedo PNG."""
    from dreamfusion_tpu_torch.mesh.export import read_obj
    val = os.listdir(os.path.join(ws, "validation"))
    res = os.listdir(os.path.join(ws, "results"))
    check(any(n.endswith("_rgb.png") for n in val),
          f"{what}: no validation PNG in {ws}")
    check("df_rgb.mp4" in res or "df_rgb_0000.png" in res,
          f"{what}: no turntable in {res}")
    path = summary.get("mesh_path") or ""
    check(path.endswith("mesh.obj") and os.path.exists(path),
          f"{what}: no mesh.obj written ({path!r})")
    _, tris, uv, tex = read_obj(path)
    check(len(tris) > 0 and uv is not None and tex is not None and
          os.path.exists(tex), f"{what}: mesh.obj without faces or texture")
    log(f"{what}: {path} with {len(tris)} faces and {os.path.basename(tex)}")


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
    from dreamfusion_tpu_torch.native import meshops
    t0 = time.time()
    meshops.build()
    log(f"host mesh library built with g++ in {time.time() - t0:.1f} s "
        f"(build/meshops)")

    results = {}
    kernel_phases(torch, results)
    sd_kernel_phases(torch, results)
    t_k = time.time()
    dmtet_kernel_phases(torch, results)
    log(f"K7/K8 phases in {time.time() - t_k:.1f} s")

    # ---- the oracle path, stage 1 with the run's end (slices 1, 3) --------
    kernels.reset_launch_counts()
    ws = os.path.join(ROOT, "build", "chip_smoke_ws")
    summary = port_main.main(FLAGSHIP + STAGE1_END + [
        "--iters", str(STEPS), "--workspace", ws])
    launches = dict(kernels.LAUNCHES)
    log(f"oracle path: {STEPS} steps, steady {summary['steady_its']:.3f} "
        f"it/s, PSNR {summary['psnr_init']:.3f} -> "
        f"{summary['psnr_final']:.3f} dB, launches {launches}")
    log(f"oracle run's end (s): {_rounded(summary['phases'])}; export "
        f"phases (s): {_rounded(summary['export_phases'])}; on {smi_line}")
    check(summary["all_losses_finite"],
          f"non-finite loss: {summary['losses']}")
    check(summary["grad_ok"], "a step had non-finite gradients")
    for name in ORACLE_KERNELS:
        check(launches[name] > 0, f"the oracle path never launched {name}")
    gain = summary["psnr_final"] - summary["psnr_init"]
    check(gain >= 3.0, f"PSNR rose only {gain:.3f} dB (bar: 3 dB)")
    _check_outputs(ws, summary, "oracle")
    ckpts = os.listdir(os.path.join(ws, "checkpoints"))
    check("df_ep0003.pth" in ckpts and "df.pth" in ckpts,
          f"stage-1 checkpoints missing: {sorted(ckpts)}")
    bake_kernel_phase(torch, results, summary["mesh_path"])

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
    sd_launches = launches
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
    for name in ORACLE_KERNELS + ("attention_fwd", "attention_bwd",
                                  "groupnorm_fwd", "groupnorm_bwd",
                                  "conv_fwd", "conv_dgrad"):
        check(launches[name] > 0, f"the SD path never launched {name}")
    for latent in (True, False):
        gm = [gr for gr, ph in zip(sd["triplane_grad_max"],
                                   sd["latent_phase"]) if ph == latent]
        phase = "warm-up" if latent else "VAE"
        check(len(gm) > 0 and all(g > 0 for g in gm),
              f"zero triplane gradient in the {phase} phase: {gm}")

    # ---- the DMTet stage from the stage-1 checkpoint (slice 3) --------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_dm = time.time()
    ws2 = os.path.join(ROOT, "build", "chip_smoke_dmtet_ws")
    dm = port_main.main(DMTET_FLAGS + [
        "--iters", str(DMTET_STEPS), "--workspace", ws2, "--init_with",
        os.path.join(ws, "checkpoints")])
    torch.cuda.synchronize()
    dm_launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = dm["blocks"][1:]
    s_step = sum(t for _, t in steady) / sum(n for n, _ in steady)
    log(f"DMTet path: {DMTET_STEPS} steps in {time.time() - t_dm:.1f} s "
        f"(start-up and run's end included), losses {dm['losses']}, "
        f"{s_step:.4f} s/step over steps 11-{DMTET_STEPS} (ms/step by "
        f"block {[round(1e3 * t / n, 2) for n, t in dm['blocks']]}), peak "
        f"device memory {peak_gib:.2f} GiB, "
        f"faces {dm['n_faces'][0]} -> {dm['n_faces'][-1]} of "
        f"{dm['max_tris']}, albedo PSNR {dm['psnr_init']:.3f} -> "
        f"{dm['psnr_final']:.3f} dB, run's end (s) "
        f"{_rounded(dm['phases'])}, export (s) "
        f"{_rounded(dm['export_phases'])}, on {smi_line}, launches "
        f"{dm_launches}")
    check(dm["all_losses_finite"], f"non-finite DMTet loss: {dm['losses']}")
    check(dm["grad_ok"], "a DMTet step had non-finite gradients")
    for name in DMTET_KERNELS:
        check(dm_launches[name] > 0, f"the DMTet path never launched {name}")
    for gname in ("sdf", "deform"):
        gm = dm[f"{gname}_grad_max"]
        check(all(g > 0 for g in gm), f"zero {gname} gradient: {gm}")
    check(all(0 < n < dm["max_tris"] for n in dm["n_faces"]),
          f"face counts outside (0, max_tris): {dm['n_faces']}")
    _check_outputs(ws2, dm, "DMTet")

    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": (dm_launches if name in DMTET_KERNELS and
                      name not in ORACLE_KERNELS else sd_launches)[name],
         **results[name]}
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
