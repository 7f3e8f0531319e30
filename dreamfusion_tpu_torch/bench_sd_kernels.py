"""K10's and K12's forwards, K12's dgrad, K10's backward and K11 (forward,
and the VAE's backward) at the SD 2.1 (or SD 1.5) step's shapes, on one
GPU.

    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --tag change \\
        --outputs change.pt
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only attn \\
        --sd_version 1.5
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only dgrad
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only gn
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only gn_routes
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only field
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only dmtet \
        --bake_mesh ws/mesh/mesh.obj
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only render
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only sdf \
        --sdf_mesh ws/mesh/mesh.obj
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only dpt
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only dpt_splits
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only dpt_dgrad
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . --only wgrad
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only dpt_wgrad
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only attn_bwd
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only attn_bwd_splits
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root . \
        --only tower_bwd
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --root <parent> \\
        --tag parent --outputs parent.pt
    python3 dreamfusion_tpu_torch/bench_sd_kernels.py --compare parent.pt \\
        change.pt

The shapes are ``chip_smoke.py``'s ``SD_CONVS``, ``SD_ATTNS`` and
``SD_GROUPNORMS`` (the
``chip_smoke.py`` beside this package, whatever ``--root`` is), so that one
list serves the check and the timing; ``--sd_version 1.5`` takes SD 1.5's
attention rows (d = 40, 80, 160, and the VAE's d = 512) in place of SD
2.1's (d = 64 and 512), its convs and norms being SD 2.1's.  Each K10
forward rounds q·scale first where JAX's dispatch takes its chunked
branch (``ops/attention.py::chunked_branch``, in a checkout that has it).
For the port found under ``--root`` (so that two checkouts can be
compared with one script) it times, per
shape: the wrapper's time (``ms``: ``chip_smoke.median_ms``, CUDA events,
which include the host's enqueue gap where that is longer than the
kernel), the kernels' own device time (``kernel_ms``: the sum of the
profiler's kernel durations over 10 calls, per call), its host time per
call (one call on the host clock with the card idle before it, as a
host-bound step pays it: Python, the tensor maps and the launch; timed
before the profiler runs, over 200 calls: ``host_us_min``, the least,
which other processes on the host's cores can only raise, and
``host_us``, the median; the library call's as ``library_host_us_min``
and ``library_host_us``), the device time of one call in a CUDA graph
(``graph_ms``: 20 calls captured in one graph, the graph replayed between
two CUDA events, the median of 10 replays per call; no host in the window
and no profiler records to drop, the few µs between a graph's kernels
included), and, timed all three ways, the one PyTorch call
that computes the same function (``F.conv2d`` with TF32 off for fp32, as
the kernel's fp32 FMAs; ``scaled_dot_product_attention``; ``F.group_norm``
and ``F.silu`` on the NCHW view of the same tensor; null for the VAE's
asymmetric padding; the backwards of SDPA and of ``F.group_norm`` +
``F.silu`` are autograd calls on a graph built once, timed by events and
the profiler, with no graph ms).  K10's backward row is the VAE
mid-block's (``SD_ATTNS``' row with the backward flag), under ``--only
attn``; K11's rows take the wrappers of whichever checkout ``--root``
names (the parent's Triton ones or the CUDA ones); ``--only gn_routes``
times K11 through every route it could take (``sweep_gn_routes``).  The
rows of ``SD_CONVS`` whose dgrad ``chip_smoke.py`` checks are timed again
as dgrads (the route ``conv2d_dgrad_cuda`` takes: the wgmma route's
packed weight comes from its cache, as on the path; the mma.sync route's
transpose is included) beside cuDNN's input gradient alone
(``aten.convolution_backward`` with output mask (True, False, False) on
channels-last views of the same tensors: no layout copy of ours in the
timed window); their and K10's backward's ``kernel_names`` split the
kernel time by kernel.  It prints one JSON line per shape with the launch
counters the wrapper moved (its route) and the card's name and power
limit, after a line with the SHA-256 of the port's ``csrc/`` and ``ops/``
under ``--root`` (which sources were timed).  Compare two checkouts within
one call, in turns (parent, change, change, parent).  With ``--outputs
FILE`` it also saves every forward's output (the inputs come from one
seed, so two checkouts see the same ones); ``--compare A B`` prints, per
shape, whether two such files agree bit for bit.

``--only field`` times the field encoders, K1 (triplane, 3x256²x16) and K6
(hash grid, the flagship L4C8 table), at the shapes of the flagship step
(the 98,304 sample positions of ``chip_smoke.flagship_march``: forward
with the jacobian and the table-only backward from four bf16 cotangents)
and of the DMTet albedo query (the 262,144 positions of
``chip_smoke.dmtet_query`` on the DMTet view of ``chip_smoke``'s tet-grid
128 surface, bf16 cotangents zero on the missed pixels: the forward, and
the backward that gives the table's and the positions' gradients, by
whatever route the checkout has: ``triplane_bwd_dx_cuda`` /
``hash_bwd_dx_cuda``, or the table-only backward plus ``_x_grad``'s
jacobian forward and reductions).  K1's rows have ``F.grid_sample``
(bilinear, align_corners=True, the planes as a batch of three) and
``aten.grid_sampler_2d_backward`` beside them; K6's none.  Each row's
``kernel_names`` splits its device time by kernel, and ``--outputs`` keeps
every output of a row (features and jacobians; the table's and the
positions' gradients).

``--only dmtet`` times every K7 and K8 entry point, forward and backward,
at the DMTet stage's shapes (``dmtet_cases``: tet grid 128, max_tris
131,072, the 512² view, cap 512, soft edge 1; ``--bake_mesh`` adds K7's
forward at the bake's 1024²); each backward is its op's autograd backward
called directly (``backward_call``), so a parent checkout is timed by the
same calls.
``--outputs`` keeps every tensor a row returns (forwards: ``--compare``
bit for bit; backwards: within fp32 reduction order).

``--only render`` times K2's march, K3 (composite) and K4 (the field head)
at the flagship stage-1 step's shapes and at an 800² eval render in one
call (``render_cases``): K3 and K4 alone, and each forward and backward
together with the torch epilogue that the fused kernels took in (the
normals and the shading select; the background and the orient loss), and
K2's whole march region (near/far, probe edges, draws, bool mask and
clamped positions: ``march_region_call``), each timed as one region; a
parent checkout's regions are its own kernel plus those torch ops, as its
field and renderer ran them.  The backward regions run through autograd (events and the
profiler, no graph ms).

``--only dpt`` times the DPT that ``preprocess_image`` runs
(``dpt_cases``): K12 at each of the 17 distinct fp32 conv shapes of a 384²
forward (``chip_smoke.dpt_calls``; ``per_forward`` counts its convs) beside
``F.conv2d`` with TF32 off, the TF-SAME pad applied to its input once,
outside the timing (padding 0 then), and K10's fp32 forward at the ViT's
[1, 577, 12, 64] beside ``scaled_dot_product_attention`` in fp32 (TF32
off); the rows of 5 GFLOP and more are timed over fewer calls (cuDNN's
fp32 algorithm takes ~0.2 s at the 192² conv); a last line sums the 40
convs' graph ms, the kernels' and cuDNN's.

``--only dpt_dgrad`` times K12's input gradient (``conv2d_dgrad_cuda``:
the route the checkout takes, the parent's one-thread-per-value loop or
the tiled one) at each of the 17 distinct fp32 conv shapes of a 384²
backward (``dpt_dgrad_cases``: the forward's 40 convs, the stem's
3-channel dx included) beside cuDNN's input gradient alone
(``aten.convolution_backward``, input mask, TF32 off, on an input of the
TF-SAME padded shape); a last line sums the 40 dgrads' graph ms.

``--only wgrad`` times K12's weight gradient (``conv2d_wgrad_cuda``: the
route the checkout takes) at each distinct conv shape of the four towers'
backward (``wgrad_cases``: the SD 2.1, SD 1.5 and zero123 UNets at CFG
batch 2 and the SD VAE encoder at 512², recorded from the towers' own
forwards on the meta device by ``chip_smoke.tower_forward``; bf16, the
fp32 conv_outs too) beside cuDNN's weight gradient alone
(``aten.convolution_backward``, weight mask, TF32 off, on an input padded
outside the timing where the pads are asymmetric); a last line a tower
sums its convs' graph ms, the kernels' and cuDNN's.  ``--only dpt_wgrad``
does the same at the 17 distinct fp32 conv shapes of a 384² DPT backward
(``dpt_wgrad_cases``), summed over the 40.

``--only attn_bwd`` times K10's backward (``attention_bwd_cuda``: the
route the checkout takes) at each distinct attention shape of d = 40, 64,
80 and 160 in the four towers' backward (``attn_bwd_cases``, recorded as
``--only wgrad``'s; on JAX's branch) and at the DPT's fp32 [1, 577, 12,
64], beside SDPA's backward as one library call: its autograd node (the
flash or memory-efficient kernel PyTorch picks), called directly so that
a CUDA graph captures it (``chip_smoke.sdpa_backward``), with graph ms on
both sides; a last line a tower sums its attentions' graph ms, the
kernels' and SDPA's.  ``--only tower_bwd`` runs each of the four towers
(``chip_smoke.GRAD_TOWERS``) at full width on random weights with every
parameter and the input wanting gradients: one forward and backward
(``chip_smoke.tower_grad_run``, its launches not checked), the
synchronised walls (median of 3) and the peak memory, a JSON line each.

``--only attn_bwd_splits`` times K10's flash backward at the same bf16
shapes at every split of its dK/dV pass, 1 to 16 (``sweep_flash_splits``):
graph ms, the split ``flash_bwd_splits`` chooses and the fastest, both
summed a tower.

``--only wgrad_splits`` times the weight gradient's wgmma route (the
towers' bf16 shapes) and tiled fp32 route (the DPT's and the conv_outs'
shapes) alone at splits of 1 to 64 (``sweep_wgrad_splits``): graph ms,
the split ``wgmma_wgrad_splits`` or ``fp32_wgrad_tiling`` chooses and the
fastest, both summed over the towers' and the DPT's calls.

``--only dpt_splits`` times the tiled fp32 route alone at each of those
17 shapes for every N tile (32, 64) and split (1-32) it takes
(``sweep_fp32_tiles``): graph ms, the pair ``fp32_tiling`` chooses and
the fastest, and both summed over a forward's 40 convs: how far the rule
falls behind the best split at each shape on this card.

``--only sdf`` times K9 at the DMTet mesh init's shape (``sdf_cases``:
the 274,625 tet-grid-128 points against ``--sdf_mesh`` or a UV sphere of
50,000 triangles), the default route of any checkout and the culled
kernel with its culling off; ``--outputs`` keeps sd and the winding
number.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """chip_smoke.py of this checkout, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sources_sha256(root: str) -> str:
    """SHA-256 over the relative paths and bytes of the port's csrc/ and
    ops/ files under `root` (caches left out)."""
    h = hashlib.sha256()
    for sub in ("csrc", "ops"):
        top = os.path.join(root, "dreamfusion_tpu_torch", sub)
        for dirpath, dirnames, files in sorted(os.walk(top)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".pyc"):
                    continue
                path = os.path.join(dirpath, f)
                h.update(os.path.relpath(path, root).encode() + b"\0")
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def compare(a_path: str, b_path: str) -> None:
    """One JSON line per shape saved in both files: bit-for-bit equal or
    not, and the largest difference."""
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    for key in a:
        if key not in b:
            continue
        x, y = a[key], b[key]
        same = x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        diff = (float((x.float() - y.float()).abs().max())
                if x.shape == y.shape else None)
        print(json.dumps({"compare": [a_path, b_path], "row": key,
                          "bitwise_equal": same, "max_abs_diff": diff}),
              flush=True)


def sweep_gn_routes(smoke, K11, kernels, graph_ms, dev, g, tag, card):
    """K11 at every shape of ``SD_GROUPNORMS`` (+ SiLU), forward and, for
    the VAE's, backward, through every route the kernels take: streaming,
    and resident at slabs of 1, 2 and 4 times the fewest groups, each
    cluster of 1-16 CTAs that holds the slab in ``SLAB_BUDGET`` bytes a CTA,
    128, 256 and 512 threads.  One JSON line per shape and direction: each
    route's graph ms (or the error it raised) and the route
    ``group_norm_route`` chooses.  The rule's constants were set from
    this sweep."""
    import torch
    sms = kernels.sm_count(dev)
    for B, H, W, C in dict.fromkeys(r[:4] for r in smoke.SD_GROUPNORMS):
        bwd = any(r[:4] == (B, H, W, C) and r[7] for r in smoke.SD_GROUPNORMS)
        G, HW = K11.groups_for(C), H * W
        Cg = C // G
        x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3).to(
            torch.bfloat16)
        dy = torch.randn(B, H, W, C, device=dev, generator=g).to(x.dtype)
        wt, bs = (torch.randn(C, device=dev, generator=g).to(x.dtype)
                  for _ in range(2))
        _, stats = K11.group_norm_fwd_cuda(x, wt, bs, G, 1e-6, True)
        s0 = K11.min_slab_groups(Cg, 2)
        for back in ((False, True) if bwd else (False,)):
            way = "bwd" if back else "fwd"
            routes = [K11.GNRoute(f"groupnorm_{way}_stream", C, 0, 512)]
            for s in (s0, 2 * s0, 4 * s0):
                V = s * Cg * 2 // 16
                for n in (1, 2, 4, 8, 16):
                    foot = -(-HW // n) * s * Cg * 2 * (2 if back else 1)
                    if G % s or n > HW or foot > K11.SLAB_BUDGET:
                        continue
                    routes += [K11.GNRoute(f"groupnorm_{way}_resident",
                                           s * Cg, n, t)
                               for t in (128, 256, 512) if t >= V]
            times = []
            for r in routes:
                fn = (functools.partial(K11.group_norm_bwd_cuda, x, wt, bs,
                                        stats, dy, G, True, route=r)
                      if back else
                      functools.partial(K11.group_norm_fwd_cuda, x, wt, bs,
                                        G, 1e-6, True, route=r))
                try:
                    times.append([*r, graph_ms(fn)])
                except (RuntimeError, ValueError) as e:
                    times.append([*r, str(e)[:80]])
            chosen = K11.group_norm_route((B, H, W, C), x.dtype, back, G, sms)
            print(json.dumps({"tag": tag, "shape": [B, H, W, C],
                              "backward": back, "chosen": list(chosen),
                              "routes": times, "card": card}), flush=True)


def field_cases(smoke, dev):
    """(row, the checkout's call, the library's call or None) for K1 and K6
    at the flagship step's and the DMTet albedo query's shapes (see the
    module docstring); inputs from fixed seeds, so every checkout sees the
    same ones."""
    import torch

    from dreamfusion_tpu_torch.config import Config, apply_dmtet, finalize
    from dreamfusion_tpu_torch.ops import hashgrid as K6
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    from dreamfusion_tpu_torch.ops import triplane as K1
    from dreamfusion_tpu_torch.training.data import circle_view_batch
    from dreamfusion_tpu_torch.training.trainer import grid_spec_of

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    x1 = smoke.flagship_march(torch)["x01"]
    _, pos, sdf, tets, te, ue = smoke._geometry_tet128(
        torch, dev, torch.Generator(device=dev).manual_seed(4))
    mk = K8.marching_tets(pos, sdf, tets, te, ue, 8 * 128 ** 2)
    mesh = K8.TetMesh(mk.verts.detach(), mk.vert_valid, mk.faces,
                      mk.face_mask)
    cfg = finalize(apply_dmtet(Config(guidance=("oracle",),
                                      backbone="triplane")))
    view = circle_view_batch(cfg, 1, 4, cfg.h, cfg.w, dev)
    xq, covered = smoke.dmtet_query(torch, mesh, view.mvp[0], cfg.h, cfg.w,
                                    cfg.bound)
    keep = covered[:, None].float()
    print(json.dumps({"dmtet_query": list(xq.shape), "covered": float(
        covered.float().mean())}), flush=True)
    base = Config()
    R, C = base.triplane_resolution, base.triplane_channels
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    spec = grid_spec_of(base)
    L, Cg = spec.num_levels, spec.level_dim
    table = (torch.rand(spec.table_size, Cg, device=dev, generator=g)
             - 0.5) * 0.2
    c1 = [torch.randn(x1.shape[0], 3 * C, device=dev, generator=g).to(bf)
          for _ in range(4)]
    h1 = [torch.randn(x1.shape[0], L * Cg, device=dev, generator=g).to(bf)
          for _ in range(4)]
    cq = (torch.randn(xq.shape[0], 3 * C, device=dev, generator=g)
          * keep).to(bf)
    hq = (torch.randn(xq.shape[0], L * Cg, device=dev, generator=g)
          * keep).to(bf)
    none = (None,) * 3
    if hasattr(K1, "triplane_bwd_dx_cuda"):
        k1_dx = functools.partial(K1.triplane_bwd_dx_cuda, xq, planes, cq)
        k6_dx = functools.partial(K6.hash_bwd_dx_cuda, xq, table, spec, L,
                                  hq)
    else:           # a checkout from before the one-launch routes
        def k1_dx():
            return (K1.triplane_bwd_cuda(xq, planes.shape, cq, none),
                    K1._x_grad(xq, planes, cq))

        def k6_dx():
            return (K6.hash_bwd_cuda(xq, spec, L, hq, none),
                    K6._x_grad(xq, table, spec, L, hq))
    cases = []
    for where, x, cots, jac in (("step", x1, c1, True),
                                ("dmtet_query", xq, [cq], False)):
        lib_fwd, lib_bwd, _ = smoke.grid_sample_calls(torch, x, planes,
                                                      cots[0])
        row = {"shape": [x.shape[0], R, C], "at": where, "jacobian": jac}
        cases.append(({**row, "kernel": "K1 triplane_fwd"}, functools.partial(
            K1.triplane_fwd_cuda, x, planes, jac, bf), lib_fwd))
        cases.append(({**row, "kernel": "K1 triplane_bwd" if jac else
                       "K1 triplane_bwd + dx"},
                      functools.partial(K1.triplane_bwd_cuda, x,
                                        planes.shape, cots[0], cots[1:])
                      if jac else k1_dx, lib_bwd))
    for where, x, cots, jac in (("step", x1, h1, True),
                                ("dmtet_query", xq, [hq], False)):
        row = {"shape": [x.shape[0], spec.table_size, L, Cg], "at": where,
               "jacobian": jac}
        cases.append(({**row, "kernel": "K6 hashgrid_fwd"}, functools.partial(
            K6.hash_fwd_cuda, x, table, spec, L, jac, bf), None))
        cases.append(({**row, "kernel": "K6 hashgrid_bwd" if jac else
                       "K6 hashgrid_bwd + dx"},
                      functools.partial(K6.hash_bwd_cuda, x, spec, L,
                                        cots[0], cots[1:])
                      if jac else k6_dx, None))
    return cases


def backward_call(out, cots):
    """The backward of the autograd Function that made `out`, called on this
    thread and stream (the autograd engine's worker thread cannot be
    captured in a CUDA graph) with a context holding what its forward saved
    (taken now): `cots` are the cotangents of its first outputs, None for
    the rest, as the path gives them."""
    node = out.grad_fn
    ctx = types.SimpleNamespace(**vars(node),
                                saved_tensors=tuple(node.saved_tensors))
    backward = node._forward_cls.backward
    params = list(inspect.signature(backward).parameters.values())[1:]
    return functools.partial(backward, ctx, *cots,
                             *[None] * (len(params) - len(cots)))


def dmtet_cases(smoke, dev, bake_mesh=None):
    """(row, the checkout's call, None) for every K7 and K8 entry point at
    ``chip_smoke.dmtet_kernel_phases``' inputs (tet grid 128, max_tris
    131,072, the 512² DMTet view, cap 512, soft edge 1) and K7's forward
    at the texture bake's 1024² (cap min(1024, T), soft edge 0) of
    ``bake_mesh`` when given.  Inputs ask for gradients as on the DMTet
    path, and each backward is its op's autograd backward
    (``backward_call``) with cotangents shaped as the path's: zero on
    missed pixels
    (bary, the interpolated attributes) and on the edge slots no face
    uses (the surface vertices); the depth's is None.  Calls are found by
    name, so a checkout from before the static topology (no
    ``tet_topology``) is timed the same way."""
    import torch

    from dreamfusion_tpu_torch.config import Config, apply_dmtet, finalize
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    from dreamfusion_tpu_torch.ops import raster as K7
    from dreamfusion_tpu_torch.training.data import circle_view_batch

    g = torch.Generator(device=dev).manual_seed(12)
    _, pos, sdf, tets, te, ue = smoke._geometry_tet128(
        torch, dev, torch.Generator(device=dev).manual_seed(4))
    max_tris = 8 * 128 ** 2
    topo = ((K8.tet_topology(tets, te, pos.shape[0], ue.shape[0]),)
            if hasattr(K8, "tet_topology") else ())
    pos, sdf = pos.requires_grad_(), sdf.requires_grad_()
    mk = K8.marching_tets(pos, sdf, tets, te, ue, max_tris, *topo)
    live = mk.vert_valid[:, None].float()
    c_mt = torch.randn(mk.verts.shape, device=dev, generator=g) * live
    mesh = mk._replace(verts=mk.verts.detach().requires_grad_())
    v = mesh.verts
    cases = [({"kernel": "K8 marching_tets_fwd"}, functools.partial(
        K8.marching_tets, pos, sdf, tets, te, ue, max_tris, *topo)),
        ({"kernel": "K8 marching_tets_bwd"}, backward_call(mk.verts,
                                                          [c_mt]))]
    c_vn = torch.randn(v.shape, device=dev, generator=g) * live
    for name, fn, cot in (("vertex_normals", K8.vertex_normals, c_vn),
                          ("laplacian", K8.laplacian_smooth_loss, None),
                          ("normal_consistency", K8.normal_consistency_loss,
                           None)):
        y = fn(mesh)
        cases.append(({"kernel": f"K8 {name}_fwd"},
                      functools.partial(fn, mesh)))
        cases.append(({"kernel": f"K8 {name}_bwd"}, backward_call(
            y, [torch.ones_like(y) if cot is None else cot])))

    cfg = finalize(apply_dmtet(Config(guidance=("oracle",),
                                      backbone="triplane")))
    view = circle_view_batch(cfg, 1, 4, cfg.h, cfg.w, dev)
    H, W = cfg.h, cfg.w
    clip = K7.project_verts(v, view.mvp[0])
    sx, sy, sz, valid = K7.screen_coords(clip, mesh.faces, mesh.face_mask, H,
                                         W)
    ins = [t.detach().contiguous().requires_grad_() for t in (sx, sy, sz)]
    ro = K7.raster_cuda(*ins, mesh.faces, valid, H, W, 32, 512, 1.0)
    hit = (ro.tri_id >= 0).float()
    with torch.no_grad():
        *_, bmin, bmax = K7._face_coeffs(sx, sy, sz, mesh.faces.long())
        ids, listed = K7.tile_lists(bmin, bmax, valid, H, W, 32,
                                    mesh.faces.shape[0], 1.0)
    per_tile = listed.sum(1)
    print(json.dumps({"dmtet_view": [H, W], "faces": int(
        mesh.face_mask.sum()), "covered": float(hit.mean()),
        "overlapping_per_tile": {"mean": float(per_tile.float().mean()),
                                 "max": int(per_tile.max()),
                                 "over_512": int((per_tile > 512).sum())}}),
          flush=True)
    del ids, listed
    c_bary = torch.randn(ro.bary.shape, device=dev, generator=g) * \
        hit[..., None]
    c_alpha = torch.randn(ro.alpha.shape, device=dev, generator=g)
    where = {"shape": [H, W, mesh.faces.shape[0]], "cap": 512}
    cases.append(({"kernel": "K7 raster_fwd", **where}, functools.partial(
        K7.raster_cuda, *ins, mesh.faces, valid, H, W, 32, 512, 1.0)))
    cases.append(({"kernel": "K7 raster_bwd", **where}, backward_call(
        ro.bary, [c_bary, None, None, c_alpha])))
    attrs = v.detach().clone().requires_grad_()
    bary = ro.bary.detach().clone().requires_grad_()
    rb = ro._replace(bary=bary)
    yi = K7.interpolate(attrs, rb, mesh.faces)
    c_i = torch.randn(yi.shape, device=dev, generator=g) * hit[..., None]
    cases.append(({"kernel": "K7 interpolate_fwd", **where},
                  functools.partial(K7.interpolate, attrs, rb, mesh.faces)))
    cases.append(({"kernel": "K7 interpolate_bwd", **where},
                  backward_call(yi, [c_i])))
    if bake_mesh:
        from dreamfusion_tpu_torch.mesh.export import read_obj
        _, tris, uv, _ = read_obj(bake_mesh)
        u = torch.from_numpy(uv).to(dev)
        bclip = torch.stack([u[:, 0] * 2 - 1, -(u[:, 1] * 2 - 1),
                             torch.zeros_like(u[:, 0]),
                             torch.ones_like(u[:, 0])], -1)
        bf = torch.from_numpy(tris).to(dev)
        T = bf.shape[0]
        bx, by, bz, bvalid = K7.screen_coords(
            bclip, bf, torch.ones(T, dtype=torch.bool, device=dev), 1024,
            1024)
        bx, by, bz = (t.contiguous() for t in (bx, by, bz))
        cases.append(({"kernel": "K7 raster_fwd", "shape": [1024, 1024, T],
                       "cap": min(1024, T), "at": "bake"}, functools.partial(
            K7.raster_cuda, bx, by, bz, bf, bvalid, 1024, 1024, 32,
            min(1024, T), 0.0)))
    return [(row, fn, None) for row, fn in cases]


def march_region_call(K2, cfg, ro, rd, occ, draws, dev):
    """The render's march region as one call → (z, deltas, mask, xyzs):
    the checkout's ``march_region_cuda`` with the edges and stratum centres
    built once, or, on a checkout from before it, what its renderer ran
    each render: ``near_far_from_bound``, ``probe_edges``, the draws
    (``draws()``, or ``det_u`` made contiguous), the march kernel with its
    bool copy of the mask, and the clamped positions."""
    import torch

    from dreamfusion_tpu_torch.core.sampling import (det_u,
                                                     near_far_from_bound)
    R, P, S = ro.shape[0], cfg.grid_coarse_steps, cfg.grid_fine_steps
    bound = cfg.bound
    if hasattr(K2, "march_region_cuda"):
        edges = K2.probe_edges(P, cfg.dt_gamma, device=dev)
        centres = det_u(1, S, device=dev)[0].contiguous()

        def call():
            out, xyzs = K2.march_region_cuda(
                ro, rd, occ, bound, cfg.min_near, edges,
                centres if draws is None else draws())
            return (*out, xyzs)
        return call

    def call():
        near, far = near_far_from_bound(ro, rd, bound, "cube", cfg.min_near)
        u = det_u(R, S, device=dev) if draws is None else draws()
        edges = K2.probe_edges(P, cfg.dt_gamma, device=dev)
        out = K2.march_cuda(ro, rd, near, far, occ, bound, edges,
                            u.contiguous())
        xyzs = torch.clamp(ro[:, None, :] + rd[:, None, :] *
                           out.z_vals[..., None], -bound, bound)
        return (*out, xyzs)
    return call


def sdf_cases(smoke, dev, mesh_path=None):
    """(row, the checkout's call, None) for K9 at the DMTet mesh init's
    shape: the 274,625 tet-grid-128 points scaled as the init scales them,
    against ``mesh_path`` (an OBJ, normalised as the init does) or a UV
    sphere of 50,000 triangles.  The default route of any checkout and, on
    one with the culled kernel, that kernel with the culling off (the same
    result bit for bit)."""
    import numpy as np
    import torch

    from dreamfusion_tpu_torch.mesh import sdf as K9
    from dreamfusion_tpu_torch.mesh.tets import (CACHE_DIR,
                                                 load_cached_tet_grid)
    if mesh_path:
        mv, mt = K9.load_mesh(mesh_path)
        mv = K9.normalize_mesh(mv)
    else:
        mv, mt = smoke._uv_sphere(np, 0.4, 126, 200)
    scale = float(np.abs(mv).max()) + 0.1
    grid = load_cached_tet_grid(CACHE_DIR / "cube_64.npz", 64)
    pts = torch.from_numpy(grid.vertices).to(dev) * scale
    v, f = torch.from_numpy(mv).to(dev), torch.from_numpy(mt).to(dev)
    row = {"kernel": "K9 signed_distance", "shape": [pts.shape[0],
                                                     f.shape[0]],
           "mesh": os.path.basename(mesh_path) if mesh_path else "uv_sphere",
           "slow": True}
    cases = [({**row, "route": "default"}, functools.partial(
        K9.signed_distance_cuda, pts, v, f, True))]
    if "cull" in inspect.signature(K9.signed_distance_cuda).parameters:
        cases.append(({**row, "route": "no culling"}, functools.partial(
            K9.signed_distance_cuda, pts, v, f, True, False)))
    return [(r, fn, None) for r, fn in cases]


def render_cases(smoke, dev):
    """(row, the checkout's call, None) for K2's march and K3's and K4's
    forwards and backwards at the flagship stage-1 step's shapes (4096 rays
    x 24 samples of ``chip_smoke.flagship_march``: its masks; h and the
    tangents from a 3x64 MLP on a 256²x16 triplane, bf16; one light a ray,
    the ratio and the shading id as device scalars, lambertian (1) and
    normal (3)) and at an 800² eval render in one call (640,000 rays x 24:
    the march, K3 with a white background, the head alone).  Calls are
    found by name: on a checkout from before the fused tail (the Triton
    head, K3 without its epilogue) each "+ epilogue" row times the kernel
    and the torch ops the fused kernel replaces, as that checkout's
    renderer and field ran them, as one region.  Rows marked
    ``autograd`` run a backward through autograd (a graph built once;
    no graph ms)."""
    import torch

    from dreamfusion_tpu_torch.core.math import safe_normalize
    from dreamfusion_tpu_torch.ops import activation as K4
    from dreamfusion_tpu_torch.ops import composite as K3
    from dreamfusion_tpu_torch.ops import occupancy as K2

    fused = hasattr(K4, "field_shade_fwd_cuda")
    bf = torch.bfloat16
    m = smoke.flagship_march(torch)
    cfg = m["cfg"]
    bd, br, bound = cfg.blob_density, cfg.blob_radius, cfg.bound
    fi = smoke.flagship_field_inputs(torch, m)
    field, h, t, light, ratio, g = (fi[k] for k in (
        "field", "h", "t", "light", "ratio", "g"))
    xyz, mk = m["xyz"], m["mk"]
    R, S = mk.z_vals.shape
    N = R * S
    z, dl, mask, rd = mk.z_vals, mk.deltas, mk.mask, m["rd"]
    step = {"at": "step", "shape": [R, S]}
    cases = [({"kernel": "K2 march region", **step}, march_region_call(
        K2, cfg, m["ro"][:1].expand(R, 3), rd, m["occ"], lambda: m["u"],
        dev))]

    # ---- K4: the head alone, and with the normals and the shading --------
    def parent_shade(hh, tt, ids):
        """The field's tail before the fused head: the Triton head, then
        the normals and the select in torch (with the renderer's copy of
        the expanded light directions)."""
        ld = light[:, None, :].expand(R, S, 3).reshape(-1, 3)
        sigma, albedo, dsig = K4.field_head(hh, xyz, bd, br)
        gg = tt[..., 0].float().T * dsig[:, None] / (2 * bound)
        normal = torch.nan_to_num(safe_normalize(-gg))
        lam = ratio + (1 - ratio) * torch.clamp((normal * ld).sum(-1),
                                                min=0.0)
        color = torch.where(
            ids == 0, albedo,
            torch.where(ids == 2, lam[..., None].expand_as(albedo),
                        torch.where(ids == 3, (normal + 1.0) / 2.0,
                                    albedo * lam[..., None])))
        return sigma, color, normal

    def shade(hh, tt, ids):
        if fused:
            return K4.field_shade(hh, tt, xyz, light, ratio, ids, bd, br,
                                  bound)
        return parent_shade(hh, tt, ids)

    if fused:
        head_fwd = functools.partial(K4.field_head_fwd_cuda, h, xyz, bd, br)
    else:
        head_fwd = functools.partial(K4.field_head_fwd_triton, h, xyz, bd,
                                     br)
    g_sig = torch.randn(N, device=dev, generator=g)
    g_alb = torch.randn(N, 3, device=dev, generator=g)
    head_bwd = functools.partial(K4.field_head_bwd_cuda, h, xyz, bd, br,
                                 g_sig, g_alb) if fused else \
        functools.partial(K4.field_head_bwd_triton, h, xyz, bd, br, g_sig,
                          g_alb, torch.zeros_like(g_sig))
    cases += [({"kernel": "K4 field_head_fwd", **step}, head_fwd),
              ({"kernel": "K4 field_head_bwd", **step}, head_bwd)]
    for sid in (1, 3):
        ids = torch.tensor(sid, device=dev)
        row = {**step, "shading": sid}
        cases.append(({"kernel": "K4 shade_fwd + epilogue", **row},
                      functools.partial(torch.no_grad()(shade), h, t, ids)))
        cots = [torch.randn(N, device=dev, generator=g),
                torch.randn(N, 3, device=dev, generator=g),
                torch.randn(N, 3, device=dev, generator=g)]
        if fused:
            cases.append(({"kernel": "K4 shade_bwd", **row},
                          functools.partial(
                              K4.field_shade_bwd_cuda, h, t, xyz, light,
                              ratio, ids, bd, br, bound, *cots)))
        hg, tg = h.detach().requires_grad_(), t.detach().requires_grad_()
        outs = shade(hg, tg, ids)
        cases.append(({"kernel": "K4 shade_bwd + epilogue", **row,
                       "autograd": True},
                      functools.partial(torch.autograd.grad, outs, (hg, tg),
                                        cots, retain_graph=True)))

    # ---- K3: the kernel alone, and with the background and the orient loss
    with torch.no_grad():
        sigma, color, normal = shade(h, t, torch.tensor(1, device=dev))
    sigma = sigma.reshape(R, S).contiguous()
    rgb = color.reshape(R, S, 3).contiguous()
    normals = normal.reshape(R, S, 3).contiguous()
    bg = torch.rand(3, device=dev, generator=g).expand(R, 3)
    bg_net = torch.rand(R, 3, device=dev, generator=g)
    use = torch.tensor(True, device=dev)

    def parent_composite(sg, cl, nm, net):
        """K3, then the renderer's background and orient loss in torch."""
        dirs = safe_normalize(rd[:, None, :].expand(R, S, 3))
        out = K3.composite_rays(sg, cl, z, dl, mask=mask, t_thresh=1e-4)
        bgc = torch.where(use, net, bg)
        image = out.image + (1.0 - out.weights_sum)[..., None] * bgc
        w = out.weights.detach()
        loss = w * torch.clamp((nm * dirs).sum(-1), min=0.0) ** 2
        return (image, out.depth, out.weights, out.weights_sum,
                loss.sum(-1).mean())

    def composite(sg, cl, nm, net):
        if fused:
            return tuple(K3.composite_rays(
                sg, cl, z, dl, mask, 1e-4, False, bg_color=bg, bg_net=net,
                use_bg_net=use, normals=nm, rays_d=rd))
        return parent_composite(sg, cl, nm, net)

    cases.append(({"kernel": "K3 composite_fwd", **step}, functools.partial(
        K3._composite_fwd_cuda, sigma, rgb, z, dl, mask, 1e-4, False)))
    cases.append(({"kernel": "K3 composite_fwd + epilogue", **step},
                  functools.partial(torch.no_grad()(composite), sigma, rgb,
                                    normals, bg_net)))
    w = K3._composite_fwd_cuda(sigma, rgb, z, dl, mask, 1e-4, False).weights
    cc = [torch.randn(R, 3, device=dev, generator=g),
          torch.randn(R, device=dev, generator=g),
          torch.randn(R, S, device=dev, generator=g),
          torch.randn(R, device=dev, generator=g)]
    g_loss = torch.randn((), device=dev, generator=g)
    bwd_args = (sigma, rgb, z, dl, mask, w, *cc, 1e-4)
    if "binarize" in inspect.signature(K3._composite_bwd_cuda).parameters:
        kernel_bwd = functools.partial(K3._composite_bwd_cuda, *bwd_args,
                                       False)
    else:
        kernel_bwd = functools.partial(K3._composite_bwd_cuda, *bwd_args)
        wsum = w.sum(-1)
        cases.append(({"kernel": "K3 composite_bwd + epilogue (kernel)",
                       **step}, functools.partial(
            K3._composite_bwd_cuda, *bwd_args, bg_color=bg, bg_net=bg_net,
            use_bg_net=use, normals=normals, rays_d=rd, g_loss=g_loss,
            wsum=wsum)))
    cases.append(({"kernel": "K3 composite_bwd", **step}, kernel_bwd))
    ins = [v.detach().requires_grad_() for v in (sigma, rgb, normals,
                                                 bg_net)]
    outs = composite(*ins)
    cases.append(({"kernel": "K3 composite_bwd + epilogue", **step,
                   "autograd": True},
                  functools.partial(torch.autograd.grad, outs, ins,
                                    cc + [g_loss], retain_graph=True)))

    # ---- an 800² eval render in one call: albedo, white background -------
    n_eval = cfg.H * cfg.W
    gen = torch.Generator(device=dev).manual_seed(14)
    idx = torch.randint(0, R, (n_eval,), device=dev, generator=gen)
    ro_e = (m["ro"][idx] + torch.randn(n_eval, 3, device=dev, generator=gen)
            * 0.05).contiguous()
    rd_e = safe_normalize(rd[idx] + torch.randn(
        n_eval, 3, device=dev, generator=gen) * 0.05).contiguous()
    ev = {"at": "eval", "shape": [n_eval, S]}
    region_e = march_region_call(K2, cfg, ro_e, rd_e, m["occ"], None, dev)
    cases.append(({"kernel": "K2 march region", **ev}, region_e))
    *me, xe = region_e()
    me, xe = K2.MarchOut(*me), xe.reshape(-1, 3)
    with torch.no_grad():
        he = field.sigma_net(field.encode(xe), bf)
    head_e = K4.field_head_fwd_cuda if fused else K4.field_head_fwd_triton
    cases.append(({"kernel": "K4 field_head_fwd", **ev},
                  functools.partial(head_e, he, xe, bd, br)))
    se, ae = head_e(he, xe, bd, br)[:2]
    se = se.reshape(n_eval, S).contiguous()
    ae = ae.reshape(n_eval, S, 3).contiguous()

    def eval_composite():
        if fused:
            return K3._composite_fwd_cuda(se, ae, me.z_vals, me.deltas,
                                          me.mask, 1e-4, False, 1.0)
        out = K3._composite_fwd_cuda(se, ae, me.z_vals, me.deltas, me.mask,
                                     1e-4, False)
        one = torch.ones((), device=dev)
        return out.image + (1.0 - out.weights_sum)[..., None] * one

    cases.append(({"kernel": "K3 composite_fwd + epilogue", **ev},
                  eval_composite))
    return [(row, fn, None) for row, fn in cases]


def sweep_fp32_tiles(smoke, K12, kernels, graph_ms, dev, g, tag, card):
    """The tiled fp32 route at every distinct conv shape of a 384² DPT
    forward, launched directly at each N tile (32, 64) and split (1 to
    32, at most one a K step): one JSON line a shape with each pair's
    graph ms (or the error it raised), the pair ``fp32_tiling`` chooses and
    the fastest pair, each with its ms; a last line sums both over the 40
    convs of a forward."""
    import torch

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    convs, _ = smoke.dpt_calls(DPTConfig.depth(), smoke.DPT_HW)
    sms = kernels.sm_count(dev)
    sums = {"chosen_ms": 0.0, "best_ms": 0.0}
    for call in dict.fromkeys(convs):
        (B, H, W, I), (O, kh, kw, _), st, pads = call
        x = torch.randn(B, H, W, I, device=dev, generator=g)
        w = torch.randn(O, kh, kw, I, device=dev, generator=g) / \
            (kh * kw * I) ** 0.5
        bias = torch.randn(O, device=dev, generator=g)
        Ho, Wo = K12.out_size(H, W, kh, kw, (st, st), pads)
        y = torch.empty(B, Ho, Wo, O, device=dev)
        K = kh * kw * I
        times = {}
        for bn in (32, 64):
            for sp in range(1, min(32, -(-K // 16)) + 1):
                ws = torch.empty(sp * y.numel(), device=dev) \
                    if sp > 1 else None
                fn = functools.partial(
                    kernels.launch, "conv_fwd_fp32_tiled", x.data_ptr(),
                    w.data_ptr(), bias.data_ptr(), y.data_ptr(), B, H, W, I,
                    Ho, Wo, O, kh, kw, st, st, pads[0][0], pads[1][0], bn, 1,
                    sp, None if ws is None else ws.data_ptr())
                try:
                    times[f"{bn}/{sp}"] = graph_ms(fn, 10, 5)
                except RuntimeError as e:
                    times[f"{bn}/{sp}"] = str(e)[:80]
        chosen = "/".join(map(str, K12.fp32_tiling(B * Ho * Wo, O, K, sms)))
        ok = {k: v for k, v in times.items() if isinstance(v, float)}
        best = min(ok, key=ok.get)
        n = convs.count(call)
        sums["chosen_ms"] += n * ok[chosen]
        sums["best_ms"] += n * ok[best]
        print(json.dumps({"tag": tag, "shape": [B, H, W, I, O], "k": kh,
                          "stride": st, "per_forward": n, "chosen": chosen,
                          "chosen_ms": ok[chosen], "best": best,
                          "best_ms": ok[best], "graph_ms": times,
                          "card": card}), flush=True)
    print(json.dumps({"tag": tag, "dpt_convs_a_forward": len(convs), **sums,
                      "card": card}), flush=True)


def sweep_wgrad_splits(smoke, K12, kernels, graph_ms, dev, g, tag, card):
    """The weight gradient's split rules against the fastest split: the
    wgmma route at every distinct bf16 shape of the four towers' backward
    (``wgrad_cases``) and the tiled fp32 route at the DPT's 17 shapes and
    the conv_outs', each launched directly at every split of 1-16 and at
    20-64 in steps of 4 or 8 (at most one a step): one JSON line a shape
    with each split's graph ms, the split the rule chooses and the fastest,
    each with its ms; a last line a group sums both over its calls."""
    import torch

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    sms = kernels.sm_count(dev)
    shapes = {}
    for row, _, _ in wgrad_cases(smoke, kernels, dev):
        B, H, W, I, O = row["shape"]
        route = K12.wgrad_route(torch.bfloat16 if row["dtype"] == "bf16"
                                else torch.float32, I, O,
                                (row["stride"], row["stride"]))
        if route != "conv_wgrad_mma":
            key = (B, H, W, I, O, row["k"], row["stride"], row["pads"],
                   row["dtype"])
            shapes[key] = {"towers": sum(row["calls"].values())}
    convs, _ = smoke.dpt_calls(DPTConfig.depth(), smoke.DPT_HW)
    for (B, H, W, I), (O, k, _, _), st, pads in convs:
        key = (B, H, W, I, O, k, st, pads, "fp32")
        shapes.setdefault(key, {"dpt": 0})["dpt"] += 1
    sums = {}
    for (B, H, W, I, O, k, st, pads, dt), calls in shapes.items():
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
        x = torch.randn(B, H, W, I, device=dev, generator=g).to(dtype)
        dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(dtype)
        dw = torch.empty(O, k, k, I, device=dev, dtype=dtype)
        K = k * k * I
        shape = (B, H, W, I, Ho, Wo, O, k, k, st, st, pads[0][0],
                 pads[1][0])
        if dt == "bf16":
            route = "conv_wgrad_wgmma"
            steps = K12.wgrad_boxes(B, Ho, Wo)
            chosen = K12.wgmma_wgrad_splits(O, K, steps, sms)
            extra = lambda sp: (*K12.wgrad_box(B, Ho, Wo), 0, sp, sms)
            top = min(32, steps)
        else:
            route = "conv_wgrad_fp32_tiled"
            steps = -(-B * Ho * Wo // 16)
            bn, chosen = K12.fp32_wgrad_tiling(O, K, B * Ho * Wo, sms)
            extra = lambda sp: (bn, sp)
            top = min(64, steps)
        times = {}
        for sp in sorted({s for s in list(range(1, 17)) +
                          list(range(20, 33, 4)) + list(range(40, 65, 8))
                          if s <= top} | {chosen}):
            ws = torch.empty(sp * dw.numel(), device=dev) if sp > 1 else None
            fn = functools.partial(
                kernels.launch, route, x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), None if ws is None else ws.data_ptr(), *shape,
                *extra(sp))
            times[sp] = graph_ms(fn, 10, 5)
        best = min(times, key=times.get)
        print(json.dumps({"tag": tag, "kernel": route,
                          "shape": [B, H, W, I, O], "k": k, "stride": st,
                          "calls": calls, "chosen": chosen,
                          "chosen_ms": times[chosen], "best": best,
                          "best_ms": times[best], "graph_ms": times,
                          "card": card}), flush=True)
        for group, n in calls.items():
            s = sums.setdefault(group, {"chosen_ms": 0.0, "best_ms": 0.0})
            s["chosen_ms"] += n * times[chosen]
            s["best_ms"] += n * times[best]
    for group, s in sums.items():
        print(json.dumps({"tag": tag, "group": group, **s, "card": card}),
              flush=True)


def dpt_cases(smoke, dev):
    """(row, the checkout's call, the library's call) for K12 at each
    distinct conv shape of a 384² DPT forward and K10's fp32 forward at
    the ViT's shape (see the module docstring); inputs from a fixed
    seed."""
    import torch
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12

    g = torch.Generator(device=dev).manual_seed(21)
    convs, attns = smoke.dpt_calls(DPTConfig.depth(), smoke.DPT_HW)
    cases = []
    for call in dict.fromkeys(convs):
        (B, H, W, I), (O, kh, kw, _), st, pads = call
        x = torch.randn(B, H, W, I, device=dev, generator=g)
        w = torch.randn(O, kh, kw, I, device=dev, generator=g) / \
            (kh * kw * I) ** 0.5
        bias = torch.randn(O, device=dev, generator=g)
        Ho, Wo = K12.out_size(H, W, kh, kw, (st, st), pads)
        xc = x.permute(0, 3, 1, 2)
        sym = pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]
        xl = xc if sym else F.pad(xc, (*pads[1], *pads[0]))
        gflop = 2 * B * Ho * Wo * O * kh * kw * I / 1e9
        cases.append(({"kernel": "K12 conv_fwd", "shape": [B, H, W, I, O],
                       "k": kh, "stride": st, "pads": pads, "dtype": "fp32",
                       "gflop": gflop, "per_forward": convs.count(call),
                       "slow": gflop >= 5},
                      functools.partial(K12.conv2d_fwd_cuda, x, w, bias,
                                        (st, st), pads, torch.float32),
                      functools.partial(F.conv2d, xl, w.permute(0, 3, 1, 2),
                                        bias, st, pads[0][0] if sym else 0)))
    B, N, h, d = attns[0]
    q, k, v = (torch.randn(B, N, h, d, device=dev, generator=g)
               for _ in range(3))
    cases.append(({"kernel": "K10 attention_fwd", "shape": [B, N, N, h, d],
                   "dtype": "fp32", "gflop": 4 * B * h * N * N * d / 1e9,
                   "per_forward": len(attns)},
                  functools.partial(K10.attention_fwd_cuda, q, k, v,
                                    d ** -0.5),
                  functools.partial(F.scaled_dot_product_attention,
                                    *(t.transpose(1, 2) for t in (q, k, v)))))
    return cases


def dpt_dgrad_cases(smoke, dev):
    """(row, the checkout's call, cuDNN's call) for K12's input gradient
    at each distinct conv shape of a 384² DPT backward (see the module
    docstring); inputs from a fixed seed."""
    import torch

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    from dreamfusion_tpu_torch.ops import conv as K12

    g = torch.Generator(device=dev).manual_seed(22)
    # each conv of the forward asks its input's gradient where the input
    # wants one (the stem's too): the forward's calls, which any checkout's
    # DPT gives
    dgrads, _ = smoke.dpt_calls(DPTConfig.depth(), smoke.DPT_HW)
    cases = []
    for call in dict.fromkeys(dgrads):
        (B, H, W, I), (O, kh, kw, _), st, pads = call
        Ho, Wo = K12.out_size(H, W, kh, kw, (st, st), pads)
        w = torch.randn(O, kh, kw, I, device=dev, generator=g) / \
            (kh * kw * I) ** 0.5
        dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g)
        (pt, pb), (pl, pr) = pads
        xl = torch.empty(B, I, H + pt + pb, W + pl + pr, device=dev)
        gflop = 2 * B * Ho * Wo * O * kh * kw * I / 1e9
        cases.append((
            {"kernel": "K12 conv_dgrad", "shape": [B, H, W, I, O], "k": kh,
             "stride": st, "pads": pads, "dtype": "fp32", "gflop": gflop,
             "per_backward": dgrads.count(call), "slow": gflop >= 5},
            functools.partial(K12.conv2d_dgrad_cuda, dy, w, (B, H, W, I),
                              (st, st), pads, torch.float32),
            functools.partial(torch.ops.aten.convolution_backward,
                              dy.permute(0, 3, 1, 2), xl,
                              w.permute(0, 3, 1, 2), None, [st, st], [0, 0],
                              [1, 1], False, [0, 0], 1,
                              [True, False, False])))
    return cases


def _wgrad_case(dev, g, B, H, W, I, O, k, st, pads, dtype):
    """(the checkout's weight gradient, cuDNN's, GFLOP) of one conv shape;
    inputs from `g`."""
    import torch
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import conv as K12
    Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(dtype)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(dtype)
    sym = pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]
    xc = x.permute(0, 3, 1, 2)
    xl = xc if sym else F.pad(xc, (*pads[1], *pads[0]))
    wc = torch.empty(O, I, k, k, device=dev, dtype=dtype)
    pad = [pads[0][0], pads[1][0]] if sym else [0, 0]
    return (functools.partial(K12.conv2d_wgrad_cuda, x, dy, (O, k, k, I),
                              (st, st), pads, dtype),
            functools.partial(torch.ops.aten.convolution_backward,
                              dy.permute(0, 3, 1, 2), xl, wc, None, [st, st],
                              pad, [1, 1], False, [0, 0], 1,
                              [False, True, False]),
            2 * B * Ho * Wo * O * k * k * I / 1e9)


def wgrad_cases(smoke, kernels, dev):
    """(row, the checkout's call, cuDNN's call) for K12's weight gradient
    at each distinct conv shape of the four towers' backward (see the
    module docstring), each row with its calls a tower (``calls``)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(23)
    calls = {}
    for tower, (prior, part) in smoke.GRAD_TOWERS.items():
        smoke.tower_forward(torch, kernels, prior, part)
        for c in smoke._TOWER_FULL[(prior, part, 1)]:
            if c[0] == "conv":
                n = calls.setdefault(c[1:], {})
                n[tower] = n.get(tower, 0) + 1
    cases = []
    for (B, H, W, I, O, k, st, pads, dt), n in calls.items():
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        fn, lib, gflop = _wgrad_case(dev, g, B, H, W, I, O, k, st, pads,
                                     dtype)
        cases.append(({"kernel": "K12 conv_wgrad", "shape": [B, H, W, I, O],
                       "k": k, "stride": st, "pads": pads, "dtype": dt,
                       "gflop": gflop, "calls": n}, fn, lib))
    return cases


def sweep_flash_splits(K10, kernels, graph_ms, cases, tag, card):
    """The flash backward's split rule against the fastest split: at every
    bf16 shape of ``attn_bwd_cases`` the backward at each split of the
    dK/dV pass from 1 to 16 (at most one a query tile; the rule replaced
    for the call): one JSON line a shape with each split's graph ms, the
    split ``flash_bwd_splits`` chooses and the fastest, each with its ms;
    a last line a tower sums both over its calls."""
    rule = K10.flash_bwd_splits
    sums = {}
    for row, fn, _ in cases:
        if row["kernel"] != "K10 attention_bwd" or row["dtype"] != "bf16":
            continue
        B, N, M, h, d = row["shape"]
        chosen = rule(B * h, N, M, d, kernels.sm_count(fn.args[0].device))
        times = {}
        try:
            for sp in range(1, min(16, -(-N // K10._FLASH_BR[d])) + 1):
                K10.flash_bwd_splits = lambda *a, sp=sp: sp
                times[sp] = graph_ms(fn, 10, 5)
        finally:
            K10.flash_bwd_splits = rule
        best = min(times, key=times.get)
        print(json.dumps({"tag": tag, "kernel": "K10 attention_bwd",
                          "shape": row["shape"], "calls": row["calls"],
                          "chosen": chosen, "chosen_ms": times[chosen],
                          "best": best, "best_ms": times[best],
                          "graph_ms": times, "card": card}), flush=True)
        for tower, n in row["calls"].items():
            t = sums.setdefault(tower, {"chosen_ms": 0.0, "best_ms": 0.0})
            t["chosen_ms"] += n * times[chosen]
            t["best_ms"] += n * times[best]
    for tower, t in sums.items():
        print(json.dumps({"tag": tag, "tower": tower, **t, "card": card}),
              flush=True)


def attn_bwd_cases(smoke, kernels, dev):
    """(row, the checkout's backward, SDPA's backward node) for K10 at each
    distinct attention shape of d = 40, 64, 80, 160 of the four towers'
    backward (see the module docstring), each row with its calls a tower
    (``calls``), and at the DPT's fp32 [1, 577, 12, 64]."""
    import torch

    from dreamfusion_tpu_torch.ops import attention as K10
    g = torch.Generator(device=dev).manual_seed(25)
    calls = {}
    for tower, (prior, part) in smoke.GRAD_TOWERS.items():
        smoke.tower_forward(torch, kernels, prior, part)
        for c in smoke._TOWER_FULL[(prior, part, 1)]:
            if c[0] == "attn" and c[-1] in (40, 64, 80, 160):
                n = calls.setdefault(c[1:], {})
                n[tower] = n.get(tower, 0) + 1
    branch = getattr(K10, "chunked_branch", None)
    cases = []
    for (B, N, M, h, d), n, dtype in (
            [(c, n, torch.bfloat16) for c, n in calls.items()] +
            [((1, 577, 577, 12, 64), {}, torch.float32)]):
        q, k, v, do = (torch.randn(B, t, h, d, device=dev, generator=g)
                       .to(dtype) for t in (N, M, M, N))
        rq = (branch(B, N, M, h),) if branch and dtype != torch.float32 \
            else ()
        o, lse = K10.attention_fwd_cuda(q, k, v, d ** -0.5, *rq)
        lib, node = smoke.sdpa_backward(torch, q, k, v, do)
        cases.append(({"kernel": "K10 attention_bwd",
                       "shape": [B, N, M, h, d],
                       "dtype": "fp32" if dtype == torch.float32 else "bf16",
                       "chunked": bool(rq and rq[0]),
                       "gflop": 10 * B * h * N * M * d / 1e9, "calls": n,
                       "library_node": node},
                      functools.partial(K10.attention_bwd_cuda, q, k, v, o,
                                        lse, do, d ** -0.5, *rq), lib))
    return cases


def dpt_wgrad_cases(smoke, dev):
    """(row, the checkout's call, cuDNN's call) for K12's weight gradient
    at each distinct conv shape of a 384² DPT backward."""
    import torch

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    g = torch.Generator(device=dev).manual_seed(24)
    convs, _ = smoke.dpt_calls(DPTConfig.depth(), smoke.DPT_HW)
    cases = []
    for call in dict.fromkeys(convs):
        (B, H, W, I), (O, kh, _, _), st, pads = call
        fn, lib, gflop = _wgrad_case(dev, g, B, H, W, I, O, kh, st, pads,
                                     torch.float32)
        cases.append(({"kernel": "K12 conv_wgrad", "shape": [B, H, W, I, O],
                       "k": kh, "stride": st, "pads": pads, "dtype": "fp32",
                       "gflop": gflop, "per_backward": convs.count(call),
                       "slow": gflop >= 5}, fn, lib))
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("conv", "dgrad", "attn", "gn",
                                       "gn_routes", "field", "dmtet",
                                       "render", "sdf", "dpt",
                                       "dpt_splits", "dpt_dgrad",
                                       "wgrad", "dpt_wgrad",
                                       "wgrad_splits", "attn_bwd",
                                       "attn_bwd_splits", "tower_bwd"),
                    default=None, help="time only K12 (forwards and "
                    "dgrads), only K12's dgrads, only K10 (forwards and "
                    "the backward), only K11, K11 through every route "
                    "it could take, only K1 and K6, only K7 and K8, "
                    "only K2, K3 and K4, only K9, only the DPT's K10 "
                    "and K12 calls, K12's tiled fp32 route over its N "
                    "tiles and splits, K12's dgrads at the DPT's shapes, "
                    "K12's weight gradients at the towers' or the "
                    "DPT's shapes, or their split rules against every "
                    "split, K10's backward at the towers' shapes or its "
                    "split rule against every split, or the towers' "
                    "forward and backward walls (the last fourteen not "
                    "in the default set)")
    ap.add_argument("--sdf_mesh", default=None,
                    help="with --only sdf: the OBJ whose signed distance "
                    "K9 measures (default: a 50,000-triangle UV sphere)")
    ap.add_argument("--bake_mesh", default=None,
                    help="with --only dmtet: an OBJ with UVs whose atlas "
                    "K7's forward is timed at the bake's 1024²")
    ap.add_argument("--sd_version", default="2.1",
                    help="whose attention rows: 2.x (d = 64) or 1.x "
                    "(d = 40, 80, 160); the VAE's d = 512 in both")
    ap.add_argument("--outputs", default=None,
                    help="save every forward's output to this file")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"),
                    help="compare two --outputs files and exit")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return
    smoke = _chip_smoke()
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    from dreamfusion_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("bench_sd_kernels measures the GPU: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    kernels.cuda_lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def kernel_ms(fn, n=10, by_name=False):
        """Device ms per call (the profiler's kernels); with `by_name`,
        also the ms per call of each kernel name (cut to 60 characters)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name[:60]
                names[key] = names.get(key, 0.0) + \
                    e.time_range.elapsed_us() / n / 1e3
        total = sum(names.values())
        return (total, names) if by_name else total

    graph_ms = smoke.graph_ms

    def map_cost(n=2000):
        """Host µs of a 1x1 conv [2,32,32,320->640] (the wgmma route) with
        x at a new address each call (its tensor map encoded afresh: n
        addresses, more than the map cache holds) and at one address (the
        map found in the cache), the two calls interleaved, medians."""
        shape = (2, 32, 32, 320)
        numel = 2 * 32 * 32 * 320
        buf = torch.randn(numel + 8 * n, device=dev).to(torch.bfloat16)
        xs = [buf[8 * i:8 * i + numel].view(shape) for i in range(n)]
        w = torch.randn(640, 1, 1, 320, device=dev).to(torch.bfloat16)
        pads = K12.norm_padding(0)
        fresh, same = [], []
        for i in range(1, n):
            for x, out in ((xs[i], fresh), (xs[0], same)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                K12.conv2d_fwd_cuda(x, w, None, (1, 1), pads, x.dtype)
                out.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return {"kernel": "K12 conv_fwd, tensor map of x",
                "shape": [2, 32, 32, 320, 640], "k": 1,
                "host_us_new_address": statistics.median(fresh) * 1e6,
                "host_us_same_address": statistics.median(same) * 1e6}

    def route_of(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return sorted(k for k, v in kernels.LAUNCHES.items() if v)

    # (row of the shape, the wrapper's call, the library's call or None)
    cases = []
    dgrads = []
    for B, H, W, I, O, k, st, pad, dt, dgrad in (
            [] if args.only in ("attn", "gn", "gn_routes", "field", "dmtet",
                                "render", "sdf", "dpt", "dpt_splits",
                                "dpt_dgrad", "wgrad", "dpt_wgrad",
                                "wgrad_splits", "attn_bwd",
                                "attn_bwd_splits", "tower_bwd")
            else smoke.SD_CONVS):
        if args.only == "dgrad" and not dgrad:
            continue
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        x = torch.randn(B, H, W, I, device=dev, generator=g).to(dtype)
        w = (torch.randn(O, k, k, I, device=dev, generator=g) /
             (k * k * I) ** 0.5).to(dtype)
        bias = torch.randn(O, device=dev, generator=g)
        pads = K12.norm_padding(pad)
        Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
        fn = functools.partial(K12.conv2d_fwd_cuda, x, w, bias, (st, st),
                               pads, dtype)
        lib_fn = None
        if pads[0][0] == pads[0][1]:
            lib_fn = functools.partial(
                F.conv2d, x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                bias.to(dtype), st, pads[0][0])
        row = {"kernel": "K12 conv_fwd", "shape": [B, H, W, I, O], "k": k,
               "stride": st, "pads": pads, "dtype": dt,
               "gflop": 2 * B * Ho * Wo * O * k * k * I / 1e9}
        if args.only != "dgrad":
            cases.append((row, fn, lib_fn))
        if not dgrad:
            continue
        dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(dtype)
        lib_fn = None
        if pads[0][0] == pads[0][1]:
            lib_fn = functools.partial(
                torch.ops.aten.convolution_backward, dy.permute(0, 3, 1, 2),
                x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), None,
                [st, st], [pads[0][0]] * 2, [1, 1], False, [0, 0], 1,
                [True, False, False])
        dgrads.append(({**row, "kernel": "K12 conv_dgrad"},
                       functools.partial(K12.conv2d_dgrad_cuda, dy, w,
                                         x.shape, (st, st), pads, dtype),
                       lib_fn))
    cases += dgrads
    # library backward calls run autograd: timed by events and the
    # profiler, not captured in a graph
    autograd_libs = set()
    unet_dims = ((64,) if args.sd_version.startswith("2")
                 else smoke.SD15_HEAD_DIMS)
    branch = getattr(K10, "chunked_branch", None)
    for B, N, M, h, d, bwd in (
            [] if args.only in ("conv", "dgrad", "gn", "gn_routes", "field",
                                "dmtet", "render", "sdf", "dpt", "dpt_splits",
                                "dpt_dgrad", "wgrad", "dpt_wgrad",
                                "wgrad_splits", "attn_bwd",
                                "attn_bwd_splits", "tower_bwd")
            else smoke.SD_ATTNS):
        if d not in unet_dims + (512,):
            continue
        q, k, v = (torch.randn(B, n, h, d, device=dev, generator=g).to(
            torch.bfloat16) for n in (N, M, M))
        rq = (branch(B, N, M, h),) if branch else ()
        cases.append(({"kernel": "K10 attention_fwd",
                       "shape": [B, N, M, h, d],
                       "gflop": 4 * B * h * N * M * d / 1e9},
                      functools.partial(K10.attention_fwd_cuda, q, k, v,
                                        d ** -0.5, *rq),
                      functools.partial(F.scaled_dot_product_attention,
                                        *(t.transpose(1, 2)
                                          for t in (q, k, v)))))
        if not bwd:
            continue
        o, lse = K10.attention_fwd_cuda(q, k, v, d ** -0.5)
        do = torch.randn(B, N, h, d, device=dev, generator=g).to(
            torch.bfloat16)
        qkvt = [t.transpose(1, 2).detach().requires_grad_()
                for t in (q, k, v)]
        ot = F.scaled_dot_product_attention(*qkvt)
        lib_fn = functools.partial(torch.autograd.grad, ot, qkvt,
                                   do.transpose(1, 2), retain_graph=True)
        autograd_libs.add(id(lib_fn))
        cases.append(({"kernel": "K10 attention_bwd",
                       "shape": [B, N, M, h, d],
                       "gflop": 10 * B * h * N * M * d / 1e9},
                      functools.partial(K10.attention_bwd_cuda, q, k, v, o,
                                        lse, do, d ** -0.5), lib_fn))
    # K11: the parent's Triton wrappers or the CUDA ones, by name
    gn_fwd = getattr(K11, "group_norm_fwd_cuda", None) or getattr(
        K11, "group_norm_fwd_triton", None)
    gn_bwd = getattr(K11, "group_norm_bwd_cuda", None) or getattr(
        K11, "group_norm_bwd_triton", None)
    for B, H, W, C, eps, silu, per_step, bwd in (
            smoke.SD_GROUPNORMS if args.only in (None, "gn") else []):
        G = K11.groups_for(C)
        x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3).to(
            torch.bfloat16)
        wt, bs = (torch.randn(C, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))
        xc = x.permute(0, 3, 1, 2)

        def lib_fwd(xc=xc, G=G, wt=wt, bs=bs, eps=eps, silu=silu):
            y = F.group_norm(xc, G, wt, bs, eps)
            return F.silu(y) if silu else y

        row = {"kernel": "K11 groupnorm_fwd", "shape": [B, H, W, C],
               "eps": eps, "silu": silu, "per_step": per_step,
               "gbytes": 2 * x.numel() * 2 / 1e9}
        cases.append((row, functools.partial(gn_fwd, x, wt, bs, G, eps,
                                             silu), lib_fwd))
        if not bwd:
            continue
        _, stats = gn_fwd(x, wt, bs, G, eps, silu)
        dy = torch.randn(B, H, W, C, device=dev, generator=g).to(
            torch.bfloat16)
        xl = xc.detach().requires_grad_()
        yl = F.group_norm(xl, G, wt, bs, eps)
        yl = F.silu(yl) if silu else yl
        lib_fn = functools.partial(torch.autograd.grad, yl, xl,
                                   dy.permute(0, 3, 1, 2), retain_graph=True)
        autograd_libs.add(id(lib_fn))
        cases.append(({**row, "kernel": "K11 groupnorm_bwd",
                       "gbytes": 3 * x.numel() * 2 / 1e9},
                      functools.partial(gn_bwd, x, wt, bs, stats, dy, G,
                                        silu), lib_fn))

    if args.only == "field":
        cases += field_cases(smoke, dev)
    if args.only == "dmtet":
        cases += dmtet_cases(smoke, dev, args.bake_mesh)
    if args.only == "render":
        cases += render_cases(smoke, dev)
    if args.only == "sdf":
        cases += sdf_cases(smoke, dev, args.sdf_mesh)
    if args.only == "dpt":
        cases += dpt_cases(smoke, dev)
    if args.only == "dpt_dgrad":
        cases += dpt_dgrad_cases(smoke, dev)
    if args.only == "wgrad":
        cases += wgrad_cases(smoke, kernels, dev)
    if args.only == "dpt_wgrad":
        cases += dpt_wgrad_cases(smoke, dev)
    if args.only in ("attn_bwd", "attn_bwd_splits"):
        cases += attn_bwd_cases(smoke, kernels, dev)

    print(json.dumps({"tag": args.tag, "root": os.path.abspath(args.root),
                      "sources_sha256": sources_sha256(args.root),
                      "card": card}), flush=True)
    if args.only == "gn_routes":
        sweep_gn_routes(smoke, K11, kernels, graph_ms, dev, g, args.tag,
                        card)
        return
    if args.only == "dpt_splits":
        sweep_fp32_tiles(smoke, K12, kernels, graph_ms, dev, g, args.tag,
                         card)
        return
    if args.only == "wgrad_splits":
        sweep_wgrad_splits(smoke, K12, kernels, graph_ms, dev, g, args.tag,
                           card)
        return
    if args.only == "attn_bwd_splits":
        sweep_flash_splits(K10, kernels, graph_ms, cases, args.tag, card)
        return
    if args.only == "tower_bwd":
        for tower, (prior, part) in smoke.GRAD_TOWERS.items():
            run = smoke.tower_grad_run(torch, kernels, tower, prior, part,
                                       None)
            print(json.dumps({"tag": args.tag, "tower": tower, **run,
                              "card": card}), flush=True)
        return
    if args.outputs:
        outs = {}
        for row, fn, _ in cases:
            if row["kernel"] in ("K12 conv_dgrad", "K12 conv_wgrad"):
                continue
            y = fn()
            key = json.dumps({k: row[k] for k in row if k != "gflop"})
            if row["kernel"].startswith(("K1 ", "K2 ", "K3 ", "K4 ", "K6 ",
                                         "K7 ", "K8 ", "K9 ")):
                for i, t in enumerate(y if isinstance(y, (tuple, list))
                                      else (y,)):
                    if isinstance(t, torch.Tensor):
                        outs[f"{key}[{i}]"] = t.detach().cpu()
                continue
            y = y[0] if isinstance(y, tuple) else y
            outs[key] = y.cpu()
        torch.save(outs, args.outputs)
        del outs
    # the host times first: the profiler leaves its hooks behind
    # a row marked "slow" (K9: ~0.1 s a call) is timed over fewer calls
    n_of = lambda row, n, few: few if row.get("slow") else n
    hosts = [{**smoke.host_us(fn, n_of(row, 200, 5)),
              **({f"library_{k}": v for k, v in smoke.host_us(
                  lib_fn, n_of(row, 200, 5)).items()} if lib_fn else {})}
             for row, fn, lib_fn in cases]
    if args.only in (None, "conv"):
        print(json.dumps({"tag": args.tag, **map_cost(), "card": card}),
              flush=True)
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    # fp32 convs and attention in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sums = {"graph_ms": 0.0, "library_graph_ms": 0.0}
    towers = {}                      # --only wgrad: a tower's sums
    try:
        for (row, fn, lib_fn), host in zip(cases, hosts):
            dgrad = row["kernel"] in ("K12 conv_dgrad", "K12 conv_wgrad",
                                      "K10 attention_bwd") \
                or row["kernel"].startswith(("K1 ", "K2 ", "K3 ", "K4 ",
                                             "K6 ", "K7 ", "K8 ", "K9 "))
            k_ms = kernel_ms(fn, n_of(row, 10, 3), by_name=dgrad)
            lib_ms = lib_fn and kernel_ms(lib_fn, by_name=dgrad)
            extra = {}
            if dgrad:
                k_ms, extra["kernel_names"] = k_ms
                extra["library_kernel_names"] = None
                if lib_ms:
                    lib_ms, extra["library_kernel_names"] = lib_ms
            out = {
                "tag": args.tag, **row,
                "ms": smoke.median_ms(fn, n_of(row, 20, 5)),
                "kernel_ms": k_ms,
                "graph_ms": None if row.get("autograd") else graph_ms(
                    fn, n_of(row, 20, 2), n_of(row, 10, 3)),
                **host,
                "library_ms": lib_fn and smoke.median_ms(
                    lib_fn, n_of(row, 20, 5)),
                "library_kernel_ms": lib_ms,
                "library_graph_ms": (None if id(lib_fn) in autograd_libs
                                     else lib_fn and graph_ms(
                                         lib_fn, n_of(row, 20, 2),
                                         n_of(row, 10, 3))), **extra,
                "routes": route_of(fn), "card": card}
            print(json.dumps(out), flush=True)
            n = row.get("per_forward", row.get("per_backward"))
            if row["kernel"].startswith("K12 conv_") and n:
                for key in sums:
                    sums[key] += out[key] * n
            for tower, n in row.get("calls", {}).items():
                t = towers.setdefault(tower, {"kernel": row["kernel"],
                                              "calls": 0, "graph_ms": 0.0,
                                              "library_graph_ms": 0.0})
                t["calls"] += n
                for key in ("graph_ms", "library_graph_ms"):
                    # a row without the time leaves its tower's sum out
                    t[key] = (None if t[key] is None or out[key] is None
                              else t[key] + out[key] * n)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    if args.only == "dpt":
        print(json.dumps({"tag": args.tag, "kernel": "K12 conv_fwd",
                          "dpt_convs_a_forward": sum(
                              r.get("per_forward", 0) for r, _, _ in cases
                              if r["kernel"] == "K12 conv_fwd"),
                          **sums, "card": card}), flush=True)
    if args.only in ("dpt_dgrad", "dpt_wgrad"):
        kind = args.only[4:]
        print(json.dumps({"tag": args.tag, "kernel": f"K12 conv_{kind}",
                          f"dpt_{kind}s_a_backward": sum(
                              r["per_backward"] for r, _, _ in cases),
                          **sums, "card": card}), flush=True)
    for tower, t in towers.items():
        print(json.dumps({"tag": args.tag, "tower": tower, **t,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
