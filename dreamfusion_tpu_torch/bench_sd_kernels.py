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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("conv", "dgrad", "attn", "gn",
                                       "gn_routes", "field", "dmtet"),
                    default=None, help="time only K12 (forwards and "
                    "dgrads), only K12's dgrads, only K10 (forwards and "
                    "the backward), only K11, K11 through every route "
                    "it could take, only K1 and K6, or only K7 and K8 (the "
                    "last three not in the default set)")
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

    def graph_ms(fn, calls=20, reps=10):
        """Device ms per call: `calls` calls captured in one CUDA graph,
        replayed between two events; the median of `reps` replays."""
        if fn is None:
            return None
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        del graph
        return statistics.median(times)

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
            [] if args.only in ("attn", "gn", "gn_routes", "field", "dmtet")
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
                                "dmtet")
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

    print(json.dumps({"tag": args.tag, "root": os.path.abspath(args.root),
                      "sources_sha256": sources_sha256(args.root),
                      "card": card}), flush=True)
    if args.only == "gn_routes":
        sweep_gn_routes(smoke, K11, kernels, graph_ms, dev, g, args.tag,
                        card)
        return
    if args.outputs:
        outs = {}
        for row, fn, _ in cases:
            if row["kernel"] == "K12 conv_dgrad":
                continue
            y = fn()
            key = json.dumps({k: row[k] for k in row if k != "gflop"})
            if row["kernel"].startswith(("K1 ", "K6 ", "K7 ", "K8 ")):
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
    hosts = [{**smoke.host_us(fn),
              **({f"library_{k}": v for k, v in smoke.host_us(lib_fn).items()}
                 if lib_fn else {})} for _, fn, lib_fn in cases]
    if args.only in (None, "conv"):
        print(json.dumps({"tag": args.tag, **map_cost(), "card": card}),
              flush=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # fp32 convs in full fp32
    try:
        for (row, fn, lib_fn), host in zip(cases, hosts):
            dgrad = row["kernel"] in ("K12 conv_dgrad", "K10 attention_bwd") \
                or row["kernel"].startswith(("K1 ", "K6 ", "K7 ", "K8 "))
            k_ms = kernel_ms(fn, by_name=dgrad)
            lib_ms = lib_fn and kernel_ms(lib_fn, by_name=dgrad)
            extra = {}
            if dgrad:
                k_ms, extra["kernel_names"] = k_ms
                extra["library_kernel_names"] = None
                if lib_ms:
                    lib_ms, extra["library_kernel_names"] = lib_ms
            print(json.dumps({
                "tag": args.tag, **row, "ms": smoke.median_ms(fn),
                "kernel_ms": k_ms, "graph_ms": graph_ms(fn), **host,
                "library_ms": lib_fn and smoke.median_ms(lib_fn),
                "library_kernel_ms": lib_ms,
                "library_graph_ms": (None if id(lib_fn) in autograd_libs
                                     else graph_ms(lib_fn)), **extra,
                "routes": route_of(fn), "card": card}), flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


if __name__ == "__main__":
    main()
