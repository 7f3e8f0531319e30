"""Where a training step's device time goes, on the GPU.

    python -m dreamfusion_tpu_torch.profile_step --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 \\
        --iters 40 --profile_steps 4
    python -m dreamfusion_tpu_torch.profile_step --text "a hamburger" \\
        --sd_version 1.5 --backbone triplane --seed 0 \\
        --lambda_3d_normal_smooth 0 --iters 40 --profile_steps 4
    python -m dreamfusion_tpu_torch.profile_step --guidance oracle \\
        --backbone grid --oracle_scene two_sphere --lr 0.01 --seed 0 \\
        --iters 300 --warmup_steps 20 --profile_steps 20
    python -m dreamfusion_tpu_torch.profile_step --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 --dmtet \\
        --lr 0.002 --tet_grid_size 128 --init_with ws/checkpoints \\
        --warmup_steps 5 --profile_steps 10     # the DMTet step under SD

Takes every flag of ``dreamfusion_tpu_torch.main``.  For each phase of the
run (the SD warm-up, then the main phase; the oracle and the DMTet stage
have only the main phase) it runs ``--warmup_steps`` steps unprofiled,
then ``--profile_steps`` steps under ``torch.profiler`` and prints, per
step: the host wall time (synchronised), the device's kernel time and busy
share (the union of the kernels' intervals over the wall time), and the
kernel time by group (the port's kernels K1-K12, matrix products,
everything else) and by name.  After the phases it profiles the guarded
Adan + EMA update alone, on a copy of the trained parameters with random
gradients: its aten kernels fall under "other" in the step's groups.
"""

from __future__ import annotations

import copy
import re
import time
from collections import defaultdict

import torch

from .main import build_parser, build_run, config_from_args, resolve_device
from .training.trainer import check_slice, guarded_update

GROUPS = [  # (group, kernel-name pattern), first match wins
    ("K7 raster", r"\b(raster|interpolate)_\w+_kernel"),
    ("K8 marching tets", r"\b(mt|vn|lap|nc)_\w+_kernel"),
    ("K12 conv", r"conv_\w*_kernel|conv_splitk_reduce|conv_wgrad_reduce"
                 r"|pad_channels8_kernel"),
    ("K5 clip_grad", r"\bclip_(f32|bf16)_kernel"),
    ("K10 attention", r"attn_"),
    ("K11 groupnorm", r"^(fwd_stats|fwd_apply|bwd_sums|bwd_apply)"
                      r"|\bgn_(resident|stream)_kernel"),
    ("K6 hashgrid", r"\bhash_\w+_kernel"),
    ("K1 triplane", r"triplane"),
    ("K2 march", r"march"),
    ("K3 composite", r"composite"),
    ("K4 field head", r"^(fwd|bwd)$|\bfield_(head|shade)_\w+_kernel"),
    ("matrix products", r"gemm|cutlass|xmma|nvjet|cublas|s\d+gemm|sm90"),
]


# a part of a group, printed under it: K12's input gradients (the wgmma
# route's dgrad instantiation, the narrow and fp32 dgrads, and the mma.sync
# and one-thread dgrads of any tree); the split-K reduces stay whole in K12;
# K10's forwards at SD 1.5's head dims (the kernel's d = 40, 80, 160
# instantiations)
PARTS = [("K12 conv", "of which input gradients",
          r"conv_wgmma_kernel<false, 128, true>|conv_dgrad_\w+_kernel"
          r"|conv_mma_kernel<true>|conv_simple_kernel<true>"),
         ("K10 attention", "of which d = 40, 80, 160 forwards",
          r"attn_fwd_wgmma_kernel<(40|80|160)>")]


# groups whose kernels are printed one by one under them
BY_KERNEL = ("K3 composite", "K4 field head", "K7 raster",
             "K8 marching tets")


def _kernel_name(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].split("::")[-1].split()[-1]


def part_of(name: str):
    for group, part, pat in PARTS:
        if re.search(pat, name):
            return group, part
    return None


def group_of(name: str) -> str:
    for g, pat in GROUPS:
        if re.search(pat, name):
            return g
    return "other (elementwise, reductions, copies)"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_phase(trainer, state, gen, n_steps: int, label: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            trainer.run_step(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"[profile] {label}: {n_steps} steps, wall {wall_ms:.3f} ms/step "
          f"(under the profiler)", flush=True)
    if not kern:
        print("[profile] the profiler recorded no device kernels", flush=True)
        return
    total = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n_steps
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kern]) / 1e3 / n_steps
    print(f"[profile] {label}: kernels {total:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step = {100 * busy / wall_ms:.1f}% of the wall, "
          f"{len(kern) / n_steps:.1f} device operations/step (kernels, "
          f"copies, fills)", flush=True)
    by_group, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    by_part = defaultdict(lambda: [0.0, 0])
    for e in kern:
        us = e.time_range.elapsed_us()
        by_group[group_of(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
        part = part_of(e.name)
        if part is not None:
            by_part[part][0] += us
            by_part[part][1] += 1
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}:   {g:<40s} {us / 1e3 / n_steps:9.3f} "
              f"ms/step {100 * us / 1e3 / n_steps / total:5.1f}%", flush=True)
        for (pg, part), (pus, n) in by_part.items():
            if pg == g:
                print(f"[profile] {label}:     {part:<38s} "
                      f"{pus / 1e3 / n_steps:9.3f} ms/step "
                      f"{n / n_steps:6.1f} launches/step", flush=True)
        if g in BY_KERNEL:
            for name, (kus, n) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][0]):
                if group_of(name) == g:
                    print(f"[profile] {label}:     {_kernel_name(name):<38s} "
                          f"{kus / 1e3 / n_steps:9.3f} ms/step "
                          f"{n / n_steps:6.1f} launches/step", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"[profile] {label}:     {us / 1e3 / n_steps:8.3f} ms/step "
              f"{n / n_steps:6.1f} launches/step  {name[:90]}", flush=True)


def profile_update(trainer, state, n: int = 10) -> None:
    """The guarded Adan + EMA update of every parameter, alone: wall and
    kernel ms per update, on copies of the module, moments and EMA."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    module = copy.deepcopy(trainer.module(state))
    opt, ema = copy.deepcopy(state.opt_state), copy.deepcopy(state.ema_params)
    g = torch.Generator(device=trainer.device).manual_seed(0)
    grads = [torch.randn(p.shape, device=p.device, generator=g) * 1e-3
             for p in module.parameters()]
    for _ in range(2):
        guarded_update(trainer.optimizer, trainer.cfg, module, opt, ema, grads)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            guarded_update(trainer.optimizer, trainer.cfg, module, opt, ema,
                           grads)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
    numel = sum(p.numel() for p in module.parameters())
    print(f"[profile] Adan + EMA alone ({numel} parameters): wall "
          f"{wall_ms:.3f} ms/update, kernels {ms:.3f} ms/update, "
          f"{len(kern) / n:.0f} launches/update", flush=True)


def main(argv=None) -> None:
    p = build_parser()
    p.add_argument("--warmup_steps", type=int, default=3)
    p.add_argument("--profile_steps", type=int, default=4)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    check_slice(cfg)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("the profile measures the GPU; it needs --device "
                           "cuda")
    trainer, state, gen = build_run(cfg, device, args.tiny_guidance)
    n = args.warmup_steps + args.profile_steps
    phases = ["main phase"]
    if trainer.latent_phase(n - 1):
        phases.insert(0, "warm-up (render as latent)")
    for label in phases:
        while label == "main phase" and trainer.latent_phase(state.step):
            trainer.run_step(state, gen)
        for _ in range(args.warmup_steps):
            trainer.run_step(state, gen)
        torch.cuda.reset_peak_memory_stats()
        profile_phase(trainer, state, gen, args.profile_steps, label)
        print(f"[profile] {label}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    profile_update(trainer, state)


if __name__ == "__main__":
    main()
