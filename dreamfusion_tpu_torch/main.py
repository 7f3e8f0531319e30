"""CLI entry point of the port's training runs.

    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 \\
        --iters 10000 --workspace ws                  # SD 2.1 guidance
    python -m dreamfusion_tpu_torch.main --guidance oracle \\
        --backbone triplane --oracle_scene two_sphere --iters 10000 \\
        --lr 0.01 --seed 0 --lambda_3d_normal_smooth 0 --workspace ws

Every ``Config`` field is a flag, as in ``dreamfusion_tpu.main``.  The run
goes on the GPU; ``--device cpu`` asks for the CPU (the kernels' plain
versions).  SD guidance runs its towers at full SD 2.1 width with random
weights drawn from the seed (no pretrained weights ship with the
repository); ``--tiny_guidance`` uses the test-size towers.  The prompt
embeddings are computed once at start-up.  The run logs loss and it/s
every ``dataset_size_train`` steps; under ``--guidance oracle`` it also
prints the analytic-scene PSNR of the EMA weights at the start and at the
end.  Flags of parts not ported yet raise NotImplementedError naming the
ROADMAP item.  Checkpoints, eval and test video and mesh export are not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from dataclasses import replace
from typing import Any, Dict

import torch

from .config import Config, finalize
from .guidance.embeddings import prepare_text_embeddings
from .guidance.sd import SDConfig, StableDiffusionGuidance
from .training.trainer import Trainer, check_slice, draw_grid

_NONE_DEFAULT_TYPES = {"text": str, "seed": int, "image": str,
                       "exp_start_iter": int, "exp_end_iter": int}
_NOT_PORTED = {"-O": "queue 1, item 5", "-O2": "queue 1, item 5",
               "--IF": "queue 1, item 7", "--gui": "queue 1, item 8",
               "--profile": "queue 1, item 8"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dreamfusion_tpu_torch")
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name == "guidance":
            continue
        v = getattr(defaults, f.name)
        arg = f"--{f.name}"
        if isinstance(v, bool):
            p.add_argument(arg, nargs="?", const=True, default=None,
                           type=lambda s: s.lower() in ("1", "true", "yes"))
        elif isinstance(v, tuple):
            p.add_argument(arg, type=float, nargs="+", default=None)
        elif v is None:
            p.add_argument(arg, type=_NONE_DEFAULT_TYPES[f.name], default=None)
        else:
            p.add_argument(arg, type=type(v), default=None)
    p.add_argument("--guidance", type=str, nargs="*", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--tiny_guidance", action="store_true",
                   help="test-size random guidance towers")
    for flag in _NOT_PORTED:
        p.add_argument(flag, action="store_true")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag.lstrip("-")):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    overrides: Dict[str, Any] = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = tuple(v) if isinstance(v, list) else v
    return finalize(replace(Config(), **overrides))


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a card is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the "
            "CPU (the kernels' plain versions)")
    return device


def build_sd_guidance(cfg: Config, tiny: bool, device, seed: int):
    """SD 2.1 towers with random weights drawn on the device from the
    seed, and the prompt embeddings (computed once)."""
    sdc = SDConfig(sd_version=cfg.sd_version, t_range=cfg.t_range, tiny=tiny,
                   image_size=16 if tiny else 512,
                   latent_size=8 if tiny else 64)
    guidance = StableDiffusionGuidance(sdc, device)
    guidance.init_params(torch.Generator(device=device).manual_seed(seed))
    emb = prepare_text_embeddings(guidance, cfg.text or "", cfg.negative)
    return guidance, emb


def build_run(cfg: Config, device, tiny_guidance: bool, log=print):
    """The trainer, its state and the step generator of a run."""
    seed = cfg.seed or 0
    guidance = emb = None
    if cfg.guidance != ("oracle",):
        t_g = time.time()
        guidance, emb = build_sd_guidance(cfg, tiny_guidance, device, seed)
        log(f"[startup] SD {cfg.sd_version} guidance "
            f"({'tiny' if tiny_guidance else 'full width'}, random "
            f"weights) and embeddings in {time.time() - t_g:.1f} s")
    trainer = Trainer(cfg, device, guidance, emb)
    state = trainer.init_state(seed)
    return trainer, state, torch.Generator(device=device).manual_seed(seed)


def run_step(trainer: Trainer, state, gen: torch.Generator):
    """One training step at state.step, with the density-grid refresh on
    its cadence → (metrics, gradients)."""
    cfg = trainer.cfg
    if state.step % cfg.update_extra_interval == 0:
        trainer.update_grid(state, draw_grid(gen, cfg, trainer.device))
    return trainer.train_step(state, trainer.draw_step(gen))


def main(argv=None) -> Dict[str, Any]:
    """Train; returns a summary (logged losses, rates, grad_ok and, under
    the oracle, the PSNRs)."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    check_slice(cfg)
    device = resolve_device(args.device)
    os.makedirs(cfg.workspace, exist_ok=True)
    log_path = os.path.join(cfg.workspace, "log_df.txt")

    def log(msg: str) -> None:
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(msg + "\n")

    oracle = cfg.guidance == ("oracle",)
    trainer, state, gen = build_run(cfg, device, args.tiny_guidance, log)
    if oracle:
        psnr0 = trainer.oracle_eval_metric(state)
        log(f"[eval] step 0 oracle PSNR {psnr0:.4f} dB")

    ok = torch.ones((), dtype=torch.bool, device=device)
    losses, blocks, tri_grad = [], [], []
    tri = [i for i, (n, _) in enumerate(state.renderer.named_parameters())
           if "triplanes" in n]
    t0 = t_blk = time.time()
    s_blk = 0
    for step in range(cfg.iters):
        metrics, grads = run_step(trainer, state, gen)
        ok &= metrics["grad_ok"]
        tri_grad.append(torch.stack([grads[i].abs().max() for i in tri]).max())
        done = step + 1
        if done % cfg.dataset_size_train == 0 or done == cfg.iters:
            loss = float(metrics["loss"])          # waits for the device
            now = time.time()
            rate = (done - s_blk) / (now - t_blk)
            losses.append(loss)
            blocks.append((done - s_blk, now - t_blk))
            t_blk, s_blk = now, done
            log(f"[step {done}/{cfg.iters}] loss={loss:.4f} "
                f"mean_density={float(state.mean_density):.3f} "
                f"({done / (now - t0):.2f} it/s avg, {rate:.2f} block)")
    steady = blocks[1:] or blocks
    steady_its = sum(n for n, _ in steady) / sum(t for _, t in steady)
    log(f"[train] steady {steady_its:.3f} it/s over "
        f"{sum(n for n, _ in steady)} steps after the first block")
    summary = {"losses": losses, "steady_its": steady_its, "blocks": blocks,
               "grad_ok": bool(ok),
               "all_losses_finite": all(math.isfinite(l) for l in losses),
               # per step: largest |d loss / d triplanes| and the phase
               "triplane_grad_max": torch.stack(tri_grad).tolist(),
               "latent_phase": [trainer.latent_phase(s)
                                for s in range(cfg.iters)],
               "steps": cfg.iters, "device": str(device)}
    if oracle:
        psnr1 = trainer.oracle_eval_metric(state)
        log(f"[eval] step {cfg.iters} oracle PSNR {psnr1:.4f} dB")
        summary.update(psnr_init=psnr0, psnr_final=psnr1)
    return summary


if __name__ == "__main__":
    main()
