"""CLI entry point of the port's training runs.

    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 \\
        --iters 10000 --workspace ws                  # SD 2.1 guidance
    python -m dreamfusion_tpu_torch.main --guidance oracle \\
        --backbone triplane --oracle_scene two_sphere --iters 10000 \\
        --lr 0.01 --seed 0 --lambda_3d_normal_smooth 0 --save_mesh \\
        --ckpt scratch --workspace ws                 # stage 1
    python -m dreamfusion_tpu_torch.main --guidance oracle \\
        --backbone triplane --dmtet --init_with ws/checkpoints --lr 0.002 \\
        --iters 5000 --save_mesh --workspace ws_dmtet  # stage 2 (DMTet)

Every ``Config`` field is a flag, as in ``dreamfusion_tpu.main``; ``--dmtet``
applies the DMTet preset (``config.apply_dmtet``).  The run goes on the GPU;
``--device cpu`` asks for the CPU (the kernels' plain versions).  SD
guidance runs its towers at full SD 2.1 width with random weights drawn
from the seed (no pretrained weights ship with the repository);
``--tiny_guidance`` uses the test-size towers.

A run resumes from ``--ckpt`` (default ``latest``; ``scratch`` starts
afresh), logs loss and it/s every ``dataset_size_train`` steps (an epoch),
evaluates every ``eval_interval`` epochs (validation PNGs at H×W, the
EMA-only ``df`` checkpoint kept best by the metric) and saves the rolling
checkpoint every ``save_interval`` epochs; the block rates leave out the
time of evals and saves.  It ends with the turntable video (or PNG frames)
and, with ``--save_mesh``, ``mesh/mesh.obj`` with its albedo texture.
``--test`` renders and exports from the checkpoint without training.
Under ``--guidance oracle`` it also logs the analytic-scene PSNR of the EMA
weights at the start and the end.  Flags of parts not ported yet raise
NotImplementedError naming the ROADMAP item.
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

from .config import Config, apply_dmtet, finalize
from .guidance.embeddings import prepare_text_embeddings
from .guidance.sd import SDConfig, StableDiffusionGuidance
from .mesh.export import export_mesh
from .training.dmtet_trainer import DMTetTrainer
from .training.trainer import Trainer, check_slice
from .utils.device import resolve_device

TEX_RES = 1024        # the exported albedo texture's side

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
    cfg = replace(Config(), **overrides)
    return finalize(apply_dmtet(cfg) if cfg.dmtet else cfg)


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
    if cfg.dmtet:
        trainer = DMTetTrainer(cfg, device)
        state = trainer.init_state(seed, cfg.init_with)
        return trainer, state, torch.Generator(device=device).manual_seed(seed)
    guidance = emb = None
    if cfg.guidance != ("oracle",) and not cfg.test:
        t_g = time.time()
        guidance, emb = build_sd_guidance(cfg, tiny_guidance, device, seed)
        log(f"[startup] SD {cfg.sd_version} guidance "
            f"({'tiny' if tiny_guidance else 'full width'}, random "
            f"weights) and embeddings in {time.time() - t_g:.1f} s")
    trainer = Trainer(cfg, device, guidance, emb)
    state = trainer.init_state(seed)
    return trainer, state, torch.Generator(device=device).manual_seed(seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> Dict[str, Any]:
    """Train (or, with --test, only render and export); returns a summary:
    logged losses, block rates, grad_ok, per-step gradient maxima, the
    wall seconds of the run's end (``phases``) and, under the oracle, the
    PSNRs; a DMTet run adds its face counts and regularizer values."""
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
    if cfg.ckpt != "scratch":
        state, loaded = trainer.load_checkpoint(state, cfg.ckpt)
        if loaded:
            log(f"[ckpt] resumed from step {state.step}")
    summary: Dict[str, Any] = {"device": str(device), "steps": cfg.iters,
                               "phases": {}}
    phases = summary["phases"]

    def timed(name: str, fn, *a, **kw):
        t = time.time()
        out = fn(*a, **kw)
        _sync(device)
        phases[name] = phases.get(name, 0.0) + time.time() - t
        return out

    def finish(six_views: bool = False) -> Dict[str, Any]:
        timed("test", trainer.test, state, six_views=six_views)
        if cfg.save_mesh:
            ex: Dict[str, float] = {}
            summary["mesh_path"] = timed(
                "export", export_mesh, trainer, state,
                os.path.join(cfg.workspace, "mesh"),
                resolution=cfg.mcubes_resolution,
                decimate_target=cfg.decimate_target, tex_res=TEX_RES,
                phases=ex)
            summary["export_phases"] = ex
        log(f"[end] phases (s): "
            f"{ {k: round(v, 3) for k, v in phases.items()} }")
        return summary

    if cfg.test:
        return finish(cfg.six_views)

    if oracle:
        psnr0 = trainer.oracle_eval_metric(state)
        log(f"[eval] step {state.step} oracle PSNR {psnr0:.4f} dB")
        summary["psnr_init"] = psnr0

    ok = torch.ones((), dtype=torch.bool, device=device)
    losses, blocks, grad_max, extra = [], [], [], []
    names = [n for n, _ in trainer.module(state).named_parameters()]
    # per step, the largest |gradient| of each watched group
    groups = {"triplane": [i for i, n in enumerate(names)
                           if "triplanes" in n]}
    if cfg.dmtet:
        groups.update(sdf=[names.index("geo.sdf")],
                      deform=[names.index("geo.deform")])
    t0 = t_blk = time.time()
    s_blk = start = state.step
    for _ in range(start, cfg.iters):
        metrics, grads = trainer.run_step(state, gen)
        ok &= metrics["grad_ok"]
        grad_max.append(torch.stack([
            torch.stack([grads[i].abs().max() for i in idx]).max()
            for idx in groups.values()]))
        if cfg.dmtet:
            extra.append(torch.stack([metrics["n_faces"].float(),
                                      metrics["normal_loss"],
                                      metrics["lap_loss"]]))
        done = state.step
        if done % cfg.dataset_size_train == 0 or done == cfg.iters:
            loss = float(metrics["loss"])          # waits for the device
            now = time.time()
            rate = (done - s_blk) / (now - t_blk)
            losses.append(loss)
            blocks.append((done - s_blk, now - t_blk))
            log(f"[step {done}/{cfg.iters}] loss={loss:.4f} "
                f"({(done - start) / (now - t0):.2f} it/s avg, {rate:.2f} "
                f"block)")
            epoch = trainer.epoch(state)
            if cfg.eval_interval > 0 and epoch % cfg.eval_interval == 0:
                metric = timed("eval", trainer.evaluate, state)
                timed("save", trainer.save_checkpoint, state, full=False,
                      metric=metric)
            if epoch % max(cfg.save_interval, 1) == 0 or done == cfg.iters:
                timed("save", trainer.save_checkpoint, state)
            # the block rates leave out evals and saves
            t_blk, s_blk = time.time(), done
    n_run = state.step - start
    if blocks:
        steady = blocks[1:] or blocks
        summary["steady_its"] = sum(n for n, _ in steady) / \
            sum(t for _, t in steady)
        log(f"[train] steady {summary['steady_its']:.3f} it/s over "
            f"{sum(n for n, _ in steady)} steps after the first block")
    gm = torch.stack(grad_max).tolist() if grad_max else []
    summary.update(
        losses=losses, blocks=blocks, grad_ok=bool(ok),
        all_losses_finite=all(math.isfinite(l) for l in losses),
        latent_phase=[trainer.latent_phase(s) for s in range(start,
                                                             cfg.iters)],
        steps_run=n_run,
        **{f"{g}_grad_max": [row[k] for row in gm]
           for k, g in enumerate(groups)})
    if cfg.dmtet and extra:
        ex = torch.stack(extra).tolist()
        summary.update(n_faces=[int(r[0]) for r in ex],
                       normal_loss=[r[1] for r in ex],
                       lap_loss=[r[2] for r in ex],
                       max_tris=trainer.dmtet_renderer.max_tris)
    if oracle:
        psnr1 = trainer.oracle_eval_metric(state)
        log(f"[eval] step {state.step} oracle PSNR {psnr1:.4f} dB")
        summary["psnr_final"] = psnr1
    return finish()


if __name__ == "__main__":
    main()
