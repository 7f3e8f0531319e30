"""CLI entry point of the port's training runs.

    python -m dreamfusion_tpu_torch.main --text "a hamburger" -O \\
        --workspace ws                 # SD 2.1 guidance, hash-grid backbone
    python -m dreamfusion_tpu_torch.main --text "a hamburger" -O2 \\
        --workspace ws                 # SD 2.1 guidance, vanilla backbone
    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --sd_version 1.5 --backbone triplane --seed 0 \\
        --lambda_3d_normal_smooth 0 --workspace ws    # SD 1.5 guidance
    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 \\
        --iters 10000 --workspace ws                  # triplane backbone
    python -m dreamfusion_tpu_torch.main --guidance oracle \\
        --backbone grid --oracle_scene two_sphere --iters 10000 \\
        --lr 0.01 --seed 0 --lambda_3d_normal_smooth 0 --save_mesh \\
        --ckpt scratch --workspace ws                 # stage 1
    python -m dreamfusion_tpu_torch.main --guidance oracle \\
        --backbone grid --dmtet --init_with ws/checkpoints --lr 0.002 \\
        --iters 5000 --save_mesh --workspace ws_dmtet  # stage 2 (DMTet)
    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --backbone triplane --seed 0 --lambda_3d_normal_smooth 0 --dmtet \\
        --init_with ws/checkpoints --lr 0.002 --save_mesh \\
        --workspace ws_dmtet_sd        # stage 2 under SD (512² VAE encode)
    python -m dreamfusion_tpu_torch.main --image analytic:two_sphere \\
        --guidance image_oracle --guidance_scale 1.0 --lr 0.01 \\
        --backbone triplane --seed 0 --save_mesh --ckpt scratch \\
        --workspace ws_img                            # image → 3D, stage 1
    python -m dreamfusion_tpu_torch.main --image analytic:two_sphere \\
        --guidance image_oracle --backbone triplane --dmtet \\
        --init_with ws_img/mesh/mesh.obj --lr 0.002 --save_mesh \\
        --workspace ws_img_dmtet          # stage 2 from the exported mesh
    python -m dreamfusion_tpu_torch.main --image ref_rgba.png \\
        --backbone triplane --seed 0 --workspace ws_z123   # zero123
    python -m dreamfusion_tpu_torch.main --image ref_rgba.png \\
        --image_config refs.csv --backbone triplane \\
        --workspace ws_z123k                # zero123 over K references
    python -m dreamfusion_tpu_torch.main --image ref_rgba.png \\
        --backbone triplane --dmtet --init_with ws_img/checkpoints \\
        --lr 0.002 --workspace ws_z123_dmtet    # DMTet under zero123
    python -m dreamfusion_tpu_torch.main --image ref_rgba.png \\
        --text "a hamburger" --backbone triplane \\
        --workspace ws_it                   # image + text: SD + CLIP
    python -m dreamfusion_tpu_torch.main --text "a hamburger" --IF \\
        --fp16 true --backbone triplane --workspace ws_if   # DeepFloyd-IF
    python -m dreamfusion_tpu_torch.main --image_config refs.csv \\
        --text "a hamburger" --guidance SD zero123 clip \\
        --backbone triplane --workspace ws_multi    # three priors summed
    python -m dreamfusion_tpu_torch.main --text "a hamburger" \\
        --backbone triplane --save_guidance --save_guidance_interval 1 \\
        --workspace ws_snap           # guidance/step_*_SD.png triptychs

Every ``Config`` field is a flag, as in ``dreamfusion_tpu.main``; ``-O``
applies the fp16 + hash-grid preset after the flags (``config.apply_O``),
``-O2`` the fp16 + vanilla-backbone + progressive-level preset
(``config.apply_O2``: the frequency-encoded ResMLP field, rendered by the
sphere-bounded coarse + importance-resampled march),
``--IF`` DeepFloyd-IF guidance in SD's place (``config.apply_IF``: IF-I-XL
at full width, the prompts' T5 states from ``--pretrained_root``'s T5, or
JAX's md5-seeded stand-ins without one; ``guidance/deepfloyd.py``),
``--image`` without ``--text`` the image preset (``config.apply_image_mode``,
which overrides the command line's lambdas unless ``--dont_override_stuff``)
and with ``--text`` the image + text preset (SD + CLIP guidance,
``config.apply_image_text_mode``), ``--dmtet`` the DMTet preset
(``config.apply_dmtet``), in that order.  ``--guidance`` names any set of
the priors SD, IF, zero123, clip, oracle and image_oracle; their losses are
summed in sorted name order, each with its own draws, as JAX sums them.
``clip`` is CLIP guidance (``guidance/clip.py``: ViT-B/16 at full width,
the render's gradient through it); a text run scores its evals with CLIP
where a CLIP tower is at hand (``install_clip_scorer``).
``--image analytic:<scene>`` with ``--guidance image_oracle`` is the
weight-free image → 3D run: the reference image is the analytic scene's
default view (``training/image_data.py``), the prior the image oracle
(``guidance/oracle.py``), and every ``known_view_interval``-th step a
known-view step.  ``--image file.png`` (an RGBA PNG) without ``--text``
is Zero-1-to-3 guidance (``guidance/zero123.py``) toward that reference;
``--image_config refs.csv`` gives K references with their poses and
weights (``training/image_data.py``; with ``--image`` for the image
preset, or alone beside any ``--guidance``: its known-view steps train
with every prior, as ``--image file.png`` does beside ``--guidance
oracle``).  The run goes on the GPU;
``--device cpu`` asks for the CPU (the kernels' plain versions).  SD
guidance runs its towers at the full width of ``--sd_version`` (2.1 by
default; 1.5: CLIP-L and the 8-head UNet), zero123 at its own (SD 1.5's
UNet on 8 channels, the VAE at 256², CLIP ViT-L/14), with random weights
drawn from the seed, or with ``--pretrained_root`` the converted weights
in its ``<tower>.npz`` files (``clip.npz`` for CLIP), or a raw diffusers
directory or CompVis / zero123 ``.ckpt`` converted on the fly
(``utils/raw_weights.py``), and CLIP's tokenizer from its ``vocab.json``
and ``merges.txt`` (no weights ship with the repository);
``--tiny_guidance`` uses the test-size towers.

A run resumes from ``--ckpt`` (default ``latest``; ``scratch`` starts
afresh), logs loss and it/s every ``dataset_size_train`` steps (an epoch),
evaluates every ``eval_interval`` epochs (validation PNGs at H×W, the
EMA-only ``df`` checkpoint kept best by the metric) and saves the rolling
checkpoint every ``save_interval`` epochs; with ``--save_guidance``, after
the eval of every ``save_guidance_interval``-th epoch, a triptych of the
default view per diffusion prior (``Trainer.save_guidance_snapshot``:
render | noised | one-step denoised, ``guidance/step_*_<prior>.png``); the
block rates leave out the time of evals, snapshots and saves.  It ends
with the turntable video (or PNG frames) and, with ``--save_mesh``,
``mesh/mesh.obj`` with its albedo texture.
``--test`` renders and exports from the checkpoint without training.
Under the oracles it also logs the analytic-scene PSNR of the EMA weights at
the start and the end, and under ``--image`` (stage 1) the known-view masked
PSNR.  A DMTet run logs when its surface outgrew the marching tets' face
cap (the cap then grows) or K7's tile cap, and reports the steps that
dropped faces or cut a tile's list, and the eval and test views whose
fullest tile passed K7's cap (``view_tile_cut``).  What JAX refuses
(zero123 without a reference, the image oracle without ``--image
analytic:<scene>``) raises ValueError.

The run writes ``config.json`` to its workspace and, where tensorboardX
imports and ``--use_tensorboard`` is on (the default), the loss and the
SDS loss at each log step under ``run/``.  ``--profile`` traces the first
epoch with ``torch.profiler`` into ``profile/trace.json`` (Chrome's trace
format) and logs its device time by kernel group
(``profile_step.GROUPS``).  ``--gui`` serves the browser viewer
(``viewer.py``) on the run's state instead of training, on port
``DFTPU_VIEWER_PORT`` (7860), with "train" where the run has guidance.
JAX's flag surface parses: ``--file args.txt`` splices a file's flags in,
``--radius`` and ``--fovy`` set ``default_radius`` and ``default_fovy``,
and ``--cuda_ray``, ``--taichi_ray`` and ``--max_spp`` are accepted and do
nothing, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from dataclasses import replace
from typing import Any, Dict

import torch

from .config import (Config, apply_dmtet, apply_IF, apply_image_mode,
                     apply_image_text_mode, apply_O, apply_O2, finalize,
                     save_config_json)
from .guidance.clip import CLIPConfig, CLIPGuidance
from .guidance.deepfloyd import IFConfig, IFGuidance
from .guidance.embeddings import prepare_text_embeddings
from .guidance.sd import SDConfig, StableDiffusionGuidance
from .guidance.zero123 import Zero123Config, Zero123Guidance
from .mesh.export import export_mesh
from .training.dmtet_trainer import DMTetTrainer
from .training.image_data import analytic_ref_images, load_ref_images
from .training.trainer import Trainer, check_slice
from .utils.device import resolve_device

TEX_RES = 1024        # the exported albedo texture's side

_NONE_DEFAULT_TYPES = {"text": str, "seed": int, "image": str,
                       "image_config": str, "exp_start_iter": int,
                       "exp_end_iter": int, "pretrained_root": str,
                       "zero123_config": str, "zero123_ckpt": str,
                       "hf_key": str, "learned_embeds_path": str,
                       "ckpt_extra": str}


class FileArgs(argparse.Action):
    """``--file args.txt`` splices in the flags the file holds."""

    def __call__(self, parser, namespace, values, option_string=None):
        with open(values) as f:
            extra = f.read().split()
        parser.parse_args(extra, namespace)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dreamfusion_tpu_torch")
    defaults = Config()
    p.add_argument("--file", type=str, action=FileArgs, help="args file")
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
    p.add_argument("-O", action="store_true",
                   help="fp16 and the hash-grid backbone")
    p.add_argument("-O2", action="store_true",
                   help="fp16, the vanilla backbone and progressive levels")
    p.add_argument("--IF", action="store_true",
                   help="DeepFloyd-IF guidance in SD's place")
    p.add_argument("--gui", action="store_true",
                   help="serve the browser orbit viewer on the run's state")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch "
                        "under workspace/profile")
    # the JAX CLI's compatibility flags: accepted, no effect
    p.add_argument("--cuda_ray", action="store_true",
                   help="no effect (occupancy marching is built in)")
    p.add_argument("--taichi_ray", action="store_true",
                   help="no effect (occupancy marching is built in)")
    p.add_argument("--max_spp", type=int, default=None,
                   help="no effect (the viewer renders a full frame)")
    p.add_argument("--radius", type=float, default=None,
                   help="sets default_radius")
    p.add_argument("--fovy", type=float, default=None,
                   help="sets default_fovy")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    overrides: Dict[str, Any] = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = tuple(v) if isinstance(v, list) else v
    # --radius and --fovy set default_radius and default_fovy (the alias
    # wins over both given, as in JAX)
    for alias, field in (("radius", "default_radius"),
                         ("fovy", "default_fovy")):
        if getattr(args, alias, None) is not None:
            if field in overrides:
                print(f"[warn] both --{alias} and --{field} given; "
                      f"--{alias} wins", file=sys.stderr)
            overrides[field] = getattr(args, alias)
    cfg = replace(Config(), **overrides)
    if args.O:
        cfg = apply_O(cfg)
    if args.O2:
        cfg = apply_O2(cfg)
    if args.IF:
        cfg = apply_IF(cfg)
    if cfg.image is not None:
        cfg = apply_image_mode(cfg) if cfg.text is None else \
            apply_image_text_mode(cfg)
    return finalize(apply_dmtet(cfg) if cfg.dmtet else cfg)


def _counts(towers) -> Dict[str, float]:
    return {k: sum(p.numel() for p in t.parameters()) / 1e6
            for k, t in towers.items()}


def build_sd_guidance(cfg: Config, tiny: bool, device, seed: int):
    """The SD towers of ``cfg.sd_version`` (2.x or 1.x), with the
    converted weights of ``--pretrained_root`` (full width) or random
    weights drawn on the device from the seed, and the prompt embeddings
    (computed once)."""
    sdc = SDConfig(sd_version=cfg.sd_version, t_range=cfg.t_range, tiny=tiny,
                   image_size=16 if tiny else 512,
                   latent_size=8 if tiny else 64)
    guidance = StableDiffusionGuidance(sdc, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.pretrained_root and not tiny:
        guidance.load_pretrained(cfg.pretrained_root, gen)
    else:
        guidance.init_params(gen)
    emb = prepare_text_embeddings(guidance, cfg.text or "", cfg.negative,
                                  cfg.pretrained_root)
    return guidance, emb


def build_if_guidance(cfg: Config, tiny: bool, device, seed: int,
                      log=print):
    """DeepFloyd-IF's UNet (IF-I-XL at full width, bf16 under ``--fp16``;
    converted weights of ``--pretrained_root``, else random from the seed)
    and the prompt embeddings, computed once: through the T5 tower where
    the root holds one, which is freed before the first step, else JAX's
    md5-seeded stand-ins → (guidance, embeddings, the start-up seconds)."""
    t0 = time.time()
    pdt = torch.bfloat16 if cfg.fp16 and not tiny else torch.float32
    guidance = IFGuidance(IFConfig(t_range=cfg.t_range, tiny=tiny), device,
                          pdt)
    _sync(device)
    startup = {"allocate": time.time() - t0}
    gen = torch.Generator(device=device).manual_seed(seed)
    pretrained = bool(cfg.pretrained_root) and not tiny
    startup.update(guidance.load_pretrained(cfg.pretrained_root, gen, log)
                   if pretrained else guidance.init_params(gen))
    n = _counts(guidance.towers())
    t5 = f", T5 {n['t5']:.2f}M, freed" if "t5" in n else ""
    t0 = time.time()
    emb = guidance.prepare_embeddings(cfg.text or "", cfg.negative)
    _sync(device)
    startup["embeddings"] = time.time() - t0
    guidance.free_t5()
    log(f"[startup] DeepFloyd-IF guidance ({'tiny' if tiny else 'IF-I-XL'}, "
        f"{'converted' if pretrained else 'random'} weights: UNet "
        f"{n['unet']:.2f}M parameters{t5}); prompts "
        f"{'by T5' if t5 else 'by the md5 stand-in (no T5)'}; "
        f"seconds: { {k: round(v, 3) for k, v in startup.items()} }")
    return guidance, emb, startup


def build_zero123_guidance(cfg: Config, tiny: bool, device, seed: int,
                           ref, log=print):
    """Zero123's towers (converted weights of ``--pretrained_root`` at full
    width, else random from the seed) and the reference images'
    embeddings (computed once) → (guidance, embeddings, the start-up
    seconds: the towers' allocation, each tower's weights, the
    embeddings)."""
    t0 = time.time()
    guidance = Zero123Guidance(Zero123Config(
        t_range=cfg.t_range, tiny=tiny,
        grad_scale_mode=cfg.zero123_grad_scale), device)
    _sync(device)
    startup = {"allocate": time.time() - t0}
    gen = torch.Generator(device=device).manual_seed(seed)
    startup.update(guidance.load_pretrained(cfg.pretrained_root, gen)
                   if cfg.pretrained_root and not tiny
                   else guidance.init_params(gen))
    t0 = time.time()
    emb = guidance.prepare_image_embeddings(ref.rgb, ref.polars,
                                            ref.azimuths, ref.radii,
                                            ref.weights)
    _sync(device)
    startup["embeddings"] = time.time() - t0
    n = _counts(guidance.towers())
    log(f"[startup] zero123 guidance ({'tiny' if tiny else 'full width'}, "
        f"{'converted' if cfg.pretrained_root and not tiny else 'random'} "
        f"weights: UNet {n['unet']:.2f}M, VAE {n['vae']:.2f}M, vision "
        f"{n['vision']:.2f}M, cc_projection {n['cc_projection']:.3f}M "
        f"parameters); seconds: "
        f"{ {k: round(v, 3) for k, v in startup.items()} } "
        f"({len(ref.polars)} reference{'s' if len(ref.polars) > 1 else ''})")
    return guidance, emb, startup


def build_clip_guidance(cfg: Config, tiny: bool, device, seed: int, ref,
                        log=print):
    """CLIP guidance's towers (ViT-B/16 and the 12-layer text tower at full
    width; ``root/clip.npz`` of ``--pretrained_root``, else random from the
    seed) and its targets: the prompt's embedding and, with reference
    images, the first one's → (guidance, targets)."""
    t0 = time.time()
    clip = CLIPGuidance(CLIPConfig(tiny=tiny), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.pretrained_root and not tiny:
        clip.load_pretrained(cfg.pretrained_root, gen)
    else:
        clip.init_params(gen)
    clip_z = clip.prepare_embeddings(
        cfg.text or None, None if ref is None else ref.rgb[0],
        cfg.pretrained_root)
    n = _counts({"vision": clip.vision, "text": clip.text})
    log(f"[startup] CLIP guidance ({'tiny' if tiny else 'ViT-B/16'}, "
        f"{'converted' if cfg.pretrained_root and not tiny else 'random'} "
        f"weights: vision {n['vision']:.2f}M, text {n['text']:.2f}M "
        f"parameters; targets {sorted(clip_z)}) in {time.time() - t0:.1f} s")
    return clip, clip_z


def build_priors(cfg: Config, device, tiny: bool, seed: int, ref,
                 log=print):
    """The towers and embeddings of every prior ``--guidance`` names that
    has weights (SD, IF, zero123, CLIP; the trainer builds the oracles),
    each from the seed → ({name: (guidance, embeddings)}, the start-up
    seconds)."""
    priors, startup = {}, {}
    if cfg.test:
        return priors, startup
    # each prior's seconds under its own name where several are built
    several = len(set(cfg.guidance) & {"SD", "IF", "zero123"}) > 1

    def add(name, seconds):
        startup.update({(f"{name}_{k}" if several else k): v
                        for k, v in seconds.items()})
    if "SD" in cfg.guidance:
        t_g = time.time()
        guidance, emb = build_sd_guidance(cfg, tiny, device, seed)
        priors["SD"] = (guidance, emb)
        startup["towers_and_embeddings"] = time.time() - t_g
        n = _counts(guidance.towers())
        log(f"[startup] SD {cfg.sd_version} guidance "
            f"({'tiny' if tiny else 'full width'}, "
            f"{'converted' if cfg.pretrained_root and not tiny else 'random'}"
            f" weights: UNet {n['unet']:.2f}M, VAE {n['vae']:.2f}M, text "
            f"{n['text']:.2f}M parameters) and embeddings in "
            f"{time.time() - t_g:.1f} s")
    if "IF" in cfg.guidance:
        guidance, emb, s = build_if_guidance(cfg, tiny, device, seed, log)
        priors["IF"] = (guidance, emb)
        add("IF", s)
    if "zero123" in cfg.guidance:
        guidance, emb, s = build_zero123_guidance(cfg, tiny, device, seed,
                                                  ref, log)
        priors["zero123"] = (guidance, emb)
        add("zero123", s)
    if "clip" in cfg.guidance:
        t_g = time.time()
        priors["clip"] = build_clip_guidance(cfg, tiny, device, seed, ref,
                                             log)
        startup["clip"] = time.time() - t_g
    return priors, startup


def build_run(cfg: Config, device, tiny_guidance: bool, log=print):
    """The trainer, its state and the step generator of a run."""
    device = resolve_device(device)
    seed = cfg.seed or 0
    ref = None
    if cfg.image is not None and cfg.image.startswith("analytic:"):
        # the weight-free image run: the analytic scene's default view
        ref = analytic_ref_images(cfg, cfg.h, cfg.w,
                                  cfg.image.split(":", 1)[1])
    elif cfg.image is not None or cfg.image_config is not None:
        ref = load_ref_images(cfg, cfg.h, cfg.w)
    priors, startup = build_priors(cfg, device, tiny_guidance, seed, ref,
                                   log)
    kw = dict(ref_images=ref, priors=priors)
    if cfg.dmtet:
        trainer = DMTetTrainer(cfg, device, **kw)
        t_i = time.time()
        state = trainer.init_state(seed, cfg.init_with)
        _sync(trainer.device)
        trainer.init_seconds = time.time() - t_i
        log(f"[startup] DMTet state from {cfg.init_with or 'a sphere'} in "
            f"{trainer.init_seconds:.3f} s")
    else:
        trainer = Trainer(cfg, device, **kw)
        state = trainer.init_state(seed)
    trainer.startup = startup
    return trainer, state, torch.Generator(device=device).manual_seed(seed)


def install_clip_scorer(trainer, cfg: Config, tiny: bool, log=print) -> None:
    """A text run's eval metric (JAX ``main.py``): the CLIP score of its
    eval renders, by the run's CLIP guidance where it has one, else by a
    scorer from ``root/clip.npz`` (or a tiny one under
    ``--tiny_guidance``); none without weights."""
    if cfg.test or not cfg.clip_eval or trainer.ref_images is not None or \
            not cfg.text:
        return
    clip, clip_z = trainer.priors.get("clip", (None, None))
    if clip is None:
        root = cfg.pretrained_root
        has_w = bool(root) and os.path.exists(os.path.join(root, "clip.npz"))
        if not (has_w or tiny):
            return
        clip = CLIPGuidance(CLIPConfig(tiny=tiny), trainer.device)
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        if has_w:
            clip.load_pretrained(root, gen)
        else:
            clip.init_params(gen)
        clip_z = clip.prepare_embeddings(cfg.text, None, root)
    if clip_z:
        trainer.set_clip_scorer(clip, clip_z)
        log(f"[startup] eval metric: the CLIP score "
            f"({'the guidance' if 'clip' in trainer.priors else 'a scorer'})")


def tensorboard_writer(cfg: Config):
    """tensorboardX's SummaryWriter under workspace/run, where
    ``use_tensorboard`` is on and the package imports (JAX's rule), else
    None."""
    if not cfg.use_tensorboard:
        return None
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(os.path.join(cfg.workspace, "run"))
    except Exception:
        return None


def start_profile(device):
    """A running ``torch.profiler`` over the host and, on the card, the
    device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, device, workspace: str, log=print) -> Dict[str, Any]:
    """Stop `prof`, write its Chrome trace to workspace/profile/trace.json
    and log the device time by kernel group (``profile_step.GROUPS``) →
    {"trace": the path, "device_ms": {group: ms}}."""
    from torch.autograd import DeviceType

    from .profile_step import group_of
    _sync(device)
    prof.stop()
    path = os.path.join(workspace, "profile", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    groups: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = group_of(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"[profile] first epoch traced -> {path}; device ms by group: "
        f"{ {k: round(v, 3) for k, v in sorted(groups.items())} }")
    return {"trace": path, "device_ms": groups}


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
    save_config_json(cfg, os.path.join(cfg.workspace, "config.json"))
    log_path = os.path.join(cfg.workspace, "log_df.txt")

    def log(msg: str) -> None:
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(msg + "\n")

    oracle = any(g in ("oracle", "image_oracle") for g in cfg.guidance)
    trainer, state, gen = build_run(cfg, device, args.tiny_guidance, log)
    install_clip_scorer(trainer, cfg, args.tiny_guidance, log)
    known_view = trainer.ref_images is not None and not cfg.dmtet
    if cfg.ckpt != "scratch":
        state, loaded = trainer.load_checkpoint(state, cfg.ckpt)
        if loaded:
            log(f"[ckpt] resumed from step {state.step}")
            if cfg.dmtet:
                trainer.fit_caps(trainer.geo_params(state.model,
                                                    state.tet_scale))
    summary: Dict[str, Any] = {"device": str(device), "steps": cfg.iters,
                               "phases": {}, "startup": trainer.startup}
    phases = summary["phases"]
    if args.gui:
        from .viewer import ViewerState, make_server
        srv = make_server(ViewerState(trainer, state, gen),
                          not cfg.test and bool(trainer.priors),
                          int(os.environ.get("DFTPU_VIEWER_PORT", 7860)))
        log(f"[gui] serving http://0.0.0.0:{srv.server_address[1]}")
        srv.serve_forever()
        srv.server_close()
        return summary

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
        if cfg.dmtet:
            summary.update(trainer.view_tile_report())
            if summary["view_tile_cut"]:
                log(f"[dmtet] {len(summary['view_tile_cut'])} eval/test "
                    f"views cut a tile's list (over tile_cap "
                    f"{trainer.dmtet_renderer.tile_cap}): "
                    f"{summary['view_tile_cut']}")
        log(f"[end] phases (s): "
            f"{ {k: round(v, 3) for k, v in phases.items()} }")
        return summary

    if cfg.test:
        return finish(cfg.six_views)

    if cfg.dmtet:
        summary["init_seconds"] = trainer.init_seconds
    if oracle:
        psnr0 = trainer.oracle_eval_metric(state)
        log(f"[eval] step {state.step} oracle PSNR {psnr0:.4f} dB")
        summary["psnr_init"] = psnr0
    if known_view:
        kv0 = trainer.known_view_psnr(state)
        log(f"[eval] step {state.step} known-view masked PSNR {kv0:.4f} dB")
        summary["kv_psnr_init"] = kv0

    ok = torch.ones((), dtype=torch.bool, device=device)
    losses, blocks, grad_max, extra = [], [], [], []
    caps = []           # DMTet: max_tris at each step
    names = [n for n, _ in trainer.module(state).named_parameters()]
    # per step, the largest |gradient| of each watched group: the encoder
    # (the hash table or the triplanes; the vanilla field's ResMLP), and the
    # DMTet geometry
    watched = {"grid": "grid_table", "triplane": "triplanes",
               "vanilla": "sigma_net"}[cfg.backbone]
    groups = {cfg.backbone: [i for i, n in enumerate(names)
                             if watched in n]}
    if cfg.dmtet:
        groups.update(sdf=[names.index("geo.sdf")],
                      deform=[names.index("geo.deform")])
    tb = tensorboard_writer(cfg)
    t0 = t_blk = time.time()
    s_blk = start = state.step
    n_known = 0
    snaps = []          # the --save_guidance triptychs
    # --profile: the first epoch, as JAX's (steps up to dataset_size_train)
    prof = start_profile(device) if args.profile else None
    prof_end = min(cfg.iters, cfg.dataset_size_train)
    for _ in range(start, cfg.iters):
        if prof is not None and state.step >= prof_end:
            summary["profile"] = stop_profile(prof, device, cfg.workspace,
                                              log)
            prof = None
        n_known += trainer.is_known_view_step(state.step)
        if cfg.dmtet:
            caps.append(trainer.dmtet_renderer.max_tris)
        metrics, grads = trainer.run_step(state, gen)
        ok &= metrics["grad_ok"]
        grad_max.append(torch.stack([
            torch.stack([grads[i].abs().max() for i in idx]).max()
            for idx in groups.values()]))
        if cfg.dmtet:
            extra.append(torch.stack([metrics["n_faces"].float(),
                                      metrics["n_faces_true"].float(),
                                      metrics["tile_max"].float(),
                                      metrics["normal_loss"],
                                      metrics["lap_loss"]]))
        done = state.step
        if done % cfg.dataset_size_train == 0 or done == cfg.iters:
            loss = float(metrics["loss"])          # waits for the device
            now = time.time()
            if cfg.dmtet:
                # the block's largest counts: the device is done
                peak = torch.stack(extra[s_blk - start:])[:, 1:3].amax(0)
                trainer.check_caps(*map(int, peak.tolist()), done)
            rate = (done - s_blk) / (now - t_blk)
            if tb is not None:
                tb.add_scalar("train/loss", loss, done)
                tb.add_scalar("train/loss_sds",
                              float(metrics.get("loss_sds", 0.0)), done)
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
            if cfg.save_guidance and trainer.priors and epoch > 0 and \
                    epoch % max(cfg.save_guidance_interval, 1) == 0:
                snaps += timed("guidance_snapshot",
                               trainer.save_guidance_snapshot, state)
            if epoch % max(cfg.save_interval, 1) == 0 or done == cfg.iters:
                timed("save", trainer.save_checkpoint, state)
            # the block rates leave out evals, snapshots and saves
            t_blk, s_blk = time.time(), done
    if prof is not None:
        summary["profile"] = stop_profile(prof, device, cfg.workspace, log)
    if tb is not None:
        tb.close()
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
        steps_run=n_run, known_view_steps=n_known,
        guidance_snapshots=snaps,
        **{f"{g}_grad_max": [row[k] for row in gm]
           for k, g in enumerate(groups)})
    if cfg.dmtet and extra:
        ex = torch.stack(extra).tolist()
        true = [int(r[1]) for r in ex]
        tiles = [int(r[2]) for r in ex]
        dmr = trainer.dmtet_renderer
        dropped = [(start + i, n - c) for i, (n, c) in
                   enumerate(zip(true, caps)) if n > c]
        cut = [start + i for i, n in enumerate(tiles) if n > dmr.tile_cap]
        summary.update(n_faces=[int(r[0]) for r in ex], n_faces_true=true,
                       tile_max=tiles, normal_loss=[r[3] for r in ex],
                       lap_loss=[r[4] for r in ex],
                       max_tris_at=caps,
                       max_tris=dmr.max_tris, tile_cap=dmr.tile_cap,
                       faces_dropped_steps=[s for s, _ in dropped],
                       faces_dropped=sum(n for _, n in dropped),
                       tile_cut_steps=cut)
        if dropped:
            log(f"[dmtet] {len(dropped)} steps dropped "
                f"{summary['faces_dropped']} faces in all, from step "
                f"{dropped[0][0]} to {dropped[-1][0]}")
        if cut:
            log(f"[dmtet] {len(cut)} steps cut a tile's list, from step "
                f"{cut[0]} to {cut[-1]}")
    if oracle:
        psnr1 = trainer.oracle_eval_metric(state)
        log(f"[eval] step {state.step} oracle PSNR {psnr1:.4f} dB")
        summary["psnr_final"] = psnr1
    if known_view:
        kv1 = trainer.known_view_psnr(state)
        log(f"[eval] step {state.step} known-view masked PSNR {kv1:.4f} dB")
        summary["kv_psnr_final"] = kv1
    return finish()


if __name__ == "__main__":
    main()
