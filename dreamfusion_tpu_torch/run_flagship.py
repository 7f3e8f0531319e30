"""The port's full-length flagship runs → ``RUN_torch_<mode>.json``.

    python -m dreamfusion_tpu_torch.run_flagship --oracle
    python -m dreamfusion_tpu_torch.run_flagship --mode image_oracle \\
        --iters 5000
    python -m dreamfusion_tpu_torch.run_flagship --mode dmtet_oracle \\
        --iters 2000 --init_with build/runs/oracle/checkpoints
    python -m dreamfusion_tpu_torch.run_flagship --mode dmtet_sd \\
        --iters 500 --init_with build/runs/oracle/checkpoints
    python -m dreamfusion_tpu_torch.run_flagship --mode if --iters 500
    python -m dreamfusion_tpu_torch.run_flagship          # SD 2.1, 10k steps

The modes and flags of the JAX package's ``scripts/run_flagship.py``:
``sd`` (the SD 2.1 text → 3D run on the triplane), ``perpneg`` (SD with
Perp-Neg), ``--oracle`` (the weight-free pixel oracle against an analytic
scene: the run that converges without weights), ``image_oracle`` (the
weight-free image → 3D run), ``dmtet_oracle`` (the DMTet stage under the
oracle from a stage-1 checkpoint) and ``if`` (DeepFloyd-IF stage 1,
``--IF --fp16 true``: IF-I-XL at full width); and ``dmtet_sd``, the DMTet
stage under SD from a stage-1 checkpoint.  It runs ``dreamfusion_tpu_torch.main.main``
in this process and writes its summary as a record: the steady it/s, the
run's end by phase, the PSNRs, the DMTet face counts, the peak device
memory, the artifacts, and the card's name and power limit.  Flags this
script does not know go to ``main`` as they are (``--device cpu``, sizes).
Workspaces default to ``build/runs/<mode>``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Dict, List

import torch

from . import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("sd", "if", "perpneg", "image_oracle", "dmtet_oracle", "dmtet_sd")
TEXT = "a DSLR photo of a delicious hamburger"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("dreamfusion_tpu_torch.run_flagship")
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--mode", default="sd", choices=MODES)
    ap.add_argument("--oracle", action="store_true",
                    help="the pixel oracle instead of SD (the run that "
                         "converges without pretrained weights)")
    ap.add_argument("--oracle_scene", default="two_sphere")
    ap.add_argument("--init_with", default="",
                    help="stage-1 checkpoint dir (or mesh file) of the "
                         "DMTet modes")
    ap.add_argument("--text", default=TEXT)
    ap.add_argument("--eval_interval", type=int, default=25,
                    help="epochs between evals")
    ap.add_argument("--save_interval", type=int, default=25,
                    help="epochs between rolling checkpoints")
    ap.add_argument("--test_frames", type=int, default=50,
                    help="turntable frames of the run's end")
    ap.add_argument("--workspace", default=None,
                    help="default: build/runs/<mode>")
    ap.add_argument("--out", default=None,
                    help="default: RUN_torch_<mode>.json at the repo root")
    return ap


def run_name(args: argparse.Namespace) -> str:
    return "oracle" if args.oracle else args.mode


def main_flags(args: argparse.Namespace, extra: List[str] = ()) -> List[str]:
    """The ``dreamfusion_tpu_torch.main`` command line of a mode."""
    workspace = args.workspace or os.path.join(ROOT, "build", "runs",
                                               run_name(args))
    flags = ["--iters", str(args.iters), "--workspace", workspace,
             "--backbone", "triplane", "--seed", "0",
             "--lambda_3d_normal_smooth", "0",
             "--eval_interval", str(args.eval_interval),
             "--save_interval", str(args.save_interval), "--ckpt", "scratch",
             "--dataset_size_test", str(args.test_frames), "--save_mesh"]
    oracle = ["--guidance", "oracle", "--oracle_scene", args.oracle_scene,
              "--guidance_scale", "1.0"]
    if args.mode.startswith("dmtet") and not args.init_with:
        raise ValueError(f"--mode {args.mode} needs --init_with")
    if args.oracle:
        flags += oracle + ["--lr", "0.01"]
    elif args.mode == "if":
        flags += ["--text", args.text, "--IF", "--fp16", "true"]
    elif args.mode == "perpneg":
        flags += ["--text", args.text, "--perpneg", "--fp16", "true"]
    elif args.mode == "image_oracle":
        flags += ["--image", f"analytic:{args.oracle_scene}", "--guidance",
                  "image_oracle", "--guidance_scale", "1.0", "--lr", "0.01"]
    elif args.mode == "dmtet_oracle":
        flags += ["--dmtet", "--init_with", args.init_with] + oracle + [
            "--lr", "0.002"]
    elif args.mode == "dmtet_sd":
        flags += ["--dmtet", "--init_with", args.init_with, "--text",
                  args.text, "--lr", "0.002"]
    else:
        flags += ["--text", args.text]
    return flags + list(extra)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown"


def record(args, flags: List[str], summary: Dict[str, Any], total: float,
           peak_gib) -> Dict[str, Any]:
    """The run's record from main's summary."""
    ws = flags[flags.index("--workspace") + 1]
    listing = lambda d: sorted(os.listdir(d)) if os.path.isdir(d) else []
    blocks = summary.get("blocks", [])
    out = {
        "mode": run_name(args), "iters": args.iters,
        # paths inside the checkout, relative to its root
        "main_flags": [f.replace(ROOT + os.sep, "") for f in flags],
        "device": summary.get("device"),
        "card": card() if torch.cuda.is_available() else None,
        "total_wall_s": total,
        "train_s": sum(t for _, t in blocks),
        "steady_its": summary.get("steady_its"),
        "phases": summary.get("phases"),
        "export_phases": summary.get("export_phases"),
        "peak_device_memory_gib": peak_gib,
        "all_losses_finite": summary.get("all_losses_finite"),
        "grad_ok": summary.get("grad_ok"),
        "losses": summary.get("losses"),
        "artifacts": {"results": listing(os.path.join(ws, "results")),
                      "mesh": listing(os.path.join(ws, "mesh"))},
        "text": None if (args.oracle or "oracle" in args.mode)
        else args.text,
    }
    for k in ("psnr_init", "psnr_final", "kv_psnr_init", "kv_psnr_final",
              "init_seconds", "max_tris", "tile_cap", "faces_dropped",
              "faces_dropped_steps", "tile_cut_steps"):
        if k in summary:
            out[k] = summary[k]
    for k in ("n_faces", "n_faces_true", "tile_max"):
        if summary.get(k):
            out[f"{k}_first_last"] = [summary[k][0], summary[k][-1]]
            out[f"{k}_max"] = max(summary[k])
    if out["steady_its"]:
        out["steady_s_per_step"] = 1.0 / out["steady_its"]
    return out


def run(argv=None) -> Dict[str, Any]:
    args, extra = build_parser().parse_known_args(argv)
    flags = main_flags(args, extra)
    print("[run_flagship] main", " ".join(flags), flush=True)
    cuda = torch.cuda.is_available() and "cpu" not in extra
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = port_main.main(flags)
    total = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    rec = record(args, flags, summary, total, peak)
    path = args.out or os.path.join(ROOT, f"RUN_torch_{run_name(args)}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[run_flagship] wrote {path}", flush=True)
    return rec


if __name__ == "__main__":
    run()
