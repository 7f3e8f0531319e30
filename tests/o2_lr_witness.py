"""A witness for the -O2 oracle's learning rate: the JAX package's run and
the port's, side by side, on the CPU at a reduced render size.

The -O2 oracle (the vanilla field under Adan at 5·lr with its vanilla lr
decay) is run for `--iters` steps at each learning rate given, once by the
JAX package's trainer (jitted, fp32) and once by the port's (plain torch,
fp32), both from JAX's init (carried across by ``params_from_jax``).  Each
prints the analytic PSNR of the EMA weights before and after, and the gain.
Only the size is cut (32² renders and evals instead of 64² and 800²); the
field, the sampling (64 + 32 samples a ray) and the optimizer are -O2's.
The two sides draw their own poses and samples, so the gains agree in
kind, not to the digit.

    JAX_PLATFORMS=cpu python tests/o2_lr_witness.py --lrs 1e-3 1e-2
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import dreamfusion_tpu.training.trainer as jtrainer  # noqa: E402
from dreamfusion_tpu.config import Config, apply_O2, finalize  # noqa: E402
from dreamfusion_tpu.guidance.oracle import (  # noqa: E402
    PixelOracleGuidance)
from dreamfusion_tpu.guidance.sd import SDConfig  # noqa: E402
from dreamfusion_tpu_torch.training.trainer import Trainer  # noqa: E402
from dreamfusion_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from torch_parity import port_cfg  # noqa: E402


def config(lr, iters, side, ws):
    cfg = finalize(apply_O2(Config(
        guidance=("oracle",), oracle_scene="two_sphere", workspace=ws,
        w=side, h=side, iters=iters, batch_size=1, seed=0, eval_interval=-1,
        lambda_3d_normal_smooth=0.0, use_tensorboard=False,
        guidance_scale=1.0, lr=lr)))
    return dataclasses.replace(cfg, fp16=False)


def run(lr, iters, side, threads):
    with tempfile.TemporaryDirectory() as ws:
        cfg = config(lr, iters, side, ws)
        jt = jtrainer.Trainer(
            cfg, guidances={"oracle": PixelOracleGuidance(
                SDConfig(tiny=True), scene=cfg.oracle_scene)},
            guidance_params={"oracle": {}},
            embeddings={"oracle": jnp.zeros(())})
        js = jt.init_state(jax.random.PRNGKey(0))
        init = params_from_jax(jax.tree.map(np.asarray, js.params))
        t0 = time.time()
        j0 = jt._oracle_eval_metric(js)
        js = jt.train(js, iters)
        j1 = jt._oracle_eval_metric(js)
        tj = time.time() - t0

        torch.set_num_threads(threads)
        pt = Trainer(port_cfg(cfg), "cpu")
        ps = pt.init_state(0)
        ps.renderer.load_state_dict(init)
        for k, v in ps.ema_params.items():
            v.copy_(init[k])
        gen = torch.Generator().manual_seed(0)
        t0 = time.time()
        p0 = pt.oracle_eval_metric(ps)
        for _ in range(iters):
            pt.run_step(ps, gen)
        p1 = pt.oracle_eval_metric(ps)
        tp = time.time() - t0
    print(f"lr {lr:g}, {iters} steps, {side}² renders: JAX {j0:.3f} -> "
          f"{j1:.3f} dB ({j1 - j0:+.3f}, {tj:.0f} s); port {p0:.3f} -> "
          f"{p1:.3f} dB ({p1 - p0:+.3f}, {tp:.0f} s)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 1e-2])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--side", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    for lr in args.lrs:
        run(lr, args.iters, args.side, args.threads)


if __name__ == "__main__":
    main()
