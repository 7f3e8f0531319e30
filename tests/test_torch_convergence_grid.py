"""The hash-grid twin of tests/test_torch_convergence.py: the pixel-oracle
trainer on the grid backbone (-O's, at L4C8 affine smoothstep, cut to a
2^12-row table and a 128 finest resolution), driven through the port's CLI
entry point on the CPU, where K6 takes its plain version.  The bars are the
JAX package's convergence test's: >= 20 dB analytic PSNR, >= +6 dB over
init (here in 150 steps)."""

import math

import torch

from dreamfusion_tpu_torch.main import main

torch.set_num_threads(2)


def test_port_grid_oracle_trainer_convergence(tmp_path):
    out = main([
        "--guidance", "oracle", "--oracle_scene", "sphere",
        "--workspace", str(tmp_path / "ws"), "--backbone", "grid",
        "--w", "32", "--h", "32", "--iters", "150",
        "--dataset_size_train", "60", "--batch_size", "2",
        "--grid_levels", "4", "--grid_features_per_level", "8",
        "--grid_log2_hashmap_size", "12", "--grid_desired_resolution", "128",
        "--hidden_dim", "32", "--num_layers", "2",
        "--grid_size", "32", "--grid_coarse_steps", "24",
        "--grid_fine_steps", "24", "--update_extra_interval", "16",
        "--fp16", "false", "--seed", "0", "--lambda_3d_normal_smooth", "0",
        "--lambda_opacity", "0", "--guidance_scale", "1.0", "--lr", "0.01",
        "--device", "cpu", "--eval_interval", "0", "--H", "32", "--W", "32",
        "--dataset_size_test", "2", "--ckpt", "scratch"])
    psnr0, psnr1 = out["psnr_init"], out["psnr_final"]
    assert out["grad_ok"] and out["all_losses_finite"]
    assert all(g > 0 for g in out["grid_grad_max"])
    assert math.isfinite(psnr1)
    assert psnr1 >= 20.0, f"port grid oracle PSNR {psnr1:.2f} dB < 20 dB bar"
    assert psnr1 - psnr0 >= 6.0, (
        f"oracle SDS gave only {psnr1 - psnr0:.2f} dB over init "
        f"({psnr0:.2f} -> {psnr1:.2f})")
