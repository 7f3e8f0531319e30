"""The port's twin of tests/test_sds_convergence.py::
test_pixel_oracle_trainer_convergence: the same configuration and bars
(>= 20 dB analytic PSNR, >= +6 dB over init), driven through the port's
CLI entry point on the CPU, where every kernel takes its plain version."""

import math

import torch

from dreamfusion_tpu_torch.main import main

torch.set_num_threads(2)


def test_port_oracle_trainer_convergence(tmp_path):
    out = main([
        "--guidance", "oracle", "--oracle_scene", "sphere",
        "--workspace", str(tmp_path / "ws"), "--backbone", "triplane",
        "--w", "32", "--h", "32", "--iters", "240",
        "--dataset_size_train", "60", "--batch_size", "2",
        "--triplane_resolution", "32", "--triplane_channels", "8",
        "--triplane_scales", "2", "--hidden_dim", "32", "--num_layers", "2",
        "--grid_size", "32", "--grid_coarse_steps", "24",
        "--grid_fine_steps", "24", "--update_extra_interval", "16",
        "--fp16", "false", "--seed", "0", "--lambda_3d_normal_smooth", "0",
        "--lambda_opacity", "0", "--guidance_scale", "1.0", "--lr", "0.01",
        "--device", "cpu", "--eval_interval", "0", "--H", "32", "--W", "32",
        "--dataset_size_test", "2", "--ckpt", "scratch"])
    psnr0, psnr1 = out["psnr_init"], out["psnr_final"]
    assert out["grad_ok"] and out["all_losses_finite"]
    assert math.isfinite(psnr1)
    assert psnr1 >= 20.0, f"port oracle PSNR {psnr1:.2f} dB < 20 dB bar"
    assert psnr1 - psnr0 >= 6.0, (
        f"oracle SDS gave only {psnr1 - psnr0:.2f} dB over init "
        f"({psnr0:.2f} -> {psnr1:.2f})")
