"""The port's twin of tests/test_image_oracle.py::
test_image_oracle_pipeline_converges: the same configuration and bars
(known-view masked PSNR > 14 dB, silhouette IoU > 0.6 at a novel view the
known-view losses never see), the run built through the port's CLI
(``config_from_args`` + ``build_run``) on the CPU, where every kernel takes
its plain version."""

import math

import torch

from dreamfusion_tpu_torch.evaluation.analytic import scene_views
from dreamfusion_tpu_torch.main import build_parser, build_run, config_from_args
from dreamfusion_tpu_torch.training.data import default_view_batch

torch.set_num_threads(2)


def test_port_image_oracle_pipeline_converges(tmp_path):
    cfg = config_from_args(build_parser().parse_args([
        "--image", "analytic:sphere", "--guidance", "image_oracle",
        "--workspace", str(tmp_path / "ws"), "--backbone", "triplane",
        "--triplane_resolution", "64", "--triplane_channels", "8",
        "--w", "32", "--h", "32", "--H", "32", "--W", "32", "--iters", "250",
        "--dataset_size_train", "50", "--known_view_interval", "2",
        "--known_view_scale", "1.0", "--grid_size", "32",
        "--grid_coarse_steps", "24", "--grid_fine_steps", "24",
        "--hidden_dim", "32", "--num_layers", "2", "--hidden_dim_bg", "8",
        "--num_layers_bg", "2", "--fp16", "false", "--eval_interval", "-1",
        "--seed", "0", "--lambda_3d_normal_smooth", "0", "--lambda_depth",
        "1.0", "--progressive_view", "false"]))
    # the image preset overrode the given values, as in the JAX test
    assert cfg.guidance == ("image_oracle",) and cfg.latent_iter_ratio == 0
    assert cfg.lambda_3d_normal_smooth == 10.0 and cfg.progressive_view
    trainer, state, gen = build_run(cfg, "cpu", False)
    n_known = 0
    for _ in range(cfg.iters):
        n_known += trainer.is_known_view_step(state.step)
        metrics, _ = trainer.run_step(state, gen)
        assert bool(metrics["grad_ok"])
    assert n_known == cfg.iters // cfg.known_view_interval

    # (a) the known-view masked PSNR, the run's eval metric
    psnr = trainer.eval_metric(state)
    assert math.isfinite(psnr)
    assert psnr > 14.0, f"known-view masked PSNR {psnr:.2f} dB"

    # (b) the silhouette at 90° azimuth, never a known view
    b = default_view_batch(cfg, (cfg.default_radius,), (cfg.default_polar,),
                           (90.0,), cfg.h, cfg.w)
    _, _, wsum = trainer.render_view(state, b, cfg.h, cfg.w)
    _, hit = scene_views(b.rays_o[0], b.rays_d[0], "sphere")
    pred = wsum > 0.5
    iou = float((pred & hit).sum()) / max(float((pred | hit).sum()), 1.0)
    assert iou > 0.6, f"novel-view silhouette IoU {iou:.3f}"
