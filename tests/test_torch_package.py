"""The port stands alone: importing all of it (and chip_smoke.py) pulls in
neither jax nor the JAX package, it builds its host mesh library from its
own copy of the source, its Config (and its -O preset) agrees field by
field with the JAX package's, its CLI refuses what it does not port, and it
runs on the GPU unless the caller asks for the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.config import apply_O as j_apply_O
from dreamfusion_tpu.config import finalize as j_finalize
from dreamfusion_tpu_torch.config import Config, apply_O, finalize
from dreamfusion_tpu_torch.main import build_parser, config_from_args, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dreamfusion_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'dreamfusion_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) >= 30, names\n"
        "assert 'dreamfusion_tpu_torch.guidance.sd' in names\n"
        "for m in ('native.meshops', 'ops.raster', 'ops.marching_tets',\n"
        "          'ops.hashgrid', 'mesh.export', 'mesh.tets',\n"
        "          'models.dmtet',\n"
        "          'training.dmtet_trainer', 'utils.image'):\n"
        "    assert 'dreamfusion_tpu_torch.' + m in names, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dreamfusion_tpu' or m.startswith('dreamfusion_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_config_fields_and_defaults_match_the_jax_package():
    jdefaults = JConfig()
    for f in dataclasses.fields(Config):
        assert hasattr(jdefaults, f.name), f.name
        assert getattr(Config(), f.name) == getattr(jdefaults, f.name), f.name
    assert Config().cascade == jdefaults.cascade
    assert Config(bound=2.0).cascade == JConfig(bound=2.0).cascade
    grid = [f.name for f in dataclasses.fields(Config)
            if f.name.startswith("grid_") and f.name not in (
                "grid_size", "grid_coarse_steps", "grid_fine_steps")]
    assert sorted(grid) == sorted([
        "grid_levels", "grid_features_per_level", "grid_log2_hashmap_size",
        "grid_base_resolution", "grid_desired_resolution",
        "grid_interpolation", "grid_hash"])


@pytest.mark.parametrize("overrides", [dict(), dict(backbone="triplane",
                                                    fp16=False)])
def test_apply_O_matches(overrides):
    p, j = apply_O(Config(**overrides)), j_apply_O(JConfig(**overrides))
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.backbone == "grid" and p.fp16


@pytest.mark.parametrize("overrides", [
    dict(guidance=("oracle",), iters=300),
    dict(guidance=("oracle",), exp_start_iter=5, exp_end_iter=50),
    dict(guidance=("SD",)),
    dict(guidance=("oracle",), backbone="grid_tcnn"),
    dict(backbone="grid_taichi"),
])
def test_finalize_fixups_match(overrides):
    p, j = finalize(Config(**overrides)), j_finalize(JConfig(**overrides))
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("flags", [
    ["--text", "a hamburger", "--sd_version", "1.5"],       # head dim 40
    ["--guidance", "oracle", "--backbone", "vanilla"],
    ["--guidance", "oracle", "--backbone", "triplane", "--dmtet",
     "--init_with", "mesh.obj"],                            # K9
    ["--text", "a hamburger", "--backbone", "triplane", "--dmtet"],
    ["--guidance", "oracle", "--backbone", "triplane", "-O2"],
    ["--guidance", "oracle", "--backbone", "triplane", "--dmtet",
     "--image", "x.png"],
])
def test_cli_refuses_what_is_not_ported(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(flags + ["--workspace", str(tmp_path), "--iters", "1"])


def test_cli_refuses_tv_on_the_triplane(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--guidance", "oracle", "--backbone", "triplane", "--lambda_tv",
              "1e-3", "--workspace", str(tmp_path), "--iters", "1",
              "--device", "cpu"])


def test_cli_O_selects_the_grid_and_runs(tmp_path):
    """-O is fp16 + the hash grid, applied after the flags as the JAX CLI
    does; a tiny SD run through it trains here with --tiny_guidance."""
    cfg = config_from_args(build_parser().parse_args(
        ["--text", "a hamburger", "--backbone", "triplane", "--fp16",
         "false", "-O"]))
    assert cfg.backbone == "grid" and cfg.fp16
    out = main(["--text", "a hamburger", "-O", "--iters", "4", "--w", "8",
                "--h", "8", "--grid_log2_hashmap_size", "12", "--grid_size",
                "16", "--hidden_dim", "16", "--dataset_size_train", "2",
                "--dataset_size_test", "1", "--H", "8", "--W", "8",
                "--tiny_guidance", "--device", "cpu", "--ckpt", "scratch",
                "--workspace", str(tmp_path)])
    assert out["grad_ok"] and out["all_losses_finite"]
    assert len(out["grid_grad_max"]) == 4
    assert all(g > 0 for g in out["grid_grad_max"])


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--guidance", "oracle", "--backbone", "triplane",
              "--workspace", str(tmp_path), "--iters", "1"])


def test_trainers_need_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from dreamfusion_tpu_torch.guidance.sd import (SDConfig,
                                                   StableDiffusionGuidance)
    from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
    from dreamfusion_tpu_torch.training.trainer import Trainer
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    cfg = finalize(Config(guidance=("oracle",), backbone="triplane",
                          workspace=str(tmp_path)))
    with pytest.raises(RuntimeError, match="device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device"):
        DMTetTrainer(cfg)
    with pytest.raises(RuntimeError, match="device"):
        StableDiffusionGuidance(SDConfig(tiny=True))
    assert Trainer(cfg, "cpu").device.type == "cpu"


def test_meshops_builds_from_the_ports_own_source():
    from dreamfusion_tpu_torch.native import meshops
    src = meshops.SRC_DIR
    assert str(src) == os.path.join(ROOT, "dreamfusion_tpu_torch", "native",
                                    "src")
    assert (src / "meshops.cpp").exists() and (src / "mc_tables.h").exists()
    lib = meshops.build()
    assert str(lib).startswith(os.path.join(ROOT, "build", "meshops"))
    v, t = meshops.marching_cubes(np.ones((4, 4, 4), np.float32), 0.5)
    assert len(t) == 0            # no surface in a constant field
