"""The port stands alone: importing all of it (and chip_smoke.py) pulls in
neither jax nor the JAX package, its Config agrees field by field with the
JAX package's, its CLI refuses what it does not port, and it runs on the
GPU unless the caller asks for the CPU."""

import dataclasses
import os
import subprocess
import sys

import pytest

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.config import finalize as j_finalize
from dreamfusion_tpu_torch.config import Config, finalize
from dreamfusion_tpu_torch.main import main

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


@pytest.mark.parametrize("overrides", [
    dict(guidance=("oracle",), iters=300),
    dict(guidance=("oracle",), exp_start_iter=5, exp_end_iter=50),
    dict(guidance=("SD",)),
])
def test_finalize_fixups_match(overrides):
    p, j = finalize(Config(**overrides)), j_finalize(JConfig(**overrides))
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("flags", [
    ["--text", "a hamburger", "--sd_version", "1.5"],       # head dim 40
    ["--guidance", "oracle", "--backbone", "grid"],
    ["--guidance", "oracle", "--backbone", "triplane", "--save_mesh"],
    ["--guidance", "oracle", "--backbone", "triplane", "--test"],
    ["--guidance", "oracle", "--backbone", "triplane", "-O"],
])
def test_cli_refuses_what_is_not_ported(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(flags + ["--workspace", str(tmp_path), "--iters", "1"])


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--guidance", "oracle", "--backbone", "triplane",
              "--workspace", str(tmp_path), "--iters", "1"])
