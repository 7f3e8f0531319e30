"""The port stands alone: importing all of it (and chip_smoke.py) pulls in
neither jax nor the JAX package, it builds its host mesh library from its
own copy of the source, its Config (and its -O, --image and --dmtet
presets, in the JAX CLI's order) agrees field by field with the JAX
package's, its CLI refuses what it does not port and builds the image
run and the mesh-file DMTet run, and it runs on the GPU unless the caller
asks for the CPU."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.config import apply_dmtet as j_apply_dmtet
from dreamfusion_tpu.config import apply_image_mode as j_apply_image_mode
from dreamfusion_tpu.config import apply_O as j_apply_O
from dreamfusion_tpu.config import finalize as j_finalize
from dreamfusion_tpu.main import build_parser as j_build_parser
from dreamfusion_tpu.main import config_from_args as j_config_from_args
from dreamfusion_tpu_torch.config import (Config, apply_dmtet,
                                          apply_image_mode, apply_O, finalize)
from dreamfusion_tpu_torch.main import (build_parser, build_run,
                                        config_from_args, main)

from test_torch_sdf import _uv_sphere, _write_obj

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
        "          'models.dmtet', 'mesh.sdf', 'ops.clip_grad',\n"
        "          'training.image_data', 'guidance.zero123',\n"
        "          'training.dmtet_trainer', 'utils.image', 'models.dpt',\n"
        "          'preprocess_image', 'evaluation.mesh_to_video',\n"
        "          'evaluation.r_precision', 'evaluation.prompt', 'viewer',\n"
        "          'utils.convert', 'guidance.t5_tokenizer'):\n"
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


def test_port_imports_no_triton():
    """Every kernel of the port is CUDA C++ under csrc/: no module of the
    port, nor chip_smoke.py, imports triton (at the top or inside a
    function, where the Triton wrappers used to)."""
    port = Path(ROOT) / "dreamfusion_tpu_torch"
    files = sorted(port.rglob("*.py")) + [Path(ROOT) / "chip_smoke.py"]
    assert len(files) >= 30
    bad = [str(f) for f in files
           if re.search(r"^\s*(import|from)\s+triton\b", f.read_text(),
                        re.M)]
    assert not bad, bad


def test_every_entry_point_has_its_c_signature():
    """ctypes passes each argument by the type ``kernels._SIGNATURES``
    gives it: every C entry point the wrappers launch has as many types
    as its definition in csrc/ has parameters (the stream included), and
    each signature names an entry point of the sources."""
    from dreamfusion_tpu_torch.ops import kernels
    src = "".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    defs = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', src)}
    checked = 0
    for name, types in kernels._SIGNATURES.items():
        assert name in kernels.LAUNCHES, name
        if name not in defs:         # instantiated by a macro
            assert re.search(rf"\b{name}\b", src), name
            continue
        params = [a for a in defs[name].split(",") if a.strip()]
        assert len(params) == len(types), name
        checked += 1
    assert checked >= 40
    for name in ("composite_fwd", "composite_bwd", "field_head_fwd",
                 "field_head_bwd", "field_shade_fwd", "field_shade_bwd"):
        assert name in defs


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
    dict(guidance=("image_oracle",), image="analytic:two_sphere"),
    dict(guidance=("image_oracle",), image="analytic:sphere", dmtet=True,
         iters=20),
])
def test_finalize_fixups_match(overrides):
    p, j = finalize(Config(**overrides)), j_finalize(JConfig(**overrides))
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("overrides", [
    dict(guidance=("image_oracle",), image="analytic:two_sphere",
         lambda_3d_normal_smooth=0.0, guidance_scale=1.0),
    dict(guidance=("image_oracle",), image="analytic:two_sphere",
         lambda_3d_normal_smooth=0.0, dont_override_stuff=True),
    dict(guidance=("SD",), image="x.png", fovy_range=(15.0, 25.0)),
])
@pytest.mark.parametrize("dmtet", [False, True], ids=["stage1", "dmtet"])
def test_image_and_dmtet_presets_match(overrides, dmtet):
    """apply_image_mode, then apply_dmtet, then finalize, as the CLIs do:
    the image preset overrides the given lambdas, the DMTet preset then
    turns the progressive view off and renders the known view at 1x."""
    p = apply_image_mode(Config(**overrides))
    j = j_apply_image_mode(JConfig(**overrides))
    if dmtet:
        p, j = apply_dmtet(p), j_apply_dmtet(j)
    p, j = finalize(p), j_finalize(j)
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name


IMAGE_FLAGS = ["--image", "analytic:two_sphere", "--guidance",
               "image_oracle", "--guidance_scale", "1.0", "--lr", "0.01",
               "--backbone", "triplane", "--seed", "0",
               "--lambda_3d_normal_smooth", "0", "--grad_clip_rgb", "0.05"]


@pytest.mark.parametrize("extra", [
    [], ["--dont_override_stuff"], ["--lambda_entropy", "0.5"],
    ["--dmtet", "--init_with", "m.obj", "--tet_grid_size", "128"],
    ["--dmtet", "--init_with", "m.obj", "--dont_override_stuff"],
])
def test_cli_image_config_matches_jax(extra):
    """The finished Config of the image command lines, field by field."""
    p = config_from_args(build_parser().parse_args(IMAGE_FLAGS + extra))
    j = j_config_from_args(j_build_parser().parse_args(IMAGE_FLAGS + extra))
    for f in dataclasses.fields(Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    if "--dont_override_stuff" not in extra:
        assert p.lambda_3d_normal_smooth == 10.0 and p.lambda_entropy == 1.0
        assert p.progressive_view == ("--dmtet" not in extra)


@pytest.mark.parametrize("flags", [
    ["--text", "a hamburger", "--gui"],
    ["--guidance", "oracle", "--backbone", "triplane", "--profile"],
    ["--text", "a hamburger", "--IF", "--profile", "trace"],
])
def test_cli_refuses_what_is_not_ported(flags, tmp_path):
    """Every flag of JAX's CLI is ported, so the port's CLI refuses what
    JAX's refuses and nothing more: ``--gui`` and ``--profile`` are
    switches giving JAX's Config, and ``--profile trace``, a value JAX's
    switch does not take, is refused by both parsers."""
    argv = flags + ["--workspace", str(tmp_path), "--iters", "1"]
    try:
        want = j_config_from_args(j_build_parser().parse_args(argv))
    except SystemExit:
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
        return
    args = build_parser().parse_args(argv)
    assert (args.gui, args.profile) == ("--gui" in flags,
                                        "--profile" in flags)
    cfg = config_from_args(args)
    for f in dataclasses.fields(Config):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name


TINY = ["--backbone", "triplane", "--w", "8", "--h", "8",
        "--triplane_resolution", "16", "--triplane_channels", "4",
        "--grid_size", "16", "--hidden_dim", "16"]


@pytest.mark.parametrize("what", ["image", "mesh"])
def test_cli_builds_the_image_run_and_the_mesh_init(what, tmp_path):
    """``--image analytic:two_sphere --guidance image_oracle`` and a
    mesh-file ``--init_with`` each build a run on the CPU."""
    flags = IMAGE_FLAGS + TINY + ["--workspace", str(tmp_path / "ws")]
    if what == "mesh":
        _write_obj(tmp_path / "sphere.obj", *_uv_sphere(1.0, 8, 12))
        flags += ["--dmtet", "--init_with", str(tmp_path / "sphere.obj"),
                  "--tet_grid_size", "16", "--w", "2", "--h", "2"]
    cfg = config_from_args(build_parser().parse_args(flags))
    trainer, state, gen = build_run(cfg, "cpu", False)
    assert trainer.ref_images is not None
    assert trainer.is_known_view_step(0) and not trainer.is_known_view_step(1)
    if what == "mesh":
        assert state.tet_scale.tolist() == [0.5, 0.5, 0.5]
        sdf = state.model.geo["sdf"]
        assert bool((sdf > 0).any()) and bool((sdf < 0).any())
    else:
        assert trainer.kv_batch.rays_o.shape[1] == 12 * 12   # 1.5 x 8²
    metrics, _ = trainer.run_step(state, gen)
    assert bool(metrics["grad_ok"]) and state.step == 1


def _queue1_titles():
    """The titles of ROADMAP.md's queue 1 items (bold, after the number),
    backquotes dropped."""
    text = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1")[1].split("### Queue 2")[0]
    return [t.replace("`", "").rstrip(".") for t in
            re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M)]


@pytest.mark.parametrize("flags", [
    ["--text", "a hamburger", "--gui"],
    ["--text", "a hamburger", "--profile"],
])
def test_refusals_name_a_roadmap_queue1_title(flags, tmp_path):
    """Every refusal of the port names the ROADMAP queue 1 item that ports
    it by a title the queue holds (numbers change when the queue is
    renumbered; titles do not).  The Tooling item's refusals are lifted:
    its flags build a run, and the queue no longer holds its title."""
    cfg = config_from_args(build_parser().parse_args(
        flags + ["--workspace", str(tmp_path), "--iters", "1"]))
    assert cfg.text == "a hamburger"
    titles = _queue1_titles()
    assert "Tooling" not in titles
    port = Path(__file__).resolve().parents[1] / "dreamfusion_tpu_torch"
    for path in port.rglob("*.py"):
        for m in re.finditer(r"ROADMAP queue 1: ([^)\"']+)\)",
                             path.read_text()):
            assert m.group(1) in titles, (path, m.group(1))


def _write_refs(tmp_path, K=2):
    """K RGBA reference PNGs and an ``--image_config`` CSV naming them →
    (the CSV's path, the first PNG's)."""
    from dreamfusion_tpu_torch.utils.image import save_image
    yy, xx = np.mgrid[0:24, 0:24]
    rows = ["image, polar, azimuth, radius, zero123_weight"]
    for k in range(K):
        a = np.clip(1.5 - np.hypot(xx - 12 - 2 * k, yy - 11) / 6, 0, 1)
        rgba = np.stack([0.7 * a, 0.4 * a, (0.3 + 0.2 * k) * a, a], -1)
        save_image(str(tmp_path / f"r{k}_rgba.png"), rgba)
        rows.append(f"{tmp_path / f'r{k}_rgba.png'}, {90 - 15 * k}, "
                    f"{120 * k}, 3.2, 1.0")
    (tmp_path / "refs.csv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "refs.csv"), str(tmp_path / "r0_rgba.png")


# the runs that once raised "not ported" (their flags): each builds now, with
# the tiny towers, and trains one step on the CPU
LIFTED_RUNS = {
    "IF with --image_config": ["--text", "a hamburger", "--IF",
                               "--image_config", "CSV"],
    "SD with --image_config and no prompt": ["--image_config", "CSV"],
    "CLIP alone with references": ["--image_config", "CSV", "--guidance",
                                   "clip", "--text", "a hamburger"],
    "IF and CLIP": ["--guidance", "IF", "clip", "--text", "a hamburger"],
    "--IF turns SD clip into IF clip": ["--text", "a hamburger", "--IF",
                                        "--guidance", "SD", "clip"],
    "zero123 and CLIP": ["--guidance", "zero123", "clip", "--image_config",
                         "CSV", "--text", "a hamburger"],
    "SD and zero123 with references": ["--guidance", "SD", "zero123",
                                       "--text", "a hamburger",
                                       "--image_config", "CSV"],
    "the pixel oracle with --image file.png": ["--guidance", "oracle",
                                               "--image", "PNG"],
    "the pixel oracle with --image analytic": [
        "--image", "analytic:two_sphere", "--guidance", "oracle"],
    "SD with --image_config and --text": ["--image_config", "CSV",
                                          "--guidance", "SD", "--text",
                                          "a hamburger"],
}
# what JAX's main refuses, with its message
JAX_REFUSALS = {
    "SD and zero123 without a reference image": (
        ["--guidance", "SD", "zero123", "--text", "a hamburger"],
        "zero123 guidance needs a reference image"),
    "image_oracle without --image analytic": (
        ["--guidance", "image_oracle"],
        "--guidance image_oracle needs --image analytic:<scene>"),
}


DMTET_ORACLE_FILE = "DMTet under the pixel oracle with --image file.png"


def _lifted_run(name, tmp_path):
    """A guidance set or reference-image run that JAX's main builds builds
    here too (priors summed in sorted order, known-view steps with any
    prior) and trains a step on the CPU with the test-size towers; what JAX
    refuses raises ValueError with its message."""
    csv, png = _write_refs(tmp_path)
    ws = ["--workspace", str(tmp_path / "ws")]
    if name in JAX_REFUSALS:
        flags, msg = JAX_REFUSALS[name]
        with pytest.raises(ValueError, match=re.escape(msg)):
            main(flags + TINY + ws + ["--device", "cpu", "--iters", "1"])
        return
    if name.startswith("DMTet"):
        out = main(["--guidance", "oracle", "--image", png, "--dmtet",
                    "--tet_grid_size", "16", "--w", "2", "--h", "2",
                    "--lr", "0.002"] + TINY[:2] + TINY[6:] + ws +
                   LIFTED_TINY)
        assert out["grad_ok"] and out["known_view_steps"] == 1
        return
    flags = [{"CSV": csv, "PNG": png}.get(f, f) for f in LIFTED_RUNS[name]]
    cfg = config_from_args(build_parser().parse_args(flags + TINY + ws))
    if name.startswith("--IF"):
        assert cfg.guidance == ("IF", "clip")
    trainer, state, gen = build_run(cfg, "cpu", True)
    assert list(trainer.priors) == sorted(cfg.guidance)
    assert (trainer.ref_images is not None) == ("CSV" in LIFTED_RUNS[name]
                                                or "PNG" in LIFTED_RUNS[name]
                                                or "analytic" in name)
    step = 1 if trainer.ref_images is not None else 0   # not a known view
    state.step = step
    metrics, _ = trainer.run_step(state, gen)
    assert bool(metrics["grad_ok"]) and state.step == step + 1
    assert np.isfinite(float(metrics["loss"]))
    if trainer.ref_images is not None:
        state.step = 0                                  # a known view
        metrics, _ = trainer.run_step(state, gen)
        assert bool(metrics["grad_ok"])


LIFTED_TINY = ["--iters", "2", "--dataset_size_train", "2",
               "--dataset_size_test", "1", "--H", "8", "--W", "8",
               "--eval_interval", "0", "--ckpt", "scratch", "--device",
               "cpu", "--tiny_guidance", "--known_view_interval", "2"]


O2_TINY = ["--iters", "4", "--w", "8", "--h", "8", "--H", "8", "--W", "8",
           "--hidden_dim", "16", "--num_steps", "8", "--upsample_steps", "4",
           "--dataset_size_train", "2", "--dataset_size_test", "1",
           "--device", "cpu", "--ckpt", "scratch"]
OPTION_FLAGS = ["--guidance", "oracle", "--backbone", "triplane"]


@pytest.mark.parametrize("lifted", [
    "--IF", "squaredcos_cap_v2", "-O2", "-O2 after -O, before --IF",
    "-O2 oracle run", "-O2 SD run", "--backbone vanilla", "--optim adam",
    "--grad_clip", "--lambda_tv on the triplane",
    "--normal_mode finite_difference", "softplus and vanilla fields"] +
    list(LIFTED_RUNS) + list(JAX_REFUSALS) + [DMTET_ORACLE_FILE])
def test_lifted_refusals_now_build(lifted, tmp_path):
    """DeepFloyd-IF is ported: ``--IF`` parses to IF guidance with no
    warm-up phase, and the cosine schedule builds.  So are ``-O2`` (fp16,
    the vanilla backbone, progressive levels; applied after ``-O`` and
    before ``--IF``, as JAX's CLI), the small field options and every
    guidance set and reference-image run of JAX's main (``_lifted_run``):
    each configuration that raised builds, and the -O2 runs and the guidance
    sets train on the CPU."""
    if lifted in LIFTED_RUNS or lifted in JAX_REFUSALS or \
            lifted == DMTET_ORACLE_FILE:
        return _lifted_run(lifted, tmp_path)
    import torch

    from dreamfusion_tpu_torch.guidance.schedule import make_schedule
    from dreamfusion_tpu_torch.models.nerf import NeRFField
    from dreamfusion_tpu_torch.training.optimizer import Adam
    from dreamfusion_tpu_torch.training.trainer import Trainer, check_slice

    def parse(*flags):
        cfg = config_from_args(build_parser().parse_args(list(flags)))
        check_slice(cfg)
        return cfg

    ws = ["--workspace", str(tmp_path / "ws")]
    if lifted == "--IF":
        cfg = parse("--text", "a hamburger", "--IF")
        assert cfg.guidance == ("IF",) and cfg.latent_iter_ratio == 0.0
    elif lifted == "squaredcos_cap_v2":
        ac = make_schedule(lifted).alphas_cumprod
        assert ac.shape == (1000,) and 0 < ac[-1] < ac[0] < 1
    elif lifted == "-O2":
        flags = ["--guidance", "oracle", "--backbone", "triplane", "--fp16",
                 "false", "-O2"]
        cfg = parse(*flags)
        assert cfg.backbone == "vanilla" and cfg.fp16 and \
            cfg.progressive_level
        j = j_config_from_args(j_build_parser().parse_args(flags))
        assert (j.backbone, j.fp16, j.progressive_level, j.num_steps,
                j.upsample_steps) == (cfg.backbone, cfg.fp16,
                                      cfg.progressive_level, cfg.num_steps,
                                      cfg.upsample_steps)
    elif lifted == "-O2 after -O, before --IF":
        cfg = parse("--text", "a hamburger", "-O", "-O2", "--IF")
        assert cfg.backbone == "vanilla" and cfg.guidance == ("IF",)
    elif lifted == "-O2 oracle run":
        out = main(["--guidance", "oracle", "-O2"] + O2_TINY + ws)
        assert out["grad_ok"] and out["all_losses_finite"]
        assert all(g > 0 for g in out["vanilla_grad_max"])
        assert out["psnr_final"] > 0
    elif lifted == "-O2 SD run":
        out = main(["--text", "a hamburger", "-O2", "--tiny_guidance"] +
                   O2_TINY + ws)
        assert out["grad_ok"] and out["all_losses_finite"]
    elif lifted == "--backbone vanilla":
        cfg = parse("--guidance", "oracle", "--backbone", "vanilla", *ws)
        t = Trainer(cfg, "cpu")
        state = t.init_state(0)
        assert not t.needs_density_grid and t.occ_grid(state) is None
    elif lifted == "--optim adam":
        cfg = parse(*OPTION_FLAGS, "--optim", "adam", *ws)
        t = Trainer(cfg, "cpu")
        t.init_state(0)
        assert isinstance(t.optimizer, Adam)
    elif lifted == "--grad_clip":
        cfg = parse(*OPTION_FLAGS, "--grad_clip", "1", *ws)
        t = Trainer(cfg, "cpu")
        t.init_state(0)
        assert t.optimizer.grad_clip == 1.0
    elif lifted == "--lambda_tv on the triplane":
        out = main(OPTION_FLAGS + ["--lambda_tv", "1e-3",
                                   "--triplane_resolution", "16",
                                   "--triplane_channels", "4",
                                   "--grid_size", "16"] + O2_TINY + ws)
        assert out["grad_ok"] and out["all_losses_finite"]
    elif lifted == "--normal_mode finite_difference":
        cfg = parse(*OPTION_FLAGS, "--normal_mode", "finite_difference",
                    *ws)
        t = Trainer(cfg, "cpu")
        assert t.init_state(0).renderer.field.finite_difference
    else:
        for field in (NeRFField(backbone="vanilla"),
                      NeRFField(backbone="grid", density_act="softplus")):
            field.reset_parameters(torch.Generator().manual_seed(0))
            sigma = field.density(torch.zeros(4, 3))["sigma"]
            assert bool(torch.isfinite(sigma).all())


def test_module_refusals_name_a_roadmap_queue1_title():
    """No message of the port names a queue 1 item by its number."""
    port = Path(__file__).resolve().parents[1] / "dreamfusion_tpu_torch"
    for path in port.rglob("*.py"):
        assert not re.search(r"queue 1, item", path.read_text()), path


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
