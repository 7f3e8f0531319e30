"""The port's tooling against the JAX package's on the CPU: the turntable of
an OBJ (``evaluation/mesh_to_video.py``) on a textured sphere, CLIP
R-precision (``evaluation/r_precision.py``) on the tiny CLIP with the same
converted weights, the prompt decomposition, the browser viewer (its view
geometry against JAX's, a frame served on localhost, ``main --gui`` with
its "train" stepping), ``--profile``'s trace, the Tensorboard scalars and
the JAX CLI's flag surface (``tests/test_cli_config.py``'s checks, each
against JAX's parser).

Tolerances: turntable frames 1e-4 (the same rasterizer selections, fp32
shading); the CLIP similarities 1e-5; Pillow's bilinear resize, the
prompt keywords, the parsed configs and the view's rays exact or 1e-6.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.evaluation import mesh_to_video as jmv
from dreamfusion_tpu.evaluation import prompt as jprompt
from dreamfusion_tpu.evaluation import r_precision as jrp
from dreamfusion_tpu.main import build_parser as j_build_parser
from dreamfusion_tpu.main import config_from_args as j_config_from_args
from dreamfusion_tpu_torch import main as pmain
from dreamfusion_tpu_torch import viewer as pviewer
from dreamfusion_tpu_torch.config import Config, load_config_json
from dreamfusion_tpu_torch.evaluation import mesh_to_video as pmv
from dreamfusion_tpu_torch.evaluation import prompt as pprompt
from dreamfusion_tpu_torch.evaluation import r_precision as prp
from dreamfusion_tpu_torch.utils.image import decode_png, save_image

from test_torch_sdf import _uv_sphere

torch.set_num_threads(2)
TINY_RUN = ["--guidance", "oracle", "--backbone", "triplane", "--w", "16",
            "--h", "16", "--H", "16", "--W", "16", "--triplane_resolution",
            "32", "--triplane_channels", "8", "--grid_size", "32",
            "--hidden_dim", "32", "--dataset_size_train", "4",
            "--dataset_size_test", "1", "--ckpt", "scratch", "--device",
            "cpu"]


def _textured_sphere(tmp_path):
    verts, tris = _uv_sphere(0.8, 10, 16)
    uv = (verts[:, :2] * 0.5 + 0.5).astype(np.float32)
    tex = np.random.default_rng(0).uniform(0, 1, (16, 16, 3))
    obj = tmp_path / "sphere.obj"
    with open(obj, "w") as f:
        f.write("mtllib sphere.mtl\n")
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines(f"vt {u} {1 - v}\n" for u, v in uv)
        f.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in t) + "\n"
                     for t in tris)
    (tmp_path / "sphere.mtl").write_text("newmtl m\nmap_Kd tex.png\n")
    save_image(str(tmp_path / "tex.png"), tex)
    return obj


@pytest.mark.parametrize("textured", [True, False])
def test_turntable_matches_jax(textured, tmp_path):
    """Two 64² frames of a sphere (textured: the texture sampled at the
    interpolated uv; else 0.7 grey) under two-sided Lambert, against JAX's
    ``render_turntable``."""
    from dreamfusion_tpu_torch.mesh.export import read_obj
    verts, tris, uv, tex_path = read_obj(str(_textured_sphere(tmp_path)))
    tex = np.asarray(decode_png(open(tex_path, "rb").read()),
                     np.float32) / 255.0 if textured else None
    uv = uv if textured else None
    want = jmv.render_turntable(verts, tris, uv, tex, frames=2, size=64)
    got = pmv.render_turntable(verts, tris, uv, tex, frames=2, size=64,
                               device="cpu")
    for g, w in zip(got, want):
        assert (g < 0.99).any()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_turntable_cli_writes_the_frames(tmp_path):
    """``python -m ...evaluation.mesh_to_video`` on the CPU: the video (or,
    without an encoder, its PNG frames) of a textured OBJ."""
    obj = _textured_sphere(tmp_path)
    out = pmv.main(["--mesh", str(obj), "--out", str(tmp_path / "t.mp4"),
                    "--frames", "2", "--size", "32", "--device", "cpu"])
    assert os.path.exists(out) and os.path.getsize(out) > 0


def _clip_root(tmp_path):
    """A root holding the tiny CLIP's converted weights (JAX's
    ``save_params_npz`` of random params)."""
    from dreamfusion_tpu.guidance.clip import CLIPConfig, CLIPGuidance
    from dreamfusion_tpu.utils.params import save_params_npz
    from torch_parity import random_flax_params
    g = CLIPGuidance(CLIPConfig(tiny=True))
    vc, tc = g.cfg.vision_config(), g.cfg.text_config()
    params = {
        "vision": random_flax_params(
            g.vision.init, jnp.zeros((1, vc.image_size, vc.image_size, 3)),
            seed=3),
        "text": random_flax_params(
            g.text.init, jnp.zeros((1, tc.max_len), jnp.int32), seed=4)}
    proj = np.random.default_rng(5).standard_normal(
        (tc.hidden_size, vc.projection_dim)).astype(np.float32) * 0.1
    params["text_projection"] = proj
    root = tmp_path / "clip"
    root.mkdir()
    save_params_npz(str(root / "clip.npz"), params)
    return str(root)


def test_r_precision_matches_jax(tmp_path):
    """Three renders and two distractors through the tiny CLIP with the
    same weights: the images as Pillow resizes them, the mean similarity
    and R-precision as JAX's."""
    imgs = tmp_path / "renders"
    rng = np.random.default_rng(1)
    for i in range(3):
        save_image(str(imgs / f"r{i}.png"), rng.uniform(0, 1, (40, 48, 3)))
    want_x = jrp.load_images(str(imgs))
    got_x = prp.load_images(str(imgs))
    np.testing.assert_array_equal(got_x, want_x)
    root = _clip_root(tmp_path)
    dis = ["a red car", "a wooden chair"]
    want = jrp.r_precision(want_x, "a hamburger", dis, pretrained_root=root,
                           tiny=True)
    got = prp.r_precision(got_x, "a hamburger", dis, pretrained_root=root,
                          tiny=True, device="cpu")
    assert got["n_images"] == want["n_images"] == 3
    assert got["n_prompts"] == want["n_prompts"] == 3
    assert got["r_precision"] == want["r_precision"]
    np.testing.assert_allclose(got["mean_clip_similarity"],
                               want["mean_clip_similarity"], atol=1e-5)
    out = prp.main(["--images", str(imgs), "--text", "a hamburger",
                    "--pretrained_root", root, "--tiny", "--device", "cpu"])
    assert out["r_precision"] == 1.0 and out["n_prompts"] == 1


@pytest.mark.parametrize("text", [
    "a DSLR photo of a hamburger", "a squirrel wearing a leather jacket "
    "riding a motorcycle, highly detailed", "a bunny on a pancake and a cup "
    "of coffee next to a teapot; 3d render"])
def test_prompt_keywords_match_jax(text):
    assert pprompt.decompose(text) == jprompt.decompose(text)
    assert pprompt.main(["--text", text]) == jprompt.decompose(text)


def test_viewer_view_matches_jax():
    """The viewer's orbit view (rays and mvp) as JAX's ``_make_view``."""
    from dreamfusion_tpu.viewer import _make_view
    cfg = JConfig(text="x")
    want = _make_view(cfg, 70.0, 390.0, 3.0, 24)
    got = pviewer.make_view(Config(text="x"), 70.0, 390.0, 3.0, 24, "cpu")
    for name in ("rays_o", "rays_d", "mvp"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _get(url):
    return urllib.request.urlopen(url, timeout=120).read()


def test_viewer_serves_a_frame_on_localhost(tmp_path):
    """A tiny oracle run's workspace (config.json, checkpoints) served by
    the viewer over HTTP: the page, the caps, a PNG frame per shading mode
    that is the trainer's own albedo render for albedo."""
    ws = tmp_path / "ws"
    pmain.main(TINY_RUN + ["--iters", "4", "--workspace", str(ws)])
    cfg = load_config_json(str(ws / "config.json"))
    assert cfg.triplane_resolution == 32 and cfg.guidance == ("oracle",)
    trainer, state, gen = pmain.build_run(dataclasses.replace(cfg, test=True),
                                          "cpu", False)
    state, loaded = trainer.load_checkpoint(state, "latest")
    assert loaded and state.step == 4
    srv = pviewer.make_server(pviewer.ViewerState(trainer, state, gen), False,
                              0, "127.0.0.1")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert b"<canvas" in _get(url + "/")
        assert json.loads(_get(url + "/caps")) == {"train": False}
        frames = {s: decode_png(_get(
            f"{url}/render?polar=80&azimuth=20&size=24&shading={s}"))
            for s in ("albedo", "lambertian", "normal")}
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    batch = pviewer.make_view(cfg, 80.0, 20.0, cfg.default_radius, 24, "cpu")
    ref = trainer.render_view(state, batch, 24, 24)[0].reshape(24, 24, 3)
    want = (ref.clamp(0, 1).numpy() * 255).astype(np.uint8)
    np.testing.assert_array_equal(frames["albedo"], want)
    assert all(f.shape == (24, 24, 3) for f in frames.values())
    assert not np.array_equal(frames["albedo"], frames["normal"])


def test_main_gui_serves_the_run_and_trains(tmp_path, monkeypatch):
    """``main --gui`` serves the run's state instead of training; with a
    prior, "train" steps it."""
    servers = []
    make = pviewer.make_server

    def capture(*a, **k):
        servers.append(make(*a, **k))
        return servers[-1]

    monkeypatch.setattr(pviewer, "make_server", capture)
    monkeypatch.setenv("DFTPU_VIEWER_PORT", "0")
    out = {}
    th = threading.Thread(target=lambda: out.update(pmain.main(
        TINY_RUN + ["--iters", "4", "--gui", "--workspace",
                    str(tmp_path / "ws")])))
    th.start()
    try:
        for _ in range(600):
            if servers or not th.is_alive():
                break
            th.join(0.1)
        assert servers, "main --gui started no server"
        url = f"http://localhost:{servers[0].server_address[1]}"
        assert json.loads(_get(url + "/caps")) == {"train": True}
        assert json.loads(_get(url + "/train?steps=2"))["step"] == 2
        assert decode_png(_get(url + "/render?size=16")).shape == (16, 16, 3)
    finally:
        if servers:
            servers[0].shutdown()
        th.join()
    assert out["steps"] == 4 and "losses" not in out


def test_profile_writes_a_trace_and_tensorboard_its_scalars(tmp_path):
    """``--profile``: the first epoch's Chrome trace under
    workspace/profile; the loss and SDS loss under workspace/run through
    tensorboardX at each log step; ``config.json`` beside them."""
    ws = tmp_path / "ws"
    summary = pmain.main(TINY_RUN + ["--iters", "8", "--profile",
                                     "--workspace", str(ws)])
    trace = ws / "profile" / "trace.json"
    assert summary["profile"]["trace"] == str(trace)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(ws / "run"))
    acc.Reload()
    steps = [e.step for e in acc.Scalars("train/loss")]
    assert steps == [4, 8]
    assert [e.value for e in acc.Scalars("train/loss")] == pytest.approx(
        summary["losses"])
    assert load_config_json(str(ws / "config.json")).iters == 8
    quiet = tmp_path / "quiet"
    pmain.main(TINY_RUN + ["--iters", "4", "--use_tensorboard", "false",
                           "--workspace", str(quiet)])
    assert not (quiet / "run").exists() and not (quiet / "profile").exists()


FLAG_SETS = {
    "compat": ["--cuda_ray", "--taichi_ray", "--max_spp", "4", "--radius",
               "4.5", "--fovy", "30", "--light_theta", "45", "--light_phi",
               "10"],
    "fields": ["--test_interval", "7", "--hf_key", "k", "--vram_O",
               "--learned_embeds_path", "e.bin", "--ckpt_extra", "x.pth",
               "--max_steps", "512", "--use_tensorboard", "false",
               "--lambda_clip", "2.5", "--freq_multires", "8",
               "--freq_multires_bg", "3"],
    "alias wins": ["--default_radius", "2.0", "--radius", "4.0",
                   "--default_fovy", "15", "--fovy", "25"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_jax_flag_surface_parses_as_jax(name):
    """The flags of ``tests/test_cli_config.py``'s compat and field checks,
    each parsed by both CLIs: every field of the port's Config as JAX's."""
    argv = ["--text", "x"] + FLAG_SETS[name]
    want = j_config_from_args(j_build_parser().parse_args(argv))
    got = pmain.config_from_args(pmain.build_parser().parse_args(argv))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if name == "compat":
        assert got.default_radius == 4.5 and got.default_fovy == 30.0
        assert got.light_theta == 45.0 and got.light_phi == 10.0
    if name == "alias wins":
        assert (got.default_radius, got.default_fovy) == (4.0, 25.0)


def test_args_file_splices_as_jax(tmp_path):
    f = tmp_path / "res.args"
    f.write_text("--w\n32\n--h\n24\n--radius 3.5\n")
    argv = ["--text", "x", "--file", str(f)]
    got = pmain.config_from_args(pmain.build_parser().parse_args(argv))
    want = j_config_from_args(j_build_parser().parse_args(argv))
    assert (got.w, got.h, got.default_radius) == (32, 24, 3.5)
    assert (got.w, got.h, got.default_radius) == \
        (want.w, want.h, want.default_radius)


def _t5_tokenizer_dir(tmp_path):
    """A small Unigram tokenizer in T5's layout (NFKC, runs of spaces
    collapsed, Metaspace, ``$A </s>``), written as ``tokenizer.json``."""
    from tokenizers import (Regex, Tokenizer, models, normalizers,
                            pre_tokenizers, processors)
    pieces = ["<pad>", "</s>", "<unk>", "▁", "▁a", "▁ham", "burger",
              "▁hamburger", "▁the", "▁of", "▁photo", "▁dslr", "s", "a", "b",
              "e", "g", "h", "m", "o", "r", "t", "u", "x", ",", "!", "fi",
              "▁fi", "sh", "▁f"]
    rng = np.random.default_rng(9)
    vocab = [(p, 0.0 if i < 3 else float(-rng.uniform(1, 9)))
             for i, p in enumerate(pieces)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFKC(),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    root = tmp_path / "t5tok"
    root.mkdir()
    tok.save(str(root / "tokenizer.json"))
    return str(root)


T5_PROMPTS = ["a hamburger", "a  DSLR photo of  the hamburger, xyz!",
              "ﬁsh ｏf the sea", "", "a " * 60 + "hamburger", "burgers"]


def test_t5_tokenizer_matches_transformers(tmp_path):
    """The plain-Python Unigram reader against ``T5TokenizerFast`` on a
    tokenizer the test writes: ids and attention masks, padded and
    truncated to 77, on prompts with unknown characters, runs of spaces,
    NFKC's ligatures and full-width letters, and one past the length."""
    from transformers import T5TokenizerFast

    from dreamfusion_tpu_torch.guidance.t5_tokenizer import T5Tokenizer
    root = _t5_tokenizer_dir(tmp_path)
    ref = T5TokenizerFast.from_pretrained(root)
    ours = T5Tokenizer(os.path.join(root, "tokenizer.json"), 77)
    for text in T5_PROMPTS:
        want = ref(text, padding="max_length", max_length=77,
                   truncation=True, return_tensors="np")
        ids, mask = ours(text)
        np.testing.assert_array_equal(ids, want["input_ids"], err_msg=text)
        np.testing.assert_array_equal(mask, want["attention_mask"],
                                      err_msg=text)


def test_if_encode_text_with_a_tokenizer_matches_jax(tmp_path):
    """``IFGuidance.encode_text(text, pretrained_root)``: T5's tokens from
    the root's ``tokenizer.json`` through the tiny T5 with JAX's weights,
    against JAX's method (``T5TokenizerFast``); without the file, the hash
    tokens on both sides."""
    from dreamfusion_tpu.guidance.deepfloyd import IFConfig as JIFConfig
    from dreamfusion_tpu.guidance.deepfloyd import IFGuidance as JIF
    from dreamfusion_tpu_torch.guidance.deepfloyd import IFConfig, IFGuidance
    from dreamfusion_tpu_torch.utils.convert import params_from_jax

    from test_torch_if import _t5_params
    root = _t5_tokenizer_dir(tmp_path)
    t5p = _t5_params(21)
    jg = JIF(JIFConfig(tiny=True))
    pg = IFGuidance(IFConfig(tiny=True), "cpu")
    pg.t5 = pg.build_t5()
    pg.t5.load_state_dict(params_from_jax({"t5": t5p})["t5"])
    for text, r in (("a  DSLR photo of the hamburger", root),
                    ("a hamburger", None)):
        want = np.asarray(jg.encode_text(t5p, text, r))
        got = pg.encode_text(text, r).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
