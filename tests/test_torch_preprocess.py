"""The port's ``preprocess_image`` against the JAX package's on the CPU:
``run_omnidata`` on the port's DPT from a written torch checkpoint (a tiny
DPT: the full width is never built on the CPU), ``normal_from_depth``,
``recenter`` and the whole CLI (GrabCut's matte, the recentring, the depth
and normal sidecars) on one PNG.

Tolerances: the DPT's output 1e-4 of its largest magnitude (fp32 layers,
sums in another order), the sidecars one uint8 level (the depth's rounding
to 8 bits), ``normal_from_depth`` and ``recenter`` and the matte exact.
"""

import functools
import os

import numpy as np
import pytest
import torch

from dreamfusion_tpu import preprocess_image as JP
from dreamfusion_tpu.models import dpt as jdpt
from dreamfusion_tpu_torch import preprocess_image as PP
from dreamfusion_tpu_torch.models import dpt as pdpt
from dreamfusion_tpu_torch.utils import convert as PC
from dreamfusion_tpu_torch.utils.image import decode_png, save_image

from test_torch_dpt import TINY, _tiny_pair, _torch_state

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")


def _ckpts(tmp_path):
    """Tiny depth and normal DPTs' checkpoints in the omnidata layout."""
    out = {}
    for task, seed in (("depth", 7), ("normal", 8)):
        _, _, pm = _tiny_pair(seed)
        if task == "depth":
            sd = pm.state_dict()
            pm = pdpt.DPTDepthModel(pdpt.DPTConfig(**{**TINY,
                                                      "num_channels": 1}))
            sd = {k: v[:1] if k.startswith("scratch.output_conv.4") else v
                  for k, v in sd.items()}
            pm.load_state_dict(sd)
        path = tmp_path / f"omnidata_dpt_{task}_v2.pt"
        torch.save(_torch_state(pm), path)
        out[task] = str(path)
    return out


def _cfgs(task):
    kw = {**TINY, "num_channels": 1 if task == "depth" else 3}
    return jdpt.DPTConfig(**kw), pdpt.DPTConfig(**kw)


def _photo(tmp_path, n=72):
    """An RGB photo: a shaded disc on a grey, textured background."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:n, 0:n]
    disc = np.hypot(xx - 0.55 * n, yy - 0.5 * n) < 0.3 * n
    bg = 0.55 + 0.05 * rng.standard_normal((n, n, 3))
    fg = np.stack([0.9 - yy / (2 * n), 0.3 + 0 * xx, 0.2 + xx / (2 * n)], -1)
    img = np.where(disc[..., None], fg, bg)
    path = tmp_path / "photo.png"
    save_image(str(path), img)
    return str(path)


@pytest.mark.parametrize("task", ["depth", "normal"])
def test_run_omnidata_matches_jax(task, tmp_path):
    """The DPT as the omnidata wrapper runs it (resize to hw², depth's
    (x - 0.5) / 0.5, clamp, resize back) from a ``.pt`` converted on the
    fly, on both sides."""
    rgb = (np.random.default_rng(3).uniform(0, 1, (40, 52, 3)) * 255
           ).astype(np.uint8)
    ckpt = _ckpts(tmp_path)[task]
    jc, pc = _cfgs(task)
    want = JP.run_omnidata(rgb, ckpt, task, cfg=jc, hw=64)
    got = PP.run_omnidata(rgb, ckpt, task, cfg=pc, hw=64, device="cpu")
    assert got.shape == want.shape == ((40, 52) if task == "depth"
                                       else (40, 52, 3))
    assert 0 < np.abs(want).max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_normal_from_depth_and_recenter_match_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 1, (30, 34)).astype(np.float32)
    np.testing.assert_array_equal(PP.normal_from_depth(depth),
                                  JP.normal_from_depth(depth))
    rgba = np.zeros((50, 60, 4), np.uint8)
    rgba[10:30, 20:45] = rng.integers(0, 255, (20, 25, 4))
    rgba[10:30, 20:45, 3] = 255
    for size, border in ((32, 0.2), (64, 0.1)):
        np.testing.assert_array_equal(PP.recenter(rgba, size, border),
                                      JP.recenter(rgba, size, border))
    empty = np.zeros((20, 20, 4), np.uint8)
    np.testing.assert_array_equal(PP.recenter(empty, 16),
                                  JP.recenter(empty, 16))


def _read(path):
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.int16)


def test_cli_matches_jax(tmp_path, monkeypatch):
    """``python -m dreamfusion_tpu_torch.preprocess_image photo.png
    --omnidata_depth d.pt --omnidata_normal n.pt --size 64`` against JAX's
    ``preprocess``: the same rgba (GrabCut from one RNG seed), depth and
    normal PNGs; the port's normal model from the ``.npz`` its converter
    writes reads the same."""
    ckpts = _ckpts(tmp_path)
    run_omnidata = PP.run_omnidata
    # the tiny configs at 64² stand in for the full width at 384²
    monkeypatch.setattr(JP, "run_omnidata", functools.partial(
        _jax_tiny, JP.run_omnidata))
    monkeypatch.setattr(PP, "run_omnidata", functools.partial(
        _port_tiny, PP.run_omnidata))
    src = _photo(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    outs = {}
    for d, run in ((jdir, lambda p: JP.preprocess(
            p, 64, 0.2, None, True, ckpts["depth"], ckpts["normal"])),
            (pdir, lambda p: PP.main([p, "--size", "64", "--omnidata_depth",
                                      ckpts["depth"], "--omnidata_normal",
                                      ckpts["normal"], "--device", "cpu"]))):
        d.mkdir()
        p = str(d / "photo.png")
        with open(src, "rb") as f, open(p, "wb") as g:
            g.write(f.read())
        cv2.setRNGSeed(0)
        outs[d] = run(p)
    for j, p in zip(outs[jdir], outs[pdir]):
        assert os.path.basename(j) == os.path.basename(p)
        a, b = _read(j), _read(p)
        assert a.shape == b.shape
        if j.endswith("_rgba.png"):
            np.testing.assert_array_equal(b, a)
            assert 0 < (a[..., 3] > 0).mean() < 1
        else:
            assert np.abs(b - a).max() <= 1, j
    _, pc = _cfgs("normal")
    monkeypatch.setattr(pdpt.DPTConfig, "normal", staticmethod(lambda: pc))
    PC.main(["--kind", "dpt", "--src", ckpts["normal"], "--out",
             str(tmp_path / "npz")])
    rgb = _read(outs[pdir][0])[..., :3].astype(np.uint8)
    np.testing.assert_array_equal(
        run_omnidata(rgb, str(tmp_path / "npz" / "dpt_normal.npz"),
                     "normal", cfg=pc, hw=64, device="cpu"),
        run_omnidata(rgb, ckpts["normal"], "normal", cfg=pc, hw=64,
                     device="cpu"))


def _jax_tiny(run, rgb, ckpt, task="depth", **kw):
    return run(rgb, ckpt, task, cfg=_cfgs(task)[0], hw=64)


def _port_tiny(run, rgb, ckpt, task="depth", **kw):
    return run(rgb, ckpt, task, cfg=_cfgs(task)[1], hw=64, **kw)
