"""The file-based image mode against Pillow and the JAX package.

The port's PNG reader (``utils/image.py``; the GPU host has no Pillow)
against Pillow on PNGs Pillow writes (grey, grey + alpha, RGB, RGBA, its
adaptive row filters) and on PNGs written here with each of the five row
filters forced; the files it refuses, by name; ``to_rgba`` against
Pillow's ``convert("RGBA")``; the known-view resize against JAX's
``_resize`` (Pillow's bilinear on uint8) within 1/255 (it is exact);
``parse_image_config`` on ``config/example.csv``'s form (spaces after the
commas, in the header too) and ``load_ref_images`` with the ``_depth`` and
``_normal`` sidecars and with ``--image_config``, field by field against
JAX's.
"""

import dataclasses
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.training import image_data as jimg
from dreamfusion_tpu.utils.image import load_image as j_load_image
from dreamfusion_tpu_torch.training import image_data as pimg
from dreamfusion_tpu_torch.utils.image import decode_png, load_image, to_rgba

from torch_parity import port_cfg

ROOT = Path(__file__).resolve().parents[1]
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _picture(C, H=40, W=45, seed=0):
    """Smooth rows (which Pillow's adaptive filtering encodes with the
    sub, up and paeth filters) over noisy ones (none)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (np.sin(xx / 7.0)[..., None] * 60 + np.cos(yy / 5.0)[..., None]
              * 50 + 120 + rng.integers(0, 3, (H, W, C))).clip(0, 255)
    noise = rng.integers(0, 256, (H, W, C))
    img = np.concatenate([smooth[:H // 2], noise[H // 2:]]).astype(np.uint8)
    return img[..., 0] if C == 1 else img


def _pil_png(arr, mode) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def _filter_row(kind, row, prev, bpp):
    """PNG's filter `kind` applied to one row (uint8 arrays)."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = (np.abs(a + p - c - v) for v in (a, p, c))
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _png_with_filter(arr, kind) -> bytes:
    """An 8-bit PNG of `arr` with every row under filter `kind` (4: a
    cycle of all five)."""
    arr = arr if arr.ndim == 3 else arr[..., None]
    H, W, C = arr.shape
    rows, prev = [], np.zeros(W * C, np.uint8)
    for y in range(H):
        k = y % 5 if kind == "all" else kind
        row = arr[y].reshape(-1)
        rows.append(bytes([k]) + _filter_row(k, row, prev, C).tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) +
            chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_matches_pillow_on_its_files(mode):
    data = _pil_png(_picture(MODES[mode]), mode)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:])
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_png(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert raw[0] in range(5)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "all"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_undoes_every_row_filter(mode, kind):
    """Each filter forced on every row (and all five in turn), read by
    Pillow and by the port."""
    data = _png_with_filter(_picture(MODES[mode], seed=1), kind)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(decode_png(data), want)


def test_load_image_and_to_rgba_match(tmp_path):
    """``load_image`` is JAX's (Pillow's array over 255) for every mode,
    and ``to_rgba`` Pillow's ``convert("RGBA")``."""
    for mode, C in MODES.items():
        arr = _picture(C, seed=2)
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode).save(path)
        got = load_image(path)
        np.testing.assert_array_equal(got, j_load_image(path))
        want = np.asarray(Image.open(path).convert("RGBA")) / 255.0
        np.testing.assert_allclose(to_rgba(got), want, atol=1e-7)


@pytest.mark.parametrize("what", ["palette", "16-bit", "interlaced",
                                  "not a PNG"])
def test_png_reader_names_what_it_does_not_read(tmp_path, what):
    arr = _picture(3, seed=3)
    if what == "palette":
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").convert("P").save(buf, "PNG")
        data, match = buf.getvalue(), "palette"
    elif what == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(arr[..., 0].astype(np.uint16) * 257).save(buf,
                                                                  "PNG")
        data, match = buf.getvalue(), "16-bit"
    elif what == "interlaced":
        data = bytearray(_png_with_filter(arr, 0))
        data[28] = 1                      # IHDR's interlace byte
        data, match = bytes(data), "interlaced"
    else:
        data, match = b"GIF89a" + bytes(20), "not a PNG"
    with pytest.raises(ValueError, match=match):
        decode_png(data)


@pytest.mark.parametrize("src,dst,C", [
    ((96, 96), (96, 96), 3), ((37, 53), (96, 96), 3),
    ((300, 200), (96, 144), 3), ((64, 64), (512, 512), 0),
    ((513, 257), (37, 91), 3), ((1024, 768), (96, 96), 0)])
def test_known_view_resize_matches_jax(src, dst, C):
    """Pillow's bilinear on the uint8 image, shrinking (antialiased) and
    growing, per axis; the values clipped to [0, 1] first."""
    rng = np.random.default_rng(sum(src) + C)
    img = (rng.random(src + ((C,) if C else ())) * 1.1 - 0.05).astype(
        np.float32)
    want = jimg._resize(img, *dst)
    got = pimg.pil_bilinear_resize(img, *dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-7)
    np.testing.assert_array_equal(got, want)


def _write_refs(tmp_path, sidecars=True):
    """Three RGBA references (the alpha soft at the edges) and, with
    `sidecars`, their depth (grey) and normal (RGB) PNGs; a CSV in
    config/example.csv's form naming them."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:50, 0:60]
    names = []
    for i in range(3):
        alpha = np.clip(1.5 - np.hypot(xx - 30 - 5 * i, yy - 25) / 12, 0, 1)
        rgba = np.concatenate([rng.random((50, 60, 3)), alpha[..., None]],
                              -1)
        path = tmp_path / f"view{i}_rgba.png"
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(path)
        if sidecars:
            depth = (alpha * 200 + rng.integers(0, 20, alpha.shape))
            Image.fromarray(depth.astype(np.uint8), "L").save(
                tmp_path / f"view{i}_depth.png")
            Image.fromarray((rng.random((50, 60, 3)) * 255).astype(np.uint8),
                            "RGB").save(tmp_path / f"view{i}_normal.png")
        names.append(str(path))
    csv = tmp_path / "refs.csv"
    csv.write_text("zero123_weight, radius, polar, azimuth, image\n" +
                   "".join(f"{w}, {r}, {p}, {a}, {n}\n" for (w, r, p, a), n
                           in zip([(1, 3, 90, 0), (1, 3, 90, 180),
                                   (0.5, 3.5, 80, 90)], names)))
    return names, str(csv)


def test_parse_image_config_matches_jax(tmp_path):
    """The spaces after the commas, the header's included, are
    stripped; config/example.csv itself parses the same."""
    _, csv = _write_refs(tmp_path, sidecars=False)
    for path in (csv, str(ROOT / "config" / "example.csv")):
        rows = pimg.parse_image_config(path)
        assert rows == jimg.parse_image_config(path)
        assert set(rows[0]) == {"zero123_weight", "radius", "polar",
                                "azimuth", "image"}
    assert pimg.parse_image_config(csv)[2]["zero123_weight"] == "0.5"


@pytest.mark.parametrize("how", ["image", "image_config", "no_sidecars"])
def test_load_ref_images_matches_jax(tmp_path, how):
    """``--image`` (one reference, the default pose) or ``--image_config``
    (three, their poses and weights): rgb premultiplied by alpha, the mask
    resized as floats then > 0.5, depth and normals from the sidecars
    (none when a reference lacks them), at 1.5 x 24²."""
    names, csv = _write_refs(tmp_path, sidecars=how != "no_sidecars")
    kw = dict(image=names[0], h=24, w=24)
    if how != "image":
        kw["image_config"] = csv
    jcfg = JConfig(**kw)
    want = jimg.load_ref_images(jcfg, 24, 24)
    got = pimg.load_ref_images(port_cfg(jcfg), 24, 24)
    K = 1 if how == "image" else 3
    assert got.rgb.shape == (K, 36, 36, 3) and got.mask.dtype == bool
    for f in dataclasses.fields(pimg.RefImages):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_allclose(a, b, atol=1 / 255 + 1e-7,
                                       err_msg=f.name)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (got.depth is None) == (how == "no_sidecars")
    assert 0 < got.mask.mean() < 1


@pytest.mark.parametrize("mode", ["L", "LA"])
def test_load_ref_images_reads_grey_and_grey_alpha(tmp_path, mode):
    """A grey or grey + alpha reference reads as JAX's reader reads the
    same picture converted to RGBA by Pillow: grey spread to RGB, the mask
    from the alpha where the file has one, else everywhere."""
    yy, xx = np.mgrid[0:50, 0:60]
    alpha = np.clip(1.5 - np.hypot(xx - 30, yy - 25) / 12, 0, 1)
    grey = np.random.default_rng(5).random((50, 60))
    arr = np.stack([grey, alpha], -1) if mode == "LA" else grey
    im = Image.fromarray((arr * 255).astype(np.uint8), mode)
    im.save(tmp_path / "grey_rgba.png")
    im.convert("RGBA").save(tmp_path / "conv_rgba.png")
    got = pimg.load_ref_images(port_cfg(JConfig(
        image=str(tmp_path / "grey_rgba.png"), h=24, w=24)), 24, 24)
    want = jimg.load_ref_images(JConfig(
        image=str(tmp_path / "conv_rgba.png"), h=24, w=24), 24, 24)
    assert got.rgb.shape == (1, 36, 36, 3)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.mask.all() == (mode == "L")


# ---------------------------------------------------------------------------
# the CLI on a file reference
# ---------------------------------------------------------------------------

CLI = ["--backbone", "triplane", "--iters", "5", "--w", "8", "--h", "8",
       "--triplane_resolution", "16", "--triplane_channels", "4",
       "--grid_size", "16", "--hidden_dim", "16", "--dataset_size_train",
       "5", "--dataset_size_test", "1", "--H", "8", "--W", "8", "--ckpt",
       "scratch"]


def test_cli_zero123_runs_on_the_cpu_and_needs_a_gpu(tmp_path, monkeypatch):
    """``--image <png> --tiny_guidance --device cpu`` (zero123 through the
    image preset) and its ``--image_config`` twin (three references) train
    end to end; the novel-view CLI writes its PNG; without ``--device
    cpu`` on a machine with no GPU each raises, naming the flag."""
    from dreamfusion_tpu_torch.guidance import zero123
    from dreamfusion_tpu_torch.main import main

    names, csv = _write_refs(tmp_path, sidecars=False)
    flags = ["--image", names[0]] + CLI
    for extra in ([], ["--image_config", csv]):
        out = main(flags + extra + ["--tiny_guidance", "--device", "cpu",
                                    "--workspace", str(tmp_path / "ws")])
        assert out["grad_ok"] and out["all_losses_finite"]
        assert out["known_view_steps"] == 2
        assert set(out["startup"]) >= {"unet", "vae", "vision",
                                        "cc_projection", "embeddings"}
    png = str(tmp_path / "novel.png")
    zero123._main(["--image", names[0], "--tiny", "--steps", "2", "--out",
                   png, "--device", "cpu"])
    assert load_image(png).shape == (16, 16, 3)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(flags + ["--tiny_guidance", "--workspace", str(tmp_path / "g")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        zero123._main(["--image", names[0], "--tiny", "--out", png])
