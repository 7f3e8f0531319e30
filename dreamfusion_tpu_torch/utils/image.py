"""Host-side image and video files (``dreamfusion_tpu/utils/image.py``).

PNGs are written and read with the standard library (``zlib`` +
``struct``): the GPU host has no Pillow, imageio or OpenCV.  The reader
takes 8-bit grey, grey + alpha, RGB and RGBA PNGs, not interlaced, with any
of the five row filters, and names anything else it finds;
``load_image`` returns what Pillow's array of the file would be, over 255.  Videos go to mp4 through
imageio or OpenCV when one of them imports, else to per-frame PNGs with a
logged line, as the JAX package's writer does.  A choice of file format on
the host, not a device fallback.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np


def to_uint8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H, W] (grey) or [H, W, 3|4] → PNG bytes (8-bit, no filter)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    color = {1: 0, 3: 2, 4: 6}[C]
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          arr.reshape(H, W * C)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}       # PNG colour type → channels
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha",
                6: "RGBA"}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each row's filter (0 none, 1 sub, 2 up, 3 average, 4 paeth)
    → uint8 [H, stride]."""
    rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + stride)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        f, line = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prev
        elif f in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if f == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {f} (0-4 exist)")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W] (grey) or [H, W, 2 | 3 | 4] (grey + alpha,
    RGB, RGBA): 8 bits a sample, not interlaced, any row filters."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file (no PNG signature)")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if head is None:
        raise ValueError("PNG without an IHDR chunk")
    W, H, depth, color, _, _, interlace = head
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'unknown')}) is not "
                         f"read: grey, grey + alpha, RGB or RGBA only")
    if depth != 8:
        raise ValueError(f"PNG of {depth}-bit samples is not read: 8-bit "
                         f"only")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not read")
    C = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), H, W * C, C)
    return img.reshape(H, W) if C == 1 else img.reshape(H, W, C)


def load_image(path: str) -> np.ndarray:
    """A PNG file → float32 in [0, 1], [H, W] (grey) or [H, W, C]."""
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float32) / 255.0


def to_rgba(img: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 1-4] → [H, W, 4]: grey spread to RGB, an opaque
    alpha where there is none (Pillow's ``convert("RGBA")``)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[-1]
    rgb = img[..., :3] if C >= 3 else np.repeat(img[..., :1], 3, axis=-1)
    alpha = img[..., C - 1:] if C in (2, 4) else np.ones_like(img[..., :1])
    return np.concatenate([rgb, alpha], axis=-1)


def save_image(path: str, img) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def _save_video_cv2(path: str, arr: np.ndarray, fps: int) -> str:
    import cv2
    h, w = arr.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    for f in arr:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"cv2.VideoWriter wrote nothing to {path}")
    return path


def save_video(path: str, frames: List[np.ndarray], fps: int = 25,
               log=print) -> str:
    """mp4 through imageio or OpenCV; per-frame PNGs when neither can
    write one.  Returns the written path (the first PNG's under the
    fallback)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.stack([to_uint8(f) for f in frames])
    if arr.ndim == 3:
        arr = np.stack([arr] * 3, axis=-1)
    errors = []
    try:
        import imageio
        imageio.mimwrite(path, arr, fps=fps, quality=8, macro_block_size=1)
        return path
    except Exception as e:    # no imageio, or no ffmpeg plugin behind it
        errors.append(repr(e))
    try:
        return _save_video_cv2(path, arr, fps)
    except Exception as e:
        errors.append(repr(e))
    log(f"[save_video] no video encoder available ({'; '.join(errors)}); "
        f"writing {os.path.basename(path)} as {len(arr)} per-frame PNGs")
    base = os.path.splitext(path)[0]
    for i, f in enumerate(arr):
        save_image(f"{base}_{i:04d}.png", f)
    return f"{base}_0000.png"


def colorize_depth(depth) -> np.ndarray:
    d = np.asarray(depth)
    lo, hi = np.percentile(d[d > 0], 1) if (d > 0).any() else 0.0, \
        d.max() + 1e-6
    d = np.clip((d - lo) / (hi - lo + 1e-6), 0, 1)
    return np.stack([d] * 3, axis=-1)
