"""Host-side image and video files (``dreamfusion_tpu/utils/image.py``).

PNGs are written with the standard library (``zlib`` + ``struct``): the
GPU host has no Pillow, imageio or OpenCV.  Videos go to mp4 through
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


def decode_png(data: bytes) -> np.ndarray:
    """The inverse of ``encode_png`` for its own files (filter type 0)."""
    pos, idat = 8, b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            W, H, _, color = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    C = {0: 1, 2: 3, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + W * C)
    if raw[:, 0].any():
        raise ValueError("only unfiltered PNG rows are read")
    return raw[:, 1:].reshape(H, W, C)


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
