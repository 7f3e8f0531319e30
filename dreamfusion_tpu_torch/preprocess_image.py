"""Image preprocessing for image-conditioned training
(``dreamfusion_tpu/preprocess_image.py``).

Writes ``X_rgba.png`` and, where a model gives them, ``X_depth.png`` and
``X_normal.png``, the sidecars ``training/image_data.py::load_ref_images``
reads.  Each stage takes the first backend that imports, in JAX's order:
- background removal: carvekit, then rembg, then OpenCV's GrabCut seeded
  by the image border;
- depth and normals: the port's DPT (``models/dpt.py``, omnidata's
  vitb_rn50_384) with local omnidata checkpoints (``--omnidata_depth`` /
  ``--omnidata_normal``: a torch ``.ckpt``/``.pt``, converted on the fly,
  or a converted ``.npz``), on the card unless ``--device cpu``; else a
  local transformers DPT for depth (``--dpt_path``) and finite-difference
  normals from the depth;
- an optional BLIP-2 caption (``--caption_model``, a local transformers
  checkpoint).
PNGs are read and written by ``utils/image.py``.  A backend that is needed
and missing (OpenCV for the GrabCut matte and the recentring, transformers
for ``--dpt_path`` or the caption) raises its ImportError.

    python -m dreamfusion_tpu_torch.preprocess_image image.png [--size 256]
        [--border_ratio 0.2] [--recenter 1] [--omnidata_depth d.ckpt]
        [--omnidata_normal n.ckpt] [--dpt_path dir] [--caption_model dir]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .models.dpt import DPTConfig, DPTDepthModel, load_dpt
from .ops.resize import resize_bilinear
from .utils.device import resolve_device
from .utils.image import decode_png, encode_png


def read_rgb(path: str) -> np.ndarray:
    """A PNG → uint8 [H, W, 3], as Pillow's ``convert("RGB")`` (alpha
    dropped, grey spread)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.ndim == 2:
        img = img[..., None]
    return np.ascontiguousarray(img[..., :3] if img.shape[-1] >= 3 else
                                np.repeat(img[..., :1], 3, axis=-1))


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


# ---------------------------------------------------------------------------
# background removal
# ---------------------------------------------------------------------------

class BackgroundRemoval:
    """carvekit → rembg → GrabCut, the first that imports."""

    def __init__(self):
        self.backend = "grabcut"
        try:
            from carvekit.api.high import HiInterface  # noqa: F401
            self.backend = "carvekit"
        except Exception:
            try:
                import rembg  # noqa: F401
                self.backend = "rembg"
            except Exception:
                pass

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 → [H, W, 4] uint8 rgba."""
        if self.backend == "carvekit":
            from PIL import Image

            from carvekit.api.high import HiInterface
            iface = HiInterface(object_type="object", batch_size_seg=1,
                                batch_size_matting=1)
            out = iface([Image.fromarray(rgb)])[0]
            return np.asarray(out.convert("RGBA"))
        if self.backend == "rembg":
            import rembg
            return np.asarray(rembg.remove(rgb))
        return self._grabcut(rgb)

    @staticmethod
    def _grabcut(rgb: np.ndarray, iters: int = 5) -> np.ndarray:
        import cv2
        h, w = rgb.shape[:2]
        mask = np.zeros((h, w), np.uint8)
        b = max(2, int(0.02 * min(h, w)))
        rect = (b, b, w - 2 * b, h - 2 * b)
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        cv2.grabCut(rgb, mask, rect, bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
        alpha = np.where((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD),
                         255, 0).astype(np.uint8)
        kernel = np.ones((3, 3), np.uint8)
        alpha = cv2.morphologyEx(alpha, cv2.MORPH_OPEN, kernel)
        alpha = cv2.morphologyEx(alpha, cv2.MORPH_CLOSE, kernel)
        return np.dstack([rgb, alpha])


# ---------------------------------------------------------------------------
# depth / normal
# ---------------------------------------------------------------------------

def dpt_predict(model: DPTDepthModel, rgb: np.ndarray, task: str = "depth",
                hw: int = 384) -> np.ndarray:
    """The omnidata wrapper around a built DPT: the image resized to hw²
    (antialiased when shrinking), depth's input (x - 0.5) / 0.5, the
    output clamped to [0, 1] and resized back → [H, W] depth or [H, W, 3]
    normals, float32."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(rgb.astype(np.float32) / 255.0).to(dev)[None]
    x = resize_bilinear(x, (hw, hw))
    if task == "depth":
        x = (x - 0.5) / 0.5
    out = model(x).clamp(0.0, 1.0)
    out = resize_bilinear(out, rgb.shape[:2])[0].cpu().numpy()
    return out[..., 0] if task == "depth" else out


def run_omnidata(rgb: np.ndarray, ckpt: str, task: str = "depth",
                 cfg: Optional[DPTConfig] = None, hw: int = 384,
                 device="cuda") -> np.ndarray:
    """The DPT with omnidata weights (`ckpt`: a torch checkpoint, converted
    on the fly, or a converted ``.npz``) on `device` → ``dpt_predict``."""
    if cfg is None:
        cfg = DPTConfig.normal() if task == "normal" else DPTConfig.depth()
    model = load_dpt(ckpt, cfg, resolve_device(device))
    return dpt_predict(model, rgb, task, hw)


def estimate_depth(rgb: np.ndarray, dpt_path: Optional[str]
                   ) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 → [H, W] float32 in [0, 1] from a local transformers
    DPT, or None without one."""
    if not dpt_path or not os.path.exists(dpt_path):
        return None
    from transformers import DPTForDepthEstimation, DPTImageProcessor
    proc = DPTImageProcessor.from_pretrained(dpt_path)
    model = DPTForDepthEstimation.from_pretrained(dpt_path)
    model.eval()
    with torch.no_grad():
        inputs = proc(images=rgb, return_tensors="pt")
        depth = model(**inputs).predicted_depth[0].numpy()
    import cv2
    depth = cv2.resize(depth, (rgb.shape[1], rgb.shape[0]),
                       interpolation=cv2.INTER_LINEAR)
    lo, hi = depth.min(), depth.max()
    return ((depth - lo) / (hi - lo + 1e-9)).astype(np.float32)


def normal_from_depth(depth: np.ndarray, scale: float = 4.0) -> np.ndarray:
    """Finite-difference surface normals of a depth map → [H, W, 3] in
    [0, 1] (omnidata's encoding: n * 0.5 + 0.5)."""
    dzdx = np.gradient(depth, axis=1) * scale * depth.shape[1]
    dzdy = np.gradient(depth, axis=0) * scale * depth.shape[0]
    n = np.dstack([-dzdx, -dzdy, np.ones_like(depth)])
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9)
    return (n * 0.5 + 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# recenter
# ---------------------------------------------------------------------------

def recenter(rgba: np.ndarray, size: int, border_ratio: float = 0.2
             ) -> np.ndarray:
    """The alpha's bounding box scaled to (1 - border_ratio)·size on its
    longer side (OpenCV's area resize) and centred in a size² canvas."""
    import cv2
    alpha = rgba[..., 3]
    ys, xs = np.nonzero(alpha > 10)
    if len(ys) == 0:
        return cv2.resize(rgba, (size, size), interpolation=cv2.INTER_AREA)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    crop = rgba[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    crop = cv2.resize(crop, (nw, nh), interpolation=cv2.INTER_AREA)
    out = np.zeros((size, size, 4), rgba.dtype)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    out[oy:oy + nh, ox:ox + nw] = crop
    return out


# ---------------------------------------------------------------------------

class BLIP2Captioner:
    """An image → prompt captioner from a local transformers BLIP-2
    checkpoint directory; a missing directory raises at construction."""

    def __init__(self, model: str):
        from transformers import (AutoProcessor,
                                  Blip2ForConditionalGeneration)
        if not os.path.isdir(model):
            raise FileNotFoundError(
                f"BLIP-2 checkpoint dir not found: {model} (pass a local "
                "pre-downloaded Salesforce/blip2-* directory)")
        self.processor = AutoProcessor.from_pretrained(model)
        self.model = Blip2ForConditionalGeneration.from_pretrained(
            model).eval()

    def __call__(self, image: np.ndarray) -> str:
        from PIL import Image
        with torch.no_grad():
            inputs = self.processor(Image.fromarray(image),
                                    return_tensors="pt")
            ids = self.model.generate(**inputs, max_new_tokens=20)
        return self.processor.batch_decode(
            ids, skip_special_tokens=True)[0].strip()


def preprocess(path: str, size: int = 256, border_ratio: float = 0.2,
               dpt_path: Optional[str] = None, do_recenter: bool = True,
               omnidata_depth: Optional[str] = None,
               omnidata_normal: Optional[str] = None,
               caption_model: Optional[str] = None, device="cuda"
               ) -> Tuple[str, Optional[str], Optional[str]]:
    """`path` → (rgba path, depth path or None, normal path or None)."""
    img = read_rgb(path)
    rgba = BackgroundRemoval()(img)
    if do_recenter:
        rgba = recenter(rgba, size, border_ratio)
    base = os.path.splitext(path)[0]
    rgba_path = f"{base}_rgba.png"
    write_png(rgba_path, rgba)

    depth_path = normal_path = None
    mask = rgba[..., 3] > 10
    if omnidata_depth and os.path.exists(omnidata_depth):
        depth = run_omnidata(rgba[..., :3], omnidata_depth, "depth",
                             device=device)
    else:
        depth = estimate_depth(rgba[..., :3], dpt_path)
    if depth is not None:
        depth = depth * mask
        depth_path = f"{base}_depth.png"
        write_png(depth_path, (depth * 255).astype(np.uint8))
    if omnidata_normal and os.path.exists(omnidata_normal):
        normal = run_omnidata(rgba[..., :3], omnidata_normal, "normal",
                              device=device)
        normal = normal * mask[..., None]
    elif depth is not None:
        normal = normal_from_depth(depth)
    else:
        normal = None
    if normal is not None:
        normal_path = f"{base}_normal.png"
        write_png(normal_path, (normal * 255).astype(np.uint8))
    if caption_model:
        caption = BLIP2Captioner(caption_model)(img)
        cap_path = f"{base}_caption.txt"
        with open(cap_path, "w") as f:
            f.write(caption + "\n")
        print(f"[caption] {caption!r} -> {cap_path}")
    return rgba_path, depth_path, normal_path


def main(argv=None):
    ap = argparse.ArgumentParser("preprocess_image")
    ap.add_argument("path", type=str)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--border_ratio", type=float, default=0.2)
    ap.add_argument("--dpt_path", type=str, default=None,
                    help="local transformers DPT checkpoint dir (optional)")
    ap.add_argument("--omnidata_depth", type=str, default=None,
                    help="omnidata_dpt_depth_v2 .ckpt/.pt/.npz (optional)")
    ap.add_argument("--omnidata_normal", type=str, default=None,
                    help="omnidata_dpt_normal_v2 .ckpt/.pt/.npz (optional)")
    ap.add_argument("--recenter", type=int, default=1)
    ap.add_argument("--caption_model", type=str, default=None,
                    help="local BLIP-2 checkpoint dir → writes "
                         "*_caption.txt")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the DPT's device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    outs = preprocess(args.path, args.size, args.border_ratio,
                      args.dpt_path, bool(args.recenter),
                      args.omnidata_depth, args.omnidata_normal,
                      caption_model=args.caption_model, device=args.device)
    print("wrote:", *[o for o in outs if o])
    return outs


if __name__ == "__main__":
    main()
