"""CLIP R-precision (``dreamfusion_tpu/evaluation/r_precision.py``).

The cosine similarity of each render to the prompt through the port's
CLIP (``guidance/clip.py``: ViT-B/16 and its 12-layer text tower, the
patch embedding on K12), and R-precision@1 over the prompt and its
distractors.  Renders are resized to 224² as Pillow's ``BILINEAR`` does
(``training/image_data.py::pil_bilinear_resize``).  Without converted
weights (``--pretrained_root`` holding ``clip.npz``) the towers keep
random weights from the seed: the pipeline runs, the numbers mean
nothing.  On the card unless ``--device cpu``.

    python -m dreamfusion_tpu_torch.evaluation.r_precision \\
        --images workspace/validation --text "a hamburger" \\
        [--distractors prompts.txt] [--pretrained_root dir]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..guidance.clip import CLIPConfig, CLIPGuidance
from ..guidance.embeddings import load_tokenizer
from ..preprocess_image import read_rgb
from ..training.image_data import pil_bilinear_resize
from ..utils.device import resolve_device


def load_images(path: str, size: int = 224) -> np.ndarray:
    """A directory of PNGs (or one file) → [N, size, size, 3] float32 in
    [0, 1], sorted by name."""
    files = sorted(glob.glob(os.path.join(path, "*.png"))) \
        if os.path.isdir(path) else [path]
    if not files:
        raise FileNotFoundError(f"no .png under {path}")
    return np.stack([pil_bilinear_resize(read_rgb(f) / 255.0, size, size)
                     for f in files])


@torch.no_grad()
def r_precision(images: np.ndarray, text: str,
                distractors: Sequence[str] = (),
                pretrained_root: Optional[str] = None, tiny: bool = False,
                device="cuda", seed: int = 0) -> dict:
    """The mean cosine similarity of the renders to `text`, and the share
    of renders whose most similar prompt among [text] + distractors is
    `text` (1.0 with no distractors)."""
    dev = resolve_device(device)
    g = CLIPGuidance(CLIPConfig(tiny=tiny), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if pretrained_root:
        g.load_pretrained(pretrained_root, gen)
    else:
        g.init_params(gen)
    tc = g.cfg.text_config()
    tok = load_tokenizer(pretrained_root, tc.vocab_size, tc.max_len)
    prompts = [text] + list(distractors)
    ids = torch.from_numpy(np.concatenate([tok(p) for p in prompts])
                           ).long().to(dev)
    tz = g.get_text_embeds(ids)
    tz = tz / torch.linalg.norm(tz, dim=-1, keepdim=True)
    iz = g.get_img_embeds(torch.as_tensor(images, dtype=torch.float32,
                                          device=dev))
    iz = iz / torch.linalg.norm(iz, dim=-1, keepdim=True)
    sims = (iz @ tz.T).cpu().numpy()                         # [N, P]
    rp = float((sims.argmax(axis=1) == 0).mean()) if len(prompts) > 1 \
        else 1.0
    return {"mean_clip_similarity": float(sims[:, 0].mean()),
            "r_precision": rp, "n_images": int(len(images)),
            "n_prompts": len(prompts)}


def main(argv=None):
    ap = argparse.ArgumentParser("r_precision")
    ap.add_argument("--images", required=True,
                    help="directory of rendered pngs (or one file)")
    ap.add_argument("--text", required=True)
    ap.add_argument("--distractors", type=str, default=None,
                    help="text file, one distractor prompt per line")
    ap.add_argument("--pretrained_root", type=str, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny CLIP (smoke runs)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="default cuda; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    distractors: List[str] = []
    if args.distractors:
        with open(args.distractors) as f:
            distractors = [line.strip() for line in f if line.strip()]
    out = r_precision(load_images(args.images), args.text, distractors,
                      pretrained_root=args.pretrained_root, tiny=args.tiny,
                      device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
