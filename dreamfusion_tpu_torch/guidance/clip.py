"""CLIP guidance (``dreamfusion_tpu/guidance/clip.py``): the negative cosine
similarity of the render's CLIP image embedding with the prompt's text
embedding and/or the reference image's.

Unlike the diffusion priors, the gradient flows through the vision tower
into the render: ``clip_preprocess``'s resize (64² → 224² at full width),
the ViT-B/16's layers (plain torch, as JAX's towers call no kernel there:
``models/clip.py::attention_plain``) and its patch embedding, a K12 conv
(k = s = 16 on 3 channels: ``conv_fwd_mma`` forward, ``conv_dgrad``
input gradient, once each per loss).  The towers are frozen.

The prompt is tokenized once: JAX always uses its hash tokenizer here
(``load_tokenizer(None, ...)``); the port reads CLIP's BPE from
``pretrained_root`` where its ``vocab.json`` and ``merges.txt`` are, as
the reference (``clip_utils.py``) and the port's SD prompt do, else the
same hash tokenizer.  With hash tokens no id is CLIP's EOS (49407), so the
text embedding pools row 0, as JAX's does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.clip import (CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig,
                           CLIPVisionEncoder, clip_preprocess)
from ..models.unet import Dense
from ..utils.device import resolve_device
from ..utils.params import load_params_npz
from .embeddings import load_tokenizer


@dataclass(frozen=True)
class CLIPConfig:
    tiny: bool = False

    def vision_config(self) -> CLIPVisionConfig:
        return CLIPVisionConfig.tiny() if self.tiny else \
            CLIPVisionConfig.vit_b16()

    def text_config(self) -> CLIPTextConfig:
        if self.tiny:
            return CLIPTextConfig.tiny()
        return CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8)


class CLIPTowers(nn.Module):
    """The vision tower, the text tower and the text projection to the
    shared space (``text_projection.weight`` [proj, hidden])."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        vc, tc = cfg.vision_config(), cfg.text_config()
        self.vision = CLIPVisionEncoder(vc)
        self.text = CLIPTextEncoder(tc)
        self.text_projection = Dense(tc.hidden_size, vc.projection_dim,
                                     bias=False, dtype=tc.dtype,
                                     compute_dtype=torch.float32)
        for p in self.parameters():
            p.requires_grad_(False)


class CLIPGuidance:
    def __init__(self, cfg: CLIPConfig, device="cuda"):
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.towers = CLIPTowers(cfg)
        self.vision, self.text = self.towers.vision, self.towers.text

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    scale: float = 0.02) -> None:
        """Random weights, N(0, scale²) for every tensor, in the towers'
        dtype on their device (not JAX's init's bits)."""
        for p in self.towers.parameters():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=p.dtype) * scale)

    def load_pretrained(self, root: str, generator: torch.Generator) -> None:
        """Converted weights from ``root/clip.npz`` (JAX's
        ``utils.convert --kind clip``) over the random init; without the
        file the init stays (JAX's ``maybe_load_params``)."""
        self.init_params(generator)
        path = os.path.join(root, "clip.npz") if os.path.isdir(root) else root
        if os.path.exists(path):
            load_params_npz(path, self.towers, "clip")

    def load_state_dicts(self, state: Dict[str, Dict[str, torch.Tensor]]
                         ) -> None:
        """{"vision" | "text" | "text_projection": state_dict}
        (``utils/convert.py::params_from_jax``)."""
        for name, sd in state.items():
            getattr(self.towers, name).load_state_dict(sd, strict=True)

    # ------------------------------------------------------------------
    def get_img_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → L2-normalised [B, proj] fp32;
        differentiable in the images."""
        px = clip_preprocess(images, self.cfg.vision_config().image_size)
        z, _ = self.vision(px)
        return z / torch.linalg.norm(z, dim=-1, keepdim=True)

    def get_text_embeds(self, input_ids: torch.Tensor) -> torch.Tensor:
        z = self.towers.text_projection(self.text.pooled(input_ids))
        return z / torch.linalg.norm(z, dim=-1, keepdim=True)

    @torch.no_grad()
    def prepare_embeddings(self, text: Optional[str] = None, image=None,
                           pretrained_root: Optional[str] = None
                           ) -> Dict[str, torch.Tensor]:
        """{"text": [1, proj], "image": [1, proj]} for whichever of the
        prompt and the reference image ([H, W, 3+] or [1, H, W, 3+] in
        [0, 1]) is given, each normalised."""
        out: Dict[str, torch.Tensor] = {}
        dev = self.towers.text_projection.weight.device
        if text:
            tc = self.cfg.text_config()
            tok = load_tokenizer(pretrained_root, tc.vocab_size, tc.max_len)
            ids = torch.from_numpy(tok(text)).long().to(dev)
            out["text"] = self.get_text_embeds(ids)
        if image is not None:
            img = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
            if img.dim() == 3:
                img = img[None]
            out["image"] = self.get_img_embeds(img[..., :3])
        return out

    def loss(self, clip_z: Dict[str, torch.Tensor], pred_rgb: torch.Tensor,
             grad_scale) -> torch.Tensor:
        """−mean cos(render, target)·grad_scale for each target
        (``clip_utils.py:37-53``); `grad_scale` a number or a [] tensor."""
        image_z = self.get_img_embeds(pred_rgb[..., :3])
        loss = torch.zeros((), device=pred_rgb.device)
        for name in ("image", "text"):
            if name in clip_z:
                loss = loss - ((image_z * clip_z[name]).sum(-1) *
                               grad_scale).mean()
        return loss
