"""CLIP text and vision encoders (``dreamfusion_tpu/models/clip.py``:
``CLIPTextEncoder``, ``CLIPVisionEncoder``, ``clip_preprocess``).

Their attention is plain torch, softmax written out as JAX's
``jax.nn.dot_product_attention`` computes it (fp32 logits and softmax, P
rounded to the value dtype): JAX's towers call no hand-written kernel
there.  The text towers and zero123's image tower run once at start-up;
CLIP guidance (``guidance/clip.py``) runs the ViT-B/16 every step, with
the gradient through it into the render.  The vision tower's patch
embedding is a K12 conv (``models/unet.py::Conv2d``, kernel = stride = the
patch, no bias), whose input gradient is K12's dgrad.  Module names follow
the transformers keys: the text tower's ``CLIPTextModel`` keys below
``text_model.`` (``embeddings.token_embedding``,
``encoder.layers.0.self_attn.q_proj``, ``final_layer_norm``), the vision
tower's ``CLIPVisionModelWithProjection`` keys below ``vision_model.``
(``embeddings.patch_embedding``, ``pre_layrnorm``, ``post_layernorm``)
and its ``visual_projection``.  SD 2.x's OpenCLIP tower uses the exact
gelu; CLIP ViT-L's towers (SD 1.5's text, zero123's vision) the quick
gelu.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .unet import Conv2d, Dense, LayerNorm


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77
    use_quick_gelu: bool = True
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """CLIP ViT-L/14's text tower (the dataclass defaults)."""
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                              use_quick_gelu=False)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=256, hidden_size=32, num_layers=2,
                              num_heads=2, max_len=16, dtype=torch.float32)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    use_quick_gelu: bool = True
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        """CLIP ViT-L/14 (the dataclass defaults): zero123's image tower."""
        return CLIPVisionConfig()

    @staticmethod
    def vit_b16() -> "CLIPVisionConfig":
        return CLIPVisionConfig(patch_size=16, hidden_size=768, num_layers=12,
                                num_heads=12, projection_dim=512)

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                                num_layers=2, num_heads=2, projection_dim=16,
                                dtype=torch.float32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """[B, N, h, d] each → [B, N, h, d] in q's dtype: fp32 logits and
    softmax (the future masked when `causal`), P rounded to v's dtype."""
    N, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(d)
    if causal:
        future = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype,
                 causal: bool = True):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.q_proj = Dense(hidden, hidden, dtype=dtype)
        self.k_proj = Dense(hidden, hidden, dtype=dtype)
        self.v_proj = Dense(hidden, hidden, dtype=dtype)
        self.out_proj = Dense(hidden, hidden, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, N, C = h.shape
        q, k, v = (f(h).reshape(B, N, self.heads, C // self.heads)
                   for f in (self.q_proj, self.k_proj, self.v_proj))
        o = attention_plain(q, k, v, self.causal)
        return self.out_proj(o.reshape(B, N, C))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, quick_gelu: bool, dtype: torch.dtype):
        super().__init__()
        self.quick_gelu = quick_gelu
        self.fc1 = Dense(hidden, hidden * 4, dtype=dtype)
        self.fc2 = Dense(hidden * 4, hidden, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.fc1(h)
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg, causal: bool = True):
        super().__init__()
        dt = cfg.dtype
        self.dtype = dt
        self.layer_norm1 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, dt,
                                       causal)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.use_quick_gelu, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x).to(self.dtype))
        return x + self.mlp(self.layer_norm2(x).to(self.dtype))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=dt)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_len, cfg.hidden_size, dtype=dt)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPLayer(cfg)
                                            for _ in range(cfg.num_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, dtype=dt)
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] → last_hidden_state [B, L, hidden] fp32."""
        dt = self.cfg.dtype
        emb = self.embeddings
        L = input_ids.shape[1]
        x = emb.token_embedding(input_ids).to(dt) + \
            emb.position_embedding.weight[None, :L].to(dt)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.final_layer_norm(x)

    def pooled(self, input_ids: torch.Tensor,
               eos_token_id: int = 49407) -> torch.Tensor:
        """The last hidden state's row at each prompt's first EOS token
        [B, hidden] fp32; row 0 where no id equals `eos_token_id` (the hash
        tokenizer's EOS is 1: JAX's argmax over all-false picks 0)."""
        h = self(input_ids)
        eos = (input_ids == eos_token_id).int().argmax(dim=-1)
        return h[torch.arange(h.shape[0], device=h.device), eos]


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        dt, C, P = cfg.dtype, cfg.hidden_size, cfg.patch_size
        self.embeddings = nn.Module()
        self.embeddings.class_embedding = nn.Parameter(
            torch.empty(C, dtype=dt), requires_grad=False)
        self.embeddings.patch_embedding = Conv2d(3, C, k=P, stride=P,
                                                 padding=0, bias=False,
                                                 dtype=dt)
        self.embeddings.position_embedding = nn.Embedding(
            (cfg.image_size // P) ** 2 + 1, C, dtype=dt)
        self.pre_layrnorm = LayerNorm(C, dtype=dt)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPLayer(cfg, causal=False)
                                            for _ in range(cfg.num_layers))
        self.post_layernorm = LayerNorm(C, dtype=dt)
        self.visual_projection = Dense(C, cfg.projection_dim, bias=False,
                                       dtype=dt, compute_dtype=torch.float32)
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels [B, H, W, 3] normalised (``clip_preprocess``) →
        (pooled projection [B, proj] fp32, last hidden [B, 1 + P, hidden]):
        the patches, the class token, the position embedding, ``pre_ln``,
        the non-causal layers, ``post_ln`` on the class token, the
        projection in fp32."""
        dt, C = self.cfg.dtype, self.cfg.hidden_size
        emb = self.embeddings
        B = pixels.shape[0]
        x = emb.patch_embedding(pixels.to(dt)).reshape(B, -1, C)
        x = torch.cat([emb.class_embedding.to(dt).expand(B, 1, C), x], dim=1)
        x = x + emb.position_embedding.weight[None].to(dt)
        x = self.pre_layrnorm(x).to(dt)
        for layer in self.encoder.layers:
            x = layer(x)
        pooled = self.post_layernorm(x[:, 0])
        return self.visual_projection(pooled), x


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device):
    """CLIP's mean and std on `device`, copied there once (a copy from the
    host waits for the device's stream)."""
    return (torch.from_numpy(CLIP_IMAGE_MEAN).to(device),
            torch.from_numpy(CLIP_IMAGE_STD).to(device))


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] → resized to size² (bilinear, antialiased
    when it shrinks) and normalised by CLIP's mean and std."""
    x = resize_bilinear(images, (size, size))
    mean, std = _mean_std(x.device)
    return (x - mean) / std
