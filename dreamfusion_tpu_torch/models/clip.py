"""CLIP text encoder (``dreamfusion_tpu/models/clip.py::CLIPTextEncoder``).

Runs once at start-up to embed the prompts, so it is plain torch: causal
softmax attention written out, no kernel.  Module names follow the
transformers ``CLIPTextModel`` keys below ``text_model.``
(``embeddings.token_embedding``, ``encoder.layers.0.self_attn.q_proj``,
``final_layer_norm``).  SD 2.x's OpenCLIP tower uses the exact gelu; SD 1.5's
CLIP ViT-L the quick gelu.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .unet import Dense, LayerNorm


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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """[B, N, h, d] each → [B, N, h, d]; fp32 softmax, future masked."""
    N, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(d)
    future = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(hidden, hidden, dtype=dtype)
        self.k_proj = Dense(hidden, hidden, dtype=dtype)
        self.v_proj = Dense(hidden, hidden, dtype=dtype)
        self.out_proj = Dense(hidden, hidden, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, N, C = h.shape
        q, k, v = (f(h).reshape(B, N, self.heads, C // self.heads)
                   for f in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(causal_attention(q, k, v).reshape(B, N, C))


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
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        dt = cfg.dtype
        self.dtype = dt
        self.layer_norm1 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, dt)
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
