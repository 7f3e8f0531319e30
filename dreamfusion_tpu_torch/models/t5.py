"""The T5 v1.1 encoder (``dreamfusion_tpu/models/t5.py``): DeepFloyd-IF's
text encoder, T5-XXL at full width.

RMSNorm pre-norm blocks, no biases anywhere; a bucketed relative position
bias (32 buckets, max distance 128), learned per head in block 0 and shared
by every block; no 1/√d scale on the logits; the gated tanh-GELU
feed-forward (``wi_0`` gated, ``wi_1`` linear, ``wo`` out); a final
RMSNorm.  Module names are transformers' ``T5EncoderModel`` keys
(``shared``, ``encoder.block.0.layer.0.SelfAttention.q``,
``encoder.block.3.layer.1.DenseReluDense.wi_0``,
``encoder.final_layer_norm``), so a checkpoint lines up key for key.

It runs once per prompt at start-up, in fp32 as in JAX, and stays plain
torch: the position bias sits inside the softmax, which K10 does not take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.float32

    @staticmethod
    def xxl() -> "T5Config":
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                        num_layers=2, num_heads=4)


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class RMSNorm(nn.Module):
    """x / rms(x) · weight in fp32, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(dim, dtype=dtype)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (self.weight.float() * (x32 * torch.rsqrt(var + self.eps))) \
            .to(x.dtype)


class Linear(nn.Module):
    """A bias-free ``nn.Dense(dtype=...)``: weight [out, in]."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(d_out, d_in, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int, device=None
                              ) -> torch.Tensor:
    """Bidirectional T5 bucketing of key - query position → [qlen, klen]
    int64 bucket ids, the log buckets in float32 with a truncating int
    cast, as JAX forms them."""
    ctx = torch.arange(qlen, device=device)[:, None]
    mem = torch.arange(klen, device=device)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = torch.where(rel > 0, nb, 0)
    n = rel.abs()
    max_exact = nb // 2
    log_range = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32, device=device))
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact) /
                         log_range * (nb - max_exact)).to(torch.int32)
    large = large.clamp(max=nb - 1)
    return (buckets + torch.where(n < max_exact, n, large)).long()


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        for name in ("q", "k", "v"):
            setattr(self, name, Linear(cfg.d_model, inner, cfg.dtype))
        self.o = Linear(inner, cfg.d_model, cfg.dtype)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads,
                dtype=cfg.dtype)
            self.relative_attention_bias.weight.requires_grad_(False)

    def position_bias(self, L: int) -> torch.Tensor:
        """[heads, L, L] from this block's bias table."""
        c = self.cfg
        w = self.relative_attention_bias.weight
        buckets = relative_position_buckets(
            L, L, c.relative_attention_num_buckets,
            c.relative_attention_max_distance, w.device)
        return w[buckets].permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        """x [B, L, D]; mask [B, L] (1 = keep); position_bias [H, L, L]."""
        c = self.cfg
        B, L, _ = x.shape
        q, k, v = (getattr(self, n)(x).reshape(B, L, c.num_heads, c.d_kv)
                   for n in ("q", "k", "v"))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + \
            position_bias[None].float()
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, -1)
        return self.o(o)


class _LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_relative_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                  cfg.dtype)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.wo = Linear(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") *
                       self.wi_1(h))


class _LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                  cfg.dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_LayerSelfAttention(cfg,
                                                        has_relative_bias),
                                    _LayerFF(cfg)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), mask, position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                        cfg.dtype)


class T5Encoder(nn.Module):
    """token ids [B, L] + mask [B, L] → last hidden state [B, L, d_model]."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                   dtype=cfg.dtype)
        self.shared.weight.requires_grad_(False)
        self.encoder = _Stack(cfg)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.shared(input_ids).to(self.cfg.dtype)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1])
        for blk in blocks:
            x = blk(x, attention_mask, bias)
        return self.encoder.final_layer_norm(x)
