"""DeepFloyd-IF stage-1 pixel UNet (``dreamfusion_tpu/models/if_unet.py``),
NHWC.

The IF-I-XL topology: scale_shift resnets (the time embedding projects to
2·C and modulates norm2 as ``norm(h)·(1 + scale) + shift``), resnet down-
and upsamplers (both paths avg-pooled or nearest-upsampled before conv1),
one attention per block over ``[text; spatial]`` keys (the text group-
normalised and projected by ``add_k_proj``/``add_v_proj``), the
attention-pooled T5 states added to the timestep embedding, and
``encoder_hid_proj`` taking T5-XXL's 4096-wide states to the 2048-wide
context.  Module names are the diffusers checkpoint keys
(``down_blocks.1.attentions.0.add_k_proj``, ``downsamplers.0.norm1``,
``add_embedding.pool.q_proj``, ...).

Every conv runs on K12 (``ops/conv.py``; the 1×1 shortcuts too, weight
``[O, 1, 1, I]``), every attention on K10 (``ops/attention.py``).  The
GroupNorms are JAX's flax ``nn.GroupNorm`` in fp32 (``GN``: mean and
E[x²] - mean² over the group's channels and every pixel or token), plain
torch here: JAX's IF does not use K11.  The pooled text path
(``TextTimeEmbedding``) computes in fp32, as flax's ``Dense`` without a
dtype promotes to its fp32 LayerNorm input; ``encoder_hid_proj`` likewise
computes in the promoted dtype of the bf16 context and its weight.  GELU
is flax's default tanh form, as in JAX (diffusers' IF uses the exact
form), and ``AttentionPooling`` divides its logits by √head_dim once, as
JAX does.

Parameters live in ``param_dtype`` (bf16 at full width under ``--fp16``,
else fp32); each layer computes in ``cfg.dtype`` (bf16 at IF-XL's width,
fp32 for the tiny test config) as the Flax modules do, the final
``conv_out`` in fp32.  The tower is frozen.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .unet import Conv2d, Dense, timestep_embedding


@dataclass(frozen=True)
class IFUNetConfig:
    in_channels: int = 3
    out_channels: int = 6
    block_out_channels: Tuple[int, ...] = (640, 1280, 2560, 2560)
    layers_per_block: int = 3
    attn_levels: Tuple[bool, ...] = (False, True, True, True)
    head_dim: int = 64
    cross_attention_dim: int = 2048
    encoder_hid_dim: int = 4096        # T5-XXL d_model
    addition_num_heads: int = 64       # TextTimeEmbedding pooling heads
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def xl() -> "IFUNetConfig":
        return IFUNetConfig()

    @staticmethod
    def tiny(context_dim: int = 32) -> "IFUNetConfig":
        return IFUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                            attn_levels=(False, True), head_dim=16,
                            cross_attention_dim=24,
                            encoder_hid_dim=context_dim,
                            addition_num_heads=4, dtype=torch.float32)

    @staticmethod
    def from_diffusers_config(cfg: dict) -> "IFUNetConfig":
        """From a diffusers ``unet/config.json`` dict."""
        return IFUNetConfig(
            in_channels=cfg["in_channels"],
            out_channels=cfg["out_channels"],
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg["layers_per_block"],
            attn_levels=tuple("CrossAttn" in t
                              for t in cfg["down_block_types"]),
            head_dim=cfg["attention_head_dim"],
            cross_attention_dim=cfg["cross_attention_dim"],
            encoder_hid_dim=cfg.get("encoder_hid_dim") or
            cfg["cross_attention_dim"],
            addition_num_heads=cfg.get("addition_embed_type_num_heads", 64),
            norm_eps=cfg.get("norm_eps", 1e-5))


def _groups(ch: int, want: int = 32) -> int:
    g = want
    while ch % g:
        g //= 2
    return g


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class GN(nn.Module):
    """Flax ``nn.GroupNorm`` (32 groups, fewer for narrow test widths) in
    fp32 over [B, ..., C] (pixels or tokens and the group's channels), cast
    back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _param(channels, dtype=dtype)
        self.bias = _param(channels, dtype=dtype)
        self.groups = _groups(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xg = x.float().reshape(B, -1, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) -
               mean * mean).clamp(min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class PromotedDense(Dense):
    """Flax ``nn.Dense`` without a dtype: computes in the promoted dtype of
    its input and its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm32(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 in and out."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _param(channels, dtype=dtype)
        self.bias = _param(channels, dtype=dtype)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.float().reshape(B, H // 2, 2, W // 2, 2, C).mean(
        dim=(2, 4)).to(x.dtype)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


class IFResnetBlock(nn.Module):
    """diffusers ``ResnetBlock2D`` with time_embedding_norm="scale_shift"
    and optional resampling (``"down"``: avg-pool, ``"up"``: nearest) of
    both paths before conv1."""

    def __init__(self, c_in: int, c_out: int, temb_dim: int, eps: float,
                 dtype: torch.dtype, pdt: torch.dtype,
                 sample: Optional[str] = None):
        super().__init__()
        self.dtype, self.sample = dtype, sample
        self.norm1 = GN(c_in, eps, pdt)
        self.conv1 = Conv2d(c_in, c_out, dtype=pdt, compute_dtype=dtype)
        self.time_emb_proj = Dense(temb_dim, 2 * c_out, dtype=pdt,
                                   compute_dtype=dtype)
        self.norm2 = GN(c_out, eps, pdt)
        self.conv2 = Conv2d(c_out, c_out, dtype=pdt, compute_dtype=dtype)
        self.conv_shortcut = Conv2d(c_in, c_out, 1, padding=0, dtype=pdt,
                                    compute_dtype=dtype) \
            if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(x))
        if self.sample == "down":
            x, h = avg_pool2(x), avg_pool2(h)
        elif self.sample == "up":
            x, h = upsample2(x), upsample2(h)
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(F.silu(temb))[:, None, None, :] \
            .chunk(2, dim=-1)
        h = self.norm2(h) * (1.0 + scale) + shift
        h = self.conv2(F.silu(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class IFAttention(nn.Module):
    """diffusers ``Attention`` with ``AttnAddedKVProcessor``: the spatial
    tokens group-normalised, the context by ``norm_cross``; K and V are
    ``[add_k/v_proj(context), to_k/v(spatial)]``, text first, on K10."""

    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 head_dim: int, eps: float, dtype: torch.dtype,
                 pdt: torch.dtype):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        self.group_norm = GN(channels, eps, pdt)
        self.norm_cross = GN(context_dim, eps, pdt)

        def dense(d_in, d_out):
            return Dense(d_in, d_out, dtype=pdt, compute_dtype=dtype)

        self.to_q = dense(channels, inner)
        self.to_k = dense(channels, inner)
        self.to_v = dense(channels, inner)
        self.add_k_proj = dense(context_dim, inner)
        self.add_v_proj = dense(context_dim, inner)
        self.to_out = nn.ModuleList([dense(inner, channels)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.group_norm(x.reshape(B, H * W, C))
        ctx = self.norm_cross(context.to(self.dtype))
        k = torch.cat([self.add_k_proj(ctx), self.to_k(h)], dim=1)
        v = torch.cat([self.add_v_proj(ctx), self.to_v(h)], dim=1)
        N, M, nh, hd = H * W, k.shape[1], self.num_heads, self.head_dim
        out = attention(self.to_q(h).reshape(B, N, nh, hd),
                        k.reshape(B, M, nh, hd), v.reshape(B, M, nh, hd))
        out = self.to_out[0](out.reshape(B, N, nh * hd))
        return out.reshape(B, H, W, C) + x


class AttentionPooling(nn.Module):
    """diffusers ``AttentionPooling``: the mean token plus a learned
    position attends over [class; tokens]; logits / √head_dim once (JAX's
    form), softmax in fp32."""

    def __init__(self, num_heads: int, dim: int, pdt: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = _param(1, dim, dtype=pdt)
        self.q_proj = PromotedDense(dim, dim, dtype=pdt)
        self.k_proj = PromotedDense(dim, dim, dtype=pdt)
        self.v_proj = PromotedDense(dim, dim, dtype=pdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # [B, L, D]
        B, L, D = x.shape
        cls = x.mean(dim=1, keepdim=True) + \
            self.positional_embedding[None].to(x.dtype)
        seq = torch.cat([cls, x], dim=1)
        hd = D // self.num_heads
        q = self.q_proj(cls).reshape(B, 1, self.num_heads, hd)
        k = self.k_proj(seq).reshape(B, L + 1, self.num_heads, hd)
        v = self.v_proj(seq).reshape(B, L + 1, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, D)


class TextTimeEmbedding(nn.Module):
    """LayerNorm → AttentionPooling → proj → LayerNorm, in fp32 (diffusers
    ``TextTimeEmbedding``, addition_embed_type="text")."""

    def __init__(self, dim: int, time_embed_dim: int, num_heads: int,
                 pdt: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm32(dim, dtype=pdt)
        self.pool = AttentionPooling(num_heads, dim, pdt)
        self.proj = PromotedDense(dim, time_embed_dim, dtype=pdt)
        self.norm2 = LayerNorm32(time_embed_dim, dtype=pdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.proj(self.pool(self.norm1(x))))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class IFUNet(nn.Module):
    """x [B, H, W, in] ; t [B] ; context [B, M, encoder_hid_dim] (raw T5
    states) → [B, H, W, out] fp32 (eps ‖ variance)."""

    def __init__(self, cfg: IFUNetConfig,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        pdt = param_dtype or dt
        ch0 = cfg.block_out_channels[0]
        tdim = ch0 * 4
        L = len(cfg.block_out_channels)
        eps = cfg.norm_eps
        ctx = cfg.cross_attention_dim

        def res(c_in, c_out, sample=None):
            return IFResnetBlock(c_in, c_out, tdim, eps, dt, pdt, sample)

        def attn(ch):
            return IFAttention(ch, ctx, ch // cfg.head_dim, cfg.head_dim,
                               eps, dt, pdt)

        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Dense(ch0, tdim, dtype=pdt,
                                             compute_dtype=dt)
        self.time_embedding.linear_2 = Dense(tdim, tdim, dtype=pdt,
                                             compute_dtype=dt)
        self.add_embedding = TextTimeEmbedding(
            cfg.encoder_hid_dim, tdim, cfg.addition_num_heads, pdt)
        self.encoder_hid_proj = PromotedDense(cfg.encoder_hid_dim, ctx,
                                              dtype=pdt)
        self.conv_in = Conv2d(cfg.in_channels, ch0, dtype=pdt,
                              compute_dtype=dt)

        skips = [ch0]
        c_in = ch0
        self.down_blocks = nn.ModuleList()
        for lvl, ch in enumerate(cfg.block_out_channels):
            blk = _Level()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(res(c_in, ch))
                if cfg.attn_levels[lvl]:
                    blk.attentions.append(attn(ch))
                c_in = ch
                skips.append(ch)
            if lvl != L - 1:
                blk.downsamplers = nn.ModuleList([res(ch, ch, "down")])
                skips.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Level()
        self.mid_block.resnets.extend([res(c_in, c_in), res(c_in, c_in)])
        self.mid_block.attentions.append(attn(c_in))

        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(L)):
            ch = cfg.block_out_channels[lvl]
            blk = _Level()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(res(c_in + skips.pop(), ch))
                if cfg.attn_levels[lvl]:
                    blk.attentions.append(attn(ch))
                c_in = ch
            if lvl != 0:
                blk.upsamplers = nn.ModuleList([res(ch, ch, "up")])
            self.up_blocks.append(blk)

        self.conv_norm_out = GN(c_in, eps, pdt)
        self.conv_out = Conv2d(c_in, cfg.out_channels, dtype=pdt,
                               compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        L = len(cfg.block_out_channels)
        te = self.time_embedding
        temb = te.linear_1(timestep_embedding(t, cfg.block_out_channels[0])
                           .to(dt))
        temb = te.linear_2(F.gelu(temb, approximate="tanh"))
        temb = temb + self.add_embedding(context).to(dt)
        ctx = self.encoder_hid_proj(context.to(dt))

        h = self.conv_in(x.to(dt))
        skips = [h]
        for lvl, blk in enumerate(self.down_blocks):
            for i, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[i](h, ctx)
                skips.append(h)
            if lvl != L - 1:
                h = blk.downsamplers[0](h, temb)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ctx),
                           temb)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
            if i != L - 1:
                h = blk.upsamplers[0](h, temb)

        h = F.gelu(self.conv_norm_out(h), approximate="tanh")
        return self.conv_out(h.float())
