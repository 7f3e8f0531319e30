"""Conditional diffusion UNet (``dreamfusion_tpu/models/unet.py``), NHWC.

Activations stay channel-last as in JAX.  The k×k convolutions run on K12
(``ops/conv.py``), GroupNorm (+SiLU) on K11 (``ops/groupnorm.py``) and
attention on K10 (``ops/attention.py``); the 1×1 convs (``proj_in``,
``proj_out``, resblock shortcuts) and every dense layer are ``F.linear``,
as JAX computes them as one einsum.  Module names follow the diffusers
checkpoint keys (``down_blocks.0.resnets.0.conv1``, ``mid_block``,
``up_blocks``, ``time_embedding.linear_1``, ...), so a state_dict lines up
with a diffusers UNet key for key (conv weights are [O, kh, kw, I] here,
1×1 convs [O, I]).

Parameters live in the tower's dtype (bf16 at SD width, fp32 for the tiny
test config); each layer computes in its own dtype as the Flax modules do
(bf16, with the final ``conv_out`` in fp32).  The towers are frozen on
every guidance path (``requires_grad=False``); switched on with
``requires_grad_(True)``, K10-K12 give every weight's gradient as
``jax.grad`` of the Flax ``apply`` does, and the ``.to(dt)`` casts carry
it back to each parameter's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.conv import conv2d
from ..ops.groupnorm import group_norm, groups_for


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    context_dim: int = 768
    head_dim: Optional[int] = None      # if set, heads = channels // head_dim
    num_heads: int = 8                  # used when head_dim is None
    transformer_depth: int = 1
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "UNetConfig":
        """CLIP-L's 768-wide context, 8 heads at every level: head dims
        40, 80 and 160 over 320, 640 and 1280 channels."""
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig(context_dim=1024, head_dim=64)

    @staticmethod
    def zero123() -> "UNetConfig":
        """SD 1.5's topology on 8 input channels: the noisy latent and the
        reference's latent (``c_concat``)."""
        return UNetConfig(in_channels=8)

    @staticmethod
    def tiny(context_dim: int = 32, in_channels: int = 4,
             out_channels: int = 4) -> "UNetConfig":
        return UNetConfig(in_channels=in_channels, out_channels=out_channels,
                          model_channels=32, channel_mult=(1, 2),
                          num_res_blocks=1, attn_levels=(False, True),
                          context_dim=context_dim, num_heads=2,
                          dtype=torch.float32)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in [cos | sin] order (diffusers
    flip_sin_to_cos=True, downscale_freq_shift=0).  t [B] → [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``nn.Dense(dtype=...)``: input cast to the layer's dtype; weight
    [out, in] as in ``nn.Linear``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(d_out, dtype=dtype),
                                 requires_grad=False) if bias else None
        self.compute_dtype = compute_dtype or dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Module):
    """``MMConv`` on K12: weight [O, kh, kw, I]; products in fp32, bias
    added in fp32, output in the layer's compute dtype."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1,
                 padding=1, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, k, k, c_in,
                                               dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype),
                                 requires_grad=False) if bias else None
        self.stride = stride
        self.padding = padding
        self.compute_dtype = compute_dtype or dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return conv2d(x.to(dt), self.weight.to(dt), self.bias, self.stride,
                      self.padding, dt)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with fp32 statistics on K11 (fewer groups for narrow
    test widths), optionally followed by SiLU; output in the input dtype.
    eps: 1e-5 in UNet resblocks and the output norm, 1e-6 in the VAE and
    the SpatialTransformer."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype),
                                 requires_grad=False)
        self.groups = groups_for(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps,
                          silu)


class LayerNorm(nn.Module):
    """LayerNorm in fp32 (eps 1e-5), output fp32."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype),
                                 requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm32(c_in, 1e-5, dtype)
        self.conv1 = Conv2d(c_in, c_out, dtype=dtype)
        self.time_emb_proj = Dense(temb_dim, c_out, dtype=dtype)
        self.norm2 = GroupNorm32(c_out, 1e-5, dtype)
        self.conv2 = Conv2d(c_out, c_out, dtype=dtype)
        self.conv_shortcut = Dense(c_in, c_out, dtype=dtype) \
            if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 head_dim: int, dtype: torch.dtype):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(inner, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        B, N, M = x.shape[0], x.shape[1], context.shape[1]
        q = self.to_q(x).reshape(B, N, self.num_heads, self.head_dim)
        k = self.to_k(context).reshape(B, M, self.num_heads, self.head_dim)
        v = self.to_v(context).reshape(B, M, self.num_heads, self.head_dim)
        out = attention(q, k, v).reshape(B, N, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """proj → (h, gate) → h · gelu(gate), flax's tanh-approximate gelu."""

    def __init__(self, dim: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        # net.1 is the reference's dropout: no parameters
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, dtype), nn.Identity(),
                                  Dense(dim * 4, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 head_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                    dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        return x + self.ff(self.norm3(x).to(dt))


class SpatialTransformer(nn.Module):
    """GroupNorm → proj_in → transformer blocks → proj_out + residual."""

    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 head_dim: int, depth: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels, 1e-6, dtype)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(channels, context_dim, num_heads, head_dim,
                             dtype) for _ in range(depth))
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return self.proj_out(h.reshape(B, H, W, C)) + x


class _Sampler(nn.Module):
    """Holds the conv of a down- or upsampler (diffusers ``.conv``)."""

    def __init__(self, conv: Conv2d):
        super().__init__()
        self.conv = conv


def upsample_nearest2x(h: torch.Tensor) -> torch.Tensor:
    B, H, W, C = h.shape
    return h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ch0 = cfg.model_channels
        L = len(cfg.channel_mult)
        temb_dim = ch0 * 4
        ctx = cfg.context_dim
        depth = cfg.transformer_depth

        def heads(c):
            if cfg.head_dim is not None:
                return c // cfg.head_dim, cfg.head_dim
            return cfg.num_heads, c // cfg.num_heads

        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Dense(ch0, temb_dim, dtype=dt)
        self.time_embedding.linear_2 = Dense(temb_dim, temb_dim, dtype=dt)
        self.conv_in = Conv2d(cfg.in_channels, ch0, dtype=dt)

        skips = [ch0]
        c_in = ch0
        self.down_blocks = nn.ModuleList()
        for lvl, mult in enumerate(cfg.channel_mult):
            ch = ch0 * mult
            blk = _Level()
            for _ in range(cfg.num_res_blocks):
                blk.resnets.append(ResnetBlock(c_in, ch, temb_dim, dt))
                if cfg.attn_levels[lvl]:
                    blk.attentions.append(
                        SpatialTransformer(ch, ctx, *heads(ch), depth, dt))
                c_in = ch
                skips.append(ch)
            if lvl != L - 1:
                blk.downsamplers = nn.ModuleList(
                    [_Sampler(Conv2d(ch, ch, stride=2, dtype=dt))])
                skips.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Level()
        self.mid_block.resnets.extend(
            [ResnetBlock(c_in, c_in, temb_dim, dt),
             ResnetBlock(c_in, c_in, temb_dim, dt)])
        self.mid_block.attentions.append(
            SpatialTransformer(c_in, ctx, *heads(c_in), depth, dt))

        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(L)):
            ch = ch0 * cfg.channel_mult[lvl]
            blk = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                blk.resnets.append(ResnetBlock(c_in + skips.pop(), ch,
                                               temb_dim, dt))
                if cfg.attn_levels[lvl]:
                    blk.attentions.append(
                        SpatialTransformer(ch, ctx, *heads(ch), depth, dt))
                c_in = ch
            if lvl != 0:
                blk.upsamplers = nn.ModuleList([_Sampler(Conv2d(ch, ch,
                                                                dtype=dt))])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm32(c_in, 1e-5, dt)
        self.conv_out = Conv2d(c_in, cfg.out_channels, dtype=dt,
                               compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, in] ; t [B] ; context [B, M, ctx] → eps [B, H, W,
        out] fp32."""
        dt = self.cfg.dtype
        L = len(self.cfg.channel_mult)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(
            timestep_embedding(t, self.cfg.model_channels).to(dt))))
        context = context.to(dt)

        h = self.conv_in(x.to(dt))
        skips = [h]
        for lvl, blk in enumerate(self.down_blocks):
            for i, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[i](h, context)
                skips.append(h)
            if lvl != L - 1:
                h = blk.downsamplers[0].conv(h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
            if i != L - 1:
                h = blk.upsamplers[0].conv(upsample_nearest2x(h))

        h = self.conv_norm_out(h, silu=True)
        return self.conv_out(h.float())
