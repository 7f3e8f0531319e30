"""AutoencoderKL, the SD VAE (``dreamfusion_tpu/models/vae.py``), NHWC.

``encode`` is differentiable: SDS backpropagates through the encoder into
the render, through K12's dgrad, K11's backward and K10's backward (the
mid-block attention).  The downsample keeps the reference's asymmetric
(0, 1) pad before its stride-2 VALID conv, expressed as the conv's
padding ((0, 1), (0, 1)).  Module names follow the diffusers
``AutoencoderKL`` keys (``encoder.down_blocks.0.resnets.0.norm1``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..ops.attention import attention
from .unet import Conv2d, Dense, GroupNorm32, _Level, _Sampler, \
    upsample_nearest2x


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    scale_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1,
                         dtype=torch.float32)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


class VAEResnet(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm32(c_in, 1e-6, dtype)
        self.conv1 = Conv2d(c_in, c_out, dtype=dtype)
        self.norm2 = GroupNorm32(c_out, 1e-6, dtype)
        self.conv2 = Conv2d(c_out, c_out, dtype=dtype)
        self.conv_shortcut = Dense(c_in, c_out, dtype=dtype) \
            if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttn(nn.Module):
    """Single-head spatial self-attention over all H·W positions."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.group_norm = GroupNorm32(c, 1e-6, dtype)
        self.to_q = Dense(c, c, dtype=dtype)
        self.to_k = Dense(c, c, dtype=dtype)
        self.to_v = Dense(c, c, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(c, c, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.group_norm(x)
        q, k, v = (f(h).reshape(B, H * W, 1, C)
                   for f in (self.to_q, self.to_k, self.to_v))
        o = attention(q, k, v).reshape(B, H, W, C)
        return x + self.to_out[0](o)


def _mid_block(c: int, dtype: torch.dtype) -> _Level:
    mid = _Level()
    mid.resnets.extend([VAEResnet(c, c, dtype), VAEResnet(c, c, dtype)])
    mid.attentions.append(VAEAttn(c, dtype))
    return mid


def _run_mid(mid: _Level, h: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        self.conv_in = Conv2d(3, cfg.ch, dtype=dt)
        self.down_blocks = nn.ModuleList()
        c_in = cfg.ch
        L = len(cfg.ch_mult)
        for lvl, mult in enumerate(cfg.ch_mult):
            ch = cfg.ch * mult
            blk = _Level()
            for _ in range(cfg.num_res_blocks):
                blk.resnets.append(VAEResnet(c_in, ch, dt))
                c_in = ch
            if lvl != L - 1:
                # the (0, 1) pad then a VALID stride-2 conv (ldm Downsample)
                blk.downsamplers = nn.ModuleList([_Sampler(Conv2d(
                    ch, ch, stride=2, padding=((0, 1), (0, 1)), dtype=dt))])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(c_in, dt)
        self.conv_norm_out = GroupNorm32(c_in, 1e-6, dt)
        self.conv_out = Conv2d(c_in, 2 * cfg.z_channels, dtype=dt,
                               compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
        h = _run_mid(self.mid_block, h)
        h = self.conv_norm_out(h, silu=True)
        return self.conv_out(h.float())


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        L = len(cfg.ch_mult)
        c_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, c_in, dtype=dt)
        self.mid_block = _mid_block(c_in, dt)
        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(L)):
            ch = cfg.ch * cfg.ch_mult[lvl]
            blk = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                blk.resnets.append(VAEResnet(c_in, ch, dt))
                c_in = ch
            if lvl != 0:
                blk.upsamplers = nn.ModuleList([_Sampler(Conv2d(ch, ch,
                                                                dtype=dt))])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm32(c_in, 1e-6, dt)
        self.conv_out = Conv2d(c_in, 3, dtype=dt, compute_dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(upsample_nearest2x(h))
        h = self.conv_norm_out(h, silu=True)
        return self.conv_out(h.float())


class GaussianMoments(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std·noise with logvar clipped to [-30, 20]; noise is a
        standard normal draw of mean's shape."""
        std = torch.exp(0.5 * torch.clamp(self.logvar, -30.0, 20.0))
        return self.mean + std * noise


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        z2 = 2 * cfg.z_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Dense(z2, z2, dtype=cfg.dtype,
                                compute_dtype=torch.float32)
        self.post_quant_conv = Dense(cfg.z_channels, cfg.z_channels,
                                     dtype=cfg.dtype,
                                     compute_dtype=torch.float32)

    def encode(self, x: torch.Tensor) -> GaussianMoments:
        """x [B, H, W, 3] in [-1, 1] → moments over [B, H/8, W/8, z]."""
        moments = self.quant_conv(self.encoder(x.to(self.cfg.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return GaussianMoments(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: scaled latents → [B, H, W, 3] in [-1, 1] (fp32)."""
        z = self.post_quant_conv(z.float() / self.cfg.scale_factor)
        return self.decoder(z.to(self.cfg.dtype))
