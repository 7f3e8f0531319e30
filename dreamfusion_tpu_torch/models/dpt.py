"""The DPT monocular depth / normal network (``dreamfusion_tpu/models/dpt.py``).

omnidata's ``DPTDepthModel(backbone='vitb_rn50_384')``: a hybrid
ResNet50-v2 + ViT-B/16 backbone (timm ``vit_base_resnet50_384``), the
'project' readout, a four-level reassemble and a RefineNet-style fusion
decoder with its head, NHWC and fp32 as the JAX package runs it.

Modules are named by the omnidata checkpoint's keys (``pretrained.model.*``
for the backbone, ``pretrained.act_postprocess{3,4}.*`` for the reassemble,
``scratch.*`` for the decoder), so a checkpoint loads by name
(``utils/convert.py::convert_dpt``); the checkpoint's
``scratch.refinenet4.resConfUnit1.*``, dead in the reference too, has no
module.  Every k×k conv runs on K12 (``ops/conv.py::conv2d``, fp32) with
TF-SAME padding, which is asymmetric at stride 2; a 1×1 conv at stride 1
is a matrix product (``F.linear``), as JAX's single einsum
(``ops/conv.py:68-69``).  The ResNet's convs standardise their weight per
output channel in fp32 first (timm ``StdConv2dSame``).  Its GroupNorms are
flax's fp32 ``GroupNorm(32)`` in plain torch, as in JAX (not K11).  The ViT
blocks take flax's LayerNorm (epsilon 1e-6), the exact GELU and K10
(``ops/attention.py::attention``: fp32 q, k, v over 577 tokens, the
dense branch).

The weights load frozen and ``forward`` runs under ``no_grad``, as
``preprocess_image`` infers with it.  ``forward_grad`` is the same network
with autograd, as ``jax.grad`` differentiates JAX's ``apply``: with
``requires_grad_(True)`` on the model (or on the input) it takes the
gradient of every weight and the input, through K10's fp32 backward
(``attention_bwd_fp32``), K12's fp32 input and weight gradients
(``conv_dgrad_fp32_tiled``, ``conv_wgrad_fp32_tiled``) and plain torch for the
rest (the weight standardisation, the norms, the max pool, the resizes),
as JAX's are plain XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.conv import conv2d
from ..ops.resize import resize_bilinear


@dataclass(frozen=True)
class DPTConfig:
    """vitb_rn50_384 with the 'project' readout (JAX ``DPTConfig``)."""
    num_channels: int = 1               # 1 = depth, 3 = omnidata normals
    features: int = 256                 # decoder width
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    hooks: Tuple[int, int] = (8, 11)    # ViT blocks tapped for layers 3/4
    resnet_depths: Tuple[int, int, int] = (3, 4, 9)
    grid: int = 24                      # pos-embed grid side (384 / 16)
    non_negative: bool = True

    @staticmethod
    def depth() -> "DPTConfig":
        return DPTConfig(num_channels=1)

    @staticmethod
    def normal() -> "DPTConfig":
        return DPTConfig(num_channels=3)


# ResNetV2 stages: (mid, out, stride of the first block)
STAGES = ((64, 256, 1), (128, 512, 2), (256, 1024, 2))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding of one side n: total max((ceil(n/s)-1)·s + k - n, 0),
    the lower half rounded down (flax / lax "SAME")."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _param(*shape) -> nn.Parameter:
    """A weight, frozen until ``requires_grad_(True)`` asks for its
    gradient."""
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Conv(nn.Module):
    """``MMConv`` with "SAME" padding: weight [O, kh, kw, I] on K12."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = _param(c_out, k, k, c_in)
        self.bias = _param(c_out) if bias else None
        self.k, self.stride = k, stride

    def kernel(self) -> torch.Tensor:
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel()
        if self.k == 1 and self.stride == 1:
            return F.linear(x, w[:, 0, 0], self.bias)
        _, H, W, _ = x.shape
        pads = (same_pads(H, self.k, self.stride),
                same_pads(W, self.k, self.stride))
        return conv2d(x, w, self.bias, self.stride, pads, torch.float32)


class StdConv(Conv):
    """timm ``StdConv2dSame``: the weight standardised per output channel
    (mean and variance over kh, kw, I; epsilon 1e-6), no bias."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__(c_in, c_out, k, stride, bias=False)

    def kernel(self) -> torch.Tensor:
        w = self.weight.float()
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = ((w - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        return (w - mu) * torch.rsqrt(var + 1e-6)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(32)``: fp32 statistics with E[x²] - E[x]²
    clipped at 0, epsilon 1e-5."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xg = x.float().reshape(B, -1, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) -
               mean * mean).clamp(min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6)`` in fp32 (E[x²] - E[x]², clipped
    at 0)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        return (xf - mu) * torch.rsqrt(var + 1e-6) * self.weight + self.bias


def _linear(c_in: int, c_out: int) -> nn.Linear:
    lin = nn.Linear(c_in, c_out)
    lin.requires_grad_(False)
    return lin


class Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv = StdConv(c_in, c_out, 1, stride)
        self.norm = GroupNorm(c_out)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2's non-preact bottleneck: conv → norm → relu ×3 with a
    projection shortcut on a stage's first block."""

    def __init__(self, c_in: int, mid: int, out: int, stride: int,
                 proj: bool):
        super().__init__()
        self.downsample = Downsample(c_in, out, stride) if proj else None
        self.conv1 = StdConv(c_in, mid, 1)
        self.norm1 = GroupNorm(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GroupNorm(mid)
        self.conv3 = StdConv(mid, out, 1)
        self.norm3 = GroupNorm(out)

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + sc)


class Stage(nn.Module):
    def __init__(self, c_in: int, mid: int, out: int, stride: int,
                 depth: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            Bottleneck(c_in if b == 0 else out, mid, out,
                       stride if b == 0 else 1, b == 0)
            for b in range(depth))

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, 64, 7, 2)
        self.norm = GroupNorm(64)

    def forward(self, x):
        return max_pool_same(F.relu(self.norm(self.conv(x))))


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """MaxPool with TF-SAME padding of -inf (timm ``MaxPool2dSame``),
    NHWC."""
    _, H, W, _ = x.shape
    (pt, pb), (pl, pr) = same_pads(H, window, stride), \
        same_pads(W, window, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=-torch.inf)
    return F.max_pool2d(xp, window, stride).permute(0, 2, 3, 1)


class ResNetBackbone(nn.Module):
    def __init__(self, depths):
        super().__init__()
        self.stem = Stem()
        c_in, stages = 64, []
        for (mid, out, stride), depth in zip(STAGES, depths):
            stages.append(Stage(c_in, mid, out, stride, depth))
            c_in = out
        self.stages = nn.ModuleList(stages)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.backbone = ResNetBackbone(cfg.resnet_depths)
        self.proj = Conv(STAGES[-1][1], cfg.vit_dim, 1)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)
        self.heads = heads

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3 * self.heads, D // self.heads)
        q, k, v = qkv.split(self.heads, dim=2)
        return self.proj(attention(q, k, v).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class HybridViT(nn.Module):
    """ResNetV2 stages → the 1×1 patch projection → ViT-B tokens; returns
    the four taps: stage 0 [H/4, 256], stage 1 [H/8, 512] and the token
    sequences after ViT blocks ``hooks``."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.cls_token = _param(1, 1, cfg.vit_dim)
        self.pos_embed = _param(1, cfg.grid * cfg.grid + 1, cfg.vit_dim)
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.vit_dim, cfg.vit_heads, cfg.vit_mlp)
            for _ in range(cfg.vit_depth))
        # the checkpoint's final LayerNorm; DPT taps block outputs only
        self.norm = LayerNorm(cfg.vit_dim)

    def forward(self, x) -> List[torch.Tensor]:
        cfg = self.cfg
        B, H, W, _ = x.shape
        bb = self.patch_embed.backbone
        h = bb.stem(x)
        taps = []
        for s, stage in enumerate(bb.stages):
            h = stage(h)
            if s < 2:
                taps.append(h)
        gh, gw = H // 16, W // 16
        t = self.patch_embed.proj(h).reshape(B, gh * gw, cfg.vit_dim)
        pos_tok, pos_grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (cfg.grid, cfg.grid):
            pos_grid = resize_bilinear(
                pos_grid.reshape(1, cfg.grid, cfg.grid, cfg.vit_dim),
                (gh, gw), antialias=False).reshape(1, gh * gw, cfg.vit_dim)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], 1)
        t = t + torch.cat([pos_tok, pos_grid], 1)
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in cfg.hooks:
                taps.append(t)
        return taps


class ProjectReadout(nn.Module):
    """The 'project' readout: the cls token folded into every patch token
    by Linear(2D → D) + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.ModuleList([_linear(2 * dim, dim)])

    def forward(self, t):
        readout = t[:, :1].expand_as(t[:, 1:])
        return F.gelu(self.project[0](torch.cat([t[:, 1:], readout], -1)))


class Pretrained(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        D = cfg.vit_dim
        self.model = HybridViT(cfg)
        self.act_postprocess3 = nn.ModuleDict(
            {"0": ProjectReadout(D), "3": Conv(D, D, 1)})
        self.act_postprocess4 = nn.ModuleDict(
            {"0": ProjectReadout(D), "3": Conv(D, D, 1),
             "4": Conv(D, D, 3, 2)})


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features)
        self.conv2 = Conv(features, features)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """RCU on the skip, added; RCU; ×2 align_corners upsample; 1×1 out
    conv."""

    def __init__(self, features: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if skip else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv(features, features, 1)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        _, H, W, _ = x.shape
        x = resize_bilinear(x, (2 * H, 2 * W), align_corners=True)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        Fw, D = cfg.features, cfg.vit_dim
        self.layer1_rn = Conv(STAGES[0][1], Fw, bias=False)
        self.layer2_rn = Conv(STAGES[1][1], Fw, bias=False)
        self.layer3_rn = Conv(D, Fw, bias=False)
        self.layer4_rn = Conv(D, Fw, bias=False)
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(Fw, i < 4))
        self.output_conv = nn.ModuleDict(
            {"0": Conv(Fw, Fw // 2), "2": Conv(Fw // 2, 32),
             "4": Conv(32, cfg.num_channels, 1)})


class DPTDepthModel(nn.Module):
    """[B, H, W, 3] (H, W multiples of 32) → [B, H, W, num_channels]
    fp32."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.pretrained = Pretrained(cfg)
        self.scratch = Scratch(cfg)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Inference: ``forward_grad`` without autograd."""
        return self.forward_grad(x)

    def forward_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The forward with autograd: differentiable with respect to every
        weight that wants a gradient and to x."""
        cfg, pre, sc = self.cfg, self.pretrained, self.scratch
        x = x.float()
        B, H, W, _ = x.shape
        gh, gw = H // 16, W // 16
        l1, l2, t3, t4 = pre.model(x)
        p3, p4 = pre.act_postprocess3, pre.act_postprocess4
        l3 = p3["3"](p3["0"](t3).reshape(B, gh, gw, cfg.vit_dim))
        l4 = p4["4"](p4["3"](p4["0"](t4).reshape(B, gh, gw, cfg.vit_dim)))
        r1, r2 = sc.layer1_rn(l1), sc.layer2_rn(l2)
        r3, r4 = sc.layer3_rn(l3), sc.layer4_rn(l4)
        p = sc.refinenet4(r4)
        p = sc.refinenet3(p, r3)
        p = sc.refinenet2(p, r2)
        p = sc.refinenet1(p, r1)
        head = sc.output_conv
        h = resize_bilinear(head["0"](p), (H, W), align_corners=True)
        h = head["4"](F.relu(head["2"](h)))
        return F.relu(h) if cfg.non_negative else h


def load_dpt(path: str, cfg: DPTConfig, device) -> DPTDepthModel:
    """The DPT with `path`'s weights on `device`: a JAX ``.npz``
    (``utils/convert.py --kind dpt``) or an omnidata torch checkpoint
    (``.ckpt`` / ``.pt``), converted on the fly."""
    from ..utils.convert import convert_dpt
    from ..utils.params import load_params_npz
    model = DPTDepthModel(cfg)
    if path.endswith(".npz"):
        load_params_npz(path, model, "dpt")
    else:
        convert_dpt(path, model)
    return model.to(device)
