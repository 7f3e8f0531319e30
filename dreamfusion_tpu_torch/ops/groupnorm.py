"""K11: GroupNorm with fp32 statistics and an optional fused SiLU.

Replaces ``dreamfusion_tpu/models/unet.py::group_norm_fused`` (a custom_vjp
with the closed-form backward) and ``GroupNorm32`` (flax ``nn.GroupNorm``
in fp32, then cast back).  x is channel-last ``[B, ..., C]``; channels are
grouped contiguously, statistics run over (spatial, channels in the group)
per (batch, group):

    y  = silu?((x - mean) * rstd * scale + bias)        rstd = 1/sqrt(var+eps)
    dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)),
         dxh = dy * silu'(u) * scale,   xh = (x - mean) * rstd

On a CUDA tensor the forward and the backward are each two launches of
Triton kernels, counted once per call.  Bound on the card: memory (one read
of x and one write of y forward; x and dy in, dx out backward; a few
operations per element).  The statistics parallelise badly: at the VAE's
first level B*G = 32 groups each hold 512*512*4 ≈ 1M values, so one program
per group would fill 32 of 132 SMs.  Each group is therefore cut into
chunks of pixels: pass 1 writes per-chunk (mean, M2) (sums for the
backward), pass 2 merges the chunks of its group with Chan's formula
(numerically safe in fp32, unlike E[x²] − E[x]²) and normalises its own
chunk.  The weights are frozen on every path: the backward gives no
gradient for scale and bias and refuses tensors that ask for one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import kernels


def groups_for(channels: int, groups: int = 32) -> int:
    """GroupNorm32's fallback for narrow channel counts: halve the group
    count until it divides the channels."""
    g = groups
    while channels % g:
        g //= 2
    return g


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     silu: bool = False) -> torch.Tensor:
    """x [B, ..., C] → same shape and dtype; statistics in fp32."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    xh = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = xh * weight.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

@functools.cache
def _triton_kernels():
    """Compile-on-first-use kernels (Triton is imported here: the CPU tests
    import this module where Triton is absent)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _tile(base, p0, HW, C, c0, Cg, BLOCK_P: tl.constexpr,
              BLOCK_C: tl.constexpr):
        rows = p0 + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_C)
        mask = (rows[:, None] < HW) & (cols[None, :] < Cg)
        offs = base + rows[:, None] * C + c0 + cols[None, :]
        return offs, mask, cols

    @triton.jit
    def fwd_stats(x_ptr, part_ptr, HW, C, G, Cg, n_chunks,
                  BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        bg = tl.program_id(0)
        ch = tl.program_id(1)
        b = bg // G
        grp = bg % G
        offs, mask, _ = _tile(b * HW * C, ch * BLOCK_P, HW, C, grp * Cg, Cg,
                              BLOCK_P, BLOCK_C)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        cnt = tl.sum(tl.sum(mask.to(tl.float32), axis=1), axis=0)
        mean = tl.sum(tl.sum(x, axis=1), axis=0) / tl.maximum(cnt, 1.0)
        d = tl.where(mask, x - mean, 0.0)
        m2 = tl.sum(tl.sum(d * d, axis=1), axis=0)
        pbase = (bg * n_chunks + ch) * 3
        tl.store(part_ptr + pbase, cnt)
        tl.store(part_ptr + pbase + 1, mean)
        tl.store(part_ptr + pbase + 2, m2)

    @triton.jit
    def _merge(part_ptr, bg, n_chunks, eps, NCH: tl.constexpr):
        """Chan's merge of a group's chunk statistics → (mean, rstd)."""
        idx = tl.arange(0, NCH)
        m = idx < n_chunks
        base = (bg * n_chunks + idx) * 3
        cnt = tl.load(part_ptr + base, mask=m, other=0.0)
        mu = tl.load(part_ptr + base + 1, mask=m, other=0.0)
        m2 = tl.load(part_ptr + base + 2, mask=m, other=0.0)
        n = tl.sum(cnt, axis=0)
        mean = tl.sum(cnt * mu, axis=0) / n
        dm = mu - mean
        var = (tl.sum(m2, axis=0) + tl.sum(cnt * dm * dm, axis=0)) / n
        return mean, 1.0 / tl.sqrt(var + eps)

    @triton.jit
    def fwd_apply(x_ptr, w_ptr, b_ptr, y_ptr, part_ptr, stat_ptr, HW, C, G,
                  Cg, n_chunks, eps, SILU: tl.constexpr,
                  BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
                  NCH: tl.constexpr):
        bg = tl.program_id(0)
        ch = tl.program_id(1)
        b = bg // G
        grp = bg % G
        mean, rstd = _merge(part_ptr, bg, n_chunks, eps, NCH)
        if ch == 0:
            tl.store(stat_ptr + bg * 2, mean)
            tl.store(stat_ptr + bg * 2 + 1, rstd)
        offs, mask, cols = _tile(b * HW * C, ch * BLOCK_P, HW, C, grp * Cg,
                                 Cg, BLOCK_P, BLOCK_C)
        cm = cols < Cg
        w = tl.load(w_ptr + grp * Cg + cols, mask=cm, other=0.0).to(tl.float32)
        bb = tl.load(b_ptr + grp * Cg + cols, mask=cm, other=0.0).to(
            tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        u = (x - mean) * rstd * w[None, :] + bb[None, :]
        if SILU:
            u = u / (1.0 + tl.exp(-u))
        tl.store(y_ptr + offs, u.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _dxh(x_ptr, dy_ptr, w_ptr, b_ptr, stat_ptr, bg, b, grp, p0, HW, C,
             Cg, SILU: tl.constexpr, BLOCK_P: tl.constexpr,
             BLOCK_C: tl.constexpr):
        offs, mask, cols = _tile(b * HW * C, p0, HW, C, grp * Cg, Cg,
                                 BLOCK_P, BLOCK_C)
        cm = cols < Cg
        mean = tl.load(stat_ptr + bg * 2)
        rstd = tl.load(stat_ptr + bg * 2 + 1)
        w = tl.load(w_ptr + grp * Cg + cols, mask=cm, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xh = (x - mean) * rstd
        if SILU:
            bb = tl.load(b_ptr + grp * Cg + cols, mask=cm, other=0.0).to(
                tl.float32)
            u = xh * w[None, :] + bb[None, :]
            s = 1.0 / (1.0 + tl.exp(-u))
            dy = dy * s * (1.0 + u * (1.0 - s))
        dxh = tl.where(mask, dy * w[None, :], 0.0)
        xh = tl.where(mask, xh, 0.0)
        return offs, mask, dxh, xh, rstd

    @triton.jit
    def bwd_sums(x_ptr, dy_ptr, w_ptr, b_ptr, stat_ptr, part_ptr, HW, C, G,
                 Cg, n_chunks, SILU: tl.constexpr, BLOCK_P: tl.constexpr,
                 BLOCK_C: tl.constexpr):
        bg = tl.program_id(0)
        ch = tl.program_id(1)
        _, _, dxh, xh, _ = _dxh(x_ptr, dy_ptr, w_ptr, b_ptr, stat_ptr, bg,
                                bg // G, bg % G, ch * BLOCK_P, HW, C, Cg,
                                SILU, BLOCK_P, BLOCK_C)
        pbase = (bg * n_chunks + ch) * 2
        tl.store(part_ptr + pbase, tl.sum(tl.sum(dxh, axis=1), axis=0))
        tl.store(part_ptr + pbase + 1,
                 tl.sum(tl.sum(dxh * xh, axis=1), axis=0))

    @triton.jit
    def bwd_apply(x_ptr, dy_ptr, w_ptr, b_ptr, stat_ptr, part_ptr, dx_ptr,
                  HW, C, G, Cg, n_chunks, inv_n, SILU: tl.constexpr,
                  BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
                  NCH: tl.constexpr):
        bg = tl.program_id(0)
        ch = tl.program_id(1)
        idx = tl.arange(0, NCH)
        m = idx < n_chunks
        pb = (bg * n_chunks + idx) * 2
        m1 = tl.sum(tl.load(part_ptr + pb, mask=m, other=0.0), axis=0) * inv_n
        m2 = tl.sum(tl.load(part_ptr + pb + 1, mask=m, other=0.0),
                    axis=0) * inv_n
        offs, mask, dxh, xh, rstd = _dxh(
            x_ptr, dy_ptr, w_ptr, b_ptr, stat_ptr, bg, bg // G, bg % G,
            ch * BLOCK_P, HW, C, Cg, SILU, BLOCK_P, BLOCK_C)
        dx = rstd * (dxh - m1 - xh * m2)
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    return fwd_stats, fwd_apply, bwd_sums, bwd_apply


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _blocks(HW: int, Cg: int):
    """(BLOCK_P, BLOCK_C, n_chunks, NCH): ~4096 values a program."""
    block_c = _next_pow2(Cg)
    block_p = max(16, 4096 // block_c)
    block_p = min(block_p, max(16, _next_pow2(HW)))
    n_chunks = -(-HW // block_p)
    return block_p, block_c, n_chunks, _next_pow2(n_chunks)


def _check(x, weight, bias, groups):
    kernels.check_cuda(x, weight, bias)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"groupnorm kernel takes fp32 or bf16, got {x.dtype}")
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    return x.shape[0], x.numel() // (x.shape[0] * C), C, C // groups


def group_norm_fwd_triton(x, weight, bias, groups: int, eps: float,
                          silu: bool):
    """→ (y like x, stats [B*G, 2] fp32 mean and rstd)."""
    B, HW, C, Cg = _check(x, weight, bias, groups)
    fwd_stats, fwd_apply, _, _ = _triton_kernels()
    BP, BC, nch, NCH = _blocks(HW, Cg)
    part = torch.empty(B * groups * nch * 3, device=x.device,
                       dtype=torch.float32)
    stats = torch.empty(B * groups, 2, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    grid = (B * groups, nch)
    fwd_stats[grid](x, part, HW, C, groups, Cg, nch, BLOCK_P=BP, BLOCK_C=BC)
    fwd_apply[grid](x, weight, bias, y, part, stats, HW, C, groups, Cg, nch,
                    float(eps), SILU=bool(silu), BLOCK_P=BP, BLOCK_C=BC,
                    NCH=NCH)
    kernels.LAUNCHES["groupnorm_fwd"] += 1
    return y, stats


def group_norm_bwd_triton(x, weight, bias, stats, dy, groups: int,
                          silu: bool):
    """dx like x."""
    dy = dy.contiguous()
    B, HW, C, Cg = _check(x, weight, bias, groups)
    kernels.check_cuda(stats, dy)
    _, _, bwd_sums, bwd_apply = _triton_kernels()
    BP, BC, nch, NCH = _blocks(HW, Cg)
    part = torch.empty(B * groups * nch * 2, device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x)
    grid = (B * groups, nch)
    bwd_sums[grid](x, dy, weight, bias, stats, part, HW, C, groups, Cg, nch,
                   SILU=bool(silu), BLOCK_P=BP, BLOCK_C=BC)
    bwd_apply[grid](x, dy, weight, bias, stats, part, dx, HW, C, groups, Cg,
                    nch, 1.0 / (HW * Cg), SILU=bool(silu), BLOCK_P=BP,
                    BLOCK_C=BC, NCH=NCH)
    kernels.LAUNCHES["groupnorm_bwd"] += 1
    return dx


class _GroupNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        ctx.cfg = (groups, eps, silu)
        if x.is_cuda:
            y, stats = group_norm_fwd_triton(x, weight, bias, groups, eps,
                                             silu)
            ctx.save_for_backward(x, weight, bias, stats)
            return y
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        ctx.save_for_backward(x, weight, bias)
        return group_norm_plain(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise NotImplementedError(
                "groupnorm gives no gradient for its weights (frozen "
                "guidance towers); freeze them with requires_grad_(False)")
        groups, eps, silu = ctx.cfg
        if dy.is_cuda:
            x, weight, bias, stats = ctx.saved_tensors
            dx = group_norm_bwd_triton(x, weight, bias, stats, dy, groups,
                                       silu)
        else:
            x, weight, bias = ctx.saved_tensors
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                y = group_norm_plain(xr, weight, bias, groups, eps, silu)
                (dx,) = torch.autograd.grad(y, xr, dy)
        return dx, None, None, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over channel-last x (fp32 statistics), then SiLU if asked;
    output in x's dtype.  weight and bias are [C] fp32 or x's dtype."""
    return _GroupNorm.apply(x.contiguous(), weight, bias, groups, eps, silu)
