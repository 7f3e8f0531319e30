"""K11: GroupNorm with fp32 statistics and an optional fused SiLU.

Replaces ``dreamfusion_tpu/models/unet.py::group_norm_fused`` (a custom_vjp
with the closed-form backward) and ``GroupNorm32`` (flax ``nn.GroupNorm``
in fp32, then cast back).  x is channel-last ``[B, ..., C]``; channels are
grouped contiguously, statistics run over (spatial, channels in the group)
per (batch, group):

    y  = silu?((x - mean) * rstd * scale + bias)        rstd = 1/sqrt(var+eps)
    dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)),
         dxh = dy' * scale,   dy' = dy * silu'(u),   xh = (x - mean) * rstd
    dscale = Σ dy' · xh,   dbias = Σ dy'   (per channel, over batch and pixels)

On a CUDA tensor the forward and the backward are each one launch of a
CUDA C++ kernel (``csrc/groupnorm.cu``), by the route
``group_norm_route`` picks from the shape: resident (a thread-block
cluster keeps a slab of whole groups in shared memory, merges the groups'
statistics through distributed shared memory, and writes the output from
shared memory: x, and dy, read once) or streaming (a cooperative launch of
one CTA per SM: statistics, a grid barrier, one merge per group, a second
barrier, the output).  Each route is its own C entry point and launch
counter; a shape neither takes, or a cluster the card refuses, raises.
Bound on the card: memory (one read of x and one write of y forward; x and
dy in, dx out backward; a few operations per element).  Statistics are
Welford means and M2 per thread, merged with Chan's formula (numerically
safe in fp32, unlike E[x²] − E[x]²).  Where scale and bias ask for
gradients, the backward launches the route's ``_affine`` entry point
instead (its own counter): dx as the plain route's, and each CTA's
per-channel sums of dy' and dy'·xh, finished in a fixed order in the same
launch (no float atomics) into the weights' dtype.  The frozen towers'
backwards keep the plain routes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

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
# CUDA kernels (csrc/groupnorm.cu)
# ---------------------------------------------------------------------------

_ELT = {torch.bfloat16: 2, torch.float32: 4}
# Bytes of x above which the streaming route beat the resident one on the
# H100 (every shape of the SD step, forward and backward, each route at
# each slab, cluster and block size; PERF.md): a slab's rows are
# strided pieces of 16-80 bytes, which read and write worse than whole
# rows, and the backward holds twice the bytes.  At and below it the
# resident route won or tied.
RESIDENT_MAX_BYTES = {False: 15 << 20, True: 4 << 20}    # forward, backward
SLAB_BUDGET = 192 * 1024    # bytes of x (and dy) a resident CTA may hold
MAX_CLUSTER = 16            # CTAs of a cluster (above 8: non-portable)
MIN_PIXELS = 64             # pixels a CTA keeps at least when it grows
RESIDENT_THREADS = 128      # more, smaller CTAs ran faster than fewer


class GNRoute(NamedTuple):
    name: str       # C entry point and launch counter
    slab: int       # channels a cluster owns (resident), or C (streaming)
    cluster: int    # CTAs per cluster (resident), 0 (streaming)
    threads: int    # threads per CTA


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def min_slab_groups(Cg: int, elt: int) -> int:
    """The fewest groups of `Cg` channels of `elt` bytes (a power of two)
    whose width is a multiple of 16 bytes."""
    s = 1
    while (s * Cg * elt) % 16:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def group_norm_route(shape, dtype, bwd: bool, groups: int | None = None,
                     sms: int = 132) -> GNRoute:
    """The K11 kernel, slab, cluster and threads for x of `shape` [B, ...,
    C] (a pure function of the shape; `sms`: the card's multiprocessors).

    Resident route for at most ``RESIDENT_MAX_BYTES`` of x where a
    cluster of at most 16 CTAs can hold the slab in shared memory, at most
    ``SLAB_BUDGET`` bytes a CTA.  The slab is the fewest whole groups whose
    width is a multiple of 16 bytes, doubled once towards a full 32-byte
    sector where the cluster stays within 8; the cluster is the fewest
    CTAs that hold it, doubled (up to 16, at least ``MIN_PIXELS`` pixels a
    CTA) while B x slabs x CTAs stay within two an SM.  Streaming route
    otherwise, one CTA an SM.  Raises for a dtype or a channel count the
    kernels do not take."""
    B, C = shape[0], shape[-1]
    HW = math.prod(shape[1:-1])
    G = groups or groups_for(C)
    if dtype not in _ELT:
        raise ValueError(f"groupnorm kernel takes fp32 or bf16, got {dtype}")
    if C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    elt, Cg, tensors = _ELT[dtype], C // G, 2 if bwd else 1
    way = "bwd" if bwd else "fwd"
    s = min_slab_groups(Cg, elt)        # groups per slab
    if s > G:
        raise ValueError(f"groupnorm kernel: no whole groups of {Cg} "
                         f"channels make 16 bytes within {C} channels")

    def cluster_for(s):
        """The fewest CTAs (a power of two) that hold a slab, or None."""
        n = 1
        while -(-HW // n) * s * Cg * elt * tensors > SLAB_BUDGET:
            n *= 2
            if n > MAX_CLUSTER:
                return None
        return n

    n = cluster_for(s)
    if n is None or B * HW * C * elt > RESIDENT_MAX_BYTES[bwd]:
        V = C * elt // 16
        if _pow2(V) > 512:
            raise ValueError(f"groupnorm kernel: {C} channels are too wide "
                             f"to stream")
        return GNRoute(f"groupnorm_{way}_stream", C, 0, 512)
    if s * Cg * elt < 32 and G % (2 * s) == 0:
        n2 = cluster_for(2 * s)
        if n2 is not None and n2 <= 8:
            s, n = 2 * s, n2
    slabs = B * G // s
    while (n < MAX_CLUSTER and slabs * n * 2 <= 2 * sms
           and HW // (2 * n) >= MIN_PIXELS):
        n *= 2
    return GNRoute(f"groupnorm_{way}_resident", s * Cg, n,
                   max(RESIDENT_THREADS, _pow2(s * Cg * elt // 16)))


def _check(x, weight, bias, groups):
    kernels.check_cuda(x, weight, bias)
    if x.dtype not in _ELT:
        raise ValueError(f"groupnorm kernel takes fp32 or bf16, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("the groupnorm kernels read 16-byte vectors: "
                         "16-byte aligned tensors only")
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    if weight.dtype != bias.dtype or weight.dtype not in _ELT:
        weight, bias = weight.float(), bias.float()
    return (x.shape[0], x.numel() // (x.shape[0] * C), C, weight, bias,
            int(x.dtype == torch.float32),
            int(weight.dtype == torch.bfloat16))


def group_norm_fwd_cuda(x, weight, bias, groups: int, eps: float,
                        silu: bool, route: GNRoute | None = None):
    """→ (y like x, stats [B*G, 2] fp32 mean and rstd): one launch of the
    route ``group_norm_route`` gives (or `route`, as the benchmark's sweep
    of the routes asks)."""
    B, HW, C, w, b, fp32, w_bf16 = _check(x, weight, bias, groups)
    sms = kernels.sm_count(x.device)
    route = route or group_norm_route(tuple(x.shape), x.dtype, False,
                                      groups, sms)
    y = torch.empty_like(x)
    stats = torch.empty(B * groups, 2, device=x.device, dtype=torch.float32)
    P = kernels.ptr
    if route.cluster:
        kernels.launch(route.name, P(x), P(w), P(b), P(y), P(stats), B, HW,
                       C, groups, route.slab, route.cluster, route.threads,
                       float(eps), int(silu), fp32, w_bf16)
    else:
        ctas = max(1, sms // B)
        part = torch.empty(B * ctas * groups * 3, device=x.device,
                           dtype=torch.float32)
        kernels.launch(route.name, P(x), P(w), P(b), P(y), P(stats), P(part),
                       B, HW, C, groups, ctas, route.threads, float(eps),
                       int(silu), fp32, w_bf16)
    return y, stats


def group_norm_bwd_cuda(x, weight, bias, stats, dy, groups: int,
                        silu: bool, route: GNRoute | None = None,
                        affine: bool = False):
    """dx like x, from the forward's stats (`route` as the forward's);
    with `affine`, (dx, dscale, dbias), the weights' gradients in their
    dtype (fp32 where the two differ: ``_check``), from one launch of the
    route's ``_affine`` entry point."""
    dy = dy.to(x.dtype).contiguous()
    B, HW, C, w, b, fp32, w_bf16 = _check(x, weight, bias, groups)
    kernels.check_cuda(stats, dy)
    if dy.data_ptr() % 16:
        raise ValueError("the groupnorm kernels read 16-byte vectors: "
                         "16-byte aligned tensors only")
    sms = kernels.sm_count(x.device)
    route = route or group_norm_route(tuple(x.shape), x.dtype, True,
                                      groups, sms)
    dx = torch.empty_like(x)
    P = kernels.ptr
    ctas = route.cluster or max(1, sms // B)
    name, extra = route.name, []
    if affine:
        # each CTA's per-channel partials, then dscale and dbias
        apart = torch.empty(B * ctas * C * 2, device=x.device,
                            dtype=torch.float32)
        dw, db = torch.empty_like(w), torch.empty_like(b)
        name, extra = name + "_affine", [P(apart), P(dw), P(db)]
    if route.cluster:
        kernels.launch(name, P(x), P(dy), P(w), P(b), P(stats), P(dx),
                       *extra, B, HW, C, groups, route.slab, route.cluster,
                       route.threads, int(silu), fp32, w_bf16)
    else:
        part = torch.empty(B * ctas * groups * 3 + B * groups * 2,
                           device=x.device, dtype=torch.float32)
        fin = part[B * ctas * groups * 3:]
        kernels.launch(name, P(x), P(dy), P(w), P(b), P(stats),
                       P(part), P(fin), P(dx), *extra, B, HW, C, groups,
                       ctas, route.threads, int(silu), fp32, w_bf16)
    return (dx, dw, db) if affine else dx


class _GroupNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        ctx.cfg = (groups, eps, silu)
        if x.is_cuda:
            y, stats = group_norm_fwd_cuda(x, weight, bias, groups, eps,
                                           silu)
            ctx.save_for_backward(x, weight, bias, stats)
            return y
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        ctx.save_for_backward(x, weight, bias)
        return group_norm_plain(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        groups, eps, silu = ctx.cfg
        need = ctx.needs_input_grad[:3]
        affine = need[1] or need[2]
        if dy.is_cuda:
            x, weight, bias, stats = ctx.saved_tensors
            out = group_norm_bwd_cuda(x, weight, bias, stats, dy, groups,
                                      silu, affine=affine)
            dx, dw, db = out if affine else (out, None, None)
            if affine:
                dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        else:
            x, weight, bias = ctx.saved_tensors
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (x, weight, bias)]
                y = group_norm_plain(*ins, groups, eps, silu)
                grads = torch.autograd.grad(
                    y, [t for t, n in zip(ins, need) if n], dy)
            it = iter(grads)
            dx, dw, db = (next(it) if n else None for n in need)
        return (dx if need[0] else None), (dw if need[1] else None), \
            (db if need[2] else None), None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over channel-last x (fp32 statistics), then SiLU if asked;
    output in x's dtype.  weight and bias are [C] fp32 or x's dtype."""
    return _GroupNorm.apply(x.contiguous(), weight, bias, groups, eps, silu)
