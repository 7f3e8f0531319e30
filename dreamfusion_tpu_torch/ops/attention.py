"""K10: softmax(q kᵀ · scale) v with fp32 statistics
(``dreamfusion_tpu/ops/attention.py``: ``chunked_attention``,
``dense_attention`` and the ``attention`` dispatch between them).

q ``[B, N, h, d]``, k and v ``[B, M, h, d]`` → ``[B, N, h, d]`` in q's
dtype, scale 1/√d.  Both JAX versions take the logits' statistics in fp32
and round P to the input dtype before P·V; this one does too.

``attention`` follows JAX's dispatch (``chunked_branch``): where JAX takes
``chunked_attention`` (logits of B·h·N·M > 64·2²⁰ elements, M % 512 == 0),
the logits are bf16(q·scale)·kᵀ, q scaled in fp32 and rounded to its dtype
first (``chunked_attention`` :42), else q·kᵀ·scale in fp32.  The two agree
where the scale is a power of two (d = 64: 1/8); SD 1.5's d = 40
self-attention at 64² is the path's one call where they differ.

On a CUDA tensor the forward is one launch of ``csrc/attention.cu``.
fp32 q, k and v (DPT's ViT-B: [1, 577, 12, 64], JAX's dense branch) take
``attention_fwd_fp32``: CUDA-core FMAs (no TF32), blocks of 32 queries
whose two key halves each run an online softmax over 64-key tiles (K and
V double-buffered by cp.async, so q, k and v are 16-byte aligned) and
merge at the end, P kept in fp32.  bf16 takes the flash-style wgmma kernels
with operands by TMA: at the UNet's head dims
one kernel parametrised on d, with a counter per d
(``attention_fwd_wgmma`` at d = 64, ``attention_fwd_wgmma_d40``, ``_d80``
and ``_d160`` at SD 1.5's), at d = 512 the VAE mid-block's
(``attention_fwd_wgmma_d512``: its KV range split over ``kv_splits``
blocks, merged by a second kernel of the same launch);
``attention_route`` picks by d alone.  The backward is one call of the
route ``attention_bwd_route`` names by d.  At the UNet's head dims it is
flash-style, one kernel template on d (``attention_bwd_flash`` at d = 64,
``attention_bwd_flash_d40``, ``_d80`` and ``_d160`` at SD 1.5's): the rows'
lse and D (``dO · O``), then one launch of two passes side by side: blocks
of (b, h, 128 keys) that recompute S and dP against each query tile and
keep dK and dV in registers, and blocks of (b, h, 128 queries) for dQ that
recompute them again against each key tile; nothing of size N x M
reaches device memory, and no atomics (two launches agree bit for bit).
Where the key tiles leave SMs idle (77 text keys, zero123's one) the dK/dV
pass splits the queries (``flash_bwd_splits``) and a reduce sums the
splits' fp32 partials in order.  At d = 512 (the VAE mid-block) it is
``attention_bwd_wgmma``: four kernels (the row dots, a scores pass storing
P and dS, dV and dK in one wgmma GEMM launch, dQ in another).  Both
recompute the logits as the forward formed them: on JAX's chunked branch
with a scale that is not a power of two, from bf16(q·scale) (a kernel
writes it first), whose derivative passes straight through the rounding
as in JAX.  ``attention_bwd_plain`` is the kernels' arithmetic in torch
(P and dS rounded to bf16 between the products), the card's reference.
The fp32 forward's backward (the DPT's, JAX's dense branch
differentiated) is ``attention_bwd_fp32`` on the CUDA cores: the row
dots, then a pass a (head, 32 keys) that recomputes P from q, k and the
forward's lse for dV and dK, and a pass a (head, 32 queries) for dQ, P and
dS in fp32 (the plain version's, with no rounding in fp32).  On a CPU
tensor the plain
version runs and its backward is autograd of it.
"""

from __future__ import annotations

import math

import torch

from . import kernels


LOGITS_THRESHOLD = 64 * 2 ** 20     # JAX ``attention``'s dispatch
CHUNK = 512


def chunked_branch(B: int, N: int, M: int, h: int) -> bool:
    """Whether JAX's ``attention`` takes ``chunked_attention`` here."""
    return B * h * N * M > LOGITS_THRESHOLD and M % CHUNK == 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, round_q: bool = False) -> torch.Tensor:
    """``dense_attention``: fp32 logits and softmax, P cast to q's dtype;
    with `round_q`, the logits of q·scale rounded to q's dtype first, as
    ``chunked_attention`` forms them."""
    if round_q:
        q, scale = (q.float() * scale).to(q.dtype), 1.0
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return o.to(q.dtype)


def _check(q, k, v, dtypes=(torch.bfloat16,)):
    kernels.check_cuda(q, k, v)
    for t in (q, k, v):
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(f"attention kernel takes q, k and v of one "
                             f"dtype in {dtypes}, got {t.dtype}")
    B, N, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    return B, N, k.shape[1], H, D


_ROUTES = {40: "attention_fwd_wgmma_d40", 64: "attention_fwd_wgmma",
           80: "attention_fwd_wgmma_d80", 160: "attention_fwd_wgmma_d160",
           512: "attention_fwd_wgmma_d512"}
_FP32_ROUTE, _FP32_D = "attention_fwd_fp32", 64
_TILE_512 = 64          # d = 512: query rows per block, keys per KV tile
_MAX_SPLITS = 4


def attention_route(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The launch counter (and kernel) of the forward at head dim `d`:
    fp32 q, k and v (DPT's ViT) take ``attention_fwd_fp32`` (d = 64), bf16
    the wgmma routes."""
    if dtype == torch.float32:
        if d != _FP32_D:
            raise ValueError(f"the fp32 attention kernel takes d = "
                             f"{_FP32_D}, got {d}")
        return _FP32_ROUTE
    if d not in _ROUTES:
        raise ValueError(f"attention kernel takes d = {sorted(_ROUTES)}, "
                         f"got {d}")
    return _ROUTES[d]


def kv_splits(blocks: int, kv_tiles: int, sms: int) -> int:
    """d = 512's KV splits on a card with `sms` multiprocessors: as many
    as the `blocks` query tiles leave SMs for (4096 tokens: 64 tiles, 2
    splits on 132 SMs), at most 4 and at most one per KV tile."""
    return max(1, min(sms // max(blocks, 1), _MAX_SPLITS, kv_tiles))


def attention_fwd_cuda(q, k, v, scale: float, round_q: bool = False):
    """→ (out [B, N, h, d] in q's dtype, lse [B, h, N] fp32, the
    log-sum-exp of the logits as formed); `round_q` as in
    ``attention_plain``."""
    B, N, M, H, D = _check(q, k, v, (torch.bfloat16, torch.float32))
    route = attention_route(D, q.dtype)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the attention kernels read q, k and v in 16-byte "
                         "units (TMA, cp.async): 16-byte aligned tensors "
                         "only")
    if route == _FP32_ROUTE:
        if round_q:
            raise ValueError("the fp32 attention kernel takes JAX's dense "
                             "branch only")
        o = torch.empty_like(q)
        lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
        kernels.launch(route, *(kernels.ptr(t) for t in (q, k, v, o, lse)),
                       B, N, M, H, D, float(scale))
        return o, lse
    prescale = _prescale(round_q, scale)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
    args = [kernels.ptr(t) for t in (q, k, v, o, lse)] + [B, N, M, H]
    if route != "attention_fwd_wgmma_d512":
        args.append(int(prescale))
    elif prescale:
        raise ValueError("the d = 512 kernel does not round q·scale")
    else:
        splits = kv_splits(-(-N // _TILE_512) * B * H, -(-M // _TILE_512),
                           kernels.sm_count(q.device))
        ows = lws = None
        if splits > 1:
            ows = torch.empty(splits, B * H * N, D, device=q.device,
                              dtype=torch.float32)
            lws = torch.empty(splits, B * H * N, device=q.device,
                              dtype=torch.float32)
        args += [splits, kernels.ptr(ows), kernels.ptr(lws)]
    kernels.launch(route, *args, float(scale))
    return o, lse


_BWD_ROUTES = {40: "attention_bwd_flash_d40", 64: "attention_bwd_flash",
               80: "attention_bwd_flash_d80", 160: "attention_bwd_flash_d160",
               512: "attention_bwd_wgmma"}
_FLASH_BR = {40: 64, 64: 64, 80: 64, 160: 32}   # the dK/dV pass's query tile
_FLASH_BC = 128                                 # and its keys a block
_FLASH_ROWS = 128                               # lse and D padded to it
_FLASH_MIN_TILES, _FLASH_MAX_SPLITS = 4, 16


def attention_bwd_route(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The launch counter (and entry point) of the backward at head dim
    `d`: fp32 (the DPT's) "attention_bwd_fp32" at d = 64; bf16 the
    flash-style routes at the UNet's head dims, 40, 64, 80 and 160 each
    its own ("attention_bwd_flash", "_d40", ...), "attention_bwd_wgmma" at
    the VAE's 512."""
    if dtype == torch.float32:
        if d != _FP32_D:
            raise ValueError(f"the fp32 attention backward takes d = "
                             f"{_FP32_D}, got {d}")
        return "attention_bwd_fp32"
    if d not in _BWD_ROUTES:
        raise ValueError(f"attention backward takes d = "
                         f"{sorted(_BWD_ROUTES)}, got {d}")
    return _BWD_ROUTES[d]


def flash_bwd_splits(Z: int, N: int, M: int, d: int, sms: int) -> int:
    """Query splits of the flash backward's dK/dV pass for `Z` = B·h heads
    of N queries and M keys on `sms` multiprocessors: as many as bring its
    blocks (one a head and 128 keys) to half the card, the rest of it left
    to the dQ pass's blocks of the same launch, with at least 4 query tiles
    a split (shorter splits cost more in fp32 partials and their reduce
    than they save) and at most 16.  Both constants come from
    ``bench_sd_kernels.py --only attn_bwd_splits``: on an H100 the rule is
    within 6% of the fastest split at every tower shape."""
    blocks = Z * -(-M // _FLASH_BC)
    tiles = -(-N // _FLASH_BR[d])
    return max(1, min(sms // (2 * blocks), tiles // _FLASH_MIN_TILES,
                      _FLASH_MAX_SPLITS))


def _prescale(round_q: bool, scale: float) -> bool:
    """Rounding q·scale changes the logits only where scale is not 2^k."""
    return round_q and math.frexp(scale)[0] != 0.5


def attention_bwd_plain(q, k, v, o, do, scale: float,
                        round_q: bool = False):
    """→ (dq, dk, dv) in q's dtype, the backward kernels' arithmetic in
    fp32: the logits as the forward formed them (`round_q` as in
    ``attention_plain``), P = their softmax rounded to q's dtype, dP = dO
    Vᵀ, D = rowsum(dO ∘ O), dS = P ∘ (dP − D) rounded likewise, dV = Pᵀ dO,
    dK = scale dSᵀ q (with the rounded q·scale, dSᵀ of it) and dQ = scale
    dS K.  For fp32 q (JAX's dense branch, P cast to fp32) nothing is
    rounded: ``jax.vjp`` of ``dense_attention``."""
    dt = q.dtype
    qs, s_scale = q.float(), scale
    if _prescale(round_q, scale):
        qs, s_scale = (q.float() * scale).to(dt).float(), 1.0
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, kf) * s_scale
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    dvec = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - dvec)).to(dt).float()
    p = p.to(dt).float()
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qs) * s_scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd_cuda(q, k, v, o, lse, do, scale: float,
                       round_q: bool = False):
    """→ (dq, dk, dv) in q's dtype: one call of the route
    ``attention_bwd_route`` names.  bf16: the flash-style passes at the
    UNet's head dims, the four-kernel route at d = 512; with `round_q` on a
    scale that is not 2^k, bf16(q·scale) first.  fp32 (d = 64, JAX's dense
    branch only): the row dots and the two CUDA-core passes of
    ``attention_bwd_fp32``."""
    B, N, M, H, D = _check(q, k, v, (torch.bfloat16, torch.float32))
    route = attention_bwd_route(D, q.dtype)
    do = do.to(q.dtype).contiguous()
    kernels.check_cuda(o, lse, do)
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the attention kernels read q, k, v, o and do in "
                         "16-byte units (TMA, cp.async): 16-byte aligned "
                         "tensors only")
    Z = B * H
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if route == "attention_bwd_fp32":
        if round_q:
            raise ValueError("the fp32 attention backward takes JAX's dense "
                             "branch only")
        dvec = torch.empty(Z * N, device=dev, dtype=torch.float32)
        kernels.launch(route, *(kernels.ptr(t) for t in (
            q, k, v, o, do, lse, dq, dk, dv, dvec)), B, N, M, H, D,
            float(scale))
        return dq, dk, dv
    prescale = _prescale(round_q, scale)
    qs = torch.empty_like(q) if prescale else None
    if route == "attention_bwd_wgmma":
        dvec = torch.empty(Z * N, device=dev, dtype=torch.float32)
        Mp = -(-M // 8) * 8
        p = torch.empty(Z, N, Mp, device=dev, dtype=torch.bfloat16)
        ds = torch.empty_like(p)
        kernels.launch(route, *(kernels.ptr(t) for t in (
            q, k, v, o, do, lse, dq, dk, dv, dvec, p, ds, qs)), B, N, M, H,
            D, int(prescale), float(scale))
        return dq, dk, dv
    Np = -(-N // _FLASH_ROWS) * _FLASH_ROWS
    lse2, dvec = torch.empty(2, Z * Np, device=dev, dtype=torch.float32)
    splits = flash_bwd_splits(Z, N, M, D, kernels.sm_count(dev))
    ws = (torch.empty(2 * splits * dk.numel(), device=dev,
                      dtype=torch.float32) if splits > 1 else None)
    kernels.launch(route, *(kernels.ptr(t) for t in (
        q, k, v, o, do, lse, dq, dk, dv, lse2, dvec, qs, ws)), B, N, M, H,
        splits, int(prescale), float(scale))
    return dq, dk, dv


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, round_q):
        ctx.scale, ctx.round_q = scale, round_q
        if q.is_cuda:
            o, lse = attention_fwd_cuda(q, k, v, scale, round_q)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        if q.device.type != "cpu":
            raise ValueError(f"unsupported device {q.device}")
        ctx.save_for_backward(q, k, v)
        return attention_plain(q, k, v, scale, round_q)

    @staticmethod
    def backward(ctx, do):
        if do.is_cuda:
            q, k, v, o, lse = ctx.saved_tensors
            return (*attention_bwd_cuda(q, k, v, o, lse, do, ctx.scale,
                                        ctx.round_q), None, None)
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = attention_plain(*qkv, ctx.scale, ctx.round_q)
            grads = torch.autograd.grad(o, qkv, do)
        return (*grads, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """q [B, N, h, d], k/v [B, M, h, d] → [B, N, h, d], scale 1/√d, on
    JAX's branch (``chunked_branch``)."""
    B, N, h, d = q.shape
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            1.0 / math.sqrt(d),
                            chunked_branch(B, N, k.shape[1], h))
