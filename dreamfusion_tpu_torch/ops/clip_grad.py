"""K5: the gradient clamp of ``--grad_clip_rgb``.

Replaces ``dreamfusion_tpu/core/math.py::clip_grad`` (a custom_vjp): the
identity forward, and a backward that clamps the cotangent entering the
rendered rgb elementwise to [-limit, limit] with ``jnp.clip``'s rules (NaN
stays NaN, limit 0 gives zeros).

The forward returns a view of its input and launches nothing.  On a CUDA
tensor the backward is one launch of a Triton kernel.  Bound on the card:
memory and launch cost, one pass that reads and writes each element once
with no reuse, so shared memory, tensor cores and TMA have nothing to
offer; masked block loads of 1024 elements, clamped in fp32 (exact for
fp32 and bf16 alike) and stored in the cotangent's own type.  On a CPU
tensor the plain version runs.
"""

from __future__ import annotations

import functools

import torch

from . import kernels

_BLOCK = 1024


def clip_grad_plain(g: torch.Tensor, limit: float) -> torch.Tensor:
    return g.clamp(-limit, limit)


@functools.cache
def _triton_kernel():
    """Compile-on-first-use Triton kernel (imported here: the CPU tests
    import this module where Triton is absent)."""
    import triton
    import triton.language as tl

    @triton.jit
    def clamp(g_ptr, out_ptr, N, limit, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < N
        g = tl.load(g_ptr + offs, mask=m, other=0.0)
        x = g.to(tl.float32)
        c = tl.minimum(tl.maximum(x, -limit), limit)
        c = tl.where(x != x, x, c)            # NaN stays NaN
        tl.store(out_ptr + offs, c.to(g.dtype), mask=m)

    return clamp


def clip_grad_bwd_triton(g: torch.Tensor, limit: float) -> torch.Tensor:
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"clip_grad takes fp32 or bf16, got {g.dtype}")
    g = g.contiguous()
    kernels.check_cuda(g)
    out = torch.empty_like(g)
    N = g.numel()
    _triton_kernel()[(max(1, -(-N // _BLOCK)),)](g, out, N, float(limit),
                                                 BLOCK=_BLOCK)
    kernels.LAUNCHES["clip_grad_bwd"] += 1
    return out


class _ClipGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            return clip_grad_bwd_triton(g, ctx.limit), None
        if g.device.type == "cpu":
            return clip_grad_plain(g, ctx.limit), None
        raise ValueError(f"unsupported device {g.device}")


def clip_grad(x: torch.Tensor, limit: float) -> torch.Tensor:
    """Identity whose gradient is clamped elementwise to [-limit, limit]."""
    return _ClipGrad.apply(x, float(limit))
