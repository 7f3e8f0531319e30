"""K5: the gradient clamp of ``--grad_clip_rgb``.

Replaces ``dreamfusion_tpu/core/math.py::clip_grad`` (a custom_vjp): the
identity forward, and a backward that clamps the cotangent entering the
rendered rgb elementwise to [-limit, limit] with ``jnp.clip``'s rules (NaN
stays NaN, limit 0 gives zeros).

The forward returns a view of its input and launches nothing.  On a CUDA
tensor the backward is one launch of ``csrc/clip_grad.cu`` through ctypes
(``kernels.launch``).  Bound on the card: bytes and, at the image path's
48 KB to 3 MB, the launch itself: one pass with no reuse, 16-byte loads
and stores, clamped in fp32 (exact for fp32 and bf16 alike) and stored in
the cotangent's own type.  A C entry point keeps the host's cost per call
to a ctypes call, where the Triton kernel it replaced paid Triton's Python
launcher and lost to ``torch.clamp`` on that alone.  On a CPU tensor the
plain version runs.
"""

from __future__ import annotations

import torch

from . import kernels


def clip_grad_plain(g: torch.Tensor, limit: float) -> torch.Tensor:
    return g.clamp(-limit, limit)


def clip_grad_bwd_cuda(g: torch.Tensor, limit: float) -> torch.Tensor:
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"clip_grad takes fp32 or bf16, got {g.dtype}")
    if not limit >= 0:
        raise ValueError(f"clip_grad needs a limit >= 0, got {limit}")
    if not g.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got {g.device}")
    g = g.contiguous()
    if g.data_ptr() % 16:         # the kernel reads 16 bytes at a time
        g = g.clone()
    out = torch.empty_like(g)
    kernels.launch("clip_grad_bwd", g.data_ptr(), out.data_ptr(), g.numel(),
                   float(limit), int(g.dtype == torch.bfloat16))
    return out


class _ClipGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            return clip_grad_bwd_cuda(g, ctx.limit), None
        if g.device.type == "cpu":
            return clip_grad_plain(g, ctx.limit), None
        raise ValueError(f"unsupported device {g.device}")


def clip_grad(x: torch.Tensor, limit: float) -> torch.Tensor:
    """Identity whose gradient is clamped elementwise to [-limit, limit]."""
    return _ClipGrad.apply(x, float(limit))
