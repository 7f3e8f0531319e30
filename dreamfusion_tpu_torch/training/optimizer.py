"""Adan or Adam with the encoder's 10x update scale
(``dreamfusion_tpu/training/optimizer.py``: ``adan``, ``scale_lr_by_label``,
``build_optimizer``; Adam as ``optax.adam``).

Plain torch on a few tensors.  ``build_optimizer`` follows JAX's: Adan at
5x the learning rate or Adam (b1 0.9, b2 0.99, eps 1e-15); under the
vanilla backbone Adan's rate decays as 0.1^min(count/iters, 1) and Adam's as
``optax.exponential_decay(lr, iters, 0.1)`` (unclamped); ``grad_clip`` ≥ 0
clips every gradient element to ±grad_clip first (``optax.clip``).  The
encoder's factor multiplies the whole final update, proximal decay included — not the learning rate, which
would change the (1 + lr·wd) divisor.  Bias corrections are computed in
fp32 from the step count on the device, so a guarded step that is skipped
leaves the count, and everything else, unchanged without a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, Optional, Sequence

import torch


@dataclass
class AdanState:
    count: torch.Tensor          # [] int32
    m: List[torch.Tensor]        # EMA of grads            (beta1)
    diff: List[torch.Tensor]     # EMA of grad differences (beta2)
    n: List[torch.Tensor]        # EMA of (g + b2*diff)^2  (beta3)
    prev_grad: List[torch.Tensor]


@dataclass
class AdamState:
    count: torch.Tensor          # [] int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def state_tensors(state) -> dict:
    """An optimizer state's fields by name (the count, the moment lists)."""
    return {f.name: getattr(state, f.name) for f in fields(state)}


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


class _Optimizer:
    """The learning rate (constant, or decayed by 0.1 over ``decay_iters``
    steps) and the elementwise gradient clip shared by Adan and Adam."""

    def __init__(self, lr: float, scales: Sequence[float],
                 grad_clip: float = -1.0,
                 decay_iters: Optional[int] = None, clamp: bool = True):
        self.lr, self.scales = lr, list(scales)
        self.grad_clip = grad_clip
        self.decay_iters, self.clamp = decay_iters, clamp

    def lr_at(self, count: torch.Tensor):
        """lr, or lr·0.1^(count / iters), the exponent clamped at 1 when
        ``clamp``; count [] int32 on the device."""
        if self.decay_iters is None:
            return self.lr
        e = count.float() / self.decay_iters
        if self.clamp:
            e = torch.clamp(e, max=1.0)
        return self.lr * _f32(0.1, count.device) ** e

    def clipped(self, grads):
        c = self.grad_clip
        return grads if c < 0 else [torch.clamp(g, -c, c) for g in grads]


class Adan(_Optimizer):
    """Reference defaults: lr = 5·lr_cli, eps 1e-8, weight decay 2e-5,
    global grad-norm clip 5, betas (0.98, 0.92, 0.99); ``scales[i]``
    multiplies parameter i's final update (10 for the encoder).  The rate
    of step ``count`` (1 on the first) is ``lr_at(count)``."""

    def __init__(self, lr: float, scales: Sequence[float], b1: float = 0.98,
                 b2: float = 0.92, b3: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 2e-5, max_grad_norm: float = 5.0,
                 grad_clip: float = -1.0,
                 decay_iters: Optional[int] = None):
        super().__init__(lr, scales, grad_clip, decay_iters)
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.eps, self.wd = eps, weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Sequence[torch.Tensor]) -> AdanState:
        z = lambda: [torch.zeros_like(p) for p in params]
        return AdanState(torch.zeros((), dtype=torch.int32,
                                     device=params[0].device),
                         z(), z(), z(), z())

    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: AdanState):
        """→ (new params, new state); inputs are not modified."""
        b1, b2, b3, eps = self.b1, self.b2, self.b3, self.eps
        count = state.count + 1
        grads = self.clipped(grads)
        if self.max_grad_norm > 0:
            gn = torch.sqrt(sum((g * g).sum() for g in grads))
            clip = torch.clamp(self.max_grad_norm / (gn + eps), max=1.0)
            grads = [g * clip for g in grads]
        first = count == 1
        prev = [torch.where(first, g, p)
                for g, p in zip(grads, state.prev_grad)]
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(state.m, grads)]
        gdiff = [g - p for g, p in zip(grads, prev)]
        diff = [b2 * d + (1 - b2) * gd for d, gd in zip(state.diff, gdiff)]
        n = [b3 * nn + (1 - b3) * (g + b2 * gd) ** 2
             for nn, g, gd in zip(state.n, grads, gdiff)]

        cf = count.float()
        bc1 = 1 - _f32(b1, cf.device) ** cf
        bc2 = 1 - _f32(b2, cf.device) ** cf
        bc3_sqrt = torch.sqrt(1 - _f32(b3, cf.device) ** cf)
        lr = self.lr_at(count)
        new_params = []
        for p, mm, dd, nn, s in zip(params, m, diff, n, self.scales):
            denom = torch.sqrt(nn) / bc3_sqrt + eps
            step = (lr / bc1) * mm / denom + (lr * b2 / bc2) * dd / denom
            upd = (p - step) / (1 + lr * self.wd) - p
            new_params.append(p + upd * s)
        return new_params, AdanState(count, m, diff, n, list(grads))


class Adam(_Optimizer):
    """``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-15)``: bias-corrected
    moments, the update mu_hat / (sqrt(nu_hat) + eps) scaled by -lr; the
    rate of a step is ``lr_at`` of the count before it (optax's schedule
    count, 0 on the first); ``scales[i]`` multiplies parameter i's
    update."""

    def __init__(self, lr: float, scales: Sequence[float], b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-15,
                 grad_clip: float = -1.0,
                 decay_iters: Optional[int] = None):
        super().__init__(lr, scales, grad_clip, decay_iters, clamp=False)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        z = lambda: [torch.zeros_like(p) for p in params]
        return AdamState(torch.zeros((), dtype=torch.int32,
                                     device=params[0].device), z(), z())

    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: AdamState):
        """→ (new params, new state); inputs are not modified."""
        b1, b2 = self.b1, self.b2
        grads = self.clipped(grads)
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        cf = count.float()
        bc1 = 1 - _f32(b1, cf.device) ** cf
        bc2 = 1 - _f32(b2, cf.device) ** cf
        lr = self.lr_at(state.count)
        new_params = []
        for p, m, v, s in zip(params, mu, nu, self.scales):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            new_params.append(p + (-lr * upd) * s)
        return new_params, AdamState(count, mu, nu)


def build_optimizer(name: str, lr: float, iters: int, scales: Sequence[float],
                    vanilla: bool = False, grad_clip: float = -1.0):
    """JAX's ``build_optimizer``: Adan at 5x lr, else Adam, the vanilla
    backbone's decay, the elementwise clip; ``scales`` the encoder's 10x."""
    decay = iters if vanilla else None
    if name == "adan":
        return Adan(5.0 * lr, scales, grad_clip=grad_clip, decay_iters=decay)
    # any other name is Adam, as in JAX
    return Adam(lr, scales, grad_clip=grad_clip, decay_iters=decay)
