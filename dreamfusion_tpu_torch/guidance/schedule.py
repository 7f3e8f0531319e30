"""Diffusion noise schedules (``dreamfusion_tpu/guidance/schedule.py``):
SD's "scaled_linear" and DeepFloyd-IF's cosine "squaredcos_cap_v2", each
a precomputed ᾱ table (betas and their cumulative product in float64, cast
to float32 once, as JAX does: a cumulative product of float32 betas
drifts), ``add_noise``, ``predict_start_from_noise`` and the deterministic
DDIM step and the sampling loop over it (``ddim_sample``: SD's and IF's
txt2img, zero123's ``novel_view``).  The table is copied to a device
once and kept there (``alphas_cumprod_at``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray            # [T] fp32
    alphas_cumprod: np.ndarray   # [T] fp32

    @staticmethod
    def scaled_linear(beta_start: float = 0.00085, beta_end: float = 0.012,
                      T: int = 1000) -> "NoiseSchedule":
        """SD's "scaled_linear": linear in sqrt(beta)."""
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
        return NoiseSchedule(betas.astype(np.float32),
                             np.cumprod(1.0 - betas).astype(np.float32))

    @staticmethod
    def squaredcos_cap_v2(T: int = 1000) -> "NoiseSchedule":
        """The cosine schedule (DeepFloyd-IF): ᾱ(t) = cos²((t/T + 0.008) /
        1.008 · π/2), betas 1 - ᾱ(t+1)/ᾱ(t) clipped to [0, 0.999]."""
        def f(t):
            return np.cos((t / T + 0.008) / 1.008 * np.pi / 2) ** 2
        t = np.arange(T, dtype=np.float64)
        betas = np.clip(1 - f(t + 1) / f(t), 0, 0.999)
        return NoiseSchedule(betas.astype(np.float32),
                             np.cumprod(1.0 - betas).astype(np.float32))

    def table(self, device) -> torch.Tensor:
        """The ᾱ table on `device`, copied there once."""
        cache = self.__dict__.setdefault("_tables", {})
        dev = torch.device(device)
        if dev not in cache:
            cache[dev] = torch.as_tensor(self.alphas_cumprod, device=dev)
        return cache[dev]

    def alphas_cumprod_at(self, t: torch.Tensor) -> torch.Tensor:
        return self.table(t.device)[t]

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0); t int [B] broadcast over trailing dims."""
        ac = self.alphas_cumprod_at(t)
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return torch.sqrt(ac).reshape(shape) * x0 + \
            torch.sqrt(1.0 - ac).reshape(shape) * noise

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
        """x_0 = (x_t - sqrt(1 - ᾱ_t) ε) / sqrt(ᾱ_t)."""
        ac = self.alphas_cumprod_at(t)
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        return (x_t - torch.sqrt(1.0 - ac).reshape(shape) * noise) / \
            torch.sqrt(ac).reshape(shape)

    def ddim_step(self, x_t: torch.Tensor, eps: torch.Tensor,
                  t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
        """One deterministic (eta = 0) DDIM update t → t_prev; ᾱ of a
        negative t_prev is 1 (the last step lands on x_0)."""
        a_t = self.alphas_cumprod_at(t)
        a_prev = torch.where(t_prev >= 0,
                             self.alphas_cumprod_at(t_prev.clamp(min=0)),
                             torch.ones_like(a_t))
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
        x0 = (x_t - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(torch.clamp(1 - a_prev, min=0.0)) * eps
        return torch.sqrt(a_prev) * x0 + dir_xt


def ddim_sample(schedule: NoiseSchedule, eps_fn, x: torch.Tensor, T: int,
                n: int) -> torch.Tensor:
    """`n` deterministic DDIM steps from `x` at the timesteps
    ``range(T-1, -1, -T//n)[:n]``, ``eps_fn(x, t [B])`` the guided noise
    prediction; the last step goes to t_prev = -1 (ᾱ = 1: x0)."""
    steps = list(range(T - 1, -1, -(T // n)))[:n]
    B, dev = x.shape[0], x.device
    for i, tcur in enumerate(steps):
        t_prev = steps[i + 1] if i + 1 < len(steps) else -1
        t = torch.full((B,), tcur, dtype=torch.long, device=dev)
        x = schedule.ddim_step(x, eps_fn(x, t), t, torch.full(
            (B,), t_prev, dtype=torch.long, device=dev))
    return x


def make_schedule(name: str, T: int = 1000) -> NoiseSchedule:
    if name in ("scaled_linear", "sd", "zero123"):
        return NoiseSchedule.scaled_linear(T=T)
    if name in ("squaredcos_cap_v2", "if"):
        return NoiseSchedule.squaredcos_cap_v2(T=T)
    raise ValueError(f"unknown schedule {name!r}")
