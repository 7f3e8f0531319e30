"""Diffusion noise schedule (``dreamfusion_tpu/guidance/schedule.py``):
the precomputed ᾱ table and ``add_noise``."""

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

    def alphas_cumprod_at(self, t: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.alphas_cumprod, device=t.device)[t]

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0); t int [B] broadcast over trailing dims."""
        ac = self.alphas_cumprod_at(t)
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return torch.sqrt(ac).reshape(shape) * x0 + \
            torch.sqrt(1.0 - ac).reshape(shape) * noise


def make_schedule(name: str, T: int = 1000) -> NoiseSchedule:
    if name in ("scaled_linear", "sd", "zero123"):
        return NoiseSchedule.scaled_linear(T=T)
    raise NotImplementedError(
        f"schedule {name!r} is not ported (ROADMAP queue 1: DeepFloyd-IF)")
