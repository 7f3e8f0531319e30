"""Stable Diffusion SDS guidance (``dreamfusion_tpu/guidance/sd.py``).

The frozen UNet, VAE and CLIP text towers are ``nn.Module``s holding their
own weights (bf16 at SD width).  Every random number is an argument: the
timestep ``t``, the latent ``noise`` and the VAE ``posterior_noise``,
drawn by ``training/trainer.py::draw_step``.  The UNet runs under
``no_grad`` on stop-gradient latents, so no UNet backward is ever built;
the VAE encoder is differentiated into the render.  Images are NHWC in
[0, 1].  ``as_latent`` is a Python bool: the warm-up phase resizes the
4-channel (rgb + alpha) render straight to the latent size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..models.clip import CLIPTextConfig, CLIPTextEncoder
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from .perpneg import weighted_perpendicular_aggregator
from .schedule import NoiseSchedule, make_schedule


@dataclass(frozen=True)
class SDConfig:
    sd_version: str = "2.1"
    image_size: int = 512          # resolution fed to the VAE
    latent_size: int = 64
    t_range: Tuple[float, float] = (0.02, 0.98)
    num_train_timesteps: int = 1000
    tiny: bool = False             # test-scale towers

    def unet_config(self) -> UNetConfig:
        if self.tiny:
            return UNetConfig.tiny()
        if not self.sd_version.startswith("2"):
            raise NotImplementedError(
                "SD 1.x (head dim 40) is not ported (ROADMAP queue 1, "
                "item 4)")
        return UNetConfig.sd21()

    def vae_config(self) -> VAEConfig:
        return VAEConfig.tiny() if self.tiny else VAEConfig.sd()

    def text_config(self) -> CLIPTextConfig:
        return CLIPTextConfig.tiny() if self.tiny else CLIPTextConfig.sd21()

    @property
    def min_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[0])

    @property
    def max_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[1])


class StableDiffusionGuidance:
    def __init__(self, cfg: SDConfig, device="cuda"):
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.unet = UNet2DCondition(cfg.unet_config())
            self.vae = AutoencoderKL(cfg.vae_config())
            self.text_encoder = CLIPTextEncoder(cfg.text_config())
        ims = cfg.latent_size * self.vae.cfg.downscale
        if ims != cfg.image_size:
            raise ValueError(f"image_size {cfg.image_size} must equal "
                             f"latent_size * {self.vae.cfg.downscale}")
        self.schedule: NoiseSchedule = make_schedule(
            "scaled_linear", cfg.num_train_timesteps)

    def towers(self) -> Dict[str, nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    scale: float = 0.02) -> None:
        """Random weights, N(0, scale²) for every tensor, drawn in the
        towers' dtype on their device (the spirit of the JAX package's
        ``fast_random_params``; not its bits)."""
        for tower in self.towers().values():
            for p in tower.parameters():
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=p.dtype) * scale)

    def load_state_dicts(self, state: Dict[str, Dict[str, torch.Tensor]]
                         ) -> None:
        """{"unet" | "vae" | "text": state_dict} (``utils/convert.py``)."""
        towers = self.towers()
        for name, sd in state.items():
            towers[name].load_state_dict(sd, strict=True)

    # ---- VAE -------------------------------------------------------------
    def encode_imgs(self, imgs: torch.Tensor,
                    posterior_noise: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → scaled latent sample; differentiable."""
        moments = self.vae.encode(imgs * 2.0 - 1.0)
        return moments.sample(posterior_noise) * self.vae.cfg.scale_factor

    def _to_latents(self, pred_rgb: torch.Tensor, as_latent: bool,
                    posterior_noise: torch.Tensor) -> torch.Tensor:
        if as_latent:
            # pred_rgb is [B, h, w, 4] (rgb + alpha): straight to latents
            ls = self.cfg.latent_size
            return resize_bilinear(pred_rgb, (ls, ls)) * 2.0 - 1.0
        size = self.cfg.image_size
        rgb = resize_bilinear(pred_rgb, (size, size))
        return self.encode_imgs(rgb, posterior_noise)

    def _sds_from_noise_pred(self, latents, noise, noise_pred, t,
                             grad_scale: float) -> torch.Tensor:
        """Reparameterised SDS loss: 0.5 |latents - sg(latents - g)|² / B."""
        w = (1.0 - self.schedule.alphas_cumprod_at(t)).reshape(-1, 1, 1, 1)
        grad = torch.nan_to_num(grad_scale * w * (noise_pred - noise))
        lat = latents.float()
        targets = (lat - grad).detach()
        return 0.5 * ((lat - targets) ** 2).sum() / latents.shape[0]

    def _eps(self, latents_noisy, t, context, copies: int) -> torch.Tensor:
        with torch.no_grad():
            x_in = torch.cat([latents_noisy] * copies)
            t_in = torch.cat([t] * copies)
            return self.unet(x_in, t_in, context)

    # ---- SDS ---------------------------------------------------------------
    def sds_loss(self, text_z_cond, text_z_uncond, pred_rgb, t, noise,
                 posterior_noise, guidance_scale: float = 100.0,
                 as_latent: bool = False, grad_scale: float = 1.0):
        """text_z_* [B, L, D]; pred_rgb [B, h, w, 3 or 4] in [0, 1]; t int
        [B]; noise and posterior_noise [B, ls, ls, 4] standard normal."""
        latents = self._to_latents(pred_rgb, as_latent, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t).detach()
        eps = self._eps(latents_noisy, t,
                        torch.cat([text_z_uncond, text_z_cond]), 2)
        eps_uncond, eps_cond = eps.chunk(2)
        noise_pred = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        return self._sds_from_noise_pred(latents, noise, noise_pred, t,
                                         grad_scale)

    def sds_loss_perpneg(self, text_z, weights, text_z_uncond, pred_rgb, t,
                         noise, posterior_noise,
                         guidance_scale: float = 100.0,
                         as_latent: bool = False, grad_scale: float = 1.0):
        """text_z [B*K, L, D] interleaved; weights [B*K]; text_z_uncond
        [B, L, D]; the UNet runs at batch B*(1+K)."""
        latents = self._to_latents(pred_rgb, as_latent, posterior_noise)
        B = latents.shape[0]
        K = text_z.shape[0] // B
        latents_noisy = self.schedule.add_noise(latents, noise, t).detach()
        eps = self._eps(latents_noisy, t, torch.cat([text_z_uncond, text_z]),
                        1 + K)
        eps_uncond, eps_text = eps[:B], eps[B:]
        delta = eps_text - eps_uncond.repeat(K, 1, 1, 1)
        noise_pred = eps_uncond + guidance_scale * \
            weighted_perpendicular_aggregator(delta, weights, B)
        return self._sds_from_noise_pred(latents, noise, noise_pred, t,
                                         grad_scale)
