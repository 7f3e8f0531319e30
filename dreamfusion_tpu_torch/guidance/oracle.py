"""Oracle SDS priors (``dreamfusion_tpu/guidance/oracle.py``): the
pixel-space ``PixelOracleGuidance.sds_loss_rays``, the image oracle's
``ImageOracleGuidance.sds_loss_rays_pose`` and the latent
``OracleGuidance``.

The closed-form "denoiser" predicts the noise that maps the noised render
back to the analytic target view of the same cameras,
eps_hat = (x_t − sqrt(ᾱ_t)·x_target) / sqrt(1 − ᾱ_t), and the loss is
the reference's reparameterized SDS loss.  The timestep and the noise are
arguments, drawn by ``training/trainer.py::draw_step``.

``OracleGuidance`` is the same denoiser in SD's latent space, toward a
target image: SD's real machinery (the resize, the VAE encode with its
gradient into the render, the noising, the reparameterized loss) with the
UNet replaced by the closed form.  The target goes through the same
encoder with the same posterior draw as the render, so the sampling noise
cancels in z − z_target.  No run of ``main`` builds it (JAX's neither);
its users drive a field toward a known view through a VAE.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..evaluation.analytic import SCENES, scene_views
from .schedule import make_schedule
from .sd import StableDiffusionGuidance
from .zero123 import pose_angle_grad_scale


class OracleGuidance(StableDiffusionGuidance):
    """SD's towers and schedule with a closed-form UNet: the target image
    takes the text embedding's place."""

    def sds_loss(self, target_rgb, _uncond, pred_rgb, t, noise,
                 posterior_noise, guidance_scale: float = 1.0,
                 as_latent: bool = False, grad_scale: float = 1.0):
        """target_rgb and pred_rgb [B, h, w, 3] in [0, 1] (rgb + alpha with
        `as_latent`); t int [B]; noise and posterior_noise [B, ls, ls, 4]
        standard normal.  The gradient reaches the render through the VAE
        encoder; `guidance_scale` and `_uncond` are unused (the oracle
        predicts the conditioned direction)."""
        latents = self._to_latents(pred_rgb, as_latent, posterior_noise)
        with torch.no_grad():
            z_tgt = self._to_latents(target_rgb, as_latent, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t).detach()
        ac = self.schedule.alphas_cumprod_at(t)
        shape = (-1,) + (1,) * (latents.ndim - 1)
        eps_hat = (latents_noisy - torch.sqrt(ac).reshape(shape) * z_tgt) \
            / torch.sqrt(1.0 - ac).reshape(shape)
        return self._sds_from_noise_pred(latents, noise, eps_hat, t,
                                         grad_scale)


class PixelOracleGuidance:
    def __init__(self, scene: str = "two_sphere",
                 t_range: Tuple[float, float] = (0.02, 0.98),
                 num_train_timesteps: int = 1000):
        if scene not in SCENES:
            raise ValueError(f"unknown analytic scene {scene!r}")
        self.scene = scene
        self.schedule = make_schedule("scaled_linear", num_train_timesteps)
        self.min_step = int(num_train_timesteps * t_range[0])
        self.max_step = int(num_train_timesteps * t_range[1])

    def sds_loss_rays(self, t: torch.Tensor, noise: torch.Tensor,
                      rays_o: torch.Tensor, rays_d: torch.Tensor,
                      bg: torch.Tensor, pred_rgb: torch.Tensor,
                      grad_scale: float = 1.0) -> torch.Tensor:
        """t int [B] in [min_step, max_step]; noise [B,H,W,3] standard
        normal; rays [B, H*W, 3]; bg [3]; pred_rgb [B,H,W,3] in [0,1]."""
        B, H, W = pred_rgb.shape[:3]
        rgb, hit = scene_views(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                               self.scene)
        hitf = hit[:, None].to(pred_rgb.dtype)
        tgt = (hitf * rgb + (1.0 - hitf) * bg).reshape(B, H, W, 3)
        x = pred_rgb.float() * 2.0 - 1.0
        x_tgt = (tgt.float() * 2.0 - 1.0).detach()
        x_noisy = self.schedule.add_noise(x, noise, t).detach()
        ac = self.schedule.alphas_cumprod_at(t)
        shape = (-1,) + (1,) * (x.ndim - 1)
        eps_hat = (x_noisy - torch.sqrt(ac).reshape(shape) * x_tgt) \
            / torch.sqrt(1.0 - ac).reshape(shape)
        w = (1.0 - ac).reshape(shape)
        grad = torch.nan_to_num(grad_scale * w * (eps_hat - noise))
        targets = (x - grad).detach()
        return 0.5 * ((x - targets) ** 2).sum() / B


class ImageOracleGuidance(PixelOracleGuidance):
    """The weight-free prior of the image-conditioned pipeline
    (``--guidance image_oracle`` with ``--image analytic:<scene>``): the
    pixel oracle's SDS toward analytic novel views, each view's gradient
    scaled by zero123's pose-angle weighting against the reference views
    (``guidance/zero123.py::pose_angle_grad_scale``)."""

    def __init__(self, scene: str = "two_sphere",
                 t_range: Tuple[float, float] = (0.02, 0.98),
                 grad_scale_mode: str = "angle",
                 ref_polars: Sequence[float] = (90.0,),
                 ref_azimuths: Sequence[float] = (0.0,),
                 ref_radii: Sequence[float] = (3.2,)):
        super().__init__(scene, t_range)
        self.grad_scale_mode = grad_scale_mode
        self.refs: Dict[str, Tuple[float, ...]] = {
            "ref_polars": tuple(ref_polars),
            "ref_azimuths": tuple(ref_azimuths),
            "ref_radii": tuple(ref_radii)}
        self._ref_on: Dict[torch.device, list] = {}

    def sds_loss_rays_pose(self, t, noise, rays_o, rays_d, bg, pred_rgb,
                           polar, azimuth, radius, grad_scale: float = 1.0
                           ) -> torch.Tensor:
        """``sds_loss_rays`` with each view's gradient scaled by its pose
        angle; polar, azimuth, radius [B] are the views' deltas from the
        default view (``CameraBatch.delta_*``)."""
        B = pred_rgb.shape[0]
        dev = polar.device
        if dev not in self._ref_on:
            # once per device: a host-to-device copy waits for the stream
            self._ref_on[dev] = [
                torch.tensor(self.refs[k], dtype=torch.float32, device=dev)
                for k in ("ref_polars", "ref_azimuths", "ref_radii")]
        gs, _ = pose_angle_grad_scale(
            *self._ref_on[dev], polar, azimuth, radius,
            self.grad_scale_mode, grad_scale, B)
        return self.sds_loss_rays(
            t, noise, rays_o, rays_d, bg, pred_rgb,
            grad_scale=gs.reshape((-1,) + (1,) * (pred_rgb.ndim - 1)))
