"""Stable Diffusion SDS guidance (``dreamfusion_tpu/guidance/sd.py``), SD
2.x (OpenCLIP-H text tower, 1024-wide context, head dim 64) or SD 1.x
(CLIP-L, 768-wide context, 8 heads: head dims 40, 80 and 160), chosen by
``SDConfig.sd_version`` as in JAX; the ``--save_guidance`` snapshot
(``guidance_eval``: the noised render and the one-step denoised x0, both
through the VAE decoder) and txt2img (``produce_latents``, ``prompt_to_img``
and the CLI below: DDIM with classifier-free guidance, then the decoder).

The frozen UNet, VAE and CLIP text towers are ``nn.Module``s holding their
own weights (bf16 at SD width).  Every random number is an argument: the
timestep ``t``, the latent ``noise`` and the VAE ``posterior_noise``,
drawn by ``training/trainer.py::draw_step``.  The UNet runs under
``no_grad`` on stop-gradient latents, so no UNet backward is ever built;
the VAE encoder is differentiated into the render.  Images are NHWC in
[0, 1].  ``as_latent`` is a Python bool: the warm-up phase resizes the
4-channel (rgb + alpha) render straight to the latent size.

    python -m dreamfusion_tpu_torch.guidance.sd "a hamburger" --steps 50 \\
        --out sd_sample.png [--weights root] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..models.clip import CLIPTextConfig, CLIPTextEncoder
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from ..utils.params import load_pretrained_towers
from ..utils.raw_weights import convert_sd
from .perpneg import weighted_perpendicular_aggregator
from .schedule import NoiseSchedule, ddim_sample, make_schedule


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
        return (UNetConfig.sd21() if self.sd_version.startswith("2")
                else UNetConfig.sd15())

    def vae_config(self) -> VAEConfig:
        return VAEConfig.tiny() if self.tiny else VAEConfig.sd()

    def text_config(self) -> CLIPTextConfig:
        if self.tiny:
            return CLIPTextConfig.tiny()
        return (CLIPTextConfig.sd21() if self.sd_version.startswith("2")
                else CLIPTextConfig.sd15())

    @property
    def min_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[0])

    @property
    def max_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[1])


class StableDiffusionGuidance:
    # the trainer's draws: 4-channel latent noise and the VAE posterior's
    latent_channels = 4
    posterior = True

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

    @property
    def latent_size(self) -> int:
        return self.cfg.latent_size

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

    def load_pretrained(self, root: str, generator: torch.Generator,
                        log=print) -> None:
        """Converted weights from ``root/{unet,vae,text}.npz``
        (``utils/params.py``) over the random init: a tower without its
        file keeps the init.  A root without them, a diffusers directory or
        a CompVis ``.ckpt``, is converted on the fly
        (``utils/raw_weights.py::convert_sd``)."""
        self.init_params(generator)
        load_pretrained_towers(root, self.towers(),
                               lambda src: convert_sd(src, self, log))

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

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents → [B, H, W, 3] in [0, 1] (fp32)."""
        return torch.clamp(self.vae.decode(latents) / 2.0 + 0.5, 0.0, 1.0)

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

    def _cfg_eps(self, latents_noisy, t, text_z_cond, text_z_uncond,
                 guidance_scale: float) -> torch.Tensor:
        """The classifier-free guided noise prediction (one UNet call at
        batch 2B: uncond rows, then cond)."""
        e_u, e_c = self._eps(latents_noisy, t,
                             torch.cat([text_z_uncond, text_z_cond]),
                             2).chunk(2)
        return e_u + guidance_scale * (e_c - e_u)

    # ---- SDS ---------------------------------------------------------------
    def sds_loss(self, text_z_cond, text_z_uncond, pred_rgb, t, noise,
                 posterior_noise, guidance_scale: float = 100.0,
                 as_latent: bool = False, grad_scale: float = 1.0):
        """text_z_* [B, L, D]; pred_rgb [B, h, w, 3 or 4] in [0, 1]; t int
        [B]; noise and posterior_noise [B, ls, ls, 4] standard normal."""
        latents = self._to_latents(pred_rgb, as_latent, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t).detach()
        noise_pred = self._cfg_eps(latents_noisy, t, text_z_cond,
                                   text_z_uncond, guidance_scale)
        return self._sds_from_noise_pred(latents, noise, noise_pred, t,
                                         grad_scale)

    @torch.no_grad()
    def guidance_eval(self, text_z_cond, text_z_uncond, pred_rgb, t, noise,
                      posterior_noise, guidance_scale: float = 100.0):
        """The ``--save_guidance`` snapshot: pred_rgb [B, h, w, 3] through
        the VAE (the posterior draw `posterior_noise`), noised at `t` by
        `noise`, denoised in one step by the guided prediction → (the noised
        latents decoded, the predicted x0 decoded), [B, 512, 512, 3] in [0,
        1] at full width."""
        latents = self._to_latents(pred_rgb, False, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t)
        noise_pred = self._cfg_eps(latents_noisy, t, text_z_cond,
                                   text_z_uncond, guidance_scale)
        x0 = self.schedule.predict_start_from_noise(latents_noisy, t,
                                                    noise_pred)
        return self.decode_latents(latents_noisy), self.decode_latents(x0)

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

    # ---- txt2img -----------------------------------------------------------
    @torch.no_grad()
    def produce_latents(self, text_z_cond, text_z_uncond,
                        latents: torch.Tensor, num_inference_steps: int = 50,
                        guidance_scale: float = 7.5) -> torch.Tensor:
        """DDIM (eta 0) with classifier-free guidance from `latents` [B, ls,
        ls, 4] (standard normal) over the timesteps T-1, T-1-T//n, ...
        (the first n), the last step landing on x0."""
        return ddim_sample(self.schedule, lambda x, t: self._cfg_eps(
            x, t, text_z_cond, text_z_uncond, guidance_scale), latents,
            self.cfg.num_train_timesteps, num_inference_steps)

    def prompt_to_img(self, text_z_cond, text_z_uncond,
                      latents: torch.Tensor, **kw) -> torch.Tensor:
        """``produce_latents`` decoded → [B, H, W, 3] in [0, 1]."""
        return self.decode_latents(self.produce_latents(
            text_z_cond, text_z_uncond, latents, **kw))


def _main(argv=None) -> str:
    """Text → image with SD (JAX's ``_main``): the prompt's embeddings,
    ``prompt_to_img`` from standard normal latents drawn from the seed, the
    first image written as a PNG (512² at full width) → its path.  Random
    towers from the seed unless ``--weights`` names a converted root (or a
    raw diffusers directory or CompVis ``.ckpt``); on the GPU unless
    ``--device cpu``."""
    from ..utils.image import save_image
    from .embeddings import prepare_text_embeddings

    ap = argparse.ArgumentParser("sd txt2img")
    ap.add_argument("prompt", type=str)
    ap.add_argument("--negative", default="")
    ap.add_argument("--sd_version", default="2.1")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--weights", default=None,
                    help="dir with unet.npz/vae.npz/text.npz, a diffusers "
                         "directory or a CompVis .ckpt")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="sd_sample.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    g = StableDiffusionGuidance(SDConfig(
        sd_version=args.sd_version, tiny=args.tiny,
        **({"image_size": 16, "latent_size": 8} if args.tiny else {})), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.weights:
        g.load_pretrained(args.weights, gen)
    else:
        g.init_params(gen)
    emb = prepare_text_embeddings(g, args.prompt, args.negative,
                                  args.weights)
    ls = g.latent_size
    latents = torch.randn((1, ls, ls, g.unet.cfg.in_channels),
                          generator=gen, device=dev)
    img = g.prompt_to_img(emb["default"], emb["uncond"], latents,
                          num_inference_steps=args.steps,
                          guidance_scale=args.scale)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the image is not finite")
    save_image(args.out, img[0].float().cpu().numpy())
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    _main()
