"""Zero-1-to-3 guidance (``dreamfusion_tpu/guidance/zero123.py``):
image-conditioned novel-view SDS, and the novel-view CLI.

The UNet is SD 1.5's on 8 input channels (``UNetConfig.zero123``): the
noisy latent and ``c_concat``, the VAE latent of the reference image (the
posterior's mode, unscaled).  Its cross-attention context is one token,
``cc_projection(cat(CLIP image embedding, camera T))`` with the relative
pose T = [Δpolar (rad), sin(−Δazimuth), cos(Δazimuth), Δradius]; K10 then
attends over M = 1 key.  The CLIP image embedding comes from the ViT-L/14
vision tower (``models/clip.py``), once per reference at start-up
(``prepare_image_embeddings``), as the VAE's ``c_concat`` does.

As in JAX, the K references and both CFG halves go through one UNet call
at batch 2·K·B: per reference, B rows with zero context and zero
``c_concat`` (uncond) then B conditioned rows; the guided predictions are
mixed by the closeness weights ws over the references.  A view far from
every reference pulls harder (``pose_angle_grad_scale``; the image oracle,
``guidance/oracle.py``, weights its SDS with it too).

The towers are ``nn.Module``s holding their own weights (bf16 at full
width, ``cc_projection`` included; fp32 at the test size) and frozen.
Every random number is an argument (the timestep, the latent noise and the
VAE posterior draw of a step, the start latents of ``novel_view``), drawn
by the caller from its generator.  Images are NHWC in [0, 1].

    python -m dreamfusion_tpu_torch.guidance.zero123 --image ref_rgba.png \\
        --polar -20 --azimuth 40 --out novel.png [--weights root] [--tiny]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.clip import CLIPVisionConfig, CLIPVisionEncoder, clip_preprocess
from ..models.unet import Dense, UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from ..utils.params import load_pretrained_towers
from ..utils.raw_weights import convert_zero123
from .schedule import NoiseSchedule, ddim_sample, make_schedule


def spherical_angle_between(v1: torch.Tensor, v2: torch.Tensor
                            ) -> torch.Tensor:
    """Angles (rad) between spherical coordinates [N, (r, theta, phi)] and
    [M, (r, theta, phi)], pairwise → [N, M]."""
    def to_cart(sv):
        r, th, ph = sv[..., 0], sv[..., 1], sv[..., 2]
        return torch.stack([r * torch.sin(th) * torch.cos(ph),
                            r * torch.sin(th) * torch.sin(ph),
                            r * torch.cos(th)], dim=-1)

    a, b = to_cart(v1), to_cart(v2)
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
    cos = torch.clamp((a[:, None, :] * b[None, :, :]).sum(-1), -1.0, 1.0)
    return torch.arccos(cos)


def pose_angle_grad_scale(ref_polars: torch.Tensor,
                          ref_azimuths: torch.Tensor,
                          ref_radii: torch.Tensor, polar: torch.Tensor,
                          azimuth: torch.Tensor, radius: torch.Tensor,
                          mode: str, grad_scale, B: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The views' deltas from the default view (degrees; [B]) against K
    reference views → (grad scale [B], angles to the references in
    degrees [B, K]).  Mode ``angle``: the smallest angle / (180 / K) times
    ``grad_scale`` (views far from every reference pull harder); any other
    mode: ones."""
    K = ref_polars.shape[0]
    v1 = torch.stack([radius + ref_radii[0],
                      torch.deg2rad(polar + ref_polars[0]),
                      torch.deg2rad(azimuth + ref_azimuths[0])], dim=-1)
    v2 = torch.stack([ref_radii, torch.deg2rad(ref_polars),
                      torch.deg2rad(ref_azimuths)], dim=-1)
    angles = torch.rad2deg(spherical_angle_between(v1, v2))      # [B, K]
    if mode == "angle":
        out = angles.min(dim=1).values / (180.0 / K) * grad_scale
    else:
        out = torch.ones(B, device=angles.device)
    return out, angles


@dataclass(frozen=True)
class Zero123Config:
    image_size: int = 256          # resolution fed to the VAE
    latent_size: int = 32
    t_range: Tuple[float, float] = (0.02, 0.98)
    num_train_timesteps: int = 1000
    grad_scale_mode: str = "angle"    # angle | None
    tiny: bool = False             # test-scale towers

    def unet_config(self) -> UNetConfig:
        return UNetConfig.tiny(in_channels=8) if self.tiny else \
            UNetConfig.zero123()

    def vae_config(self) -> VAEConfig:
        return VAEConfig.tiny() if self.tiny else VAEConfig.sd()

    def vision_config(self) -> CLIPVisionConfig:
        if self.tiny:
            # the projection feeds the UNet's context
            from dataclasses import replace
            return replace(CLIPVisionConfig.tiny(),
                           projection_dim=self.unet_config().context_dim)
        return CLIPVisionConfig.vit_l14()

    @property
    def latent(self) -> int:
        """The latent side: ``latent_size``, 8 for the test towers."""
        return 8 if self.tiny else self.latent_size

    @property
    def min_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[0])

    @property
    def max_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[1])


def _sync(module: nn.Module) -> None:
    dev = next(module.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def camera_T(polar: torch.Tensor, azimuth: torch.Tensor,
             radius: torch.Tensor) -> torch.Tensor:
    """[B] pose deltas (degrees) → [B, 1, 4]: Δpolar in radians,
    sin(−Δazimuth), cos(Δazimuth) (azimuths above 180° wrapped to
    negative), Δradius."""
    a = torch.where(azimuth > 180, azimuth - 360, azimuth)
    return torch.stack([torch.deg2rad(polar), torch.sin(torch.deg2rad(-a)),
                        torch.cos(torch.deg2rad(a)), radius],
                       dim=-1)[:, None, :]


def closeness_weights(angles: torch.Tensor, ws: torch.Tensor
                      ) -> torch.Tensor:
    """Each view's weights over the K references (angles [B, K] in
    degrees, the references' ws [K]) → [B, K]: with K > 1 the inverse
    angle (at most 100), normalised by its largest and cut below 0.1,
    times ws; normalised by the largest again and cut below 0.1."""
    B, K = angles.shape
    if K > 1:
        inv = torch.clamp(1.0 / torch.clamp(angles, min=1e-6), max=100.0)
        inv = inv / inv.amax(dim=-1, keepdim=True)
        inv = torch.where(inv < 0.1, torch.zeros_like(inv), inv)
    else:
        inv = torch.ones_like(angles)
    w = ws[None, :] * inv
    w = w / w.amax(dim=-1, keepdim=True)
    return torch.where(w < 0.1, torch.zeros_like(w), w)


class Zero123Guidance:
    # the trainer's draws: 4-channel latent noise and the VAE posterior's
    latent_channels = 4
    posterior = True

    def __init__(self, cfg: Zero123Config, device="cuda"):
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.unet = UNet2DCondition(cfg.unet_config())
            self.vae = AutoencoderKL(cfg.vae_config())
            self.vision = CLIPVisionEncoder(cfg.vision_config())
            ctx = self.unet.cfg.context_dim
            self.cc_projection = Dense(ctx + 4, ctx,
                                       dtype=self.unet.cfg.dtype,
                                       compute_dtype=torch.float32)
        self.schedule: NoiseSchedule = make_schedule(
            "scaled_linear", cfg.num_train_timesteps)

    @property
    def latent_size(self) -> int:
        return self.cfg.latent

    @property
    def image_size(self) -> int:
        """The VAE's input side: 256 at full width."""
        return self.cfg.latent * self.vae.cfg.downscale

    def towers(self) -> Dict[str, nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "vision": self.vision,
                "cc_projection": self.cc_projection}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    scale: float = 0.02) -> Dict[str, float]:
        """Random tower weights, N(0, scale²) for every tensor, drawn in the
        towers' dtype on their device; ``cc_projection`` as [I | 0] with a
        zero bias (the CLIP embedding passed through, the pose ignored) →
        each tower's seconds (synchronised)."""
        seconds = {}
        for name, tower in self.towers().items():
            t0 = time.time()
            if name == "cc_projection":
                ctx = tower.weight.shape[0]
                tower.weight.zero_()
                tower.weight[:, :ctx].copy_(torch.eye(ctx))
                tower.bias.zero_()
            else:
                for p in tower.parameters():
                    p.copy_(torch.randn(p.shape, generator=generator,
                                        device=p.device, dtype=p.dtype)
                            * scale)
            _sync(tower)
            seconds[name] = time.time() - t0
        return seconds

    def load_pretrained(self, root: str, generator: torch.Generator,
                        log=print) -> Dict[str, float]:
        """Converted weights from ``root/{unet,vae,vision,cc_projection}.npz``
        (``utils/params.py``) over the init: a tower without its file keeps
        the init; any other root, a zero123(-xl) ``.ckpt``, is converted on
        the fly (``utils/raw_weights.py::convert_zero123``) → the seconds of
        the init and of the files."""
        seconds = self.init_params(generator)
        t0 = time.time()
        load_pretrained_towers(root, self.towers(),
                               lambda src: convert_zero123(src, self, log))
        _sync(self.unet)
        seconds["files"] = time.time() - t0
        return seconds

    # ---- VAE ---------------------------------------------------------------
    def encode_imgs(self, imgs: torch.Tensor,
                    posterior_noise: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → scaled latent sample; differentiable."""
        moments = self.vae.encode(imgs * 2.0 - 1.0)
        return moments.sample(posterior_noise) * self.vae.cfg.scale_factor

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents → [B, H, W, 3] in [0, 1]."""
        return torch.clamp(self.vae.decode(latents) / 2.0 + 0.5, 0.0, 1.0)

    # ---- the reference images ------------------------------------------------
    @torch.no_grad()
    def get_img_embeds(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [K, H, W, 3] in [0, 1] → (c_crossattn [K, 1, ctx]: the CLIP
        image embedding, c_concat [K, ls, ls, 4]: the VAE posterior's mode,
        unscaled), fp32."""
        px = clip_preprocess(x, self.vision.cfg.image_size)
        proj, _ = self.vision(px)
        c_concat = self.vae.encode(x * 2.0 - 1.0).mean
        return proj.float()[:, None, :], c_concat.float()

    def prepare_image_embeddings(self, images: np.ndarray,
                                 ref_polars: Sequence[float] = (90.0,),
                                 ref_azimuths: Sequence[float] = (0.0,),
                                 ref_radii: Sequence[float] = (3.2,),
                                 zero123_ws: Sequence[float] = (1.0,)
                                 ) -> Dict[str, torch.Tensor]:
        """Once at start-up: images [K, H, W, 3] (or [H, W, 3]) in [0, 1],
        resized to the VAE's side → {c_crossattn, c_concat, and the
        references' poses and ws as [K] fp32 tensors}, on the towers'
        device."""
        dev = self.cc_projection.weight.device
        x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        if x.ndim == 3:
            x = x[None]
        x = resize_bilinear(x, (self.image_size, self.image_size))
        c_crossattn, c_concat = self.get_img_embeds(x)
        ref = lambda v: torch.tensor(list(v), dtype=torch.float32,
                                     device=dev)
        return {"c_crossattn": c_crossattn, "c_concat": c_concat,
                "ref_polars": ref(ref_polars),
                "ref_azimuths": ref(ref_azimuths),
                "ref_radii": ref(ref_radii), "zero123_ws": ref(zero123_ws)}

    # ---- conditioning ----------------------------------------------------------
    def _conditioning(self, embeddings, T: torch.Tensor, K: int):
        """The UNet's context and c_concat for B views against references
        0..K-1, T [K*B, 1, 4] their relative poses (reference-major) →
        (context [K*2B, 1, ctx], c_concat [K*2B, ls, ls, 4]): per
        reference, B uncond rows (zeros) then B conditioned ones."""
        c_cross = embeddings["c_crossattn"][:K]
        c_cat = embeddings["c_concat"][:K]
        B = T.shape[0] // K
        ctx_dim = c_cross.shape[-1]
        cross = c_cross[:, None].expand(K, B, 1, ctx_dim).reshape(
            K * B, 1, ctx_dim)
        emb = self.cc_projection(torch.cat([cross, T.to(cross.dtype)],
                                           dim=-1))
        emb = emb.reshape(K, B, 1, ctx_dim)
        context = torch.cat([torch.zeros_like(emb), emb], dim=1)
        cc = c_cat[:, None].expand(K, B, *c_cat.shape[1:])
        concat = torch.cat([torch.zeros_like(cc), cc], dim=1)
        return (context.reshape(2 * K * B, 1, ctx_dim),
                concat.reshape(2 * K * B, *c_cat.shape[1:]))

    def _cfg_eps(self, x, t, context, concat, guidance_scale: float
                 ) -> torch.Tensor:
        """The guided noise prediction of latents x [B, ls, ls, 4] against
        the first reference (``_conditioning``'s K = 1 context and
        c_concat): one UNet call at batch 2B."""
        x_in = torch.cat([torch.cat([x] * 2), concat.to(x.dtype)], dim=-1)
        e_u, e_c = self.unet(x_in, t.repeat(2), context).chunk(2)
        return e_u + guidance_scale * (e_c - e_u)

    # ---- SDS ---------------------------------------------------------------
    def sds_loss(self, embeddings, pred_rgb, polar, azimuth, radius, t,
                 noise, posterior_noise, guidance_scale: float = 5.0,
                 as_latent: bool = False, grad_scale: float = 1.0):
        """pred_rgb [B, h, w, 3] in [0, 1] (or rgb + alpha [B, h, w, 4]
        with `as_latent`); polar, azimuth, radius [B]: the views' deltas
        from the default view; t int [B]; noise and posterior_noise [B, ls,
        ls, 4] standard normal."""
        cfg = self.cfg
        ls = cfg.latent
        B = pred_rgb.shape[0]
        gs, angles = pose_angle_grad_scale(
            embeddings["ref_polars"], embeddings["ref_azimuths"],
            embeddings["ref_radii"], polar, azimuth, radius,
            cfg.grad_scale_mode, grad_scale, B)
        if as_latent:
            latents = resize_bilinear(pred_rgb, (ls, ls)) * 2.0 - 1.0
        else:
            rgb = resize_bilinear(pred_rgb, (self.image_size,
                                             self.image_size))
            latents = self.encode_imgs(rgb, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t).detach()
        ws = closeness_weights(angles, embeddings["zero123_ws"])    # [B, K]
        K = ws.shape[1]
        with torch.no_grad():
            # each view's pose relative to each reference
            rp, ra, rr = (embeddings[k][:, None] for k in (
                "ref_polars", "ref_azimuths", "ref_radii"))
            T = camera_T((polar + rp[0] - rp).reshape(-1),
                         (azimuth + ra[0] - ra).reshape(-1),
                         (radius + rr[0] - rr).reshape(-1))
            context, concat = self._conditioning(embeddings, T, K)
            x_in = latents_noisy[None].expand(2 * K, *latents_noisy.shape)
            x_in = torch.cat([x_in.reshape(2 * K * B, ls, ls, -1),
                              concat.to(latents_noisy.dtype)], dim=-1)
            eps = self.unet(x_in, t.repeat(2 * K), context)
        eps = eps.reshape(K, 2 * B, *eps.shape[1:])
        e_uncond, e_cond = eps[:, :B], eps[:, B:]
        guided = e_uncond + guidance_scale * (e_cond - e_uncond)   # [K,B,..]
        noise_pred = (ws.T[:, :, None, None, None] * guided).sum(0) / \
            ws.sum(-1)[:, None, None, None]
        w = (1.0 - self.schedule.alphas_cumprod_at(t)).reshape(-1, 1, 1, 1)
        grad = torch.nan_to_num(gs.reshape(-1, 1, 1, 1) * w *
                                (noise_pred - noise))
        lat = latents.float()
        targets = (lat - grad).detach()
        return 0.5 * ((lat - targets) ** 2).sum() / B

    @torch.no_grad()
    def guidance_eval(self, embeddings, pred_rgb, polar, azimuth, radius, t,
                      noise, posterior_noise, guidance_scale: float = 5.0):
        """The ``--save_guidance`` snapshot, conditioned on the first
        reference at pose deltas polar, azimuth, radius [B]: pred_rgb [B, h,
        w, 3] resized to the VAE's side and encoded (the posterior draw
        `posterior_noise`), noised at `t` by `noise`, denoised in one step
        by the guided prediction → (the noised latents decoded, the
        predicted x0 decoded), [B, 256, 256, 3] in [0, 1] at full width."""
        rgb = resize_bilinear(pred_rgb[..., :3], (self.image_size,
                                                  self.image_size))
        latents = self.encode_imgs(rgb, posterior_noise)
        latents_noisy = self.schedule.add_noise(latents, noise, t)
        cond = self._conditioning(embeddings,
                                  camera_T(polar, azimuth, radius), 1)
        noise_pred = self._cfg_eps(latents_noisy, t, *cond, guidance_scale)
        x0 = self.schedule.predict_start_from_noise(latents_noisy, t,
                                                    noise_pred)
        return self.decode_latents(latents_noisy), self.decode_latents(x0)

    # ---- novel views ---------------------------------------------------------
    @torch.no_grad()
    def novel_view(self, embeddings, polar, azimuth, radius,
                   latents: torch.Tensor, num_inference_steps: int = 50,
                   guidance_scale: float = 3.0) -> torch.Tensor:
        """DDIM (eta 0) from `latents` [B, ls, ls, 4] (standard normal) at
        pose deltas [B] from the first reference, conditioned on it → the
        decoded views [B, H, W, 3] in [0, 1]."""
        cond = self._conditioning(embeddings,
                                  camera_T(polar, azimuth, radius), 1)
        latents = ddim_sample(
            self.schedule,
            lambda x, t: self._cfg_eps(x, t, *cond, guidance_scale),
            latents, self.cfg.num_train_timesteps, num_inference_steps)
        return self.decode_latents(latents)


def _main(argv=None) -> str:
    """Novel-view synthesis from one reference image (JAX's ``_main``):
    the image over a white background, ``novel_view`` at the pose deltas,
    the first view written as a PNG → its path.  Random towers from the
    seed unless ``--weights`` names a converted root; on the GPU unless
    ``--device cpu``."""
    from ..utils.image import load_image, save_image, to_rgba

    ap = argparse.ArgumentParser("zero123 novel view")
    ap.add_argument("--image", required=True)
    ap.add_argument("--polar", type=float, default=0.0,
                    help="delta polar vs the reference view (deg)")
    ap.add_argument("--azimuth", type=float, default=30.0)
    ap.add_argument("--radius", type=float, default=0.0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="zero123_sample.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    g = Zero123Guidance(Zero123Config(tiny=args.tiny), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.weights:
        g.load_pretrained(args.weights, gen)
    else:
        g.init_params(gen)
    rgba = to_rgba(load_image(args.image))
    rgb = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])  # white bg
    emb = g.prepare_image_embeddings(rgb[None])
    pose = [torch.tensor([v], dtype=torch.float32, device=dev)
            for v in (args.polar, args.azimuth, args.radius)]
    ls = g.latent_size
    latents = torch.randn((1, ls, ls, 4), generator=gen, device=dev)
    img = g.novel_view(emb, *pose, latents, num_inference_steps=args.steps,
                       guidance_scale=args.scale)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the novel view is not finite")
    save_image(args.out, img[0].float().cpu().numpy())
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    _main()
