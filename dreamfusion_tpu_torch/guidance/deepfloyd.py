"""DeepFloyd-IF stage-1 guidance (``dreamfusion_tpu/guidance/deepfloyd.py``):
pixel-space SDS.

No VAE: the render is resized to the UNet's 64² (``resize_bilinear``, with
its antialiasing when it shrinks) and diffused directly under the cosine
("squaredcos_cap_v2") schedule; the UNet (``models/if_unet.py``, IF-I-XL
at full width) predicts (eps, variance) in 6 channels and the variance
half is dropped.  It runs under ``no_grad`` on stop-gradient images, so no
UNet backward is ever built.  Every random number is an argument: the
timestep ``t`` and the pixel ``noise`` [B, 64, 64, 3], drawn by
``training/trainer.py::draw_step``.

The prompt embeddings are T5 states (``models/t5.py``, T5-XXL), computed
once at start-up by ``prepare_embeddings``: through the T5 tower when it is
loaded (``load_pretrained`` with ``t5.npz`` or a raw ``text_encoder/``;
``init_t5`` builds one on random weights), its tokens from the hash
tokenizer as JAX's ``main`` gives them; else JAX's fallback, an md5-seeded
numpy normal draw per prompt, bit for bit.  The tower is freed with
``free_t5`` before the first step.  ``encode_text(text, pretrained_root)``
tokenizes with T5's own tokenizer where the root holds a
``tokenizer.json`` (``guidance/t5_tokenizer.py``), as JAX's method does;
no run passes a root, as in JAX.

``guidance_eval`` is the ``--save_guidance`` snapshot (the noised 64²
render and the one-step denoised x0, both in pixels); ``produce_imgs`` and
the CLI below are txt2img at 64² (DDIM with classifier-free guidance on
the cosine schedule).

    python -m dreamfusion_tpu_torch.guidance.deepfloyd "a hamburger" \\
        --steps 20 --out if_sample.png [--weights root] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.if_unet import IFUNet, IFUNetConfig
from ..models.t5 import T5Config, T5Encoder
from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from ..utils.params import load_params_npz
from ..utils.raw_weights import convert_if
from .embeddings import DIRECTION_SUFFIXES, HashTokenizer
from .perpneg import weighted_perpendicular_aggregator
from .schedule import NoiseSchedule, ddim_sample, make_schedule
from .t5_tokenizer import T5Tokenizer


@functools.lru_cache(maxsize=4)
def t5_tokenizer(path: str, max_len: int) -> T5Tokenizer:
    """T5's tokenizer of a ``tokenizer.json``, read once."""
    return T5Tokenizer(path, max_len)


@dataclass(frozen=True)
class IFConfig:
    image_size: int = 64
    t_range: Tuple[float, float] = (0.02, 0.98)
    num_train_timesteps: int = 1000
    max_len: int = 77
    tiny: bool = False
    unet_config_json: Optional[str] = None   # diffusers unet/config.json

    def unet_config(self) -> IFUNetConfig:
        if self.unet_config_json:
            with open(self.unet_config_json) as f:
                return IFUNetConfig.from_diffusers_config(json.load(f))
        return IFUNetConfig.tiny() if self.tiny else IFUNetConfig.xl()

    def t5_config(self) -> T5Config:
        return T5Config.tiny() if self.tiny else T5Config.xxl()

    @property
    def min_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[0])

    @property
    def max_step(self) -> int:
        return int(self.num_train_timesteps * self.t_range[1])


def _sync(module: nn.Module) -> None:
    p = next(module.parameters())
    if p.is_cuda:
        torch.cuda.synchronize(p.device)


@torch.no_grad()
def _randomize(module: nn.Module, generator: torch.Generator,
               scale: float) -> None:
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=p.dtype) * scale)


class IFGuidance:
    # the trainer's draws: pixel noise at the UNet's side, no VAE posterior
    latent_channels = 3
    posterior = False

    def __init__(self, cfg: IFConfig, device="cuda",
                 param_dtype: Optional[torch.dtype] = None):
        """`param_dtype`: the towers' storage (bf16 at full width under
        ``--fp16``); the UNet computes in its config's dtype."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.unet = self._build_unet(cfg.unet_config())
        self.t5: Optional[T5Encoder] = None
        self.schedule: NoiseSchedule = make_schedule(
            "squaredcos_cap_v2", cfg.num_train_timesteps)

    def _build_unet(self, ucfg: IFUNetConfig) -> IFUNet:
        with torch.device(self.device):
            return IFUNet(ucfg, self.param_dtype)

    def rebuild_unet(self, ucfg: IFUNetConfig) -> None:
        """Replace the UNet by one of config `ucfg` (a checkpoint's own
        ``unet/config.json``), compute dtype kept."""
        ucfg = replace(ucfg, dtype=self.unet.cfg.dtype)
        if ucfg != self.unet.cfg:
            self.unet = self._build_unet(ucfg)

    def build_t5(self) -> T5Encoder:
        """An fp32 T5 tower on the guidance's device, uninitialised."""
        with torch.device(self.device):
            return T5Encoder(self.cfg.t5_config())

    @property
    def latent_size(self) -> int:
        """The UNet's pixel side (the trainer's noise draw): 16 for the
        tiny towers, else ``image_size``."""
        return 16 if self.cfg.tiny else self.cfg.image_size

    def towers(self) -> Dict[str, nn.Module]:
        out: Dict[str, nn.Module] = {"unet": self.unet}
        if self.t5 is not None:
            out["t5"] = self.t5
        return out

    def init_params(self, generator: torch.Generator,
                    scale: float = 0.02) -> Dict[str, float]:
        """Random UNet weights, N(0, scale²) for every tensor, drawn in the
        tower's dtype on its device → the seconds (synchronised)."""
        t0 = time.time()
        _randomize(self.unet, generator, scale)
        _sync(self.unet)
        return {"unet": time.time() - t0}

    def init_t5(self, generator: torch.Generator,
                scale: float = 0.02) -> float:
        """A T5 tower on random weights (N(0, scale²)), built on the device
        → the seconds (synchronised)."""
        t0 = time.time()
        self.t5 = self.build_t5()
        _randomize(self.t5, generator, scale)
        _sync(self.t5)
        return time.time() - t0

    def free_t5(self) -> None:
        self.t5 = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def load_pretrained(self, root: str, generator: torch.Generator,
                        log=print) -> Dict[str, float]:
        """JAX's rule: a root holding ``unet.npz`` or ``t5.npz``
        (``utils/params.py``; a UNet key the file lacks keeps the init, a
        T5 is built only where ``t5.npz`` is); any other root, a diffusers
        IF directory, is converted on the fly (``utils/raw_weights.py::
        convert_if``) → the seconds of the init and of the files."""
        seconds = self.init_params(generator)
        t0 = time.time()
        npz = {n: os.path.join(root, f"{n}.npz") for n in ("unet", "t5")}
        if os.path.isdir(root) and any(map(os.path.exists, npz.values())):
            if os.path.exists(npz["unet"]):
                load_params_npz(npz["unet"], self.unet, "if_unet")
            if os.path.exists(npz["t5"]):
                self.t5 = self.build_t5()
                _randomize(self.t5, generator, 0.02)
                load_params_npz(npz["t5"], self.t5, "t5")
        else:
            convert_if(root, self, log)
        _sync(self.unet)
        seconds["files"] = time.time() - t0
        return seconds

    # ---- prompt embeddings ---------------------------------------------------
    @torch.no_grad()
    def encode_text(self, text: str, pretrained_root: Optional[str] = None
                    ) -> torch.Tensor:
        """The T5 tower's states of `text` → [1, max_len, d_model] fp32:
        its tokens by T5's tokenizer where `pretrained_root` holds a
        ``tokenizer.json`` (padded, the padding masked), else its hash
        tokens, all kept (JAX's rule)."""
        path = os.path.join(pretrained_root, "tokenizer.json") \
            if pretrained_root else None
        if path and os.path.isfile(path):
            ids, mask = t5_tokenizer(path, self.cfg.max_len)(text)
        else:
            ids = HashTokenizer(self.t5.cfg.vocab_size,
                                self.cfg.max_len)(text)
            mask = np.ones_like(ids)
        dev = self.t5.shared.weight.device
        return self.t5(torch.from_numpy(ids).long().to(dev),
                       torch.from_numpy(mask).long().to(dev)).float()

    def fallback_embedding(self, text: str) -> torch.Tensor:
        """JAX's stand-in without T5 weights: N(0, 1) from numpy seeded by
        the md5 of `text`, in float32, times 0.02 → [1, max_len,
        encoder_hid_dim]."""
        seed = int(hashlib.md5(text.encode()).hexdigest()[:8], 16)
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(1, self.cfg.max_len,
                             self.unet.cfg.encoder_hid_dim)
                       ).astype(np.float32) * 0.02
        return torch.from_numpy(a).to(self.device)

    def prepare_embeddings(self, text: str, negative: str = ""
                           ) -> Dict[str, torch.Tensor]:
        """default / uncond / front / side / back, each [1, max_len, D]
        fp32 on the device: T5 states where the tower is loaded, else the
        md5 fallback."""
        embed = self.encode_text if self.t5 is not None else \
            self.fallback_embedding
        out = {"default": embed(text), "uncond": embed(negative)}
        for d, suffix in DIRECTION_SUFFIXES.items():
            out[d] = embed(f"{text}, {suffix}")
        return out

    # ---- SDS -----------------------------------------------------------------
    def _images(self, pred_rgb: torch.Tensor) -> torch.Tensor:
        s = self.latent_size
        return resize_bilinear(pred_rgb[..., :3], (s, s)) * 2.0 - 1.0

    def _eps(self, noisy, t, context, copies: int) -> torch.Tensor:
        with torch.no_grad():
            out = self.unet(torch.cat([noisy] * copies),
                            torch.cat([t] * copies), context)
        return out[..., :3]                       # the variance half dropped

    def _cfg_eps(self, noisy, t, text_z_cond, text_z_uncond,
                 guidance_scale: float) -> torch.Tensor:
        """The classifier-free guided noise prediction (one UNet call at
        batch 2B: uncond rows, then cond)."""
        e_u, e_c = self._eps(noisy, t, torch.cat([text_z_uncond,
                                                  text_z_cond]), 2).chunk(2)
        return e_u + guidance_scale * (e_c - e_u)

    def _sds(self, images, noise, noise_pred, t,
             grad_scale: float) -> torch.Tensor:
        """0.5 |images - sg(images - g)|² / B, g = w(t)(ε̂ - ε)."""
        w = (1.0 - self.schedule.alphas_cumprod_at(t)).reshape(-1, 1, 1, 1)
        grad = torch.nan_to_num(grad_scale * w * (noise_pred - noise))
        img = images.float()
        targets = (img - grad).detach()
        return 0.5 * ((img - targets) ** 2).sum() / images.shape[0]

    def sds_loss(self, text_z_cond, text_z_uncond, pred_rgb, t, noise,
                 posterior_noise=None, guidance_scale: float = 100.0,
                 as_latent: bool = False, grad_scale: float = 1.0):
        """text_z_* [B, L, D]; pred_rgb [B, h, w, 3 (or 4)] in [0, 1]; t
        int [B]; noise [B, s, s, 3] standard normal.  `posterior_noise`
        and `as_latent` are unused (no VAE), as in JAX."""
        del posterior_noise, as_latent
        images = self._images(pred_rgb)
        noisy = self.schedule.add_noise(images, noise, t).detach()
        return self._sds(images, noise, self._cfg_eps(
            noisy, t, text_z_cond, text_z_uncond, guidance_scale), t,
            grad_scale)

    @torch.no_grad()
    def guidance_eval(self, text_z_cond, text_z_uncond, pred_rgb, t, noise,
                      posterior_noise=None, guidance_scale: float = 100.0):
        """The ``--save_guidance`` snapshot: pred_rgb [B, h, w, 3] resized
        to the UNet's side, noised at `t` by `noise`, denoised in one step
        by the guided prediction → (noised, x0), [B, 64, 64, 3] in [0, 1] at
        full width.  `posterior_noise` is unused (no VAE)."""
        del posterior_noise
        noisy = self.schedule.add_noise(self._images(pred_rgb), noise, t)
        x0 = self.schedule.predict_start_from_noise(noisy, t, self._cfg_eps(
            noisy, t, text_z_cond, text_z_uncond, guidance_scale))
        return (torch.clamp(noisy / 2 + 0.5, 0, 1),
                torch.clamp(x0 / 2 + 0.5, 0, 1))

    def sds_loss_perpneg(self, text_z, weights, text_z_uncond, pred_rgb, t,
                         noise, posterior_noise=None,
                         guidance_scale: float = 100.0,
                         as_latent: bool = False, grad_scale: float = 1.0):
        """text_z [B*K, L, D] interleaved; weights [B*K]; text_z_uncond
        [B, L, D]; the UNet runs at batch B*(1+K)."""
        del posterior_noise, as_latent
        images = self._images(pred_rgb)
        B = images.shape[0]
        K = text_z.shape[0] // B
        noisy = self.schedule.add_noise(images, noise, t).detach()
        eps = self._eps(noisy, t, torch.cat([text_z_uncond, text_z]), 1 + K)
        e_u, e_text = eps[:B], eps[B:]
        delta = e_text - e_u.repeat(K, 1, 1, 1)
        noise_pred = e_u + guidance_scale * \
            weighted_perpendicular_aggregator(delta, weights, B)
        return self._sds(images, noise, noise_pred, t, grad_scale)

    # ---- txt2img -------------------------------------------------------------
    @torch.no_grad()
    def produce_imgs(self, text_z_cond, text_z_uncond, images: torch.Tensor,
                     num_inference_steps: int = 20,
                     guidance_scale: float = 7.0) -> torch.Tensor:
        """DDIM (eta 0) with classifier-free guidance on the cosine schedule
        from `images` [B, s, s, 3] (standard normal pixels) → [B, s, s, 3]
        in [0, 1]."""
        x = ddim_sample(self.schedule, lambda x, t: self._cfg_eps(
            x, t, text_z_cond, text_z_uncond, guidance_scale), images,
            self.cfg.num_train_timesteps, num_inference_steps)
        return torch.clamp(x / 2 + 0.5, 0, 1)


def _main(argv=None) -> str:
    """Text → image with IF stage 1 (JAX's ``_main``): the prompt's
    embeddings (T5 where ``--weights`` holds one, else JAX's md5
    stand-ins), ``produce_imgs`` from standard normal pixels drawn from the
    seed, the first image written as a PNG (64² at full width) → its
    path.  Random weights from the seed unless ``--weights`` names a
    converted root or a diffusers IF directory; bf16 weights at full width;
    on the GPU unless ``--device cpu``."""
    from ..utils.image import save_image

    ap = argparse.ArgumentParser("deepfloyd-if txt2img")
    ap.add_argument("prompt", type=str)
    ap.add_argument("--negative", default="")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scale", type=float, default=7.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="if_sample.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    g = IFGuidance(IFConfig(tiny=args.tiny), dev,
                   None if args.tiny else torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.weights:
        g.load_pretrained(args.weights, gen)
    else:
        g.init_params(gen)
    emb = g.prepare_embeddings(args.prompt, args.negative)
    g.free_t5()
    s = g.latent_size
    images = torch.randn((1, s, s, 3), generator=gen, device=dev)
    img = g.produce_imgs(emb["default"], emb["uncond"], images,
                         num_inference_steps=args.steps,
                         guidance_scale=args.scale)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the image is not finite")
    save_image(args.out, img[0].float().cpu().numpy())
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    _main()
