"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
JAX package's random draws for one training step, rebuilt from its own
key-split tree and handed to the port as tensors, and config mapping."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamfusion_tpu_torch.config import Config as PConfig
from dreamfusion_tpu_torch.core.poses import PoseDraws
from dreamfusion_tpu_torch.training import schedules as pschedules
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetDraws
from dreamfusion_tpu_torch.training.trainer import StepDraws

GRID_SALT = 0x9e3779b9


def tt(a) -> torch.Tensor:
    """numpy / jax array → torch tensor (a copy)."""
    return torch.from_numpy(np.array(a))


def port_cfg(jcfg) -> PConfig:
    """The port Config holding the JAX Config's values."""
    return PConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(PConfig)})


def _uniform(key, shape, lo, hi):
    return jax.random.uniform(key, shape, minval=jnp.asarray(lo, jnp.float32),
                              maxval=jnp.asarray(hi, jnp.float32))


def jax_pose_draws(k_pose, cfg) -> PoseDraws:
    """What dreamfusion_tpu.core.poses.rand_poses draws from its key."""
    B = cfg.batch_size
    k_r, k_u, k_th, k_ph, k_sph, k_jc, k_jt, k_ju = jax.random.split(k_pose, 8)
    th = [jnp.deg2rad(jnp.asarray(a, jnp.float32)) for a in cfg.theta_range]
    ph = [jnp.deg2rad(jnp.asarray(a, jnp.float32)) for a in cfg.phi_range]
    return PoseDraws(
        radius=tt(_uniform(k_r, (B,), *cfg.radius_range)),
        thetas=tt(jax.random.uniform(k_th, (B,), minval=th[0], maxval=th[1])),
        phis=tt(jax.random.uniform(k_ph, (B,), minval=ph[0], maxval=ph[1])),
        sphere_normal=tt(jax.random.normal(k_sph, (B, 3))),
        sphere_u=tt(jax.random.uniform(k_u, ())),
        jitter_center=tt(jax.random.uniform(k_jc, (B, 3))),
        jitter_target=tt(jax.random.normal(k_jt, (B, 3))),
        jitter_up=tt(jax.random.normal(k_ju, (B, 3))))


def jax_batch_draws(k_batch, cfg):
    k_pose, k_fov = jax.random.split(k_batch)
    fov = tt(_uniform(k_fov, (), *cfg.fovy_range))
    return jax_pose_draws(k_pose, cfg), fov


def jax_choice_draws(k_choice) -> pschedules.ChoiceDraws:
    k_amb, k_shade, k_bg, k_bgc, k_light = jax.random.split(k_choice, 5)
    return pschedules.ChoiceDraws(
        tt(jax.random.uniform(k_amb, ())), tt(jax.random.uniform(k_shade, ())),
        tt(jax.random.uniform(k_bg, ())), tt(jax.random.uniform(k_bgc, (3,))),
        tt(jax.random.normal(k_light, (3,))))


def jax_step_draws(cfg, renderer, base_key, step: int,
                   latent_size=None) -> StepDraws:
    """The draws of Trainer._make_train_step('main' or 'latent') at
    state.step=step: fold_in(base, step) → split 5 (batch, choice, render,
    guide, tv).  With ``latent_size`` the guide key feeds SD's sds_loss
    (split 3: posterior, t, latent noise), else the pixel oracle's."""
    key = jax.random.fold_in(base_key, step)
    k_batch, k_choice, k_render, k_guide, _ = jax.random.split(key, 5)
    pose, fov = jax_batch_draws(k_batch, cfg)
    R = cfg.batch_size * cfg.h * cfg.w
    S = cfg.grid_fine_steps
    k_march = renderer.apply({}, method=lambda m: m.make_rng("render"),
                             rngs={"render": k_render})
    march_u = (jnp.arange(S) + jax.random.uniform(k_march, (R, S))) / S
    (k_prior,) = jax.random.split(k_guide, 1)
    lo, hi = int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1])
    B = cfg.batch_size
    choice = jax_choice_draws(k_choice)
    if latent_size is None:
        k_t, k_noise = jax.random.split(k_prior)
        t = jax.random.randint(k_t, (B,), lo, hi + 1)
        noise = jax.random.normal(k_noise, (B, cfg.h, cfg.w, 3))
        return StepDraws(pose, fov, choice, tt(march_u), tt(t).long(),
                         tt(noise))
    t, noise, post = jax_sd_draws(k_prior, B, latent_size, cfg.t_range)
    return StepDraws(pose, fov, choice, tt(march_u), t, noise, post)


def jax_dmtet_step_draws(cfg, base_key, step: int) -> DMTetDraws:
    """The draws of DMTetTrainer._make_train_step at state.step=step:
    fold_in(base, step) → split 3 (batch, choice, guide); the guide key
    feeds the pixel oracle (split 1, then t and noise)."""
    key = jax.random.fold_in(base_key, step)
    k_batch, k_choice, k_guide = jax.random.split(key, 3)
    pose, fov = jax_batch_draws(k_batch, cfg)
    (k_prior,) = jax.random.split(k_guide, 1)
    k_t, k_noise = jax.random.split(k_prior)
    lo, hi = int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1])
    B = cfg.batch_size
    t = jax.random.randint(k_t, (B,), lo, hi + 1)
    noise = jax.random.normal(k_noise, (B, cfg.h, cfg.w, 3))
    return DMTetDraws(pose, fov, jax_choice_draws(k_choice), tt(t).long(),
                      tt(noise))


def jax_sd_draws(key, B: int, latent_size: int, t_range):
    """What StableDiffusionGuidance.sds_loss draws from its key:
    (t [B], latent noise, posterior noise [B, ls, ls, 4])."""
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    lo, hi = int(1000 * t_range[0]), int(1000 * t_range[1])
    shape = (B, latent_size, latent_size, 4)
    return (tt(jax.random.randint(k_t, (B,), lo, hi + 1)).long(),
            tt(jax.random.normal(k_noise, shape)),
            tt(jax.random.normal(k_enc, shape)))


def jax_grid_draws(cfg, base_key, step: int) -> torch.Tensor:
    """The cell jitter of Trainer._make_update_grid at state.step=step."""
    key = jax.random.fold_in(jax.random.fold_in(base_key, step), GRID_SALT)
    keys = jax.random.split(key, cfg.cascade)
    return torch.stack([tt(jax.random.uniform(k, (cfg.grid_size ** 3, 3)))
                        for k in keys])
