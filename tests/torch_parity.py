"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
JAX package's random draws for one training step (the hash grid's tv cells
and the normal-perturb offsets included) and for one known-view step,
rebuilt from its own key-split tree and handed to the port as tensors, and
config mapping.  A step's pose and FOV draws go to the port as the unit
uniforms behind ``jax.random.uniform(minval, maxval)``; the port scales
them by the step's ranges."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamfusion_tpu_torch.config import Config as PConfig
from dreamfusion_tpu_torch.core.poses import PoseDraws
from dreamfusion_tpu_torch.training import schedules as pschedules
from dreamfusion_tpu_torch.training.dmtet_trainer import (DMTetDraws,
                                                          DMTetKnownViewDraws)
from dreamfusion_tpu_torch.training.trainer import (KnownViewDraws,
                                                    PriorDraws, StepDraws,
                                                    grid_spec_of,
                                                    prior_fields)

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


def jax_pose_draws(k_pose, cfg, unit: bool = False) -> PoseDraws:
    """What dreamfusion_tpu.core.poses.rand_poses draws from its key; with
    ``unit`` the radius and angles as unit uniforms (the same bits)."""
    B = cfg.batch_size
    k_r, k_u, k_th, k_ph, k_sph, k_jc, k_jt, k_ju = jax.random.split(k_pose, 8)
    th = [jnp.deg2rad(jnp.asarray(a, jnp.float32)) for a in cfg.theta_range]
    ph = [jnp.deg2rad(jnp.asarray(a, jnp.float32)) for a in cfg.phi_range]
    if unit:
        radius, thetas, phis = (tt(jax.random.uniform(k, (B,)))
                                for k in (k_r, k_th, k_ph))
    else:
        radius = tt(_uniform(k_r, (B,), *cfg.radius_range))
        thetas = tt(jax.random.uniform(k_th, (B,), minval=th[0],
                                       maxval=th[1]))
        phis = tt(jax.random.uniform(k_ph, (B,), minval=ph[0], maxval=ph[1]))
    return PoseDraws(
        radius=radius, thetas=thetas, phis=phis,
        sphere_normal=tt(jax.random.normal(k_sph, (B, 3))),
        sphere_u=tt(jax.random.uniform(k_u, ())),
        jitter_center=tt(jax.random.uniform(k_jc, (B, 3))),
        jitter_target=tt(jax.random.normal(k_jt, (B, 3))),
        jitter_up=tt(jax.random.normal(k_ju, (B, 3))))


def jax_batch_draws(k_batch, cfg, unit: bool = False):
    k_pose, k_fov = jax.random.split(k_batch)
    fov = tt(jax.random.uniform(k_fov, ())) if unit else \
        tt(_uniform(k_fov, (), *cfg.fovy_range))
    return jax_pose_draws(k_pose, cfg, unit), fov


def jax_render_keys(renderer, k_render, n: int):
    """The first n keys the renderer's ``make_rng("render")`` gives."""
    return renderer.apply(
        {}, method=lambda m: [m.make_rng("render") for _ in range(n)],
        rngs={"render": k_render})


def jax_choice_draws(k_choice) -> pschedules.ChoiceDraws:
    k_amb, k_shade, k_bg, k_bgc, k_light = jax.random.split(k_choice, 5)
    return pschedules.ChoiceDraws(
        tt(jax.random.uniform(k_amb, ())), tt(jax.random.uniform(k_shade, ())),
        tt(jax.random.uniform(k_bg, ())), tt(jax.random.uniform(k_bgc, (3,))),
        tt(jax.random.normal(k_light, (3,))))


def jax_step_draws(cfg, renderer, base_key, step: int,
                   latent_size=None, pixel_size=None) -> StepDraws:
    """The draws of Trainer._make_train_step('main' or 'latent') at
    state.step=step: fold_in(base, step) → split 5 (batch, choice, render,
    guide, tv); the render key's first draw is the march's, its second the
    normal-perturb offsets'.  With ``latent_size`` the guide key feeds SD's
    sds_loss (split 3: posterior, t, latent noise), else the pixel (or
    image) oracle's, or with ``pixel_size`` DeepFloyd-IF's (t, then the
    noise at its side)."""
    key = jax.random.fold_in(base_key, step)
    k_batch, k_choice, k_render, k_guide, k_tv = jax.random.split(key, 5)
    pose, fov = jax_batch_draws(k_batch, cfg, unit=True)
    R = cfg.batch_size * cfg.h * cfg.w
    k_march, k_perturb = jax_render_keys(renderer, k_render, 2)
    march_u, pdf_u, S = jax_march_draws(cfg, k_march, R)
    (k_prior,) = jax.random.split(k_guide, 1)
    B = cfg.batch_size
    choice = jax_choice_draws(k_choice)
    if latent_size is None:
        t, noise = jax_pixel_draws(k_prior, cfg, pixel_size)
        draws = StepDraws(pose, fov, choice, tt(march_u), t, noise)
    else:
        t, noise, post = jax_sd_draws(k_prior, B, latent_size, cfg.t_range)
        draws = StepDraws(pose, fov, choice, tt(march_u), t, noise, post)
    draws = draws._replace(pdf_u=pdf_u)
    if cfg.backbone == "grid" and cfg.lambda_tv > 0:
        draws = draws._replace(tv_cells=jax_tv_cells(
            k_tv, grid_spec_of(port_cfg(cfg)).resolutions))
    if cfg.lambda_3d_normal_smooth > 0:
        draws = draws._replace(perturb_noise=tt(jax.random.normal(
            k_perturb, (R, S, 3))).reshape(-1, 3))
    return draws


def jax_march_draws(cfg, k_march, R: int):
    """A render's sampling draws from the renderer's first render key →
    (march_u, pdf_u or None, samples a ray): the grid march's stratified
    draws, or the vanilla render's (``stratified_zs``' unit jitter from
    the key's first split, ``sample_pdf``'s stratified draws from its
    second)."""
    if cfg.backbone != "vanilla":
        S = cfg.grid_fine_steps
        return ((jnp.arange(S) + jax.random.uniform(k_march, (R, S))) / S,
                None, S)
    k_strat, k_pdf = jax.random.split(k_march)
    n = cfg.upsample_steps
    pdf_u = (jnp.arange(n) + jax.random.uniform(k_pdf, (R, n))) / n
    return (jax.random.uniform(k_strat, (R, cfg.num_steps)), tt(pdf_u),
            cfg.num_steps + n)


def jax_known_view_draws(cfg, renderer, base_key, step: int, K: int,
                         R: int) -> KnownViewDraws:
    """The draws of Trainer._make_known_view_step at state.step=step for K
    references of R rays: fold_in(base, step) → split 4 (sel, noise, bg,
    render); the noise key splits into the ray origins' and directions'."""
    key = jax.random.fold_in(base_key, step)
    k_sel, k_noise, k_bg, k_render = jax.random.split(key, 4)
    nro, nrd = jax.random.split(k_noise)
    k_march, k_perturb = jax_render_keys(renderer, k_render, 2)
    march_u, pdf_u, S = jax_march_draws(cfg, k_march, R)
    draws = KnownViewDraws(
        tt(jax.random.randint(k_sel, (), 0, K)).long(),
        tt(jax.random.normal(nro, (3,))), tt(jax.random.normal(nrd, (3,))),
        tt(jax.random.uniform(k_bg, (R, 3))), tt(march_u), pdf_u=pdf_u)
    if cfg.lambda_3d_normal_smooth > 0:
        draws = draws._replace(perturb_noise=tt(jax.random.normal(
            k_perturb, (R, S, 3))).reshape(-1, 3))
    return draws


def jax_dmtet_known_view_draws(base_key, step: int, K: int
                               ) -> DMTetKnownViewDraws:
    """The draws of DMTetTrainer._make_known_view_step: split 2 (sel, bg)."""
    k_sel, k_bg = jax.random.split(jax.random.fold_in(base_key, step))
    return DMTetKnownViewDraws(
        tt(jax.random.randint(k_sel, (), 0, K)).long(),
        tt(jax.random.uniform(k_bg, (3,))))


def jax_tv_cells(key, resolutions, n_samples: int = 4096) -> torch.Tensor:
    """The cells hashgrid_tv_loss draws from its key: [L, n, 3]."""
    keys = jax.random.split(key, len(resolutions))
    return torch.stack([tt(jax.random.randint(k, (n_samples, 3), 0,
                                              max(r - 1, 1))).long()
                        for k, r in zip(keys, resolutions)])


def jax_pixel_draws(key, cfg, pixel_size=None):
    """What the pixel oracle (or DeepFloyd-IF's sds_loss) draws from its
    key: (t [B], noise [B, h, w, 3], or at IF's ``pixel_size``)."""
    k_t, k_noise = jax.random.split(key)
    lo, hi = int(1000 * cfg.t_range[0]), int(1000 * cfg.t_range[1])
    B = cfg.batch_size
    t = jax.random.randint(k_t, (B,), lo, hi + 1)
    shape = (B, cfg.h, cfg.w, 3) if pixel_size is None else \
        (B, pixel_size, pixel_size, 3)
    return tt(t).long(), tt(jax.random.normal(k_noise, shape))


def jax_dmtet_step_draws(cfg, base_key, step: int,
                         latent_size=None, pixel_size=None) -> DMTetDraws:
    """The draws of DMTetTrainer._make_train_step at state.step=step:
    fold_in(base, step) → split 3 (batch, choice, guide); the guide key
    feeds the pixel oracle (split 1, then t and noise; IF's at
    ``pixel_size``) or, with ``latent_size``, SD's sds_loss (split 1, then
    ``jax_sd_draws``)."""
    key = jax.random.fold_in(base_key, step)
    k_batch, k_choice, k_guide = jax.random.split(key, 3)
    pose, fov = jax_batch_draws(k_batch, cfg, unit=True)
    (k_prior,) = jax.random.split(k_guide, 1)
    B = cfg.batch_size
    choice = jax_choice_draws(k_choice)
    if latent_size is not None:
        t, noise, post = jax_sd_draws(k_prior, B, latent_size, cfg.t_range)
        return DMTetDraws(pose, fov, choice, t, noise, post)
    return DMTetDraws(pose, fov, choice,
                      *jax_pixel_draws(k_prior, cfg, pixel_size))


def uncut_jax_tile_cap(jt, pt, ps) -> int:
    """Raise the JAX DMTet renderer's K7 tile_cap (512) to the face count
    of the port's surface in ``ps``, which no tile can list more of: the
    port lists every triangle (``MAX_TILE_CAP``), so neither side cuts a
    list.  A step that starts from ``ps`` renders this surface."""
    dmr = pt.dmtet_renderer
    n = int(dmr.extract_mesh(pt.geo_params(ps.model, ps.tet_scale)).n_faces)
    assert 0 < n <= min(dmr.tile_cap, jt.dmtet_renderer.max_tris)
    jt.dmtet_renderer.tile_cap = max(jt.dmtet_renderer.tile_cap, n)
    return n


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


def random_flax_params(init, *args, seed):
    """Flax params of ``init``'s shapes (``jax.eval_shape``: nothing is
    compiled): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), every
    other leaf N(0, 0.05²); as good as the init for a parity test, and
    seconds faster on the CPU."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        # a list's entries (the triplanes) have no name
        name, shape = getattr(path[-1], "key", None), leaf.shape
        a = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(shape[:-1]))
        return 1 + 0.1 * a if name == "scale" else 0.05 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_set_draws(draws, base, step: int, priors, n_split: int = 5):
    """`draws` (a step's ``StepDraws`` or ``DMTetDraws``) with each prior's
    draws as JAX's step makes them for a set of priors: the guide key (the
    4th of ``fold_in(base, step)``'s 5 keys in stage 1, the 3rd of 3 in the
    DMTet stage) split once per prior, key i to the i-th name in sorted
    order.  `priors`: {name: a function of its key → (t, noise[,
    posterior noise]), or None for a prior that draws nothing (CLIP)}."""
    key = jax.random.fold_in(base, step)
    k_guide = jax.random.split(key, n_split)[n_split - 2]
    keys = jax.random.split(k_guide, len(priors))
    out = {name: PriorDraws(*priors[name](k))
           for name, k in zip(sorted(priors), keys) if priors[name]}
    return draws._replace(**prior_fields(out))


def jax_train_state(jt, step: int = 0, seed: int = 0):
    """JAX ``Trainer.init_state``'s TrainState at `step`, its field's
    params from ``random_flax_params`` (``jax.eval_shape`` of the
    renderer's init) in place of the eager flax init, which runs a whole
    render op by op on the CPU (tens of seconds a process); the optimizer
    state from the optimizer's own init."""
    from dreamfusion_tpu.models.renderer import RenderFlags
    from dreamfusion_tpu.training.trainer import TrainState
    cfg = jt.cfg
    G = cfg.grid_size
    occ = jnp.ones((cfg.cascade, G, G, G), bool)
    grid = cfg.backbone in ("grid", "triplane")
    params = random_flax_params(
        lambda k: jt.renderer.init(
            {"params": k, "render": k}, RenderFlags(), jnp.zeros((64, 3)),
            jnp.ones((64, 3)), occ_grid=occ if grid else None,
            method=jt.renderer.render), seed=seed)
    params = jax.tree.map(jnp.asarray, params)
    return TrainState(params=params, opt_state=jt.optimizer.init(params),
                      ema_params=params,
                      density_grid=jnp.zeros((cfg.cascade, G ** 3)),
                      mean_density=jnp.zeros(()), occ_grid=occ,
                      step=jnp.asarray(step, jnp.int32))


def widened(x):
    """``x`` (a tensor or a NamedTuple of draws) with every float tensor
    in float64."""
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(widened, x))
    return x


class float64_port:
    """A context in which the port's plain path computes in float64: the
    default dtype, ``Tensor.float``, ``Tensor.to(float32)``, ``einsum`` and
    the factories' ``dtype=float32`` widened.  Build the trainer and its
    towers inside it, then ``.double()`` their modules; the float64 step is
    the reference a float32 step's rounding is measured against
    (tests/f64_witness_dmtet.py)."""

    F32, F64 = torch.float32, torch.float64
    FACTORIES = ("zeros", "ones", "full", "empty", "tensor", "arange",
                 "zeros_like", "ones_like", "full_like", "empty_like",
                 "linspace", "as_tensor")

    def _patch(self, obj, name, new):
        self.saved[(obj, name)] = getattr(obj, name)
        setattr(obj, name, new)

    def __enter__(self):
        F32, F64 = self.F32, self.F64
        self.saved = {}

        def f64_dtype(fn):
            def g(*a, **k):
                if k.get("dtype") is F32:
                    k["dtype"] = F64
                return fn(*a, **k)
            return g

        to, es = torch.Tensor.to, torch.einsum

        def to64(t, *a, **k):
            a = tuple(F64 if x is F32 else x for x in a)
            if k.get("dtype") is F32:
                k["dtype"] = F64
            return to(t, *a, **k)

        def einsum64(eq, *ops):
            ops = ops[0] if len(ops) == 1 and isinstance(
                ops[0], (list, tuple)) else ops
            return es(eq, *[o.double() if o.is_floating_point() else o
                            for o in ops])

        torch.set_default_dtype(F64)
        self._patch(torch.Tensor, "float", lambda t, *a, **k: t.double())
        self._patch(torch.Tensor, "to", to64)
        self._patch(torch, "einsum", einsum64)
        for name in self.FACTORIES:
            self._patch(torch, name, f64_dtype(getattr(torch, name)))
        return self

    def __exit__(self, *exc):
        for (obj, name), v in self.saved.items():
            setattr(obj, name, v)
        torch.set_default_dtype(self.F32)
        return False


def float64_state(ps):
    """A DMTet trainer state built under ``float64_port``, its model, EMA
    parameters and tet scale widened in place → ``ps``."""
    ps.model.double()
    for k in list(ps.ema_params):
        ps.ema_params[k] = ps.ema_params[k].double()
    ps.tet_scale = ps.tet_scale.double()
    return ps
