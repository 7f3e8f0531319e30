"""Single-prior runs with reference images that the port once refused,
against the JAX package on the CPU: one SDS step of SD with
``--image_config`` and no ``--image`` (SD's loss in a run whose every 4th
step is a known-view step) and one known-view step of the pixel oracle
with ``--image file.png``, each against the jitted JAX step with the same
weights and draws; the oracle run's eval metric is the known-view PSNR,
as JAX's ``_eval_metric`` picks it.

Tolerances as ``tests/test_torch_multi_prior.py``: the loss and its SDS
part 1e-5 rel; the field's gradients rtol 1e-3 with a floor of 1e-3 of the
largest entry; the updated parameters 1e-5 where the gradient is clearly
nonzero.
"""

import dataclasses

import jax
import jax.numpy as jnp

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import apply_image_mode
from dreamfusion_tpu.guidance.oracle import PixelOracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.training.image_data import \
    load_ref_images as j_load_ref_images
from dreamfusion_tpu_torch.training.image_data import load_ref_images
from dreamfusion_tpu_torch.training.trainer import Trainer

from test_torch_multi_prior import (_capture, _cfg, _check_step, _port_ref,
                                    _refs, _sd_pair, _states)
from torch_parity import jax_known_view_draws, jax_step_draws, port_cfg


def test_one_sd_image_config_step_matches_jax(tmp_path, monkeypatch):
    """SD with ``--image_config`` and no ``--image`` (no preset): the SDS
    step of a run whose every 4th step is a known-view step."""
    csv, _ = _refs(tmp_path)
    cfg = _cfg(tmp_path, image_config=csv, guidance=("SD",))
    step = 101
    jg, jp, pg, emb, jemb = _sd_pair(cfg.t_range)
    ref = j_load_ref_images(cfg, cfg.h, cfg.w)
    jt = jtrainer.Trainer(cfg, guidances={"SD": jg},
                          guidance_params={"SD": jp},
                          embeddings={"SD": jemb}, ref_images=ref)
    pt = Trainer(port_cfg(cfg), "cpu", pg, emb,
                 ref_images=_port_ref(load_ref_images(port_cfg(cfg), cfg.h,
                                                      cfg.w)))
    assert pt.is_known_view_step(100) and not pt.is_known_view_step(step)
    captured = _capture(monkeypatch)
    base = jax.random.PRNGKey(0)
    js, ps = _states(jt, pt, step)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    pm, pgrads = pt.train_step(ps, jax_step_draws(cfg, jt.renderer, base,
                                                  step, 8))
    _check_step(pm, jm, pgrads, captured, js2, ps.renderer)


def test_one_oracle_known_view_step_with_a_file_image_matches_jax(
        tmp_path, monkeypatch):
    """The pixel oracle with ``--image file.png`` (the image preset keeps
    a named oracle): a known-view step toward the PNG; the run's eval
    metric is the known-view PSNR, as JAX's."""
    _, png = _refs(tmp_path)
    cfg = dataclasses.replace(_cfg(
        tmp_path, apply_image_mode, image=png, text=None,
        guidance=("oracle",)), lambda_3d_normal_smooth=0.0)
    assert cfg.guidance == ("oracle",)
    step = 104
    g = JOracle(JSDConfig(t_range=cfg.t_range), scene=cfg.oracle_scene)
    ref = j_load_ref_images(cfg, cfg.h, cfg.w)
    jt = jtrainer.Trainer(cfg, guidances={"oracle": g},
                          guidance_params={"oracle": {}},
                          embeddings={"oracle": jnp.zeros(())},
                          ref_images=ref)
    pt = Trainer(port_cfg(cfg), "cpu", ref_images=_port_ref(
        load_ref_images(port_cfg(cfg), cfg.h, cfg.w)))
    assert pt.is_known_view_step(step)
    captured = _capture(monkeypatch)
    base = jax.random.PRNGKey(0)
    # the field's own init, as tests/test_torch_image.py: at random field
    # params (``jax_train_state``) this step's triplane gradients part at
    # one point's texels (ROADMAP queue 3, open)
    js, ps = _states(jt, pt, step, real_init=True)
    js2, jm = jt._make_known_view_step()(js, base)
    jax.block_until_ready(js2)
    R = pt.kv_batch.rays_o.shape[1]
    pm, pgrads = pt.known_view_step(ps, jax_known_view_draws(
        cfg, jt.renderer, base, step, 1, R))
    _check_step(pm, jm, pgrads, captured, js2, ps.renderer)
    assert pt.eval_metric(ps) == pt.known_view_psnr(ps)
