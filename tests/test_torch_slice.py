"""The slice end to end against the JAX trainer: one density-grid update
and one full main step (render → oracle SDS → entropy and orient
regularizers → backward → guarded Adan → EMA), with identical weights and
the JAX step's own random draws handed to the port.

Tolerances: occupancy grid equal; density grid 1e-5 rel; loss 1e-5 rel;
gradients 1e-4 rel (of each tensor's largest entry); updated parameters and
EMA 1e-5 where the gradient is clearly nonzero (Adan's first step is
≈ lr·sign(g), so a gradient near 0 may flip sign on rounding alone).

grid_size=30 with 24 probes keeps probe midpoints off occupancy-cell
boundaries (see tests/test_torch_kernels.py::_k2_inputs); the JAX step runs
under jit with fused multiply-adds, the port eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import Config, finalize
from dreamfusion_tpu.guidance.oracle import PixelOracleGuidance as JOracle
from dreamfusion_tpu.guidance.sd import SDConfig
from dreamfusion_tpu_torch.training.trainer import Trainer
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import jax_grid_draws, jax_step_draws, port_cfg

torch.set_num_threads(2)
STEP = 48      # a grid-update step with the entropy weight ramped to 0.96


def test_one_step_and_grid_update_match_jax(tmp_path, monkeypatch):
    cfg = finalize(Config(
        guidance=("oracle",), oracle_scene="two_sphere",
        workspace=str(tmp_path / "ws"), backbone="triplane", w=16, h=16,
        iters=100, batch_size=1, triplane_resolution=32, triplane_channels=8,
        triplane_scales=2, hidden_dim=32, num_layers=3, grid_size=30,
        grid_coarse_steps=24, grid_fine_steps=24, fp16=False, seed=0,
        eval_interval=-1, lambda_3d_normal_smooth=0.0, use_tensorboard=False,
        guidance_scale=1.0, lr=1e-2))
    g = JOracle(SDConfig(tiny=True), scene=cfg.oracle_scene)
    jt = jtrainer.Trainer(cfg, guidances={"oracle": g},
                          guidance_params={"oracle": {}},
                          embeddings={"oracle": jnp.zeros(())})
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0))
    js = js.replace(step=jnp.asarray(STEP, jnp.int32))

    pt = Trainer(port_cfg(cfg), "cpu")
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = STEP

    # ---- density-grid update ------------------------------------------
    js = jt._make_update_grid()(js, base)
    pt.update_grid(ps, jax_grid_draws(cfg, base, STEP))
    np.testing.assert_array_equal(ps.occ_grid.numpy(),
                                  np.asarray(js.occ_grid))
    assert 0.02 < ps.occ_grid.float().mean() < 0.98
    np.testing.assert_allclose(ps.density_grid.numpy(),
                               np.asarray(js.density_grid), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ps.mean_density), float(js.mean_density),
                               rtol=1e-5)

    # ---- one main step, grads captured inside the jitted JAX step ------
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    draws = jax_step_draws(cfg, jt.renderer, base, STEP)
    pm, pgrads = pt.train_step(ps, draws)

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["loss_reg"]), float(jm["loss_reg"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    assert ps.step == int(js2.step) == STEP + 1

    names = [n for n, _ in ps.renderer.named_parameters()]
    jg = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    ema_j = params_from_jax(jax.tree.map(np.asarray, js2.ema_params))
    pparams = dict(ps.renderer.named_parameters())
    for name, grad in zip(names, pgrads):
        ref = jg[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        assert clear.sum() > 0
        np.testing.assert_allclose(pparams[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ps.ema_params[name].numpy()[clear],
                                   ema_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
