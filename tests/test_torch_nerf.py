"""Port parity of the field (triplane and hash-grid backbones) and of Adan.

* Field (sigma, albedo) against ``NeRFField.common``, and the closed-form
  normals against ``_autograd_normal`` (-∇σ by JAX autodiff): 1e-4.  The
  hash-grid cases scale the table to ±0.1 so that the field is not flat.
* Parameter gradients of a loss on (sigma, albedo, normal) against the
  second-order autograd reference of ``tests/test_triplane.py``'s
  ``loss_old``: 2e-3 rel.
* Adan with the encoder's 10x update scale against
  ``build_optimizer("adan", ...)`` on identical gradients over 3 steps:
  1e-6 (times the update scale: the 10x also scales the rounding of
  new_p - p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamfusion_tpu.core.math import safe_normalize as j_safe_normalize
from dreamfusion_tpu.models.nerf import NeRFField as JField
import pytest

from dreamfusion_tpu.training.optimizer import (build_optimizer,
                                                encoder_label_fn)
from dreamfusion_tpu_torch.config import Config, finalize
from dreamfusion_tpu_torch.models.nerf import NeRFField
from dreamfusion_tpu_torch.training.optimizer import Adan
from dreamfusion_tpu_torch.training.trainer import (build_renderer,
                                                   optimizer_for)
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import tt

torch.set_num_threads(2)

FIELD = dict(bound=1.0, hidden_dim=32, num_layers=3, triplane_resolution=32,
             triplane_channels=8, triplane_scales=2)
GRIDS = {
    "L4C8-affine-smooth": dict(grid_levels=4, grid_features_per_level=8,
                               grid_log2_hashmap_size=12,
                               grid_desired_resolution=128,
                               grid_interpolation="smoothstep",
                               grid_hash="affine"),
    "L16C2-xor-linear": dict(grid_levels=16, grid_features_per_level=2,
                             grid_log2_hashmap_size=12,
                             grid_desired_resolution=256,
                             grid_interpolation="linear", grid_hash="xor"),
}


def _fields(seed=3, grid=None):
    """(JAX field, its params, the port's field holding them, x); the
    triplane backbone, or the hash grid with the ``grid`` kwargs."""
    kw = dict(FIELD, backbone="triplane") if grid is None else \
        dict(FIELD, backbone="grid", **grid)
    jf = JField(bg_radius=-1.0, normal_mode="autograd",
                compute_dtype=jnp.float32, **kw)
    x = np.random.default_rng(seed).uniform(-0.9, 0.9, (128, 3)) \
        .astype(np.float32)
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     method=jf.density)["params"]
    if grid is not None:
        params = dict(params, grid_table=params["grid_table"] * 1e3)
    pf = NeRFField(compute_dtype=torch.float32, **kw)
    sd = {k[len("field."):]: v for k, v in
          params_from_jax({"field": jax.tree.map(np.asarray, params)}).items()}
    pf.load_state_dict(sd)
    return jf, params, pf, x


def test_field_sigma_albedo_and_normals():
    _check_sigma_albedo_and_normals(*_fields())


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_field_sigma_albedo_and_normals(grid):
    _check_sigma_albedo_and_normals(*_fields(grid=GRIDS[grid]))


def _check_sigma_albedo_and_normals(jf, params, pf, x):
    js, ja = jf.apply({"params": params}, jnp.asarray(x), method=jf.common)
    jn = jf.apply({"params": params}, jnp.asarray(x),
                  method=lambda m, xx: m._autograd_normal(xx, None))
    jn = jnp.nan_to_num(j_safe_normalize(jn))
    with torch.no_grad():
        ps, pa, pn = pf.common_with_normal(tt(x))
        ps2, pa2 = pf.common(tt(x))
    for a, b in ((ps, js), (pa, ja), (ps2, js), (pa2, ja)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-4,
                               rtol=1e-4)


def test_field_second_order_param_grads():
    _check_second_order_param_grads(*_fields(4))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_field_second_order_param_grads(grid):
    _check_second_order_param_grads(*_fields(4, grid=GRIDS[grid]))


def _check_second_order_param_grads(jf, params, pf, x):
    xj = jnp.asarray(x)

    def loss_old(p):
        def sig_sum(pts):
            s, _ = jf.apply({"params": p}, pts, method=jf.common)
            return jnp.sum(s)
        s, a = jf.apply({"params": p}, xj, method=jf.common)
        n = jnp.nan_to_num(j_safe_normalize(-jax.grad(sig_sum)(xj)))
        return jnp.sum(s) + jnp.sum(n * n) + jnp.sum(n[:, 0]) + jnp.sum(a)

    jg = params_from_jax({"field": jax.tree.map(
        np.asarray, jax.grad(loss_old)(params))})
    s, a, n = pf.common_with_normal(tt(x))
    loss = s.sum() + (n * n).sum() + n[:, 0].sum() + a.sum()
    names = [k for k, _ in pf.named_parameters()]
    pg = torch.autograd.grad(loss, list(pf.parameters()))
    for name, g in zip(names, pg):
        ref = jg["field." + name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3,
                                   atol=2e-4 * np.abs(ref).max())


def test_adan_encoder_scale_matches_optax():
    rng = np.random.default_rng(5)
    tree = {"field": {
        "triplanes": [rng.normal(size=(3, 8, 8, 4)).astype(np.float32)],
        "sigma_net": {"dense_0": {
            "kernel": rng.normal(size=(12, 6)).astype(np.float32),
            "bias": rng.normal(size=(6,)).astype(np.float32)}}}}
    opt = build_optimizer("adan", 1e-2, 100, "triplane")
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    names = ["field.triplanes.0", "field.sigma_net.layers.0.weight",
             "field.sigma_net.layers.0.bias"]
    pd = params_from_jax(tree)
    pp = [pd[n] for n in names]
    adan = Adan(5 * 1e-2, [10.0, 1.0, 1.0])
    ps = adan.init(pp)
    for step in range(3):
        gtree = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) *
            (3.0 if step == 1 else 0.3), tree)
        upd, js = opt.update(jax.tree.map(jnp.asarray, gtree), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        gd = params_from_jax(gtree)
        pp, ps = adan.step(pp, [gd[n] for n in names], ps)
        ref = params_from_jax(jax.tree.map(np.asarray, jp))
        for n, p, scale in zip(names, pp, adan.scales):
            # the 10x multiplies new_p - p, and with it one ulp of p
            np.testing.assert_allclose(p.numpy(), ref[n].numpy(),
                                       atol=1e-6 * scale, rtol=1e-6)


def test_adan_gives_the_grid_table_the_encoder_scale():
    """The hash table is the JAX optimizer's 'encoder' group (10x)."""
    cfg = finalize(Config(guidance=("oracle",), backbone="grid",
                          grid_log2_hashmap_size=12, hidden_dim=16))
    renderer = build_renderer(cfg)
    names = [n for n, _ in renderer.named_parameters()]
    scales = dict(zip(names, optimizer_for(cfg, renderer).scales))
    assert scales.pop("field.grid_table") == 10.0
    assert set(scales.values()) == {1.0}
    labels = encoder_label_fn({"field": {"grid_table": 0,
                                         "sigma_net": {"dense_0": 0}}})
    assert labels["field"] == {"grid_table": "encoder",
                               "sigma_net": {"dense_0": "net"}}
