"""Port parity of the small field options against the JAX package, on
tiny shapes with inputs from a numpy seed.

* ``density_activation="softplus"`` with its linear blob (K4's plain twin
  through ``NeRFField``): sigma and albedo 1e-5, the closed-form normals
  against ``_autograd_normal`` 1e-4.
* ``normal_mode="finite_difference"`` on the grid and the triplane: the
  six clipped probes' normals and the select (K4's ``field_select``)
  against ``NeRFField.__call__``: sigma, colour 1e-5, normals 1e-4; the
  parameters' gradients of a loss on colour and normals 2e-3 of each
  tensor's largest entry (the differences divide by 2·eps = 0.02: each
  side's rounding of the six probes' sigma, times 50, reaches the
  density output's bias: measured up to 8e-4 there, 1e-6 elsewhere).
* ``triplane_tv_loss``: value and gradient 1e-6 rel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.core.math import safe_normalize as j_safe_normalize
from dreamfusion_tpu.models.nerf import NeRFField as JField
from dreamfusion_tpu.ops.triplane import triplane_tv_loss as j_tv
from dreamfusion_tpu_torch.models.nerf import NeRFField
from dreamfusion_tpu_torch.ops.triplane import triplane_tv_loss
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import tt

torch.set_num_threads(2)

BACKBONES = {
    "triplane": dict(backbone="triplane", triplane_resolution=32,
                     triplane_channels=8, triplane_scales=2),
    "grid": dict(backbone="grid", grid_levels=4, grid_features_per_level=8,
                 grid_log2_hashmap_size=12, grid_desired_resolution=128),
}


def _fields(backbone, seed=0, n=64, **kw):
    kw = dict(BACKBONES[backbone], bound=1.0, hidden_dim=32, num_layers=3,
              **kw)
    jf = JField(bg_radius=-1.0, compute_dtype=jnp.float32, **kw)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    x[0] = [0.995, -0.2, 0.3]          # a probe clipped to the box
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     method=jf.density)["params"]
    if backbone == "grid":
        # the init table (±1e-4) leaves the MLP flat: ±0.1
        params = dict(params, grid_table=params["grid_table"] * 1e3)
    pf = NeRFField(compute_dtype=torch.float32, **kw)
    pf.load_state_dict({k[len("field."):]: v for k, v in params_from_jax(
        {"field": jax.tree.map(np.asarray, params)}).items()})
    light = rng.normal(size=(n, 3)).astype(np.float32)
    light /= np.linalg.norm(light, axis=-1, keepdims=True)
    return jf, params, pf, x, light


@pytest.mark.parametrize("backbone", ["triplane", "grid"])
def test_softplus_density_and_linear_blob(backbone):
    jf, params, pf, x, _ = _fields(backbone, density_act="softplus",
                                   blob_density=10.0, blob_radius=0.5)

    @jax.jit
    def jax_field(p, xx):
        s, a = jf.apply({"params": p}, xx, method=jf.common)
        n = jf.apply({"params": p}, xx,
                     method=lambda m, pts: m._autograd_normal(pts, None))
        return s, a, jnp.nan_to_num(j_safe_normalize(n))

    js, ja, jn = jax_field(params, jnp.asarray(x))
    with torch.no_grad():
        ps, pa = pf.common(tt(x))
        pn = pf.normal(tt(x))
    # the blob is linear and unclamped: negative beyond the radius
    d = np.linalg.norm(x, axis=-1)
    assert (d > 0.5).any() and (d < 0.5).any()
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-4)


@pytest.mark.parametrize("backbone,act", [("triplane", "exp"),
                                          ("grid", "exp"),
                                          ("triplane", "softplus")])
def test_finite_difference_normals_and_select(backbone, act):
    jf, params, pf, x, light = _fields(backbone, seed=1,
                                       normal_mode="finite_difference",
                                       density_act=act)
    ratio, shading = 0.3, 1

    def loss_of(sigma, color, normal):
        w = jnp.asarray(np.random.default_rng(2).normal(size=color.shape)
                        .astype(np.float32))
        return (color * w).sum() + (normal * w[:, ::-1]).sum() + \
            0.01 * sigma.sum()

    @jax.jit
    def jax_side(p, xx, ll):
        out = jf.apply({"params": p}, xx, xx, ll, ratio, shading)
        g = jax.grad(lambda q: loss_of(*jf.apply(
            {"params": q}, xx, xx, ll, ratio, shading)))(p)
        return out, g

    (jsig, jcol, jn), jgrad = jax_side(params, jnp.asarray(x),
                                       jnp.asarray(light))
    psig, pcol, pn = pf(tt(x), tt(light), ratio, torch.tensor(shading))
    np.testing.assert_allclose(psig.detach().numpy(), np.asarray(jsig),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pcol.detach().numpy(), np.asarray(jcol),
                               atol=1e-5)
    np.testing.assert_allclose(pn.detach().numpy(), np.asarray(jn),
                               atol=1e-4)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(pcol.shape)).astype(np.float32))
    loss = (pcol * w).sum() + (pn * w.flip(-1)).sum() + 0.01 * psig.sum()
    names = [k for k, _ in pf.named_parameters()]
    grads = torch.autograd.grad(loss, list(pf.parameters()))
    ref = params_from_jax({"field": jax.tree.map(np.asarray, jgrad)})
    for name, g in zip(names, grads):
        r = ref["field." + name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=2e-3 * np.abs(r).max(),
                                   err_msg=name)


def test_triplane_tv_loss():
    rng = np.random.default_rng(3)
    planes = [rng.normal(size=(3, r, r, 4)).astype(np.float32)
              for r in (16, 8)]
    jv, jg = jax.value_and_grad(j_tv)([jnp.asarray(p) for p in planes])
    pp = [tt(p).requires_grad_() for p in planes]
    pv = triplane_tv_loss(pp)
    pg = torch.autograd.grad(pv, pp)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-6)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
