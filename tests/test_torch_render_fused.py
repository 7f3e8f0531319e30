"""Port parity of the fused render tail's plain twins (the path a CPU tensor
takes) against the JAX package: K4's ``field_shade`` (the field head with
the closed-form normals and the shading select) and K3's ``composite_rays``
with the background and the orient loss.

* ``field_shade`` inside the port's field against the JAX field's call
  (triplane, ``normal_mode="analytic"``), for each shading id: sigma,
  color and normal within 1e-5; the parameter gradients of a loss on all
  three within 1e-4 of each parameter's largest (fp32 sums in another
  order, through the encoder's backward).
* ``field_shade`` against JAX's ``common_with_normal`` tail and
  ``__call__``'s select written on given h and tangents, at the ties: g = 0
  (the normal 0, where max(<n, l>, 0) meets its kink), |g|² below 1e-20
  (the normal scales with g), pre across trunc_exp's clamp at 15: values
  within 1e-6 (1e-5 rel), the gradients into h and the tangents within
  1e-5 of each group's largest.
* ``composite_rays`` with the background (a [3] colour or the background
  MLP's, chosen on the device) and the orient loss, through the port
  renderer's ``_shade_and_composite``, against JAX's: image, weights and
  loss_orient within 1e-5, the parameter gradients (the background MLP's
  included) within 1e-4 of each parameter's largest; with ``t_thresh`` >
  0, binarize, padded masks and a ray with every sample masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.core.math import safe_normalize as j_safe_normalize
from dreamfusion_tpu.models.nerf import NeRFField as JField
from dreamfusion_tpu.models.renderer import NeRFRenderer as JRenderer
from dreamfusion_tpu.models.renderer import RenderFlags as JFlags
from dreamfusion_tpu.ops.activation import trunc_exp
from dreamfusion_tpu_torch.models.nerf import NeRFField
from dreamfusion_tpu_torch.models.renderer import NeRFRenderer, RenderFlags
from dreamfusion_tpu_torch.ops import kernels
from dreamfusion_tpu_torch.ops.activation import field_shade
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import tt

torch.set_num_threads(2)

FIELD = dict(bound=1.0, hidden_dim=16, num_layers=3, triplane_resolution=16,
             triplane_channels=4, triplane_scales=1, backbone="triplane")
R, S = 24, 8
SHADINGS = [0, 1, 2, 3]         # albedo, lambertian, textureless, normal


def _rays(seed):
    """R rays from a sphere of radius 2.5 towards the box, their light
    directions, and S sorted depths with deltas across the box."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3))
    ro = (2.5 * ro / np.linalg.norm(ro, axis=-1, keepdims=True))
    rd = -ro / 2.5 + rng.normal(scale=0.2, size=(R, 3))
    light = rng.normal(size=(R, 3))
    light /= np.linalg.norm(light, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.5, 3.5, (R, S)), -1)
    deltas = np.concatenate([np.diff(z, axis=-1), np.full((R, 1), 0.05)], -1)
    f = lambda a: a.astype(np.float32)                      # noqa: E731
    return f(ro), f(rd), f(light), f(z), f(deltas)


def _grads_close(pg, jg, names, rel):
    for name, g in zip(names, pg):
        ref = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=rel,
                                   atol=rel * np.abs(ref).max(),
                                   err_msg=name)


# ---- K4: the field head with the normals and the shading ------------------

def _field_pair(seed=3):
    jf = JField(bg_radius=-1.0, normal_mode="analytic",
                compute_dtype=jnp.float32, **FIELD)
    ro, rd, light, z, _ = _rays(seed)
    x = np.clip(ro[:, None] + rd[:, None] * z[..., None], -1, 1
                ).reshape(-1, 3)
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     method=jf.density)["params"]
    pf = NeRFField(compute_dtype=torch.float32, **FIELD)
    sd = {k[len("field."):]: v for k, v in
          params_from_jax({"field": jax.tree.map(np.asarray, params)}).items()}
    pf.load_state_dict(sd)
    return jf, params, pf, x, light


@pytest.mark.parametrize("shading", SHADINGS)
def test_field_shade_matches_the_jax_field_call(shading):
    jf, params, pf, x, light = _field_pair()
    rng = np.random.default_rng(10 + shading)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((R * S,), (R * S, 3), (R * S, 3))]
    light_n = np.repeat(light, S, axis=0)        # JAX: one a sample

    def j_out(p):
        return jf.apply({"params": p}, jnp.asarray(x), jnp.zeros_like(x),
                        light_d=jnp.asarray(light_n),
                        ratio=jnp.float32(0.3), shading=jnp.int32(shading))

    def j_loss(p):
        return sum(jnp.sum(o * c) for o, c in zip(j_out(p), cots))

    jo = j_out(params)
    jg = params_from_jax({"field": jax.tree.map(
        np.asarray, jax.grad(j_loss)(params))})
    out = pf(tt(x), tt(light), torch.tensor(0.3),
             torch.tensor(shading), None)
    for a, b in zip(out, jo):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    names = [k for k, _ in pf.named_parameters()]
    pg = torch.autograd.grad(sum((o * tt(c)).sum()
                                 for o, c in zip(out, cots)),
                             list(pf.parameters()))
    _grads_close(pg, jg, ["field." + n for n in names], 1e-4)


def _j_tail(h, t, x, light, ratio, shading, bd, br, bound):
    """JAX's ``NeRFField.common_with_normal`` tail and ``__call__``'s
    shading select (``dreamfusion_tpu/models/nerf.py:244-252``,
    ``:333-344``) on given MLP outputs h [N, 4] and tangents t [3, N, 4]."""
    d = jnp.sum(x ** 2, -1)
    pre = h[:, 0] + bd * jnp.exp(-d / (2 * br ** 2))
    sigma = trunc_exp(pre)
    albedo = jax.nn.sigmoid(h[:, 1:])
    _, act_vjp = jax.vjp(trunc_exp, pre)
    (dsig,) = act_vjp(jnp.ones_like(pre))
    g = t[..., 0].T * dsig[:, None] / (2 * bound)
    normal = jnp.nan_to_num(j_safe_normalize(-g))
    lam = ratio + (1 - ratio) * jnp.maximum(jnp.sum(normal * light, -1), 0.0)
    color = jnp.where(
        shading == 0, albedo,
        jnp.where(shading == 2, jnp.broadcast_to(lam[:, None], albedo.shape),
                  jnp.where(shading == 3, (normal + 1.0) / 2.0,
                            albedo * lam[:, None])))
    return sigma, color, normal


@pytest.mark.parametrize("shading", SHADINGS)
def test_field_shade_matches_jax_at_the_ties(shading):
    rng = np.random.default_rng(20 + shading)
    N = R * S
    h = rng.normal(0, 2, (N, 4)).astype(np.float32)
    t = rng.normal(size=(3, N, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    groups = {"g = 0": slice(0, 16), "|g|² < eps": slice(16, 32),
              "across the clamp": slice(32, 48), "plain": slice(48, N)}
    t[:, groups["g = 0"]] = 0.0
    t[:, groups["|g|² < eps"]] *= 1e-18
    h[groups["across the clamp"], 0] = rng.uniform(14, 18, 16)
    light = _rays(5)[2]
    bd, br, bound, ratio = 5.0, 0.2, 1.0, 0.3
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((N,), (N, 3), (N, 3))]
    light_n = jnp.asarray(np.repeat(light, S, axis=0))

    def j_loss(hh, th):
        outs = _j_tail(hh, th, jnp.asarray(x), light_n, jnp.float32(ratio),
                       jnp.int32(shading), bd, br, bound)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jo), (jgh, jgt) = jax.value_and_grad(j_loss, (0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(t))
    ph, pt = tt(h).requires_grad_(), tt(t).requires_grad_()
    out = field_shade(ph, pt, tt(x), tt(light), torch.tensor(ratio),
                      torch.tensor(shading), bd, br, bound)
    for a, b in zip(out, jo):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
    assert not out[2][groups["g = 0"]].any()
    gh, gt = torch.autograd.grad(sum((o * tt(c)).sum()
                                     for o, c in zip(out, cots)), (ph, pt))
    for name, rows in groups.items():
        for got, ref in ((gh[rows], jgh[rows]), (gt[:, rows], jgt[:, rows])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)


# ---- K3: composite with the background and the orient loss ---------------

def _renderer_pair(t_thresh, seed=4):
    kw = dict(FIELD, bg_radius=1.4, hidden_dim_bg=8, num_layers_bg=2)
    jr = JRenderer(normal_mode="analytic", compute_dtype=jnp.float32,
                   t_thresh=t_thresh, **kw)
    x = jnp.zeros((4, 3))

    def init(m, xx):
        return m.density(xx), m.background(xx)

    params = jr.init(jax.random.PRNGKey(seed), x, method=init)["params"]
    pr = NeRFRenderer(t_thresh=t_thresh, compute_dtype=torch.float32, **kw)
    pr.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jr, params, pr


def _positions(pr, ro, rd, z):
    """The samples' clamped positions [R, S, 3], as JAX's method forms
    them and the march region hands them to the port's."""
    xyzs = tt(ro)[:, None, :] + tt(rd)[:, None, :] * tt(z)[..., None]
    return torch.clamp(xyzs, -pr.bound, pr.bound)


@pytest.mark.parametrize("use_net,binarize,t_thresh", [
    (True, False, 1e-4), (False, False, 0.05), (True, True, 0.05)])
def test_composite_with_background_and_orient_matches_jax(use_net, binarize,
                                                          t_thresh):
    jr, params, pr = _renderer_pair(t_thresh)
    ro, rd, light, z, deltas = _rays(6)
    rng = np.random.default_rng(7)
    mask = rng.uniform(size=(R, S)) < 0.8
    mask[3] = False                             # a ray with every sample off
    mask[:, -2:] &= np.arange(R)[:, None] % 2 == 0   # padded tails
    bg = rng.uniform(size=(3,)).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((R, 3), (R, S), ())]
    shading = 1
    jflags = JFlags(need_loss_orient=True, binarize=binarize)

    def j_out(p):
        out = jr.apply({"params": p}, jflags, jnp.asarray(ro),
                       jnp.asarray(rd), jnp.asarray(z), jnp.asarray(deltas),
                       jnp.asarray(mask), jnp.asarray(light),
                       jnp.float32(0.3), jnp.int32(shading), None,
                       jnp.asarray(bg), jnp.asarray(use_net),
                       method=jr._shade_and_composite)
        return out["image"], out["weights"], out["loss_orient"]

    def j_loss(p):
        return sum(jnp.sum(o * c) for o, c in zip(j_out(p), cots))

    jo = j_out(params)
    jg = params_from_jax(jax.tree.map(np.asarray,
                                      jax.grad(j_loss)(params)))
    out = pr._shade_and_composite(
        RenderFlags(need_loss_orient=True, binarize=binarize), tt(ro),
        tt(rd), tt(z), tt(deltas), tt(mask), tt(light), torch.tensor(0.3),
        torch.tensor(shading), None, tt(bg), torch.tensor(use_net),
        xyzs=_positions(pr, ro, rd, z))
    po = (out["image"], out["weights"], out["loss_orient"])
    assert float(po[2].detach()) > 0
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(po[0][3].detach().numpy(),
                               bg if not use_net else np.asarray(jo[0][3]),
                               atol=1e-6)
    names = [k for k, _ in pr.named_parameters()]
    pg = torch.autograd.grad(sum((o * tt(c)).sum() for o, c in zip(po, cots)),
                             list(pr.parameters()), allow_unused=True)
    pg = [torch.zeros_like(p) if g is None else g
          for g, p in zip(pg, pr.parameters())]
    _grads_close(pg, jg, names, 1e-4)
    bg_grads = [g for n, g in zip(names, pg) if "bg_net" in n]
    assert all(bool(g.any()) == use_net for g in bg_grads)


def test_the_fused_tail_runs_no_kernel_on_the_cpu():
    """The CPU twins run, not the kernels: the counters stay at zero."""
    jr, params, pr = _renderer_pair(1e-4)
    ro, rd, light, z, deltas = _rays(8)
    kernels.reset_launch_counts()
    out = pr._shade_and_composite(
        RenderFlags(need_loss_orient=True), tt(ro), tt(rd), tt(z),
        tt(deltas), None, tt(light), 0.5, 1, None, None,
        torch.tensor(True), xyzs=_positions(pr, ro, rd, z))
    (out["image"].sum() + out["loss_orient"]).backward()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
