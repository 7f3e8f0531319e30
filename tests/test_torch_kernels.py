"""Port parity of the four kernels' plain versions (the path a CPU tensor
takes) against the JAX functions they replace, forward and backward.

K1 triplane encode, K2 occupancy march, K3 compositing, K4 field head.
Tolerances: K1 feat 1e-6, jacobian and dplanes 1e-5 rel; K2 z and deltas
1e-5 (2e-4 for random draws, see test_k2_march), mask exact away from probe
edges and >= 99.9% overall; K3 forward 1e-6, gradients 1e-5; K4 1e-6 rel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.core.math import safe_normalize as j_safe_normalize
from dreamfusion_tpu.core.sampling import near_far_from_bound
from dreamfusion_tpu.ops.activation import trunc_exp
from dreamfusion_tpu.ops.composite import composite_rays as j_composite
from dreamfusion_tpu.ops.occupancy import march_rays_occupancy as j_march
from dreamfusion_tpu.ops.triplane import TriplaneSpec as JSpec
from dreamfusion_tpu.ops.triplane import (triplane_encode as j_encode,
                                          triplane_encode_with_xgrad)
from dreamfusion_tpu_torch.core.sampling import det_u
from dreamfusion_tpu_torch.ops import kernels
from dreamfusion_tpu_torch.ops.activation import field_head, field_shade
from dreamfusion_tpu_torch.ops.composite import composite_rays
from dreamfusion_tpu_torch.ops.occupancy import (march_rays_occupancy,
                                                 probe_edges)
from dreamfusion_tpu_torch.ops.triplane import TriplaneSpec, triplane_encode

from torch_parity import tt

torch.set_num_threads(2)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=rtol)


# ---- K1 --------------------------------------------------------------------

def _k1_inputs(seed=0, n=256):
    rng = np.random.default_rng(seed)
    spec = TriplaneSpec(resolution=32, channels=8, num_scales=2)
    planes = [rng.normal(size=(3, r, r, 8)).astype(np.float32) * 0.1
              for r in spec.resolutions]
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    x[0] = [1.5, 0.5, 0.5]                  # out of bounds → zeros
    x[1] = [-0.1, 0.2, 0.3]
    x[2] = [0.5, 0.0, 1.0]                  # on the faces: jacobian masked
    x[3] = [0.25, 0.5, 0.75]                # exactly on lattice points
    return spec, planes, x


@pytest.mark.parametrize("max_level", [None, 0.5])
def test_k1_forward_and_jacobian(max_level):
    spec, planes, x = _k1_inputs()
    jspec = JSpec(resolution=32, channels=8, num_scales=2)
    ml = None if max_level is None else jnp.asarray(max_level)
    jf, jj = triplane_encode_with_xgrad(jnp.asarray(x), [jnp.asarray(p) for p
                                                          in planes], jspec,
                                        max_level=ml)
    jf_plain = j_encode(jnp.asarray(x), [jnp.asarray(p) for p in planes],
                        jspec, max_level=ml)
    pf, pj = triplane_encode(tt(x), [tt(p) for p in planes], spec,
                             max_level=max_level, need_jacobian=True)
    pf_only = triplane_encode(tt(x), [tt(p) for p in planes], spec,
                              max_level=max_level)
    close(pf, jf_plain, atol=1e-6)
    close(pf_only, jf_plain, atol=1e-6)
    assert (pf[:2] == 0).all()
    for a, b in zip(pj, jj):
        close(a, b, atol=1e-5, rtol=1e-5)


def test_k1_backward_dplanes():
    spec, planes, x = _k1_inputs(1)
    jspec = JSpec(resolution=32, channels=8, num_scales=2)
    rng = np.random.default_rng(2)
    cots = [rng.normal(size=(x.shape[0], spec.output_dim)).astype(np.float32)
            for _ in range(4)]

    def f(ps):
        feat, (jx, jy, jz) = triplane_encode_with_xgrad(jnp.asarray(x), ps,
                                                        jspec)
        return feat, jx, jy, jz

    _, vjp = jax.vjp(f, [jnp.asarray(p) for p in planes])
    (jg,) = vjp(tuple(jnp.asarray(c) for c in cots))
    pp = [tt(p).requires_grad_() for p in planes]
    pf, pj = triplane_encode(tt(x), pp, spec, need_jacobian=True)
    loss = sum((o * tt(c)).sum() for o, c in zip((pf, *pj), cots))
    pg = torch.autograd.grad(loss, pp)
    for a, b in zip(pg, jg):
        scale = float(np.abs(np.asarray(b)).max())
        close(a, b, atol=1e-5 * scale, rtol=1e-5)


# ---- K2 --------------------------------------------------------------------

def _k2_inputs(seed=3, R=512, G=30):
    # G=30 with 24 probes: a ray that crosses the box between opposite faces
    # puts probe midpoints at x = 1 - (2k+1)/24, never on a cell boundary
    # (multiples of 2/30).  With G=32 some land exactly on one, and the cell
    # then depends on the last bit of the probe position, which XLA's fused
    # multiply-adds round differently from eager torch.
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3)).astype(np.float32)
    ro = 3.0 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    tgt = rng.uniform(-0.6, 0.6, (R, 3)).astype(np.float32)
    rd = (tgt - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ax = (np.arange(G) + 0.5) / G * 2 - 1
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((X - 0.2) ** 2 + Y ** 2 + Z ** 2 < 0.3) | \
        (rng.uniform(size=X.shape) < 0.02)
    occ[0, :, :] = False
    ro[:8] = [5.0, 5.0, 5.0]                # misses: near = far = 1e9
    return ro, rd, occ[None]


def _edge_distance(z, near, far, P):
    """Distance of each sample from its nearest probe edge, in units of one
    probe interval."""
    t = (z - near) / np.maximum(far - near, 1e-12) * P
    return np.abs(t - np.round(t))


@pytest.mark.parametrize("mode,perturb", [("resample", True),
                                          ("resample", False),
                                          ("mask", False)])
def test_k2_march(mode, perturb):
    ro, rd, occ = _k2_inputs()
    R, P, S = ro.shape[0], 24, 16
    near, far = near_far_from_bound(jnp.asarray(ro), jnp.asarray(rd), 1.0,
                                    kind="cube", min_near=0.01)
    key = jax.random.PRNGKey(4)
    jo = j_march(key if perturb else None, jnp.asarray(ro), jnp.asarray(rd),
                 near, far, jnp.asarray(occ), 1.0, n_probe=P, n_fine=S,
                 perturb=perturb, mode=mode)
    if perturb:
        u = tt((jnp.arange(S) + jax.random.uniform(key, (R, S))) / S)
    else:
        u = det_u(R, S)
    po = march_rays_occupancy(tt(ro), tt(rd), tt(near), tt(far), tt(occ),
                              1.0, probe_edges(P), u, mode=mode)
    hit = np.asarray(far[:, 0]) < 1e8
    # XLA's cumsum rounds the CDF in another order than torch's; inverse-CDF
    # divides that by the interval's probability, which is as small as
    # 1e-3 / P in an empty interval, so a random draw landing there moves by
    # up to ~1e-4 (one ulp of the CDF / 4e-5, times a 0.1-wide interval).
    # Draws at stratum centres stay in occupied intervals here: 1e-5.
    atol = 2e-4 if perturb else 1e-5
    close(po.z_vals.numpy()[hit], np.asarray(jo.z_vals)[hit], atol=atol,
          rtol=1e-6)
    close(po.deltas.numpy()[hit], np.asarray(jo.deltas)[hit], atol=atol,
          rtol=1e-6)
    pm, jm = po.mask.numpy(), np.asarray(jo.mask)
    assert (pm == jm).mean() >= 0.999
    away = _edge_distance(np.asarray(jo.z_vals), np.asarray(near),
                          np.asarray(far), P) > 1e-3
    np.testing.assert_array_equal(pm[away], jm[away])
    assert jm.any() and not jm.all()


# ---- K3 --------------------------------------------------------------------

def _k3_inputs(seed=5, R=64, S=24):
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.normal(1.0, 1.5, (R, S))).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2, 4, (R, S)), -1).astype(np.float32)
    deltas = np.concatenate([np.diff(z, axis=-1), np.full((R, 1), 0.05)],
                            -1).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.8
    return sigma, rgb, z, deltas, mask


@pytest.mark.parametrize("t_thresh,binarize,use_mask",
                         [(1e-4, False, True), (0.0, False, False),
                          (1e-4, True, True)])
def test_k3_composite_forward_and_grads(t_thresh, binarize, use_mask):
    sigma, rgb, z, deltas, mask = _k3_inputs()
    m = mask if use_mask else None
    rng = np.random.default_rng(6)
    R, S = sigma.shape
    cots = (rng.normal(size=(R, 3)), rng.normal(size=(R,)),
            rng.normal(size=(R, S)), rng.normal(size=(R,)))
    cots = tuple(c.astype(np.float32) for c in cots)

    def f(s, c):
        return tuple(j_composite(s, c, jnp.asarray(z), jnp.asarray(deltas),
                                 None if m is None else jnp.asarray(m),
                                 t_thresh=t_thresh, binarize=binarize))

    jout, vjp = jax.vjp(f, jnp.asarray(sigma), jnp.asarray(rgb))
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    ps, pc = tt(sigma).requires_grad_(), tt(rgb).requires_grad_()
    pout = composite_rays(ps, pc, tt(z), tt(deltas),
                          None if m is None else tt(m), t_thresh=t_thresh,
                          binarize=binarize)
    for a, b in zip(pout, jout):
        close(a.detach(), b, atol=1e-6, rtol=1e-6)
    loss = sum((o * tt(c)).sum() for o, c in zip(pout, cots))
    pg = torch.autograd.grad(loss, (ps, pc))
    for a, b in zip(pg, jg):
        close(a, b, atol=1e-5, rtol=1e-5)


# ---- K4 --------------------------------------------------------------------

def test_k4_field_head_forward_grad_and_dsig_grad():
    """field_head's sigma and albedo and their gradient against JAX; dsig's
    own gradient (exp(pre)·[pre < 15], across the clamp) through
    field_shade's normal, at tangents so small that |g|² < 1e-20: there the
    normal is -g·1e10, proportional to dsig."""
    rng = np.random.default_rng(7)
    N = 512
    h = rng.normal(0, 2, (N, 4)).astype(np.float32)
    h[:16, 0] = rng.uniform(14, 18, 16)          # across the clamp at 15
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    t = (rng.normal(size=(3, N, 4)) * 1e-18).astype(np.float32)
    a, b, c = (rng.normal(size=s).astype(np.float32)
               for s in ((N,), (N, 3), (N, 3)))
    bd, br, bound = 5.0, 0.2, 1.0

    def j_head(hh):
        d = jnp.sum(jnp.asarray(x) ** 2, -1)
        pre = hh[:, 0] + bd * jnp.exp(-d / (2 * br ** 2))
        _, act_vjp = jax.vjp(trunc_exp, pre)
        (dsig,) = act_vjp(jnp.ones_like(pre))
        g = jnp.asarray(t)[..., 0].T * dsig[:, None] / (2 * bound)
        normal = jnp.nan_to_num(j_safe_normalize(-g))
        return trunc_exp(pre), jax.nn.sigmoid(hh[:, 1:]), normal

    def j_loss(hh):
        s, al, n = j_head(hh)
        return jnp.sum(s * a) + jnp.sum(al * b) + jnp.sum(n * c)

    ph = tt(h).requires_grad_()
    sigma, albedo = field_head(ph, tt(x), bd, br)
    normal = field_shade(ph, tt(t), tt(x), None, 1.0, 0, bd, br, bound)[2]
    for o, r in zip((sigma, albedo, normal), j_head(jnp.asarray(h))):
        close(o.detach(), r, atol=1e-6, rtol=1e-6)
    assert float(normal.detach().abs().max()) > 1e-3
    loss = (sigma * tt(a)).sum() + (albedo * tt(b)).sum() + \
        (normal * tt(c)).sum()
    (g,) = torch.autograd.grad(loss, ph)
    close(g, jax.grad(j_loss)(jnp.asarray(h)), atol=1e-6, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """No kernel launches for CPU tensors: the counters stay at zero."""
    kernels.reset_launch_counts()
    spec, planes, x = _k1_inputs()
    pp = [tt(p).requires_grad_() for p in planes]
    triplane_encode(tt(x), pp, spec).sum().backward()
    field_head(torch.randn(8, 4), torch.rand(8, 3), 5.0, 0.2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
