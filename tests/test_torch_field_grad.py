"""The field encoders' backward, K1 (triplane) and K6 (hash grid), against
``jax.vjp`` of the JAX package's functions on the CPU, where the wrappers
take their plain versions: the table's gradient and the positions' in one
pass (``triplane_bwd_dx_plain``, ``hash_bwd_dx_plain``).

Both sides get the same seeded numpy inputs.  The coordinates include
exact ties: 0 and 1 on every axis, lattice points, the box's centre (where
the DMTet query puts its missed pixels) and samples outside the box.  At a
coordinate exactly 0, JAX's ``triplane_encode`` passes a quarter of the
interior slope to x (it clips twice, each clip halving at its tie); the
hash grid's clip passes half (``ops/hashgrid.py``'s rule).  Tolerance:
every value within 1e-5 of the reference's largest |value| plus 1e-5
relative (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops import hashgrid as JH
from dreamfusion_tpu.ops.triplane import TriplaneSpec as JSpec
from dreamfusion_tpu.ops.triplane import (triplane_encode as j_encode,
                                          triplane_encode_with_xgrad)
from dreamfusion_tpu_torch.ops import hashgrid as PH
from dreamfusion_tpu_torch.ops import kernels
from dreamfusion_tpu_torch.ops import triplane as PT

from torch_parity import tt

torch.set_num_threads(2)


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=1e-5)


def _tie_positions(rng, n):
    """n samples in [0, 1]³ with ties and a few outside the box."""
    x = rng.uniform(0.03, 0.97, (n, 3)).astype(np.float32)
    x[0] = (0.0, 0.4, 0.6)                  # x exactly 0
    x[1] = (0.3, 0.0, 0.0)                  # y and z exactly 0
    x[2] = (0.0, 0.0, 0.0)                  # a corner of the box
    x[3] = (1.0, 0.5, 0.2)                  # x exactly 1
    x[4] = (0.7, 1.0, 1.0)
    x[5] = (1.0, 1.0, 1.0)
    x[6] = (0.5, 0.5, 0.5)                  # the box's centre
    x[7:11] = (0.5, 0.5, 0.5)
    x[11] = (0.0, 1.0, 0.5)
    x[12] = (1.5, 0.5, 0.5)                 # outside: no gradient
    x[13] = (-1e-3, 0.5, 0.5)
    x[14] = (0.5, 1.0 + 1e-3, 0.0)
    x[15] = (0.25, 0.5, 0.75)               # on lattice points
    return x


# ---- K1 ---------------------------------------------------------------------

K1_CASES = {
    "R8C4": (8, 4, 1, None),
    "R32C8x2": (32, 8, 2, None),
    "R32C8x2-level": (32, 8, 2, 0.5),
    "R17C6": (17, 6, 1, None),
}


def _k1(name, seed=0, n=96):
    R, C, S, max_level = K1_CASES[name]
    rng = np.random.default_rng(seed)
    spec = PT.TriplaneSpec(resolution=R, channels=C, num_scales=S)
    jspec = JSpec(resolution=R, channels=C, num_scales=S)
    planes = [rng.normal(size=(3, r, r, C)).astype(np.float32) * 0.1
              for r in spec.resolutions]
    x = _tie_positions(rng, n)
    g = rng.normal(size=(n, spec.output_dim)).astype(np.float32)
    g[20:30] = 0.0                          # rows with a zero cotangent
    return spec, jspec, planes, x, g, max_level


@pytest.mark.parametrize("with_jacobian", [False, True])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_position_and_plane_grads_match_jax(name, with_jacobian):
    """dx and dplanes of the features, from triplane_encode (or the
    jacobian form, whose feature gradient into x JAX takes the same way)."""
    spec, jspec, planes, x, g, max_level = _k1(name)
    ml = None if max_level is None else jnp.float32(max_level)

    def j_feat(xx, ps):
        if with_jacobian:
            return triplane_encode_with_xgrad(xx, ps, jspec, max_level=ml)[0]
        return j_encode(xx, ps, jspec, max_level=ml)

    _, vjp = jax.vjp(j_feat, jnp.asarray(x), [jnp.asarray(p) for p in planes])
    jdx, jdp = vjp(jnp.asarray(g))
    xp = tt(x).requires_grad_()
    pp = [tt(p).requires_grad_() for p in planes]
    out = PT.triplane_encode(xp, pp, spec, max_level=max_level,
                             need_jacobian=with_jacobian)
    feat = out[0] if with_jacobian else out
    dx, *dp = torch.autograd.grad(feat, [xp, *pp], tt(g), allow_unused=True)
    close(dx.numpy(), jdx)
    for a, b in zip(dp, jdp):
        if a is None:                       # a scale masked by max_level
            assert not np.asarray(b).any()
        else:
            close(a.numpy(), b)
    assert not dx[12:15].any() and not dx[20:30].any()


def test_k1_tie_at_zero_is_a_quarter_of_the_slope():
    """The coordinate-0 case on its own: JAX's slope there is a quarter of
    the slope just inside, and so is the port's."""
    spec, jspec, planes, _, _, _ = _k1("R8C4")
    x = np.array([[0.0, 0.3, 0.6], [1e-6, 0.3, 0.6]], np.float32)
    g = np.ones((2, spec.output_dim), np.float32)
    _, vjp = jax.vjp(lambda xx: j_encode(xx, [jnp.asarray(planes[0])], jspec),
                     jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xp = tt(x).requires_grad_()
    (dx,) = torch.autograd.grad(PT.triplane_encode(xp, [tt(planes[0])], spec),
                                [xp], tt(g))
    assert float(dx[0, 0]) != 0.0
    close(dx.numpy(), jdx)
    np.testing.assert_allclose(float(dx[0, 0]), float(dx[1, 0]) / 4,
                               rtol=1e-4)


def test_k1_bwd_dx_plain_agrees_with_the_table_only_route():
    spec, _, planes, x, g, _ = _k1("R32C8x2")
    p0 = tt(planes[0])
    C = spec.channels
    gf = tt(g[:, :3 * C])
    dp, dx = PT.triplane_bwd_dx_plain(tt(x), p0, gf)
    ref = PT.triplane_bwd_plain(tt(x), p0.shape, gf, (None,) * 3)
    torch.testing.assert_close(dp, ref, rtol=1e-6, atol=1e-7)
    assert dx.shape == (len(x), 3) and dx.dtype == torch.float32


# ---- K6 ---------------------------------------------------------------------

K6_SPECS = {
    "L4C8-affine-smooth": dict(num_levels=4, level_dim=8, log2_hashmap_size=12,
                               desired_resolution=128, gridtype="affine",
                               interpolation="smoothstep"),
    "L16C2-xor-linear": dict(num_levels=16, level_dim=2, log2_hashmap_size=10,
                             base_resolution=8, desired_resolution=256,
                             gridtype="hash", interpolation="linear"),
    "L8C4-affine-smooth": dict(num_levels=8, level_dim=4, log2_hashmap_size=10,
                               base_resolution=8, desired_resolution=64,
                               gridtype="affine", interpolation="smoothstep"),
}


@pytest.mark.parametrize("max_level", [None, 0.4])
@pytest.mark.parametrize("name", list(K6_SPECS))
def test_k6_position_and_table_grads_match_jax(name, max_level):
    js = JH.HashGridSpec(**K6_SPECS[name])
    ps = PH.HashGridSpec(**K6_SPECS[name])
    rng = np.random.default_rng(4)
    x = _tie_positions(rng, 129)
    table = rng.uniform(-0.1, 0.1, (ps.table_size, ps.level_dim)) \
        .astype(np.float32)
    g = rng.normal(size=(len(x), ps.output_dim)).astype(np.float32)
    g[20:30] = 0.0                          # rows with a zero cotangent
    ml = None if max_level is None else jnp.float32(max_level)
    _, vjp = jax.vjp(lambda xx, tb: JH.hash_encode(xx, tb, js, max_level=ml),
                     jnp.asarray(x), jnp.asarray(table))
    jdx, jdt = vjp(jnp.asarray(g))
    n_act = PH.n_active_levels(ps, max_level)
    dt, dx = PH.hash_bwd_dx_plain(tt(x), tt(table), ps, n_act, tt(g))
    close(dx.numpy(), jdx)
    close(dt.numpy(), jdt)
    assert not dx[12:15].any() and not dx[20:30].any()
    # and through autograd, as the field takes it
    xp, tp = tt(x).requires_grad_(), tt(table).requires_grad_()
    feat = PH.hash_encode(xp, tp, ps, max_level=max_level)
    ax, at = torch.autograd.grad(feat, [xp, tp], tt(g))
    torch.testing.assert_close(ax, dx, rtol=0, atol=0)
    torch.testing.assert_close(at, dt, rtol=0, atol=0)


def test_cpu_backwards_launch_nothing():
    """The CPU path of both position gradients launches no kernel."""
    kernels.reset_launch_counts()
    spec, _, planes, x, g, _ = _k1("R8C4")
    xp = tt(x).requires_grad_()
    torch.autograd.grad(PT.triplane_encode(xp, [tt(planes[0])], spec), [xp],
                        tt(g))
    ps = PH.HashGridSpec(**K6_SPECS["L8C4-affine-smooth"])
    table = torch.zeros(ps.table_size, ps.level_dim, requires_grad=True)
    PH.hash_encode(xp, table, ps).sum().backward()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
