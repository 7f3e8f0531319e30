"""The field encoders' second derivative into the positions, K1 (triplane)
and K6 (hash grid), against ``jax.grad`` of the JAX package on the CPU,
where the wrappers take their plain versions (``triplane_bwd_dx_plain``,
``hash_bwd_dx_plain``).

The loss is Σ g_feat·feat + Σ_d g_d·j_d with seeded numpy cotangents on the
features and on the three jacobian columns (or on the jacobian alone): on
JAX's side over ``triplane_encode_with_xgrad`` and over ``hash_encode`` with
its jacobian from ``jax.jvp`` along each axis, on the port's over
``need_jacobian=True``.  Both the positions' gradient and the planes' or
table's are compared.  The positions include exact ties (0 and 1 on every
axis, the box's corner and centre), points on cell faces (the plane's or
level's lattice lines) and points outside [0, 1].  Tolerance: every value
within 1e-5 of the reference's largest |value| plus 1e-5 relative (fp32
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops import hashgrid as JH
from dreamfusion_tpu.ops.triplane import TriplaneSpec as JSpec
from dreamfusion_tpu.ops.triplane import triplane_encode_with_xgrad
from dreamfusion_tpu_torch.ops import hashgrid as PH
from dreamfusion_tpu_torch.ops import triplane as PT

from test_torch_field_grad import K1_CASES, _tie_positions
from torch_parity import tt

torch.set_num_threads(2)


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=1e-5)


def _cotangents(rng, n, dim, with_feat):
    cots = [rng.normal(size=(n, dim)).astype(np.float32) for _ in range(4)]
    for c in cots:
        c[20:24] = 0.0                      # rows with a zero cotangent
    if not with_feat:
        cots[0] = None
    return cots


def _loss(outs, cots, wrap):
    return sum((o * wrap(c)).sum() for o, c in zip(outs, cots)
               if c is not None)


# ---- K1 ---------------------------------------------------------------------

def _k1_positions(rng, n, R):
    x = _tie_positions(rng, n)
    lines = (np.arange(1, R - 1, dtype=np.float32) /
             np.float32(R - 1)).astype(np.float32)
    x[30:40, 0] = lines[rng.integers(0, len(lines), 10)]   # on cell faces
    x[40:46, 1:] = lines[rng.integers(0, len(lines), (6, 2))]
    return x


@pytest.mark.parametrize("with_feat", [True, False])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_second_derivative_matches_jax(name, with_feat):
    R, C, S, max_level = K1_CASES[name]
    rng = np.random.default_rng(11)
    spec = PT.TriplaneSpec(resolution=R, channels=C, num_scales=S)
    jspec = JSpec(resolution=R, channels=C, num_scales=S)
    planes = [rng.normal(size=(3, r, r, C)).astype(np.float32) * 0.1
              for r in spec.resolutions]
    n = 96
    x = _k1_positions(rng, n, R)
    cots = _cotangents(rng, n, spec.output_dim, with_feat)
    ml = None if max_level is None else jnp.float32(max_level)

    def j_loss(xx, ps):
        feat, jac = triplane_encode_with_xgrad(xx, ps, jspec, max_level=ml)
        return _loss((feat, *jac), cots, jnp.asarray)

    jdx, jdp = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(x), [jnp.asarray(p) for p in planes])
    xp = tt(x).requires_grad_()
    pp = [tt(p).requires_grad_() for p in planes]
    feat, jac = PT.triplane_encode(xp, pp, spec, max_level=max_level,
                                   need_jacobian=True)
    dx, *dp = torch.autograd.grad(_loss((feat, *jac), cots, tt),
                                  [xp, *pp], allow_unused=True)
    assert float(np.abs(np.asarray(jdx)).max()) > 0
    close(dx.numpy(), jdx)
    for a, b in zip(dp, jdp):
        if a is None:                       # a scale masked by max_level
            assert not np.asarray(b).any()
        else:
            close(a.numpy(), b)
    assert not dx[12:15].any() and not dx[20:24].any()


def test_k1_jacobian_alone_moves_x_by_the_mixed_term():
    """One plane, one channel, R = 2: with a cotangent on jy alone, the
    gradient along x (plane xy's u) is (R−1)²·(v00 − v01 − v10 + v11)·g."""
    spec = PT.TriplaneSpec(resolution=2, channels=1, num_scales=1)
    planes = torch.zeros(3, 2, 2, 1)
    planes[0, :, :, 0] = torch.tensor([[1.0, 2.0], [4.0, 8.0]])
    x = torch.tensor([[0.3, 0.6, 0.5]], requires_grad=True)
    _, (_, jy, _) = PT.triplane_encode(x, [planes], spec, need_jacobian=True)
    (dx,) = torch.autograd.grad(jy[0, 0], [x])
    assert float(dx[0, 0]) == pytest.approx(1.0 - 2.0 - 4.0 + 8.0)
    assert float(dx[0, 1]) == 0.0 and float(dx[0, 2]) == 0.0


# ---- K6 ---------------------------------------------------------------------

K6_SPECS = {
    "L4C8-affine-smooth": dict(num_levels=4, level_dim=8, log2_hashmap_size=12,
                               desired_resolution=128, gridtype="affine",
                               interpolation="smoothstep"),
    "L4C8-affine-linear": dict(num_levels=4, level_dim=8, log2_hashmap_size=11,
                               base_resolution=8, desired_resolution=96,
                               gridtype="affine", interpolation="linear"),
    "L4C2-xor-smooth": dict(num_levels=4, level_dim=2, log2_hashmap_size=10,
                            base_resolution=8, desired_resolution=128,
                            gridtype="hash", interpolation="smoothstep"),
    "L4C4-xor-linear": dict(num_levels=4, level_dim=4, log2_hashmap_size=10,
                            base_resolution=8, desired_resolution=64,
                            gridtype="hash", interpolation="linear"),
}


def _k6_inputs(ps, rng, n=160):
    x = _tie_positions(rng, n)
    res = ps.resolutions[0]
    # on level 0's cell faces: x * res - 0.5 an integer
    x[30:42, 0] = (rng.integers(0, res, 12) + 0.5) / res
    x[42:48] = (rng.integers(0, res, (6, 3)) + 0.5) / res
    table = rng.uniform(-0.1, 0.1, (ps.table_size, ps.level_dim)) \
        .astype(np.float32)
    return x.astype(np.float32), table


@pytest.mark.parametrize("with_feat", [True, False])
@pytest.mark.parametrize("name", list(K6_SPECS))
def test_k6_second_derivative_matches_jax(name, with_feat):
    js, ps = JH.HashGridSpec(**K6_SPECS[name]), PH.HashGridSpec(
        **K6_SPECS[name])
    rng = np.random.default_rng(13)
    x, table = _k6_inputs(ps, rng)
    n = len(x)
    cots = _cotangents(rng, n, ps.output_dim, with_feat)
    max_level = 0.75 if name.endswith("linear") else None
    ml = None if max_level is None else jnp.float32(max_level)

    def j_loss(xx, tb):
        f = lambda y: JH.hash_encode(y, tb, js, max_level=ml)
        feat = f(xx)
        jac = [jax.jvp(f, (xx,), (jnp.zeros_like(xx).at[:, d].set(1.0),))[1]
               for d in range(3)]
        return _loss((feat, *jac), cots, jnp.asarray)

    jdx, jdt = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(x),
                                                 jnp.asarray(table))
    xp = tt(x).requires_grad_()
    tab = tt(table).requires_grad_()
    feat, jac = PH.hash_encode(xp, tab, ps, max_level=max_level,
                               need_jacobian=True)
    dx, dt = torch.autograd.grad(_loss((feat, *jac), cots, tt), [xp, tab])
    assert float(np.abs(np.asarray(jdx)).max()) > 0
    close(dx.numpy(), jdx)
    close(dt.numpy(), jdt)
    assert not dx[12:15].any() and not dx[20:24].any()


def test_k6_smoothstep_pure_term_is_six_minus_twelve_t():
    """One dense level of res 2, one channel, a cotangent on jx alone: the
    gradient along x is ∂jx/∂x = Σ_k ∂w_k/∂s_x·v_k·(6 − 12t)·res²."""
    spec = PH.HashGridSpec(num_levels=2, level_dim=2, base_resolution=2,
                           log2_hashmap_size=4, desired_resolution=2,
                           interpolation="smoothstep")
    assert spec.dense(0) and spec.resolutions == (2, 2)
    table = torch.zeros(16, 2)
    table[1, 0] = 1.0                     # level 0, corner (1, 0, 0)
    x = torch.tensor([[0.6, 0.5, 0.5]], requires_grad=True)
    _, (jx, _, _) = PH.hash_encode(x, table, spec, max_level=0.5,
                                   need_jacobian=True)
    (dx,) = torch.autograd.grad(jx[0, 0], [x])
    t = 0.6 * 2 - 0.5                     # the fraction along x, y = z = 0.5
    want = 0.5 * 0.5 * (6.0 - 12.0 * t) * 4.0
    assert float(dx[0, 0]) == pytest.approx(want, rel=1e-5)
