"""Port parity of K6, the hash-grid encoder (``ops/hashgrid.py``), on the
CPU, where the wrappers take their plain versions.

Both sides get the same seeded numpy inputs.  Tolerances:
* features within 1e-6 abs (fp32, tables of ±0.1);
* the jacobian against ``jax.jvp`` along each axis, and the table gradient
  from random cotangents on the features and on the three jacobian columns
  against ``jax.vjp`` of that pair, within 1e-5 of the largest |value|;
* the position gradient against ``jax.vjp`` in x: 1e-5 of the largest;
* tv and wd values 1e-6 rel, their table gradients 1e-5 of the largest.
The specs have dense and hashed levels both (log2 size 10-12), affine and
xor hashes, linear and smoothstep weights; the samples include rows
outside the box and rows on its faces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops import hashgrid as J
from dreamfusion_tpu_torch.ops import hashgrid as P

from torch_parity import jax_tv_cells, tt

torch.set_num_threads(2)

SPECS = {
    "L4C8-affine-smooth": dict(num_levels=4, level_dim=8, log2_hashmap_size=12,
                               desired_resolution=128, gridtype="affine",
                               interpolation="smoothstep"),
    "L4C8-affine-linear": dict(num_levels=4, level_dim=8, log2_hashmap_size=11,
                               base_resolution=8, desired_resolution=96,
                               gridtype="affine", interpolation="linear"),
    "L16C2-xor-linear": dict(num_levels=16, level_dim=2, log2_hashmap_size=10,
                             base_resolution=8, desired_resolution=256,
                             gridtype="hash", interpolation="linear"),
    "L16C2-xor-smooth": dict(num_levels=16, level_dim=2, log2_hashmap_size=12,
                             desired_resolution=128, gridtype="hash",
                             interpolation="smoothstep"),
    "L8C4-affine-smooth": dict(num_levels=8, level_dim=4, log2_hashmap_size=10,
                               base_resolution=8, desired_resolution=64,
                               gridtype="affine", interpolation="smoothstep"),
}


def _inputs(spec, seed=0, n=257):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:12] = rng.uniform(-0.2, 1.2, (12, 3))          # some outside the box
    x[0] = (1.5, 0.5, 0.5)
    x[1] = (0.5, -1e-3, 0.5)
    x[12:30, 0] = 0.0                                  # on the faces
    x[30:48, 1] = 1.0
    x[48:60, 2] = 0.0
    x[60:66] = (1.0, 1.0, 0.0)                         # on an edge
    table = rng.uniform(-0.1, 0.1, (spec.table_size, spec.level_dim)) \
        .astype(np.float32)
    return x, table


def _j_encode(js, max_level):
    ml = None if max_level is None else jnp.float32(max_level)
    return lambda xx, tb: J.hash_encode(xx, tb, js, max_level=ml)


def _rel(a, b, frac):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=frac * max(np.abs(np.asarray(b)).max(),
                                               1e-30))


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_matches_jax(name):
    js, ps = J.HashGridSpec(**SPECS[name]), P.HashGridSpec(**SPECS[name])
    assert ps.resolutions == js.resolutions
    assert ps.level_sizes == js.level_sizes
    assert ps.offsets == js.offsets and ps.output_dim == js.output_dim
    dense = [ps.dense(l) for l in range(ps.num_levels)]
    assert any(dense) and not all(dense), dense


@pytest.mark.parametrize("name,max_level", [(n, None) for n in SPECS] + [
    ("L4C8-affine-smooth", 0.4), ("L16C2-xor-linear", 0.4)])
def test_hash_encode_values_jacobian_and_table_grad(name, max_level):
    js, ps = J.HashGridSpec(**SPECS[name]), P.HashGridSpec(**SPECS[name])
    x, table = _inputs(ps)
    f = _j_encode(js, max_level)
    xj, tj = jnp.asarray(x), jnp.asarray(table)
    ref = np.asarray(f(xj, tj))
    tab = tt(table).requires_grad_()
    feat, jac = P.hash_encode(tt(x), tab, ps, max_level=max_level,
                              need_jacobian=True)
    np.testing.assert_allclose(feat.detach().numpy(), ref, rtol=0, atol=1e-6)
    assert not ref[:2].any() and not feat[:2].detach().numpy().any()
    if max_level is not None:
        n_act = P.n_active_levels(ps, max_level)
        assert n_act < ps.num_levels
        assert not feat[:, n_act * ps.level_dim:].detach().numpy().any()

    def feat_and_jvps(tb):
        outs = [f(xj, tb)]
        for d in range(3):
            e = jnp.zeros_like(xj).at[:, d].set(1.0)
            outs.append(jax.jvp(lambda xx: f(xx, tb), (xj,), (e,))[1])
        return tuple(outs)

    rng = np.random.default_rng(1)
    cots = [rng.normal(size=ref.shape).astype(np.float32) for _ in range(4)]
    outs, vjp = jax.vjp(feat_and_jvps, tj)
    for d, jd in enumerate(outs[1:]):
        _rel(jac[d].detach().numpy(), jd, 1e-5)
    (jg,) = vjp(tuple(jnp.asarray(c) for c in cots))
    loss = sum((o * tt(c)).sum() for o, c in zip((feat, *jac), cots))
    (pg,) = torch.autograd.grad(loss, [tab])
    _rel(pg.numpy(), jg, 1e-5)


@pytest.mark.parametrize("name", ["L4C8-affine-smooth", "L16C2-xor-linear"])
def test_hash_encode_position_grad(name):
    js, ps = J.HashGridSpec(**SPECS[name]), P.HashGridSpec(**SPECS[name])
    x, table = _inputs(ps, seed=2)
    g = np.random.default_rng(3).normal(size=(len(x), ps.output_dim)) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda xx: J.hash_encode(xx, jnp.asarray(table), js),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xp = tt(x).requires_grad_()
    feat = P.hash_encode(xp, tt(table), ps)
    (dx,) = torch.autograd.grad(feat, [xp], tt(g))
    _rel(dx.numpy(), ref, 1e-5)
    assert not dx[:2].any()                           # outside: no gradient
    # the jacobian's own gradient into x: JAX's through jax.jvp along x
    _, vjp = jax.vjp(lambda xx: jax.jvp(
        lambda y: J.hash_encode(y, jnp.asarray(table), js), (xx,),
        (jnp.zeros_like(xx).at[:, 0].set(1.0),))[1], jnp.asarray(x))
    (ref,) = vjp(jnp.ones((len(x), ps.output_dim), jnp.float32))
    _, jac = P.hash_encode(xp, tt(table), ps, need_jacobian=True)
    (dx,) = torch.autograd.grad(jac[0].sum(), [xp])
    _rel(dx.numpy(), ref, 1e-5)


def test_outside_rows_give_zeros_and_no_table_grad():
    ps = P.HashGridSpec(**SPECS["L4C8-affine-smooth"])
    _, table = _inputs(ps)
    x = torch.tensor([[1.01, 0.5, 0.5], [0.5, -0.01, 0.2],
                      [0.3, 0.3, 2.0]])
    tab = tt(table).requires_grad_()
    feat, jac = P.hash_encode(x, tab, ps, need_jacobian=True)
    for o in (feat, *jac):
        assert torch.equal(o, torch.zeros_like(o))
    (g,) = torch.autograd.grad(feat.sum() + sum(j.sum() for j in jac), [tab])
    assert torch.equal(g, torch.zeros_like(g))


def test_face_band_has_zero_jacobian():
    """On the box's faces the derivative along the face normal is zero on
    every level (pos is clipped there)."""
    ps = P.HashGridSpec(**SPECS["L4C8-affine-smooth"])
    _, table = _inputs(ps)
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(0))
    x[:32, 0] = 0.0
    x[32:, 0] = 1.0
    _, (jx, jy, _) = P.hash_encode(x, tt(table), ps, need_jacobian=True)
    assert torch.equal(jx, torch.zeros_like(jx))
    assert jy.abs().max() > 0


@pytest.mark.parametrize("name", ["L4C8-affine-smooth", "L16C2-xor-linear",
                                  "L8C4-affine-smooth"])
def test_tv_and_wd_losses(name):
    js, ps = J.HashGridSpec(**SPECS[name]), P.HashGridSpec(**SPECS[name])
    _, table = _inputs(ps, seed=4)
    key = jax.random.PRNGKey(7)
    tj = jnp.asarray(table)
    jv, jg = jax.value_and_grad(lambda tb: J.hashgrid_tv_loss(key, tb, js))(
        tj)
    cells = jax_tv_cells(key, js.resolutions)
    tab = tt(table).requires_grad_()
    pv = P.hashgrid_tv_loss(cells, tab, ps)
    (pg,) = torch.autograd.grad(pv, [tab])
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-6)
    _rel(pg.numpy(), jg, 1e-5)

    jv, jg = jax.value_and_grad(lambda tb: J.hashgrid_wd_loss(tb, js))(tj)
    pv = P.hashgrid_wd_loss(tab, ps)
    (pg,) = torch.autograd.grad(pv, [tab])
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-6)
    _rel(pg.numpy(), jg, 1e-5)


def test_tv_draws_lie_in_each_levels_lattice():
    ps = P.HashGridSpec(**SPECS["L16C2-xor-linear"])
    cells = P.draw_tv_cells(torch.Generator().manual_seed(0), ps, "cpu")
    assert cells.shape == (ps.num_levels, 4096, 3)
    for l, r in enumerate(ps.resolutions):
        assert 0 <= int(cells[l].min()) and int(cells[l].max()) < r - 1


def test_init_hashgrid_range():
    ps = P.HashGridSpec(**SPECS["L4C8-affine-smooth"])
    t = P.init_hashgrid(ps, torch.Generator().manual_seed(0))
    assert t.shape == (ps.table_size, ps.level_dim)
    assert t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5
