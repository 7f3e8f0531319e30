"""K2's march region (``ops/occupancy.py::march_region``: the cube's
near/far, the march and the clamped sample positions in one call) against
the JAX functions it replaces, on the CPU, where the plain version runs:
``near_far_from_bound`` → ``march_rays_occupancy`` → ``clip(o + d·z)``,
with the same seeded inputs and draws.

Cases: 24, 32 and 48 probes; 16 and 40 samples; resample mode with
stratified and with deterministic draws, and mask mode; uniform and
geometric (dt_gamma 0.05) probe spacing; rays that miss the box; a draw
above the CDF's last value (the tail rule: below = P, the last edge).

Tolerances: ``test_torch_kernels.py::test_k2_march``'s, 2e-4 with
stratified draws and 1e-5 at the stratum centres (rtol 1e-6), on z, the
positions and the deltas of every sample in an occupied probe interval and
of the misses.  A sample in an empty interval is where the recorded
inverse-CDF difference lives (ROADMAP queue 3): XLA sums the CDF in
another order, and the interval's probability, down to 1e-3/P, divides
that rounding (up to 1e-3 in z at P = 48 here).  There z is held in the
space where the two agree: its float64 CDF value, within the rounding of
two P-term fp32 sums (2·P·2^-24).  The positions are clamp(o + d·z) of the
port's own z exactly; the mask equal on at least 99.9% of the samples and
exactly where a sample lies more than 1e-3 of an interval from a probe
edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.core.sampling import near_far_from_bound
from dreamfusion_tpu.ops.occupancy import march_rays_occupancy as j_march
from dreamfusion_tpu_torch.core.sampling import det_u
from dreamfusion_tpu_torch.ops import kernels
from dreamfusion_tpu_torch.ops.occupancy import (march_plain, march_region,
                                                 probe_edges)

from torch_parity import tt

torch.set_num_threads(2)

BOUND, MIN_NEAR = 1.0, 0.01


def _inputs(seed=3, R=512, G=30):
    # G = 30: probe midpoints of rays that cross the box between opposite
    # faces sit at 1 - (2k+1)/P, never on a cell boundary (multiples of
    # 2/30) for P = 24, 32 or 48 (test_k2_march's reason)
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


def _edge_distance(z, near, far, P, edges):
    """Distance of each sample from its nearest probe edge, in units of one
    probe interval (about the sample's own interval for geometric edges)."""
    t = (z - near) / np.maximum(far - near, 1e-12)
    i = np.clip(np.searchsorted(edges, t), 1, P)
    width = edges[i] - edges[i - 1]
    return np.minimum(np.abs(t - edges[i - 1]), np.abs(edges[i] - t)) / width


def _jax_region(ro, rd, occ, P, S, perturb, mode, dt_gamma, key,
                min_near=MIN_NEAR):
    near, far = near_far_from_bound(jnp.asarray(ro), jnp.asarray(rd), BOUND,
                                    kind="cube", min_near=min_near)
    jo = j_march(key if perturb else None, jnp.asarray(ro), jnp.asarray(rd),
                 near, far, jnp.asarray(occ), BOUND, n_probe=P, n_fine=S,
                 perturb=perturb, mode=mode, dt_gamma=dt_gamma)
    xyzs = jnp.clip(jnp.asarray(ro)[:, None, :] + jnp.asarray(rd)[:, None, :]
                    * jo.z_vals[..., None], -BOUND, BOUND)
    return np.asarray(near), np.asarray(far), jo, np.asarray(xyzs)


def _cdf64(z, near, far, occ, edges):
    """The probe profile's piecewise-linear CDF at z [R, S], in float64."""
    R, P = occ.shape
    e = near + (far - near) * edges.astype(np.float64)[None]      # [R, P+1]
    w = occ.astype(np.float64) + 1e-3 + 1e-5
    p = w / w.sum(-1, keepdims=True)
    c = np.concatenate([np.zeros((R, 1)), np.cumsum(p, -1)], -1)
    j = np.clip((e[:, None, :] <= z[..., None]).sum(-1) - 1, 0, P - 1)
    lo, hi = (np.take_along_axis(e, j + k, 1) for k in (0, 1))
    t = np.clip((z - lo) / np.maximum(hi - lo, 1e-30), 0, 1)
    return np.take_along_axis(c, j, 1) + t * np.take_along_axis(p, j, 1)


def _check(po, pxyz, jo, jxyz, near, far, probes, edges, ro, rd, atol,
           mask_mode=False):
    close = lambda a, b, t=atol: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), atol=t,
        rtol=1e-6)
    P = edges.shape[0] - 1
    pz, jz = po.z_vals.numpy(), np.asarray(jo.z_vals)
    pm, jm = po.mask.numpy(), np.asarray(jo.mask)
    miss = np.broadcast_to(far >= 1e8, jm.shape)
    # occupied intervals and misses; in mask mode the probes themselves
    held = jm | miss | mask_mode
    close(pz[held], jz[held])
    close(pxyz.numpy()[held], jxyz[held])
    pair = held[:, 1:] & held[:, :-1]
    close(po.deltas.numpy()[:, :-1][pair], np.asarray(jo.deltas)[:, :-1][pair])
    close(po.deltas.numpy()[:, -1], np.asarray(jo.deltas)[:, -1])
    if not mask_mode:
        np.testing.assert_array_equal(po.deltas.numpy()[:, :-1],
                                      np.diff(pz, axis=-1))
    free = ~held
    if free.any():
        hit = ~miss[:, 0]
        fp = _cdf64(pz[hit].astype(np.float64), near[hit], far[hit],
                    probes[hit], edges)
        fj = _cdf64(jz[hit].astype(np.float64), near[hit], far[hit],
                    probes[hit], edges)
        close(fp[free[hit]], fj[free[hit]], 2 * P * 2.0 ** -24)
    want = torch.clamp(torch.from_numpy(ro)[:, None] + torch.from_numpy(rd)[
        :, None] * po.z_vals[..., None], -BOUND, BOUND)
    assert torch.equal(pxyz, want)
    assert po.mask.dtype == torch.bool
    assert (pm == jm).mean() >= 0.999
    away = _edge_distance(jz, near, far, P, edges) > 1e-3
    np.testing.assert_array_equal(pm[away], jm[away])
    assert jm.any() and not jm.all()


def _probes(ro, rd, near, far, occ, P, dt_gamma):
    """JAX's probe occupancy [R, P] (its mask mode)."""
    return np.asarray(j_march(None, jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(near), jnp.asarray(far),
                              jnp.asarray(occ), BOUND, n_probe=P, n_fine=P,
                              mode="mask", dt_gamma=dt_gamma).mask)


CASES = [("resample", perturb, P, S, g)
         for perturb in (True, False) for P in (24, 32, 48) for S in (16, 40)
         for g in (0.0, 0.05)] + \
    [("mask", False, P, P, g) for P in (24, 32, 48) for g in (0.0, 0.05)]


@pytest.mark.parametrize("mode,perturb,P,S,dt_gamma", CASES)
def test_region_matches_jax(mode, perturb, P, S, dt_gamma):
    ro, rd, occ = _inputs()
    R = ro.shape[0]
    key = jax.random.PRNGKey(4)
    near, far, jo, jxyz = _jax_region(ro, rd, occ, P, S, perturb, mode,
                                      dt_gamma, key)
    if mode == "mask":
        u = None
    elif perturb:
        u = tt((jnp.arange(S) + jax.random.uniform(key, (R, S))) / S)
    else:
        u = det_u(1, S)[0]                  # one row for every ray
    edges = probe_edges(P, dt_gamma)
    kernels.reset_launch_counts()
    po, pxyz = march_region(tt(ro), tt(rd), tt(occ), BOUND, MIN_NEAR, edges,
                            u, mode=mode)
    assert not any(kernels.LAUNCHES.values())   # the plain version ran
    assert pxyz.shape == (R, S, 3) and po.z_vals.shape == (R, S)
    # the misses: every sample at 1e9, on both sides
    assert (po.z_vals.numpy()[:8] == 1e9).all()
    _check(po, pxyz, jo, jxyz, near, far,
           _probes(ro, rd, near, far, occ, P, dt_gamma), edges.numpy(), ro,
           rd, 2e-4 if perturb else 1e-5, mode == "mask")


def _cdf_last(occ: torch.Tensor) -> torch.Tensor:
    """cdf[P] per ray, summed in the plain version's order."""
    w = occ.float() + 1e-3 + 1e-5
    total = w[:, 0]
    for i in range(1, w.shape[1]):
        total = total + w[:, i]
    pdf = w / total[:, None]
    c = torch.zeros_like(total)
    for i in range(w.shape[1]):
        c = c + pdf[:, i]
    return c


def test_region_tail_draw_matches_jax(monkeypatch):
    """The last stratum's draw at the top of [0, 1): on rays whose CDF
    sums to at most that draw, below = P and the sample is the last edge
    on both sides."""
    ro, rd, occ = _inputs(seed=5)
    R, P, S = ro.shape[0], 32, 16
    unit = np.random.default_rng(6).uniform(size=(R, S)).astype(np.float32)
    unit[:, -1] = np.nextafter(np.float32(1), np.float32(0))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(unit))
    key = jax.random.PRNGKey(0)
    near, far, jo, jxyz = _jax_region(ro, rd, occ, P, S, True, "resample",
                                      0.0, key)
    u = tt((jnp.arange(S) + jnp.asarray(unit)) / S)
    edges = probe_edges(P)
    po, pxyz = march_region(tt(ro), tt(rd), tt(occ), BOUND, MIN_NEAR, edges,
                            u)
    probes = march_plain(tt(ro), tt(rd), tt(near), tt(far), tt(occ), BOUND,
                         edges, None, "mask").mask
    hit = far[:, 0] < 1e8
    tail = (u[:, -1] >= _cdf_last(probes)).numpy() & hit
    assert tail.sum() >= 10
    last_edge = torch.tensor(near + (far - near) * 1.0)[:, 0]
    assert bool((po.z_vals[tail, -1] == last_edge[tail]).all())
    _check(po, pxyz, jo, jxyz, near, far, probes.numpy(), edges.numpy(), ro,
           rd, 2e-4)


def test_region_with_near_clamped_past_far_matches_jax():
    """Rays from inside the box with min_near past their exit: near is
    clamped beyond far, so the probe edges descend (the kernel counts them
    by ballots there)."""
    rng = np.random.default_rng(8)
    R, P, S, min_near = 256, 32, 16, 0.6
    ro = rng.uniform(-0.9, 0.9, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    _, _, occ = _inputs(R=8)
    occ = occ.copy()
    occ[0, 20:, :, :] = True                  # the +x side is occupied
    key = jax.random.PRNGKey(9)
    near, far, jo, jxyz = _jax_region(ro, rd, occ, P, S, False, "resample",
                                      0.0, key, min_near)
    assert (near > far).any()
    po, pxyz = march_region(tt(ro), tt(rd), tt(occ), BOUND, min_near,
                            probe_edges(P), det_u(1, S)[0])
    np.testing.assert_allclose(po.z_vals.numpy(), np.asarray(jo.z_vals),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(pxyz.numpy(), jxyz, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(po.mask.numpy(), np.asarray(jo.mask))


def test_region_takes_any_ray_strides():
    """Origins as a broadcast row (what ``get_rays`` gives one view) and
    draws with a row stride: the same result as contiguous copies."""
    ro, rd, occ = _inputs(seed=7, R=64)
    o = tt(ro[20:21]).expand(64, 3)
    u = det_u(64, 24).contiguous()
    edges = probe_edges(32)
    a = march_region(o, tt(rd), tt(occ), BOUND, MIN_NEAR, edges, u)
    b = march_region(o.contiguous(), tt(rd), tt(occ), BOUND, MIN_NEAR, edges,
                     u[0])
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(x, y)


def test_region_refuses_an_unknown_mode():
    ro, rd, occ = _inputs(R=8)
    with pytest.raises(ValueError):
        march_region(tt(ro), tt(rd), tt(occ), BOUND, MIN_NEAR,
                     probe_edges(8), None, mode="dense")


def test_renderer_builds_its_march_constants_once():
    """The probe edges and the stratum centres are built once per device
    and kept: two renders reuse the same tensors."""
    from dreamfusion_tpu_torch.models.renderer import (NeRFRenderer,
                                                       RenderFlags)
    r = NeRFRenderer(bound=BOUND, min_near=MIN_NEAR, grid_probe_steps=24,
                     grid_fine_steps=16, backbone="triplane",
                     triplane_resolution=16, triplane_channels=4,
                     hidden_dim=16, num_layers=2)
    ro, rd, occ = _inputs(seed=9, R=32)
    first = r.march_consts(torch.device("cpu"))
    for _ in range(2):
        with torch.no_grad():
            out = r.render_grid(RenderFlags(shading_static_albedo=True),
                                tt(ro), tt(rd), tt(occ))
        assert out["image"].shape == (32, 3)
    assert r.march_consts(torch.device("cpu")) is first
    assert len(r._march_consts) == 1
    edges, centres = first
    assert torch.equal(edges, probe_edges(24))
    assert torch.equal(centres, det_u(3, 16)[0])
