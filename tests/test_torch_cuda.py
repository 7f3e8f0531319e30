"""The kernels against their plain versions on the card, at small and
ragged shapes (chip_smoke.py repeats this at the flagship shapes).  Skips
where there is no CUDA device.  The repository's conftest imports jax,
which a GPU host for the port need not have, so run there with:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from dreamfusion_tpu_torch.core.sampling import (det_u, near_far_from_bound,
                                                 stratified_u)
from dreamfusion_tpu_torch.ops import kernels
from dreamfusion_tpu_torch.core.math import safe_normalize
from dreamfusion_tpu_torch.ops.activation import (field_head,
                                                  field_head_bwd_plain,
                                                  field_head_fwd_plain,
                                                  field_shade,
                                                  field_shade_bwd_plain,
                                                  field_shade_fwd_plain)
from dreamfusion_tpu_torch.ops.composite import (_composite_fwd_cuda,
                                                 composite_bwd_plain,
                                                 composite_fwd_plain,
                                                 composite_rays)
from dreamfusion_tpu_torch.ops.occupancy import (march_plain, march_region,
                                                 march_region_cuda,
                                                 march_region_plain,
                                                 probe_edges)
from dreamfusion_tpu_torch.ops.attention import (attention,
                                                 attention_bwd_cuda,
                                                 attention_bwd_plain,
                                                 attention_bwd_route,
                                                 attention_fwd_cuda,
                                                 attention_plain)
from dreamfusion_tpu_torch.ops.conv import (conv2d, conv2d_plain, conv_route,
                                            norm_padding)
from dreamfusion_tpu_torch.ops.groupnorm import (group_norm, group_norm_plain,
                                                 group_norm_route, groups_for)
from dreamfusion_tpu_torch.ops.triplane import (TriplaneSpec,
                                                triplane_bwd_cuda,
                                                triplane_bwd_dx_cuda,
                                                triplane_bwd_dx_plain,
                                                triplane_bwd_plain,
                                                triplane_encode,
                                                triplane_fwd_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("R,C,N,dtype", [(32, 8, 1000, torch.float32),
                                         (64, 16, 4099, torch.bfloat16),
                                         (17, 6, 33, torch.float32),
                                         (13, 3, 257, torch.bfloat16),
                                         (20, 4, 515, torch.float32)])
def test_triplane_kernel(dev, R, C, N, dtype):
    g = _gen(dev)
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    x = torch.rand(N, 3, device=dev, generator=g)
    x[0] = torch.tensor([1.5, 0.5, 0.5])
    x[1] = torch.tensor([0.0, 1.0, 0.5])
    spec = TriplaneSpec(R, C, 1)
    p = planes.clone().requires_grad_()
    feat, jac = triplane_encode(x, [p], spec, out_dtype=dtype,
                                need_jacobian=True)
    torch.cuda.synchronize()
    ref = triplane_fwd_plain(x, planes, True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-2, rtol=1e-2)
    for a, b in zip((feat, *jac), ref):
        torch.testing.assert_close(a.float(), b.to(dtype).float(), **tol)
    cots = [torch.randn(N, 3 * C, device=dev, generator=g) for _ in range(4)]
    loss = sum((o.float() * c).sum() for o, c in zip((feat, *jac), cots))
    (dp,) = torch.autograd.grad(loss, [p])
    ref_dp = triplane_bwd_plain(x, planes.shape, cots[0].to(dtype),
                                [c.to(dtype) for c in cots[1:]])
    torch.testing.assert_close(dp, ref_dp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode,perturb,dt_gamma", [
    ("resample", True, 0.0), ("resample", False, 0.0),
    ("resample", True, 0.05), ("mask", False, 0.0)])
def test_march_kernel(dev, mode, perturb, dt_gamma):
    g = _gen(dev, 1)
    R, P, S, G = 3001, 32, 24, 48
    ro = torch.randn(R, 3, device=dev, generator=g)
    ro = 3.0 * ro / ro.norm(dim=-1, keepdim=True)
    rd = torch.rand(R, 3, device=dev, generator=g) - 0.5 - ro / 3.0
    occ = torch.rand(1, G, G, G, device=dev, generator=g) < 0.3
    near, far = near_far_from_bound(ro, rd, 1.0, "cube", 0.01)
    edges = probe_edges(P, dt_gamma, device=dev)
    u = stratified_u(torch.rand(R, S, device=dev, generator=g)) if perturb \
        else det_u(R, S, device=dev).contiguous()
    k, xk = march_region_cuda(ro, rd, occ, 1.0, 0.01, edges, u, mode)
    torch.cuda.synchronize()
    p, xp = march_region_plain(ro, rd, occ, 1.0, 0.01, edges, u, mode)
    same = (k.mask == p.mask).all(-1)
    assert same.float().mean() >= 0.999
    hit = (far[:, 0] < 1e8) & same
    # the kernel and the plain version form the CDF in the same order
    torch.testing.assert_close(k.z_vals[hit], p.z_vals[hit], atol=1e-5,
                               rtol=1e-6)
    torch.testing.assert_close(k.deltas[hit], p.deltas[hit], atol=1e-5,
                               rtol=1e-6)
    torch.testing.assert_close(xk[hit], xp[hit], atol=1e-5, rtol=1e-6)


def _region_inputs(dev, R, S, seed, tail=False):
    """Rays around the box (the first 7 miss it), a 48³ grid a third
    occupied, stratified draws [R, S]; with ``tail`` each ray's last draw
    at the top of [0, 1)."""
    g = _gen(dev, seed)
    ro = torch.randn(R, 3, device=dev, generator=g)
    ro = 3.0 * ro / ro.norm(dim=-1, keepdim=True)
    rd = torch.rand(R, 3, device=dev, generator=g) - 0.5 - ro / 3.0
    ro[:7] = 5.0                              # misses: near = far = 1e9
    occ = torch.rand(1, 48, 48, 48, device=dev, generator=g) < 0.3
    unit = torch.rand(R, S, device=dev, generator=g)
    if tail:
        unit[:, -1] = 1.0 - 2.0 ** -24
    return ro, rd, occ, stratified_u(unit)


def _same_region(k, p, xk, xp):
    """The kernel's region against the plain twin's: masks equal on 99.9%
    of the rays; z, deltas and positions within 1e-5 where they are (the
    same CDF order; the last delta's division may round apart)."""
    same = (k.mask == p.mask).all(-1)
    assert same.float().mean() >= 0.999
    assert k.mask.dtype == torch.bool
    for a, b in ((k.z_vals, p.z_vals), (k.deltas, p.deltas), (xk, xp)):
        torch.testing.assert_close(a[same], b[same], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("P", [32, 48, 64])
@pytest.mark.parametrize("S", [24, 56])
@pytest.mark.parametrize("mode,perturb", [("resample", True),
                                          ("resample", False),
                                          ("mask", False)])
def test_march_region_kernel(dev, P, S, mode, perturb):
    """K2's region (near/far, march, positions) in one launch against its
    plain twin, with misses and, perturbed, a draw above cdf[P] on every
    ray."""
    R = 3001
    ro, rd, occ, u = _region_inputs(dev, R, S, 11, tail=perturb)
    edges = probe_edges(P, device=dev)
    if mode == "mask":
        u = None
    elif not perturb:
        u = det_u(1, S, device=dev)[0].contiguous()
    kernels.reset_launch_counts()
    k, xk = march_region(ro, rd, occ, 1.0, 0.01, edges, u, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["march_rays"] == 1
    p, xp = march_region_plain(ro, rd, occ, 1.0, 0.01, edges, u, mode)
    _same_region(k, p, xk, xp)
    assert bool((k.z_vals[:7] == 1e9).all())
    if perturb:
        # the tail rule: where the last draw passes cdf[P] (summed in the
        # plain version's order), z is the last edge
        near, far = near_far_from_bound(ro, rd, 1.0, "cube", 0.01)
        probes = march_plain(ro, rd, near, far, occ, 1.0, edges, None,
                             "mask").mask
        w = probes.float() + 1e-3 + 1e-5
        total = w[:, 0]
        for i in range(1, P):
            total = total + w[:, i]
        c = torch.zeros_like(total)
        for i in range(P):
            c = c + w[:, i] / total
        tail = (u[:, -1] >= c) & (far[:, 0] < 1e8)
        assert int(tail.sum()) >= 10
        last = (near + (far - near) * edges[-1])[:, 0]
        assert torch.equal(k.z_vals[tail, -1], last[tail])


@pytest.mark.parametrize("P", [32, 48])
def test_march_region_counts_descending_edges(dev, P):
    """Rays from inside the box with min_near past their exit: near is
    clamped beyond far, the edges descend and the kernel counts a sample's
    interval by ballots; the region equals its twin's."""
    R, S = 999, 24
    g = _gen(dev, 15)
    ro = torch.rand(R, 3, device=dev, generator=g) * 1.8 - 0.9
    rd = torch.randn(R, 3, device=dev, generator=g)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    occ = torch.rand(1, 40, 40, 40, device=dev, generator=g) < 0.4
    u = stratified_u(torch.rand(R, S, device=dev, generator=g))
    edges = probe_edges(P, device=dev)
    near, far = near_far_from_bound(ro, rd, 1.0, "cube", 0.6)
    assert int((near > far).sum()) > 50
    k, xk = march_region_cuda(ro, rd, occ, 1.0, 0.6, edges, u)
    torch.cuda.synchronize()
    p, xp = march_region_plain(ro, rd, occ, 1.0, 0.6, edges, u)
    _same_region(k, p, xk, xp)


def test_march_region_takes_strided_rays_and_draws(dev):
    """A view's origins as a broadcast row with a column stride (what
    ``get_rays`` gives) and draws with a row stride: one launch, the same
    outputs as contiguous copies, bit for bit."""
    R, S = 1000, 24
    g = _gen(dev, 12)
    pose = torch.randn(1, 4, 4, device=dev, generator=g)
    ro = pose[:, None, :3, 3].expand(1, R, 3).reshape(-1, 3)
    assert ro.stride() == (0, 4)
    rd = torch.randn(R, 3, device=dev, generator=g) - ro / 3
    occ = torch.rand(1, 32, 32, 32, device=dev, generator=g) < 0.3
    big = stratified_u(torch.rand(R, 2 * S, device=dev, generator=g))
    u = big[:, :S]
    edges = probe_edges(32, device=dev)
    a = march_region_cuda(ro, rd, occ, 1.0, 0.01, edges, u)
    b = march_region_cuda(ro.contiguous(), rd, occ, 1.0, 0.01, edges,
                          u.contiguous())
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(x, y)


def test_march_region_replays_in_a_cuda_graph(dev):
    """The region's launch captured in a CUDA graph and replayed three
    times: the same outputs as an eager call, bit for bit."""
    R, S = 2048, 24
    ro, rd, occ, u = _region_inputs(dev, R, S, 13)
    edges = probe_edges(32, device=dev)
    want = march_region_cuda(ro, rd, occ, 1.0, 0.01, edges, u)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        march_region_cuda(ro, rd, occ, 1.0, 0.01, edges, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = march_region_cuda(ro, rd, occ, 1.0, 0.01, edges, u)
    for _ in range(3):
        for t in (*got[0], got[1]):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("perturb", [True, False])
def test_a_render_launches_the_march_once(dev, perturb):
    """One render (perturbed or at the stratum centres): one launch of
    ``march_rays``, the positions the shading reads its own."""
    from dreamfusion_tpu_torch.models.renderer import (NeRFRenderer,
                                                       RenderFlags)
    r = NeRFRenderer(bound=1.0, min_near=0.01, grid_probe_steps=32,
                     grid_fine_steps=24, backbone="triplane",
                     triplane_resolution=32, triplane_channels=8,
                     hidden_dim=16, num_layers=2).to(dev)
    R = 512
    ro, rd, occ, u = _region_inputs(dev, R, 24, 14)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = r.render_grid(RenderFlags(perturb=perturb,
                                        shading_static_albedo=True),
                            ro, rd, occ, march_u=u if perturb else None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["march_rays"] == 1
    assert out["image"].shape == (R, 3)
    assert bool(out["image"].isfinite().all())


@pytest.mark.parametrize("t_thresh,binarize,masked", [
    (1e-4, False, True), (0.0, False, False), (1e-4, True, True)])
def test_composite_kernel(dev, t_thresh, binarize, masked):
    g = _gen(dev, 2)
    R, S = 2049, 24
    sigma = torch.exp(torch.randn(R, S, device=dev, generator=g) * 1.5)
    rgb = torch.rand(R, S, 3, device=dev, generator=g)
    z = torch.sort(torch.rand(R, S, device=dev, generator=g) * 2 + 2)[0]
    deltas = torch.cat([z.diff(dim=-1), torch.full((R, 1), 0.05,
                                                   device=dev)], -1)
    mask = torch.rand(R, S, device=dev, generator=g) < 0.8 if masked else None
    s, c = sigma.clone().requires_grad_(), rgb.clone().requires_grad_()
    out = composite_rays(s, c, z, deltas, mask, t_thresh, binarize)
    ref = composite_fwd_plain(sigma, rgb, z, deltas, mask, t_thresh,
                              binarize)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    cots = (torch.randn(R, 3, device=dev, generator=g),
            torch.randn(R, device=dev, generator=g),
            torch.randn(R, S, device=dev, generator=g),
            torch.randn(R, device=dev, generator=g))
    loss = sum((o * c_).sum() for o, c_ in zip(out, cots))
    gk = torch.autograd.grad(loss, (s, c))
    gp = composite_bwd_plain(sigma, rgb, z, deltas, mask, ref.weights,
                             *cots, t_thresh)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("N,dtype", [(1000, torch.float32),
                                     (98305, torch.bfloat16)])
def test_field_head_kernel(dev, N, dtype):
    g = _gen(dev, 3)
    h = (torch.randn(N, 4, device=dev, generator=g) * 3).to(dtype)
    x = torch.rand(N, 3, device=dev, generator=g) * 2 - 1
    hh = h.clone().requires_grad_()
    out = field_head(hh, x, 5.0, 0.2)
    ref = field_head_fwd_plain(h, x, 5.0, 0.2)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=2e-5)
    cots = [torch.randn_like(o) for o in out]
    (gh,) = torch.autograd.grad(sum((o * c).sum() for o, c in
                                    zip(out, cots)), [hh])
    ref_g = field_head_bwd_plain(h, x, 5.0, 0.2, *cots).to(dtype)
    torch.testing.assert_close(gh.float(), ref_g.float(), atol=1e-4,
                               rtol=1e-2 if dtype == torch.bfloat16 else 2e-5)


# ---- K3 with the renderer's epilogue, K4 with the normals and shading ------

def _composite_inputs(dev, R, S, seed):
    """Densities, colours, sorted depths, a mask with every 7th ray fully
    masked and padded tails, unit normals and ray directions."""
    g = _gen(dev, seed)
    sigma = torch.exp(torch.randn(R, S, device=dev, generator=g) * 1.5)
    rgb = torch.rand(R, S, 3, device=dev, generator=g)
    z = torch.sort(torch.rand(R, S, device=dev, generator=g) * 2 + 2)[0]
    deltas = torch.cat([z.diff(dim=-1), torch.full((R, 1), 0.05,
                                                   device=dev)], -1)
    mask = torch.rand(R, S, device=dev, generator=g) < 0.8
    mask[::7] = False
    mask[1::2, -5:] = False
    normals = safe_normalize(torch.randn(R, S, 3, device=dev, generator=g))
    rays_d = torch.randn(R, 3, device=dev, generator=g) * 2
    return g, sigma, rgb, z, deltas, mask, normals, rays_d


def _background(form, R, dev, g):
    """composite_rays' background arguments in one of its forms."""
    if form == "none":
        return {}
    if form == "white":
        return {"bg_color": 1.0}
    rgb = torch.rand(3, device=dev, generator=g)
    if form == "rgb":
        return {"bg_color": rgb}
    if form == "per_ray":
        return {"bg_color": torch.rand(R, 3, device=dev, generator=g)}
    return {"bg_color": rgb, "bg_net": torch.rand(R, 3, device=dev,
                                                 generator=g),
            "use_bg_net": torch.tensor(form == "net_on", device=dev)}


@pytest.mark.parametrize("S,t_thresh,binarize", [
    (24, 1e-4, False), (32, 0.05, True), (56, 1e-4, False),
    (56, 0.0, True)])
@pytest.mark.parametrize("form", ["none", "white", "rgb", "per_ray",
                                  "net_on", "net_off"])
def test_composite_fused_kernel(dev, S, t_thresh, binarize, form):
    """K3 with the background and the orient loss against its plain twin:
    S = 56 takes two chunks with the scan's carry; R odd; rows with every
    sample masked; each background form."""
    R = 1001
    g, sigma, rgb, z, deltas, mask, normals, rays_d = _composite_inputs(
        dev, R, S, 4)
    bg = _background(form, R, dev, g)
    s, c, n = (t.clone().requires_grad_() for t in (sigma, rgb, normals))
    bgk = dict(bg)
    if "bg_net" in bg:
        bgk["bg_net"] = bg["bg_net"].clone().requires_grad_()
    kernels.reset_launch_counts()
    out = composite_rays(s, c, z, deltas, mask, t_thresh, binarize, **bgk,
                         normals=n, rays_d=rays_d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["composite_fwd"] == 1
    ref = composite_fwd_plain(sigma, rgb, z, deltas, mask, t_thresh,
                              binarize, **bg, normals=normals, rays_d=rays_d)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in ref]
    wrt = [s, c, n] + ([bgk["bg_net"]] if "bg_net" in bgk else [])
    gk = torch.autograd.grad(sum((o * ct).sum() for o, ct in zip(out, cots)),
                             wrt)
    assert kernels.LAUNCHES["composite_bwd"] == 1
    gp = composite_bwd_plain(sigma, rgb, z, deltas, mask, ref.weights,
                             *cots[:4], t_thresh, **bg, normals=normals,
                             rays_d=rays_d, g_loss=cots[4])
    for a, b in zip(gk, [x for x in gp if x is not None]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_composite_orient_mean_replays_in_a_cuda_graph(dev):
    """The orient mean's last-block counter resets itself: three replays of
    a captured forward give the eager loss bit for bit, and leave the
    counter at 0."""
    R, S = 4096, 24
    _, sigma, rgb, z, deltas, mask, normals, rays_d = _composite_inputs(
        dev, R, S, 5)

    def fwd():
        return _composite_fwd_cuda(sigma, rgb, z, deltas, mask, 1e-4, False,
                                   normals=normals, rays_d=rays_d)

    eager = fwd().loss_orient.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd()
    for _ in range(3):
        out.loss_orient.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.loss_orient, eager)
    assert int(kernels.zeroed(dev, "composite_done", 1)[0]) == 0
    ref = composite_fwd_plain(sigma, rgb, z, deltas, mask, 1e-4, False,
                              normals=normals, rays_d=rays_d)
    torch.testing.assert_close(eager, ref.loss_orient, atol=1e-6, rtol=1e-5)


def _shade_inputs(dev, R, S, dtype, seed):
    """h and tangents with rows where g = 0, where |g|² < 1e-20 and where
    pre crosses trunc_exp's clamp; x in the box; one light a ray."""
    g = _gen(dev, seed)
    N = R * S
    h = torch.randn(N, 4, device=dev, generator=g) * 2
    h[100:200, 0] = torch.rand(100, device=dev, generator=g) * 4 + 14
    t = torch.randn(3, N, 4, device=dev, generator=g)
    t[:, :100] = 0.0
    t[:, 200:300] *= 1e-18
    x = torch.rand(N, 3, device=dev, generator=g) * 2 - 1
    light = safe_normalize(torch.randn(R, 3, device=dev, generator=g))
    return g, h.to(dtype), t.to(dtype), x, light


def _rows_close(got, want, rows, rel):
    """Within rel of each row group's largest magnitude, elementwise."""
    for r in rows:
        a, b = got[..., r, :].float(), want[..., r, :].float()
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=rel * scale + 1e-30, rtol=rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shading", [0, 1, 2, 3])
@pytest.mark.parametrize("light", ["per_ray", "one", "none"])
def test_field_shade_kernel(dev, dtype, shading, light):
    """K4 with the normals and the shading against its plain twin, forward
    and backward, for each shading id, light form and dtype; ratio and the
    id as device tensors (per ray) or numbers; the ties: g = 0, |g|² below
    eps, pre across the clamp."""
    R, S = 333, 24
    g, h, t, x, light_d = _shade_inputs(dev, R, S, dtype, 6)
    light_d = {"per_ray": light_d, "one": light_d[0],
               "none": None}[light]
    as_tensor = light == "per_ray"
    ratio = torch.tensor(0.3, device=dev) if as_tensor else 0.3
    shade = torch.tensor(shading, device=dev) if as_tensor else shading
    hh, th = h.clone().requires_grad_(), t.clone().requires_grad_()
    kernels.reset_launch_counts()
    out = field_shade(hh, th, x, light_d, ratio, shade, 5.0, 0.2, 1.0)
    torch.cuda.synchronize()
    ref = field_shade_fwd_plain(h, t, x, light_d, ratio, shade, 5.0, 0.2,
                                1.0)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=2e-5)
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in ref]
    gh, gt = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(out, cots)), (hh, th))
    assert kernels.LAUNCHES["field_shade_fwd"] == 1
    assert kernels.LAUNCHES["field_shade_bwd"] == 1
    assert gh.dtype == dtype and gt.dtype == dtype
    assert not gt[..., 1:].any()
    ph, pt = field_shade_bwd_plain(h, t, x, light_d, ratio, shade, 5.0, 0.2,
                                   1.0, *cots)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    rows = (slice(0, 100), slice(100, 200), slice(200, 300),
            slice(300, None))
    _rows_close(gh, ph, rows, rel)
    _rows_close(gt, pt, rows, rel)


def test_render_tail_counts_its_launches(dev):
    """One shaded render tail (orient on, the background MLP drawn): K4's
    shade pair and K3 once each way, the head alone never; the density
    query (the refresh's and the DMTet albedo's) takes the head alone."""
    import dataclasses

    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.models.renderer import RenderFlags
    from dreamfusion_tpu_torch.training.trainer import build_renderer
    # the oracle's finalize turns the background MLP off: back on
    cfg = dataclasses.replace(finalize(Config(
        guidance=("oracle",), backbone="triplane", triplane_resolution=32,
        triplane_channels=8, hidden_dim=16)), bg_radius=1.4)
    r = build_renderer(cfg)
    r.field.reset_parameters(torch.Generator().manual_seed(0))
    r.to(dev)
    R, S = 64, 24
    _, _, _, z, deltas, mask, _, rd = _composite_inputs(dev, R, S, 7)
    ro = -rd * 1.5
    xyzs = torch.clamp(ro[:, None] + rd[:, None] * z[..., None], -r.bound,
                       r.bound)
    kernels.reset_launch_counts()
    out = r._shade_and_composite(
        RenderFlags(need_loss_orient=True), ro, rd, z, deltas, mask,
        safe_normalize(ro), torch.tensor(0.2, device=dev),
        torch.tensor(1, device=dev), None,
        torch.rand(3, device=dev).expand(R, 3), torch.tensor(True,
                                                             device=dev),
        xyzs=xyzs)
    (out["image"].sum() + out["loss_orient"]).backward()
    torch.cuda.synchronize()
    got = {k: kernels.LAUNCHES[k] for k in (
        "field_shade_fwd", "field_shade_bwd", "composite_fwd",
        "composite_bwd", "field_head_fwd", "field_head_bwd")}
    assert got == {"field_shade_fwd": 1, "field_shade_bwd": 1,
                   "composite_fwd": 1, "composite_bwd": 1,
                   "field_head_fwd": 0, "field_head_bwd": 0}
    assert float(r.field.bg_net.layers[0].weight.grad.abs().max()) > 0
    kernels.reset_launch_counts()
    x = (torch.rand(1000, 3, device=dev) * 2 - 1).requires_grad_()
    r.field.density(x)["albedo"].sum().backward()
    assert kernels.LAUNCHES["field_head_fwd"] == 1
    assert kernels.LAUNCHES["field_head_bwd"] == 1
    assert kernels.LAUNCHES["field_shade_fwd"] == 0


# ---- the vanilla render: K2's vanilla region, K4's options, K3 at S = 96 ---

def _vanilla_rays(dev, R, seed, strided=False):
    """Camera rays toward the unit sphere and, every 5th, rays from inside
    it (near < 0); with ``strided`` the origins are one broadcast row."""
    g = _gen(dev, seed)
    o = safe_normalize(torch.randn(R, 3, device=dev, generator=g)) * \
        (torch.rand(R, 1, device=dev, generator=g) * 0.5 + 3.0)
    o[::5] *= 0.1
    if strided:
        o = o[:1].expand(R, 3)
    d = safe_normalize(-o + 0.3 * torch.randn(R, 3, device=dev,
                                              generator=g))
    return g, o, d


@pytest.mark.parametrize("R,S,n", [(4096, 64, 32), (1001, 66, 64),
                                   (33, 3, 1)])
@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_vanilla_sampling_kernels(dev, R, S, n, perturb, strided):
    """K2's vanilla launches equal their plain twins bit for bit: z, the
    deltas and the positions; the sigma rows hold zeros, large values and
    (every 7th ray) all zeros."""
    from dreamfusion_tpu_torch.core.sampling import linspace
    from dreamfusion_tpu_torch.ops.resample import (vanilla_coarse,
                                                    vanilla_coarse_plain,
                                                    vanilla_resample,
                                                    vanilla_resample_plain)
    g, o, d = _vanilla_rays(dev, R, 8, strided)
    lin = linspace(0.0, 1.0, S, device=dev)
    u_c = torch.rand(R, S, device=dev, generator=g) if perturb else None
    u_p = stratified_u(torch.rand(R, n, device=dev, generator=g)) \
        if perturb else det_u(1, n, device=dev)[0]
    kernels.reset_launch_counts()
    zk, dk, xk = vanilla_coarse(o, d, 1.0, lin, u_c, need_deltas=True)
    zp, dp, xp = vanilla_coarse_plain(o, d, 1.0, lin, u_c, True)
    for a, b in ((zk, zp), (dk, dp), (xk, xp)):
        assert torch.equal(a, b)
    sigma = torch.exp(torch.randn(R, S, device=dev, generator=g) * 3)
    sigma[:, ::4] = 0.0
    sigma[::7] = 0.0
    out_k = vanilla_resample(o, d, 1.0, zk, sigma, u_p)
    out_p = vanilla_resample_plain(o, d, 1.0, zp, sigma, u_p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["vanilla_coarse"] == 1
    assert kernels.LAUNCHES["vanilla_resample"] == 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert out_k[0].shape == (R, S + n)


def test_vanilla_sampling_refuses_what_it_cannot_hold(dev):
    from dreamfusion_tpu_torch.core.sampling import linspace
    from dreamfusion_tpu_torch.ops.resample import (vanilla_coarse,
                                                    vanilla_resample)
    _, o, d = _vanilla_rays(dev, 8, 9)
    with pytest.raises(ValueError, match="num_steps 67"):
        vanilla_coarse(o, d, 1.0, linspace(0.0, 1.0, 67, device=dev))
    z = torch.rand(8, 64, device=dev).sort(-1)[0]
    with pytest.raises(ValueError, match="draws a ray"):
        vanilla_resample(o, d, 1.0, z, torch.ones_like(z),
                         det_u(1, 65, device=dev)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_field_head_softplus_kernel(dev, dtype):
    """K4's softplus route (softplus(x + 1) with the linear blob) alone and
    with the normals and the shading, against the plain twins."""
    g = _gen(dev, 10)
    N = 98305
    h = (torch.randn(N, 4, device=dev, generator=g) * 4).to(dtype)
    x = torch.rand(N, 3, device=dev, generator=g) * 2 - 1
    hh = h.clone().requires_grad_()
    out = field_head(hh, x, 10.0, 0.5, "softplus")
    ref = field_head_fwd_plain(h, x, 10.0, 0.5, "softplus")
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=2e-5)
    cots = [torch.randn_like(o) for o in out]
    (gh,) = torch.autograd.grad(sum((o * c).sum() for o, c in
                                    zip(out, cots)), [hh])
    ref_g = field_head_bwd_plain(h, x, 10.0, 0.5, *cots,
                                 act="softplus").to(dtype)
    torch.testing.assert_close(gh.float(), ref_g.float(), atol=1e-4,
                               rtol=1e-2 if dtype == torch.bfloat16 else 2e-5)
    R, S = 333, 24
    g, h, t, x, light_d = _shade_inputs(dev, R, S, dtype, 11)
    hh, th = h.clone().requires_grad_(), t.clone().requires_grad_()
    out = field_shade(hh, th, x, light_d, 0.3, 1, 10.0, 0.5, 1.0,
                      "softplus")
    ref = field_shade_fwd_plain(h, t, x, light_d, 0.3, 1, 10.0, 0.5, 1.0,
                                "softplus")
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=2e-5)
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in ref]
    gh, gt = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(out, cots)), (hh, th))
    ph, pt = field_shade_bwd_plain(h, t, x, light_d, 0.3, 1, 10.0, 0.5, 1.0,
                                   *cots, act="softplus")
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    rows = (slice(0, 100), slice(100, 200), slice(200, 300),
            slice(300, None))
    _rows_close(gh, ph, rows, rel)
    _rows_close(gt, pt, rows, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shading", [0, 1, 2, 3])
@pytest.mark.parametrize("act", ["exp", "softplus"])
def test_field_select_kernel(dev, dtype, shading, act):
    """K4's route with given normals (the finite-difference mode) against
    its plain twin, forward and backward into h and the normals; the
    normals hold zeros and a dot of exactly 0 with the light."""
    from dreamfusion_tpu_torch.ops.activation import (field_select,
                                                      field_select_bwd_plain,
                                                      field_select_fwd_plain)
    R, S = 333, 24
    g, h, _, x, light_d = _shade_inputs(dev, R, S, dtype, 12)
    normal = safe_normalize(torch.randn(R * S, 3, device=dev, generator=g))
    normal[:50] = 0.0
    shade = torch.tensor(shading, device=dev)
    ratio = torch.tensor(0.3, device=dev)
    hh, nn_ = h.clone().requires_grad_(), normal.clone().requires_grad_()
    kernels.reset_launch_counts()
    out = field_select(hh, nn_, x, light_d, ratio, shade, 5.0, 0.2, act)
    ref = field_select_fwd_plain(h, normal, x, light_d, ratio, shade, 5.0,
                                 0.2, act)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=2e-5)
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in ref]
    gh, gn = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(out, cots)), (hh, nn_))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["field_select_fwd"] == 1
    assert kernels.LAUNCHES["field_select_bwd"] == 1
    ph, pn = field_select_bwd_plain(h, normal, x, light_d, ratio, shade,
                                    5.0, 0.2, *cots, act=act)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    rows = (slice(0, 100), slice(100, 200), slice(200, None))
    _rows_close(gh, ph, rows, rel)
    torch.testing.assert_close(gn, pn, atol=1e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["white", "net_on", "per_ray"])
def test_composite_at_96_samples_without_a_mask(dev, form):
    """K3 at the vanilla render's [4096, 96] (three 32-sample chunks, no
    mask) with the background and the orient loss."""
    R, S = 4096, 96
    g, sigma, rgb, z, deltas, _, normals, rays_d = _composite_inputs(
        dev, R, S, 13)
    bg = _background(form, R, dev, g)
    s, c, n = (t.clone().requires_grad_() for t in (sigma, rgb, normals))
    out = composite_rays(s, c, z, deltas, None, 1e-4, False, **bg,
                         normals=n, rays_d=rays_d)
    ref = composite_fwd_plain(sigma, rgb, z, deltas, None, 1e-4, False, **bg,
                              normals=normals, rays_d=rays_d)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in ref]
    gk = torch.autograd.grad(sum((o * ct).sum() for o, ct in zip(out, cots)),
                             [s, c, n])
    gp = composite_bwd_plain(sigma, rgb, z, deltas, None, ref.weights,
                             *cots[:4], 1e-4, **bg, normals=normals,
                             rays_d=rays_d, g_loss=cots[4])
    for a, b in zip(gk, gp[:3]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("perturb", [False, True])
def test_a_vanilla_render_launches_its_kernels(dev, perturb):
    """One vanilla render: K2's coarse and resample launches once each, the
    coarse density through K4's head, the shading through K4's shade pair,
    K3 once each way; no occupancy march.  It runs as the plain twins do
    (image within 1e-4)."""
    import dataclasses

    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.models.renderer import RenderFlags
    from dreamfusion_tpu_torch.training.trainer import build_renderer
    cfg = dataclasses.replace(finalize(Config(
        guidance=("oracle",), backbone="vanilla", hidden_dim=32,
        fp16=False)), bg_radius=1.4)
    r = build_renderer(cfg)
    r.field.reset_parameters(torch.Generator().manual_seed(0))
    R = 512
    g, o, d = _vanilla_rays(dev, R, 14)
    draws = dict(march_u=torch.rand(R, 64, device=dev, generator=g),
                 pdf_u=stratified_u(torch.rand(R, 32, device=dev,
                                               generator=g))) \
        if perturb else {}
    kw = dict(light_d=safe_normalize(o), ambient_ratio=0.3,
              shading=torch.tensor(1, device=dev), max_level=0.5,
              bg_color=torch.rand(3, device=dev).expand(R, 3),
              use_bg_net=torch.tensor(True, device=dev), **draws)
    flags = RenderFlags(perturb=perturb, need_loss_orient=True)
    r.to(dev)
    kernels.reset_launch_counts()
    out = r.render(flags, o, d, None, **kw)
    (out["image"].sum() + out["loss_orient"]).backward()
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert got == {"vanilla_coarse": 1, "vanilla_resample": 1,
                   "field_head_fwd": 1, "field_shade_fwd": 1,
                   "field_shade_bwd": 1, "composite_fwd": 1,
                   "composite_bwd": 1}, got
    r.cpu()
    ref = r.render(flags, o.cpu(), d.cpu(), None,
                   **{k: v.cpu() if torch.is_tensor(v) else v
                      for k, v in kw.items()})
    torch.testing.assert_close(out["image"].cpu(), ref["image"], atol=1e-4,
                               rtol=1e-4)


def _field_positions(dev, g, N, case):
    """Positions for the backward routes: uniform with ties (coordinates
    exactly 0 and 1) and samples outside the box, or every sample at the
    box's centre (the DMTet query's missed pixels)."""
    if case.startswith("one_point"):
        return torch.full((N, 3), 0.5, device=dev)
    x = torch.rand(N, 3, device=dev, generator=g)
    x[0] = torch.tensor([1.5, 0.5, 0.5])              # outside
    x[1] = torch.tensor([0.5, -1e-3, 0.5])
    x[2:20, 0] = 0.0                                  # the coordinate-0 tie
    x[20:30, 1] = 1.0
    x[30] = torch.tensor([0.0, 0.0, 0.0])
    return x


def _field_cots(dev, g, x, D, case, dtype):
    """Cotangents [N, D] in `dtype`: random, with a band of all-zero rows;
    all zero but for every 7th row in the "one_point_sparse" case."""
    c = torch.randn(x.shape[0], D, device=dev, generator=g)
    if case == "one_point_sparse":
        c[torch.arange(x.shape[0], device=dev) % 7 != 0] = 0.0
    else:
        c[40:90] = 0.0
    return c.to(dtype)


def _term_magnitudes(monkeypatch, module, plain, *args):
    """Σ |term| for each value `plain(*args)` sums: the same plain backward
    with the corner weights and their derivatives (``module._corners``)
    and every cotangent (the tensors in `args` past the positions) taken by
    magnitude: the scale of an fp32 sum's rounding."""
    corners = module._corners

    def abs_corners(*a, **k):
        return tuple(t.abs() if t.is_floating_point() else t
                     for t in corners(*a, **k))

    def mag(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.abs()
        if isinstance(t, (list, tuple)):
            return type(t)(mag(u) for u in t)
        return t

    with monkeypatch.context() as m:
        m.setattr(module, "_corners", abs_corners)
        return plain(args[0], *(mag(a) for a in args[1:]))


def _close_to_terms(got, want, mag, rel):
    """Each value within `rel` of its terms' magnitude (`mag`:
    ``_term_magnitudes``) plus 1e-6 of the largest: fp32 sums of up to 200k
    terms in another order, by reductions in any order (sqrt(n)·2^-24 is
    2.7e-5 at 200k terms)."""
    bad = (got.float() - want.float()).abs() > \
        rel * mag + 1e-6 * float(mag.max())
    assert not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} values"


# N, case: ragged sizes, 200k samples at one point (all cotangents zero but
# every 7th row's, or all random), positions with ties and outside samples
FIELD_CASES = [(33, "ties"), (4099, "ties"), (200_000, "one_point_sparse"),
               (200_000, "one_point")]


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,case", FIELD_CASES)
@pytest.mark.parametrize("R,C", [(64, 16), (17, 6)])
def test_triplane_bwd_routes(dev, R, C, N, case, gdtype, monkeypatch):
    """triplane_bwd (4 cotangents) and triplane_bwd_dx (the features') in
    one launch each, against their plain versions."""
    from dreamfusion_tpu_torch.ops import triplane as K1
    g = _gen(dev, 3)
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    x = _field_positions(dev, g, N, case)
    cots = [_field_cots(dev, g, x, 3 * C, case, gdtype) for _ in range(4)]
    kernels.reset_launch_counts()
    dk = triplane_bwd_cuda(x, planes.shape, cots[0], cots[1:])
    dpk, dxk = triplane_bwd_dx_cuda(x, planes, cots[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["triplane_bwd"] == 1
    assert kernels.LAUNCHES["triplane_bwd_dx"] == 1
    dp = triplane_bwd_plain(x, planes.shape, cots[0], cots[1:])
    mag = _term_magnitudes(monkeypatch, K1, triplane_bwd_plain, x,
                           planes.shape, cots[0], cots[1:])
    _close_to_terms(dk, dp, mag, 1e-4)
    dpp, dxp = triplane_bwd_dx_plain(x, planes, cots[0])
    mag = _term_magnitudes(monkeypatch, K1, triplane_bwd_plain, x,
                           planes.shape, cots[0], (None,) * 3)
    _close_to_terms(dpk, dpp, mag, 1e-4)
    # dx: a sum of 3 planes x C channels x 4 corners a sample
    _close_to(dxk, dxp, 1e-5)
    if case == "ties":
        assert not dxk[:2].any() and not dxk[40:90].any()
        assert bool((dxk[2:20, 0] != 0).all())        # a quarter slope


def test_triplane_bwd_refuses_a_misaligned_table(dev):
    buf = torch.zeros(3 * 16 * 16 * 4 + 1, device=dev)
    planes = buf[1:].view(3, 16, 16, 4)
    x = torch.rand(8, 3, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        triplane_bwd_dx_cuda(x, planes, torch.ones(8, 12, device=dev))


def test_wrappers_count_their_launches(dev):
    kernels.reset_launch_counts()
    x = torch.rand(64, 3, device=dev)
    p = torch.zeros(3, 16, 16, 4, device=dev, requires_grad=True)
    triplane_encode(x, [p], TriplaneSpec(16, 4, 1)).sum().backward()
    assert kernels.LAUNCHES["triplane_fwd"] == 1
    assert kernels.LAUNCHES["triplane_bwd"] == 1


def _close_to(got, want, rel):
    """Within rel of the reference's largest magnitude, elementwise."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=rel * scale,
                               rtol=rel)


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad,dtype", [
    (2, 9, 11, 16, 32, 3, 1, 1, torch.bfloat16),
    (1, 16, 16, 32, 48, 3, 2, 1, torch.bfloat16),
    (1, 17, 15, 24, 136, 3, 2, ((0, 1), (0, 1)), torch.bfloat16),
    (2, 8, 8, 3, 128, 3, 1, 1, torch.bfloat16),
    (1, 12, 12, 16, 16, 1, 1, 0, torch.bfloat16),
    (2, 8, 8, 32, 4, 3, 1, 1, torch.float32),
    (1, 10, 10, 40, 8, 3, 1, 1, torch.float32),
    (1, 9, 9, 16, 12, 3, 1, 1, torch.bfloat16),        # dgrad on CUDA cores
    (2, 8, 8, 256, 160, 3, 1, 1, torch.bfloat16),      # split-K 9
    (1, 16, 16, 128, 256, 3, 2, 1, torch.bfloat16),    # dgrad split-K 4
])
def test_conv_kernel(dev, B, H, W, I, O, k, stride, pad, dtype):
    """K12 forward and dgrad through autograd: odd sizes, a partial N tile
    (48, 136, 160), stride 2 with symmetric and the VAE's (0, 1) padding, a
    3-channel input (the narrow-input wgmma route forward, the narrow
    dgrad), a bf16 dgrad with 12 channels (CUDA cores), fp32, and split-K
    (few output tiles, long K) forward (256 channels at stride 1 and 128 at
    stride 2: the wgmma route) and dgrad (the wgmma dgrad's four classes at
    stride 2)."""
    g = _gen(dev, 4)
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(dtype)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(dtype)
    bias = torch.randn(O, device=dev, generator=g)
    xr = x.clone().requires_grad_()
    y = conv2d(xr, w, bias, stride, pad)
    ref = conv2d_plain(x, w, bias, (stride, stride), norm_padding(pad), dtype)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    _close_to(y, ref, rel)
    dy = torch.randn(y.shape, device=dev, generator=g).to(dtype)
    (dx,) = torch.autograd.grad(y, xr, dy)
    xp = x.float().cpu().requires_grad_()
    yp = conv2d_plain(xp, w.cpu(), None, (stride, stride), norm_padding(pad),
                      torch.float32)
    (dxp,) = torch.autograd.grad(yp, xp, dy.float().cpu())
    _close_to(dx.cpu(), dxp, rel)


def _within_ulp(got, want, floor=1e-4):
    """One bf16 ulp (2^-7 relative) plus `floor` of the largest value."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=floor * scale,
                               rtol=2 ** -7)


def _border(y):
    """The first and last rows and columns of an NHWC tensor."""
    return torch.cat([y[:, 0].flatten(), y[:, -1].flatten(),
                      y[:, :, 0].flatten(), y[:, :, -1].flatten()])


@pytest.mark.parametrize("B,H,W,I,O,k,pad", [
    (1, 9, 11, 128, 200, 3, 1),        # odd grid: ragged pixel boxes
    (2, 7, 13, 320, 72, 3, 1),         # O below one N tile
    (2, 8, 8, 1280, 1280, 3, 1),       # the UNet's 8x8x1280: split-K 16
    (1, 5, 6, 1280, 136, 3, 1),        # split-K, ragged N
    (2, 16, 16, 192, 64, 1, 0),        # 1x1
    (1, 9, 10, 64, 100, 3, ((0, 1), (0, 1))),   # asymmetric padding
])
def test_conv_wgmma_kernel(dev, B, H, W, I, O, k, pad):
    """K12's Hopper route against the plain version: the padding comes from
    TMA's zero fill, so the border pixels are checked on their own; two
    launches agree bit for bit (split-K sums in a fixed order)."""
    assert conv_route(torch.bfloat16, I, O, (1, 1), k * k) == \
        "conv_fwd_wgmma"
    g = _gen(dev, 7)
    bf = torch.bfloat16
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(bf)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(bf)
    bias = torch.randn(O, device=dev, generator=g)
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, 1, pad)
    y2 = conv2d(x, w, bias, 1, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_fwd_wgmma"] == 2
    assert kernels.LAUNCHES["conv_fwd_mma"] == 0
    assert torch.equal(y, y2)
    ref = conv2d_plain(x, w, bias, (1, 1), norm_padding(pad), bf)
    assert y.shape == ref.shape
    _within_ulp(y, ref)
    _within_ulp(_border(y), _border(ref))


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad", [
    (2, 64, 64, 320, 320, 3, 2, 1),         # the UNet's downsamplers
    (2, 32, 32, 640, 640, 3, 2, 1),
    (2, 16, 16, 1280, 1280, 3, 2, 1),       # split-K 16
    (1, 512, 512, 128, 128, 3, 2, ((0, 1), (0, 1))),   # the VAE's
    (1, 256, 256, 256, 256, 3, 2, ((0, 1), (0, 1))),
    (1, 128, 128, 512, 512, 3, 2, ((0, 1), (0, 1))),   # split-K 2
    (1, 512, 512, 3, 128, 3, 1, 1),         # the VAE's conv_in
    (2, 64, 64, 4, 320, 3, 1, 1),           # the UNet's conv_in
    (1, 9, 11, 64, 72, 3, 2, 1),            # odd grids: ragged boxes
    (1, 9, 11, 64, 72, 3, 2, ((0, 1), (0, 1))),
    (2, 17, 15, 128, 136, 3, 2, 1),
    (1, 7, 13, 192, 64, 3, 2, ((0, 1), (0, 1))),
    (2, 7, 9, 3, 128, 3, 1, 1),
    (1, 9, 11, 8, 72, 3, 1, 1),             # 8 channels: x as it is
    (1, 12, 12, 3, 16, 1, 1, 0),            # 1x1: one tap
])
def test_conv_wgmma_strided_and_narrow(dev, B, H, W, I, O, k, stride, pad):
    """K12's wgmma routes at stride 2 (TMA's traversal strides walk every
    other pixel; the padding, both forms, is its zero fill) and at 3, 4
    and 8 input channels (the narrow-input route) against the plain
    version at the SD step's downsamplers and conv_ins and at odd grids;
    border pixels checked on their own; two launches agree bit for bit."""
    route = "conv_fwd_wgmma" if I % 64 == 0 else "conv_fwd_wgmma_i8"
    assert conv_route(torch.bfloat16, I, O, (stride, stride), k * k) == route
    g = _gen(dev, 11)
    bf = torch.bfloat16
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(bf)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(bf)
    bias = torch.randn(O, device=dev, generator=g)
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, stride, pad)
    y2 = conv2d(x, w, bias, stride, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 2
    assert kernels.LAUNCHES["conv_fwd_mma"] == 0
    assert torch.equal(y, y2)
    ref = conv2d_plain(x, w, bias, (stride, stride), norm_padding(pad), bf)
    assert y.shape == ref.shape
    _within_ulp(y, ref)
    _within_ulp(_border(y), _border(ref))


@pytest.mark.parametrize("I", [3, 4, 8])
def test_conv_in_is_one_launch_once_its_weight_is_packed(dev, I):
    """A conv_in on the narrow-input route is one launch of two kernels
    (x's padded copy, the conv): the weight is packed on the first call
    only (and again after an in-place update)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels_per_call = 2
    bf = torch.bfloat16
    x = torch.randn(1, 64, 64, I, device=dev).to(bf)
    w = (torch.randn(128, 3, 3, I, device=dev) / (9 * I) ** 0.5).to(bf)

    def device_kernels():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = conv2d(x, w, None, 1, 1)
            torch.cuda.synchronize()
        return y, sum(e.device_type == DeviceType.CUDA
                      for e in prof.events())

    _, first = device_kernels()
    assert first > kernels_per_call           # the packing ran once
    # the profiler may drop a kernel's record, never add one: the most
    # that three calls show is a call's kernel count
    runs = [device_kernels() for _ in range(3)]
    y = runs[0][0]
    assert max(n for _, n in runs) == kernels_per_call
    with torch.no_grad():
        w.neg_()
    y2, again = device_kernels()
    assert again > kernels_per_call           # packed again, not stale
    assert torch.equal(y2, -y)


@pytest.mark.parametrize("B,H,W,I,O,k,stride", [
    (2, 9, 7, 320, 4, 3, 1),           # the UNet's conv_out
    (1, 8, 10, 512, 8, 3, 1),          # the VAE encoder's conv_out
    (1, 6, 6, 8, 8, 1, 1),             # quant_conv
    (1, 9, 9, 12, 3, 3, 2),
])
def test_conv_fp32_narrow_kernel(dev, B, H, W, I, O, k, stride):
    assert conv_route(torch.float32, I, O, (stride, stride), k * k) == \
        "conv_fwd_fp32"
    g = _gen(dev, 8)
    x = torch.randn(B, H, W, I, device=dev, generator=g)
    w = torch.randn(O, k, k, I, device=dev, generator=g) / (k * k * I) ** 0.5
    bias = torch.randn(O, device=dev, generator=g)
    pad = k // 2
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, stride, pad)
    y2 = conv2d(x, w, bias, stride, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_fwd_fp32"] == 2
    assert torch.equal(y, y2)
    ref = conv2d_plain(x, w, bias, (stride, stride), norm_padding(pad),
                       torch.float32)
    _close_to(y, ref, 1e-5)
    _close_to(_border(y), _border(ref), 1e-5)


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad", [
    (1, 13, 11, 32, 40, 3, 1, 1),          # odd grid, a ragged N tile
    (2, 9, 7, 16, 32, 3, 1, 1),            # O = 32: the 32-wide N tile
    (1, 17, 19, 64, 200, 3, 1, 1),         # O = 200: a partial 64 tile
    (1, 7, 9, 64, 768, 3, 2, ((0, 1), (0, 1))),   # O = 768, TF-SAME s2
    (1, 38, 38, 3, 64, 7, 2, ((2, 3), (2, 3))),   # the stem: I = 3 (4-byte)
    (1, 15, 13, 5, 12, 3, 1, 1),           # I = 5: 4-byte copies, O < 16
    (1, 33, 31, 3, 8, 3, 1, 1),            # O = 8 with I = 3: not narrow
    (1, 19, 17, 96, 128, 1, 2, 0),         # 1x1 at stride 2
    (1, 12, 12, 768, 256, 3, 1, 1),        # split-K (the DPT's 12²)
    (1, 24, 24, 256, 256, 3, 1, 1),        # split-K (the DPT's 24²)
])
def test_conv_fp32_tiled_kernel(dev, B, H, W, I, O, k, stride, pad):
    """K12's tiled fp32 route (the DPT's convs) against the plain version
    at 1e-5 rel + 1e-4 of the largest value, the border pixels on their
    own: odd pixel grids, N tiles of 32 and 64 (a partial one at O = 200),
    O <= 8 where I % 4 != 0 keeps it off the narrow route, the stem's 3
    channels at 7x7 stride 2 with TF-SAME's pads (4-byte
    copies), a 1x1 at stride 2, split-K at the DPT's 12² and 24² shapes;
    two launches agree bit for bit (partials summed in split order)."""
    assert conv_route(torch.float32, I, O, (stride, stride), k * k) == \
        "conv_fwd_fp32_tiled"
    g = _gen(dev, 23)
    x = torch.randn(B, H, W, I, device=dev, generator=g)
    w = torch.randn(O, k, k, I, device=dev, generator=g) / (k * k * I) ** 0.5
    bias = torch.randn(O, device=dev, generator=g)
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, stride, pad)
    y2 = conv2d(x, w, bias, stride, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_fwd_fp32_tiled"] == 2
    assert kernels.LAUNCHES["conv_fwd_mma"] == 0
    assert torch.equal(y, y2)
    ref = conv2d_plain(x, w, bias, (stride, stride), norm_padding(pad),
                       torch.float32)
    assert y.shape == ref.shape
    for got, want in ((y, ref), (_border(y), _border(ref))):
        torch.testing.assert_close(
            got, want, rtol=1e-5, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("I,O,dtype,stride", [
    (128, 128, torch.bfloat16, 1), (320, 4, torch.float32, 1),
    (128, 64, torch.bfloat16, 2), (64, 64, torch.float32, 1)])
def test_conv_16_byte_routes_refuse_misaligned_views(dev, I, O, dtype,
                                                     stride):
    """The wgmma routes (stride 1 and 2) and the fp32 routes (narrow and
    tiled, I % 4 == 0) read x and w in 16-byte units: a contiguous view at
    an odd offset raises instead of faulting on the card."""
    route = conv_route(dtype, I, O, (stride, stride), 9)
    assert route in ("conv_fwd_wgmma", "conv_fwd_fp32",
                     "conv_fwd_fp32_tiled")
    n = 2 * 6 * 6 * I
    x = torch.randn(n + 1, device=dev).to(dtype)[1:].view(2, 6, 6, I)
    w = (torch.randn(O, 3, 3, I, device=dev) / (9 * I) ** 0.5).to(dtype)
    assert x.is_contiguous() and x.data_ptr() % 16
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        conv2d(x, w, None, stride, 1)
    wv = torch.randn(w.numel() + 1, device=dev).to(dtype)[1:].view(w.shape)
    with pytest.raises(ValueError, match="16-byte"):
        conv2d(x.clone(), wv, None, stride, 1)
    assert kernels.LAUNCHES[route] == 0
    _within_ulp(conv2d(x.clone(), w, None, stride, 1),
                conv2d_plain(x, w, None, (stride, stride), norm_padding(1),
                             dtype))
    assert kernels.LAUNCHES[route] == 1


@pytest.mark.parametrize("B,N,M,H", [
    (1, 100, 77, 2), (2, 100, 100, 3), (1, 4096 + 17, 77, 1),
    (1, 4096 + 17, 100, 2)])
def test_attention_wgmma_kernel(dev, B, N, M, H):
    """K10's d = 64 Hopper route: ragged query and key tiles, the 77-token
    cross-attention; out and lse against the plain version; two launches
    agree bit for bit."""
    g = _gen(dev, 9)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, 64, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, 0.125)
    o2, lse2 = attention_fwd_cuda(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd_wgmma"] == 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = attention_plain(q, k, v, 0.125)
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(o.float(), ref.float(), atol=1e-2 * scale,
                               rtol=2 ** -7)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * 0.125
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("B,N,M,H", [
    (1, 4096, 4096, 1),      # the VAE mid-block: 2 KV splits
    (1, 1000, 77, 1),        # ragged query and key tiles, 2 splits
    (2, 300, 200, 2),        # several (b, h), 4 KV tiles
    (1, 64, 40, 1),          # one KV tile: no split
])
def test_attention_d512_kernel(dev, B, N, M, H):
    """K10's d = 512 Hopper route: out against the plain version, lse
    against a float64 log-sum-exp (across the KV splits' merge), two
    launches bit for bit."""
    g = _gen(dev, 12)
    bf = torch.bfloat16
    q = torch.randn(B, N, H, 512, device=dev, generator=g).to(bf)
    k, v = (torch.randn(B, M, H, 512, device=dev, generator=g).to(bf)
            for _ in range(2))
    scale = 512 ** -0.5
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, scale)
    o2, lse2 = attention_fwd_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd_wgmma_d512"] == 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = attention_plain(q, k, v, scale)
    amax = float(ref.float().abs().max())
    torch.testing.assert_close(o.float(), ref.float(), atol=1e-2 * amax,
                               rtol=2 ** -7)
    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) * scale
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("B,N,M,H,D,rq", [
    (1, 100, 77, 2, 40, False),      # a 77-token cross-attention
    (2, 200, 130, 3, 40, False),     # B·h > 1, M past a 128-key tile
    (2, 4096 + 17, 77, 1, 40, False),
    (1, 300, 1024, 2, 40, True),     # q·scale rounded (chunked branch)
    (1, 100, 77, 2, 80, False),
    (2, 200, 130, 3, 80, False),     # M past two 64-key tiles
    (1, 300, 512, 2, 80, True),
    (1, 100, 77, 2, 160, False),
    (2, 200, 130, 3, 160, False),
    (2, 64, 64, 8, 160, True),       # the 8² mid-block: one query tile
])
def test_attention_sd15_head_dims_kernel(dev, B, N, M, H, D, rq):
    """K10's d = 40, 80 and 160 routes (SD 1.5's UNet): ragged query and
    key tiles, several (b, h); with rq the logits of bf16(q·scale), as
    JAX's chunked branch forms them.  Out against the plain version on the
    same branch, lse against a float64 log-sum-exp of the same logits
    (and, with rq, measurably off the unrounded ones), two launches bit for
    bit."""
    g = _gen(dev, D + N)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    q = (q.float() * 3).to(bf)          # logits of a few units: q's rounding
    scale = D ** -0.5
    route = f"attention_fwd_wgmma_d{D}"
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, scale, rq)
    o2, lse2 = attention_fwd_cuda(q, k, v, scale, rq)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = attention_plain(q, k, v, scale, rq)
    amax = float(ref.float().abs().max())
    torch.testing.assert_close(o.float(), ref.float(), atol=1e-2 * amax,
                               rtol=2 ** -7)

    def lse_of(q_, s_):
        s = torch.einsum("bnhd,bmhd->bhnm", q_.double(), k.double()) * s_
        return torch.logsumexp(s, -1)

    want = lse_of((q.float() * scale).to(bf), 1.0) if rq else \
        lse_of(q, scale)
    torch.testing.assert_close(lse.double(), want, atol=1e-3, rtol=1e-4)
    if rq:
        err = (lse.double() - want).abs().max()
        other = (lse.double() - lse_of(q, scale)).abs().max()
        assert err * 4 < other, (float(err), float(other))


def test_attention_sd15_head_dims_through_the_wrapper(dev):
    """``attention`` at d = 40, 80, 160 is one launch of its route, on
    JAX's branch (the [2, 4096, 8, 40] self-attention rounds q·scale: the
    plain version's chunked form); its backward through autograd is one
    launch of the head dim's backward route, within a bf16 ulp plus 2^-8
    of the largest entry of the kernels' arithmetic in torch
    (``attention_bwd_plain``) on the same branch."""
    g = _gen(dev, 3)
    bf = torch.bfloat16
    for B, N, M, H, D in ((2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80),
                          (2, 256, 256, 8, 160)):
        q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
                   for n in (N, M, M))
        kernels.reset_launch_counts()
        o = attention(q, k, v)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[f"attention_fwd_wgmma_d{D}"] == 1
        assert sum(kernels.LAUNCHES.values()) == 1
        rq = D == 40
        ref = attention_plain(q, k, v, D ** -0.5, rq)
        amax = float(ref.float().abs().max())
        torch.testing.assert_close(o.float(), ref.float(), atol=1e-2 * amax,
                                   rtol=2 ** -7)
    for B, N, M, H, D in ((2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80),
                          (2, 256, 256, 8, 160)):
        q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
                   for n in (N, M, M))
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        o = attention(*qkv)
        do = torch.randn(o.shape, device=dev, generator=g).to(bf)
        kernels.reset_launch_counts()
        grads = torch.autograd.grad(o, qkv, do)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[f"attention_bwd_flash_d{D}"] == 1
        assert sum(kernels.LAUNCHES.values()) == 1
        want = attention_bwd_plain(q, k, v, o.detach(), do, D ** -0.5,
                                   D == 40)
        for got, ref in zip(grads, want):
            _within_ulp(got, ref, 2 ** -8)


@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 100, 100, 2, 64),     # ragged query and key tiles
    (2, 130, 77, 3, 64),      # 77-token cross-attention tail
    (1, 70, 70, 1, 512),      # the VAE mid-block's width
    (1, 64, 40, 2, 512),      # a warpgroup's rows and a key box past N, M
    (1, 1000, 77, 1, 512),    # lse merged over 2 KV splits
    (1, 300, 260, 2, 512),    # several (b, h), tiles of 128 on both sides
])
def test_attention_kernel(dev, B, N, M, H, D):
    """Forward and backward through the autograd wrapper: the backward is
    one launch of its route per call (d = 64: the flash-style
    attention_bwd_flash; d = 512: attention_bwd_wgmma, the wgmma + TMA
    scores pass and products), at ragged tiles of both sides and several
    (b, h)."""
    g = _gen(dev, 5)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention(*qkv)
    ref = attention_plain(q, k, v, D ** -0.5)
    _close_to(o, ref, 2e-2)
    do = torch.randn(o.shape, device=dev, generator=g).to(bf)
    kernels.reset_launch_counts()
    grads = torch.autograd.grad(o, qkv, do)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[attention_bwd_route(D)] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    qkv32 = [t.float().requires_grad_() for t in (q, k, v)]
    grads_ref = torch.autograd.grad(attention_plain(*qkv32, D ** -0.5), qkv32,
                                    do.float())
    for a, b in zip(grads, grads_ref):
        _close_to(a, b, 3e-2)


@pytest.mark.parametrize("B,H,W,C,eps,silu,dtype", [
    (2, 8, 8, 64, 1e-5, True, torch.bfloat16),
    (1, 33, 17, 128, 1e-6, True, torch.bfloat16),
    (2, 5, 7, 40, 1e-6, False, torch.float32),
    (1, 64, 64, 32, 1e-5, False, torch.bfloat16),
    (2, 16, 16, 320, 1e-5, True, torch.bfloat16),     # Cg = 10: 4-group slab
    (2, 8, 8, 960, 1e-6, False, torch.bfloat16),      # Cg = 30, no SiLU
    (2, 32, 32, 1920, 1e-5, True, torch.bfloat16),    # Cg = 60; bwd streams
    (1, 320, 320, 16, 1e-6, True, torch.bfloat16),    # cluster 16; streaming
    (1, 200, 190, 24, 1e-6, True, torch.float32),     # fp32 Cg = 3: the same
    (1, 513, 511, 32, 1e-6, True, torch.bfloat16),    # streaming, both ways
    (1, 400, 400, 32, 1e-6, False, torch.float32),    # fp32 streaming
])
def test_groupnorm_kernel(dev, B, H, W, C, eps, silu, dtype):
    """Every K11 route (resident at cluster sizes 1-16, slabs of 1-8 groups
    with Cg = 1, 2, 3, 4, 5, 10, 30; streaming at a reduced 512²-like
    slab with ragged rows per CTA, at Cg = 60, at fp32) against the plain
    version, forward and backward, each call one launch of the route
    group_norm_route names."""
    g = _gen(dev, 6)
    G = groups_for(C)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3 + 1).to(dtype)
    wt = torch.randn(C, device=dev, generator=g)
    bs = torch.randn(C, device=dev, generator=g)
    sms = kernels.sm_count(dev)
    fwd = group_norm_route(tuple(x.shape), dtype, False, G, sms)
    bwd = group_norm_route(tuple(x.shape), dtype, True, G, sms)
    xr = x.clone().requires_grad_()
    kernels.reset_launch_counts()
    y = group_norm(xr, wt, bs, G, eps, silu)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[fwd.name] == 1
    ref = group_norm_plain(x, wt, bs, G, eps, silu)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    _close_to(y, ref, rel)
    dy = torch.randn(y.shape, device=dev, generator=g).to(dtype)
    (dx,) = torch.autograd.grad(y, xr, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[bwd.name] == 1
    assert sum(kernels.LAUNCHES.values()) == 2
    x32 = x.float().requires_grad_()
    (dxp,) = torch.autograd.grad(group_norm_plain(x32, wt, bs, G, eps, silu),
                                 x32, dy.float())
    _close_to(dx, dxp, 1e-4 if dtype == torch.float32 else 2e-2)
    # bf16 weights (the towers' own dtype) take the same kernels
    y2 = group_norm(x, wt.to(torch.bfloat16), bs.to(torch.bfloat16), G, eps,
                    silu)
    ref2 = group_norm_plain(x, wt.to(torch.bfloat16).float(),
                            bs.to(torch.bfloat16).float(), G, eps, silu)
    _close_to(y2, ref2, rel)


def test_groupnorm_routes_refuse(dev):
    """A misaligned view and a group width no 16-byte slab fits raise."""
    buf = torch.randn(8 * 8 * 128 + 1, device=dev).to(torch.bfloat16)
    one = torch.ones(128, device=dev)
    with pytest.raises(ValueError):
        group_norm(buf[1:].view(1, 8, 8, 128), one, one, 32, 1e-6, True)
    x = torch.randn(1, 8, 8, 12, device=dev).to(torch.bfloat16)
    one = torch.ones(12, device=dev)
    with pytest.raises(ValueError):
        group_norm(x, one, one, groups_for(12), 1e-6, True)


def _dgrad_plain(dy, w, x_shape, stride, pad):
    """dx by autograd of the plain forward, in fp32 on the card."""
    xr = torch.zeros(x_shape, device=dy.device, requires_grad=True)
    y = conv2d_plain(xr, w, None, (stride, stride), norm_padding(pad),
                     torch.float32)
    (dx,) = torch.autograd.grad(y, xr, dy.float())
    return dx


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad", [
    (1, 9, 11, 128, 128, 3, 1, 1),          # odd grid: ragged pixel boxes
    (2, 7, 13, 72, 320, 3, 1, 1),           # dx below one N tile
    (1, 5, 6, 136, 1280, 3, 1, 1),          # split-K, ragged N
    (2, 8, 8, 200, 64, 3, 1, ((0, 2), (1, 0))),  # asymmetric padding
    (2, 16, 16, 64, 192, 1, 1, 0),          # 1x1
    (1, 17, 15, 128, 128, 3, 2, ((0, 1), (0, 1))),   # the VAE's downs
    (1, 16, 16, 256, 256, 3, 2, ((0, 1), (0, 1))),
    (2, 9, 10, 64, 128, 3, 2, 1),           # the other parity layout
    (1, 12, 10, 36, 64, 3, 2, 0),           # dx channels % 8 != 0
    (1, 7, 9, 40, 128, 1, 2, 0),            # three classes without taps
    (1, 10, 10, 3, 64, 3, 2, 1),            # a 3-channel dx at stride 2
])
def test_conv_dgrad_wgmma_kernel(dev, B, H, W, I, O, k, stride, pad):
    """K12's dgrad on the Hopper route against autograd of the plain
    forward: at stride 1 a forward conv of dy with the flipped, transposed
    weight, at stride 2 its four parity classes in one launch (their
    strided TMA stores, or register stores where dx's channels are not a
    multiple of 8 or the K range is split); borders on their own; two
    launches agree bit for bit."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                dgrad_route)
    assert dgrad_route(torch.bfloat16, I, O, (stride, stride), (k, k)) == \
        "conv_dgrad_wgmma"
    g = _gen(dev, 12)
    bf = torch.bfloat16
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(bf)
    pads = norm_padding(pad)
    Ho, Wo = ((H + sum(pads[0]) - k) // stride + 1,
              (W + sum(pads[1]) - k) // stride + 1)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(bf)
    kernels.reset_launch_counts()
    dx = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads, bf)
    dx2 = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads, bf)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_dgrad_wgmma"] == 2
    assert kernels.LAUNCHES["conv_dgrad"] == 0
    assert torch.equal(dx, dx2)
    ref = _dgrad_plain(dy, w, (B, H, W, I), stride, pad)
    _within_ulp(dx, ref)
    _within_ulp(_border(dx), _border(ref))


@pytest.mark.parametrize("B,H,W,I,O,pad", [
    (1, 64, 64, 3, 128, 1),                 # the VAE conv_in's
    (2, 9, 11, 3, 128, 1),
    (1, 7, 5, 1, 64, ((0, 2), (1, 1))),
    (2, 6, 9, 4, 96, 1),
    (1, 8, 8, 8, 32, 0),
    (1, 5, 21, 3, 256, 1),                  # a ragged 16-pixel group
])
def test_conv_dgrad_narrow_kernel(dev, B, H, W, I, O, pad):
    """The 3-channel dx of the VAE's conv_in (mma.sync with A fragments
    loaded from device memory, 16 pixels a warp; odd sizes, a ragged
    16-pixel group, 1-8 dx channels, 32-256 dy channels) against autograd
    of the plain forward."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                dgrad_route)
    assert dgrad_route(torch.bfloat16, I, O, (1, 1), (3, 3)) == \
        "conv_dgrad_narrow"
    g = _gen(dev, 13)
    bf = torch.bfloat16
    w = (torch.randn(O, 3, 3, I, device=dev, generator=g) / 3.0).to(bf)
    pads = norm_padding(pad)
    Ho, Wo = H + sum(pads[0]) - 2, W + sum(pads[1]) - 2
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(bf)
    kernels.reset_launch_counts()
    dx = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (1, 1), pads, bf)
    dx2 = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (1, 1), pads, bf)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_dgrad_narrow"] == 2
    assert torch.equal(dx, dx2)
    ref = _dgrad_plain(dy, w, (B, H, W, I), 1, pad)
    _within_ulp(dx, ref)
    _within_ulp(_border(dx), _border(ref))


@pytest.mark.parametrize("B,H,W,I,O,k,stride", [
    (1, 8, 10, 512, 8, 3, 1),               # the VAE encoder's conv_out
    (2, 9, 7, 320, 4, 3, 1),                # the UNet's
    (1, 9, 9, 12, 3, 3, 2),
    (1, 6, 6, 8, 8, 1, 1),
])
def test_conv_dgrad_fp32_kernel(dev, B, H, W, I, O, k, stride):
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                dgrad_route)
    assert dgrad_route(torch.float32, I, O, (stride, stride), (k, k)) == \
        "conv_dgrad_fp32"
    g = _gen(dev, 14)
    w = torch.randn(O, k, k, I, device=dev, generator=g) / (k * k * I) ** 0.5
    pad = k // 2
    pads = norm_padding(pad)
    Ho, Wo = ((H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g)
    kernels.reset_launch_counts()
    dx = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads,
                           torch.float32)
    dx2 = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads,
                            torch.float32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_dgrad_fp32"] == 2
    assert torch.equal(dx, dx2)
    ref = _dgrad_plain(dy, w, (B, H, W, I), stride, pad)
    _close_to(dx, ref, 1e-5)
    _close_to(_border(dx), _border(ref), 1e-5)


@pytest.mark.parametrize("I,O,dtype,stride", [
    (128, 128, torch.bfloat16, 1), (128, 64, torch.bfloat16, 2),
    (3, 128, torch.bfloat16, 1), (512, 8, torch.float32, 1)])
def test_conv_dgrad_routes_refuse_misaligned_views(dev, I, O, dtype, stride):
    """The dgrad routes read dy and w in 16-byte units: a contiguous view
    at an odd offset raises instead of faulting on the card."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                dgrad_route)
    route = dgrad_route(dtype, I, O, (stride, stride), (3, 3))
    assert route != "conv_dgrad"
    pads = norm_padding(1)
    Ho = (8 + 2 - 3) // stride + 1
    n = 2 * Ho * Ho * O
    dy = torch.randn(n + 1, device=dev).to(dtype)[1:].view(2, Ho, Ho, O)
    w = (torch.randn(O, 3, 3, I, device=dev) / (9 * I) ** 0.5).to(dtype)
    assert dy.is_contiguous() and dy.data_ptr() % 16
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        conv2d_dgrad_cuda(dy, w, (2, 8, 8, I), (stride, stride), pads, dtype)
    wv = torch.randn(w.numel() + 1, device=dev).to(dtype)[1:].view(w.shape)
    with pytest.raises(ValueError, match="16-byte"):
        conv2d_dgrad_cuda(dy.clone(), wv, (2, 8, 8, I), (stride, stride),
                          pads, dtype)
    assert kernels.LAUNCHES[route] == 0
    dx = conv2d_dgrad_cuda(dy.clone(), w, (2, 8, 8, I), (stride, stride),
                           pads, dtype)
    assert kernels.LAUNCHES[route] == 1
    _close_to(dx, _dgrad_plain(dy, w, (2, 8, 8, I), stride, 1), 1e-2)


def test_new_wrappers_count_their_launches(dev):
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 8, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(16, 3, 3, 16, device=dev, dtype=torch.bfloat16)
    one = torch.ones(16, device=dev)
    h = group_norm(conv2d(x, w, None, 1, 1), one, one * 0, 8, 1e-6, True)
    q = h.reshape(1, 64, 1, 16).repeat(1, 1, 1, 4)
    attention(q, q, q).float().sum().backward()
    for name in ("conv_fwd_mma", "conv_dgrad", "groupnorm_fwd_resident",
                 "groupnorm_bwd_resident", "attention_fwd_wgmma",
                 "attention_bwd_flash"):
        assert kernels.LAUNCHES[name] == 1, name


# ---- K7: rasterize + interpolate --------------------------------------------

def _raster_scene(dev, seed, crowd=0, ties=False, T=300, slivers=False):
    """Screen-space triangles for a 100x130 image: random ones, ``crowd``
    small ones piled into one tile (over its cap), with ``ties`` a pair of
    overlapping triangles at one constant depth in front of the rest, with
    ``slivers`` every 7th triangle collapsed (two vertices on one point:
    den = 0, the guarded ones), and empty tiles (no triangle reaches
    x >= 96)."""
    g = _gen(dev, seed)
    V = 3 * (T + crowd) + 6
    sx = torch.rand(V, device=dev, generator=g) * 60
    sy = torch.rand(V, device=dev, generator=g) * 90
    sz = torch.rand(V, device=dev, generator=g) * 2 - 1
    faces = torch.arange(3 * (T + crowd), device=dev,
                         dtype=torch.int32).reshape(-1, 3)
    # small triangles: jitter around a centre
    c = torch.rand(T + crowd, 2, device=dev, generator=g) * \
        torch.tensor([60.0, 90.0], device=dev)
    c[T:] = torch.rand(crowd, 2, device=dev, generator=g) * 6 + 2
    off = (torch.rand(T + crowd, 3, 2, device=dev, generator=g) - 0.5) * 24
    p = (c[:, None] + off).reshape(-1, 2)
    sx[:3 * (T + crowd)], sy[:3 * (T + crowd)] = p[:, 0], p[:, 1]
    if ties:   # two triangles in the plane z = 0.25, overlapping
        b = 3 * (T + crowd)
        sx[b:b + 6] = torch.tensor([10., 40., 10., 12., 42., 12.])
        sy[b:b + 6] = torch.tensor([10., 10., 40., 11., 11., 41.])
        sz[b:b + 6] = -2.0
        faces = torch.cat([faces, torch.arange(b, b + 6, device=dev,
                                               dtype=torch.int32
                                               ).reshape(2, 3)])
    if slivers:   # vertex 2 on vertex 0: den = 0, guarded to 1e-9
        i = torch.arange(0, T, 7, device=dev)
        for q in (sx, sy):
            q[3 * i + 2] = q[3 * i]
    valid = torch.rand(faces.shape[0], device=dev, generator=g) > 0.05
    if ties:
        valid[-2:] = True
    return sx, sy, sz, faces, valid


def _check_bins(out, sx, sy, sz, faces, valid, H, W, cap, soft):
    """The kernel's tile lists are tile_lists': every tile's first cap
    triangles by index, and its count of overlapping ones."""
    from dreamfusion_tpu_torch.ops.raster import _face_coeffs, tile_lists
    *_, bmin, bmax = _face_coeffs(sx, sy, sz, faces.long())
    T = faces.shape[0]
    ids, listed = tile_lists(bmin, bmax, valid, H, W, 32, T, soft)
    b = out.bins
    cap = b.lists.shape[1]
    assert torch.equal(b.counts, listed.sum(1).to(torch.int32))
    assert torch.equal(out.tile_counts, b.counts)
    n = b.counts.clamp(max=cap)
    keep = torch.arange(cap, device=sx.device)[None] < n[:, None]
    assert torch.equal(b.lists[keep], ids[:, :cap][keep].to(torch.int32))
    return int((b.counts > cap).sum())


@pytest.mark.parametrize("soft,cap,crowd,ties,slivers", [
    (1.0, 512, 0, False, False), (1.0, 32, 60, False, False),
    (0.0, 64, 60, False, False), (0.0, 1024, 0, True, False),
    (1.0, 1024, 0, True, False), (1.0, 512, 0, False, True),
    (1.0, 32, 60, False, True),
    # lists longer than the backwards' 1024-slot window: kept whole, and cut
    (1.0, 4096, 3000, False, False), (1.0, 2048, 3000, False, True)])
def test_raster_kernel(dev, soft, cap, crowd, ties, slivers):
    from dreamfusion_tpu_torch.ops.raster import raster_cuda, raster_plain
    sx, sy, sz, faces, valid = _raster_scene(dev, 7, crowd, ties,
                                             slivers=slivers)
    H, W = 100, 130
    ins = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    ok = raster_cuda(*ins, faces, valid, H, W, 32, cap, soft)
    torch.cuda.synchronize()
    over = _check_bins(ok, sx, sy, sz, faces, valid, H, W, cap, soft)
    assert over > 0 or crowd < cap        # the crowded tile overflows
    ref_in = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    op = raster_plain(*ref_in, faces, valid, H, W, 32, cap, soft)
    assert torch.equal(ok.tri_id, op.tri_id)
    assert bool((ok.tri_id[:, 96:] == -1).all())          # empty tiles
    assert bool((ok.alpha[:, 96:] == 0).all())
    if ties:
        assert int(ok.tri_id[20, 20]) == faces.shape[0] - 2
    hit = op.tri_id >= 0
    torch.testing.assert_close(ok.bary[hit], op.bary[hit], atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(ok.depth, op.depth, atol=1e-6, rtol=0)
    torch.testing.assert_close(ok.alpha, op.alpha, atol=1e-5, rtol=0)
    g = _gen(dev, 8)
    cots = [torch.randn(o.shape, device=dev, generator=g)
            for o in (ok.bary, ok.depth, ok.alpha)]
    lk = sum((o * c).sum() for o, c in zip((ok.bary, ok.depth, ok.alpha),
                                           cots))
    lp = sum((o * c).sum() for o, c in zip((op.bary, op.depth, op.alpha),
                                           cots))
    gk = torch.autograd.grad(lk, ins)
    gp = torch.autograd.grad(lp, ref_in)
    for a, b in zip(gk, gp):
        _close_to(a, b, 1e-4)


def _edge_scene(dev, kind, seed=9):
    """Screen-space triangles in a 128² image whose backward turns on the
    last bits of den, bu and bv.  ``thin``: a triangle 3-7 px long and
    1e-4-1e-2 px wide in each 8x8 block, at a random angle through the
    block's centre pixel (its gradients grow as 1/den, so den's rounding
    shows in them: a product's low bits, which an FMA keeps, are most of
    the difference of two near-equal products).  ``tie``: in each 16x16
    block an isosceles triangle, its two base vertices mirrored about a
    pixel column through its apex, so that on that column bu = bv exactly
    and the margin's min is a tie (its gradient split in halves)."""
    g = _gen(dev, seed)
    if kind == "thin":
        n, side = 16, 8
    else:
        n, side = 8, 16
    by, bx = torch.meshgrid(torch.arange(n, device=dev),
                            torch.arange(n, device=dev), indexing="ij")
    bx, by = bx.reshape(-1).float(), by.reshape(-1).float()
    T = n * n
    if kind == "thin":
        c = torch.stack([bx * side + side // 2 + 0.5,
                         by * side + side // 2 + 0.5], -1)
        a = torch.rand(T, device=dev, generator=g) * 6.2832
        d = torch.stack([torch.cos(a), torch.sin(a)], -1)
        nrm = torch.stack([-d[:, 1], d[:, 0]], -1)
        L = 3 + 4 * torch.rand(T, 1, device=dev, generator=g)
        w = 10 ** (-4 + 2 * torch.rand(T, 1, device=dev, generator=g))
        q = torch.stack([c - 0.5 * L * d - w / 3 * nrm,
                         c + 0.5 * L * d - w / 3 * nrm,
                         c + 0.1 * L * d + 2 * w / 3 * nrm], 1)
    else:
        cx = bx * side + side // 2 + 0.5
        y0 = by * side + 4
        q = torch.stack([torch.stack([cx, y0], -1),
                         torch.stack([cx - 3, y0 + 6], -1),
                         torch.stack([cx + 3, y0 + 6], -1)], 1)
    q = q.reshape(-1, 2).contiguous()
    sz = torch.rand(3 * T, device=dev, generator=g) - 0.5
    faces = torch.arange(3 * T, device=dev, dtype=torch.int32).reshape(-1, 3)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    return q[:, 0].contiguous(), q[:, 1].contiguous(), sz, faces, valid


@pytest.mark.parametrize("kind", ["thin", "tie"])
def test_raster_backward_at_thin_and_symmetric_triangles(dev, kind):
    """K7's backward against the plain version's with a cotangent on every
    output of every pixel, at the triangles whose gradients turn on the
    last bits of den, bu and bv (``_edge_scene``): the kernel forms them
    as the plain version does, and splits a tie of the margin's min as
    torch.minimum does."""
    from dreamfusion_tpu_torch.ops.raster import raster_cuda, raster_plain
    sx, sy, sz, faces, valid = _edge_scene(dev, kind)
    ins = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    ref_in = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    ok = raster_cuda(*ins, faces, valid, 128, 128, 32, 512, 1.0)
    op = raster_plain(*ref_in, faces, valid, 128, 128, 32, 512, 1.0)
    assert torch.equal(ok.tri_id, op.tri_id)
    assert int((op.tri_id >= 0).sum()) >= faces.shape[0]   # every one hit
    g = _gen(dev, 10)
    cots = [torch.randn(o.shape, device=dev, generator=g)
            for o in (ok.bary, ok.depth, ok.alpha)]
    gk = torch.autograd.grad(sum((o * c).sum() for o, c in zip(
        (ok.bary, ok.depth, ok.alpha), cots)), ins)
    gp = torch.autograd.grad(sum((o * c).sum() for o, c in zip(
        (op.bary, op.depth, op.alpha), cots)), ref_in)
    scale = max(float(x.abs().max()) for x in gp)
    for a, b in zip(gk, gp):     # chip_smoke.py's K7 backward tolerance
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-4)


def test_raster_kernel_at_the_bake(dev):
    """K7's forward at the texture bake's 1024² (1024 tiles, cap 1024, no
    soft edge) on a UV atlas of small triangles, some pairs sharing an
    edge, and one triangle across the whole image."""
    from dreamfusion_tpu_torch.ops.raster import raster_cuda, raster_plain
    g = _gen(dev, 21)
    T = 6000
    c = torch.rand(T, 2, device=dev, generator=g) * 1000 + 12
    off = (torch.rand(T, 3, 2, device=dev, generator=g) - 0.5) * 20
    p = (c[:, None] + off).reshape(-1, 2)
    p[:3] = torch.tensor([[-5.0, -5.0], [2100.0, -5.0], [-5.0, 2100.0]])
    sx, sy = p[:, 0].contiguous(), p[:, 1].contiguous()
    sz = torch.zeros_like(sx)
    faces = torch.arange(3 * T, device=dev, dtype=torch.int32).reshape(-1, 3)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    ok = raster_cuda(sx, sy, sz, faces, valid, 1024, 1024, 32, 1024, 0.0)
    torch.cuda.synchronize()
    _check_bins(ok, sx, sy, sz, faces, valid, 1024, 1024, 1024, 0.0)
    op = raster_plain(sx, sy, sz, faces, valid, 1024, 1024, 32, 1024, 0.0)
    assert torch.equal(ok.tri_id, op.tri_id)
    hit = op.tri_id >= 0
    assert float(hit.float().mean()) > 0.99
    torch.testing.assert_close(ok.bary[hit], op.bary[hit], atol=1e-6, rtol=0)
    torch.testing.assert_close(ok.alpha, op.alpha, atol=0, rtol=0)


@pytest.mark.parametrize("crowd,cap", [(0, 512), (3000, 4096)])
def test_interpolate_kernel(dev, crowd, cap):
    """Against the plain version; with ``crowd`` a tile listing more
    triangles than the backward's 1024-slot window."""
    from dreamfusion_tpu_torch.ops.raster import (interpolate,
                                                  interpolate_plain,
                                                  raster_cuda)
    sx, sy, sz, faces, valid = _raster_scene(dev, 9, crowd)
    out = raster_cuda(sx, sy, sz, faces, valid, 64, 64, 32, cap, 1.0)
    assert int(out.tile_counts.max()) > (1024 if crowd else 0)
    g = _gen(dev, 10)
    attrs = torch.randn(sx.shape[0], 3, device=dev, generator=g)
    a1, b1 = attrs.clone().requires_grad_(), out.bary.clone().requires_grad_()
    a2, b2 = attrs.clone().requires_grad_(), out.bary.clone().requires_grad_()
    yk = interpolate(a1, out._replace(bary=b1), faces)
    yp = interpolate_plain(a2, b2, out.tri_id, faces)
    torch.testing.assert_close(yk, yp, atol=1e-6, rtol=1e-6)
    c = torch.randn(yk.shape, device=dev, generator=g)
    gk = torch.autograd.grad((yk * c).sum(), [a1, b1])
    gp = torch.autograd.grad((yp * c).sum(), [a2, b2])
    for a, b in zip(gk, gp):
        _close_to(a, b, 1e-5)


# ---- K8: marching tets + mesh regularizers ------------------------------------

def _tet_inputs(dev, n=16, open_surface=False):
    from dreamfusion_tpu_torch.mesh.tets import generate_tet_grid
    grid = generate_tet_grid(n)
    t = lambda a: torch.from_numpy(a).to(dev)
    v = t(grid.vertices)
    g = _gen(dev, 11)
    c = torch.tensor([0.6, 0.0, 0.0] if open_surface else [0.05, 0, 0],
                     device=dev)
    sdf = (0.62 - torch.linalg.norm(v - c, dim=-1)) * 4 + \
        0.05 * torch.sin(7 * v[:, 1])
    sdf = torch.where(sdf.abs() < 1e-4, 1e-3, sdf).clamp(-1, 1)
    pos = v + torch.randn(v.shape, device=dev, generator=g) * 0.01
    return grid, pos, sdf, t(grid.indices), t(grid.tet_edges), \
        t(grid.unique_edges)


@pytest.mark.parametrize("max_tris", [40000, 900])       # 900: overflow
def test_marching_tets_kernel(dev, max_tris):
    from dreamfusion_tpu_torch.ops.marching_tets import (marching_tets,
                                                         marching_tets_plain)
    grid, pos, sdf, tets, te, ue = _tet_inputs(dev)
    p1, s1 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    p2, s2 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    mk = marching_tets(p1, s1, tets, te, ue, max_tris)
    mp = marching_tets_plain(p2, s2, tets, te, ue, max_tris)
    torch.cuda.synchronize()
    assert torch.equal(mk.faces, mp.faces)
    assert torch.equal(mk.face_mask, mp.face_mask)
    assert torch.equal(mk.vert_valid, mp.vert_valid)
    n = int(mk.face_mask.sum())
    assert n == max_tris if max_tris == 900 else 900 < n < max_tris
    torch.testing.assert_close(mk.verts, mp.verts, atol=1e-6, rtol=0)
    c = torch.randn(mk.verts.shape, device=dev, generator=_gen(dev, 12))
    gk = torch.autograd.grad((mk.verts * c).sum(), [p1, s1])
    gp = torch.autograd.grad((mp.verts * c).sum(), [p2, s2])
    for a, b in zip(gk, gp):
        _close_to(a, b, 1e-5)


@pytest.mark.parametrize("which", ["normals", "laplacian",
                                   "normal_consistency"])
@pytest.mark.parametrize("open_surface", [False, True])
def test_mesh_regularizer_kernels(dev, which, open_surface):
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    grid, pos, sdf, tets, te, ue = _tet_inputs(dev, open_surface=open_surface)
    # the card's regularizers gather by the marching-tets kernel's slots
    mesh = K8.marching_tets(pos, sdf, tets, te, ue, 40000)
    c = torch.randn(mesh.verts.shape, device=dev, generator=_gen(dev, 13))
    kern = {"normals": lambda m: (K8.vertex_normals(m) * c).sum(),
            "laplacian": K8.laplacian_smooth_loss,
            "normal_consistency": K8.normal_consistency_loss}[which]
    plain = {"normals": lambda m: (K8.vertex_normals_plain(
        m.verts, m.faces, m.face_mask) * c).sum(),
        "laplacian": lambda m: K8.laplacian_plain(m.verts, m.faces,
                                                  m.face_mask),
        "normal_consistency": lambda m: K8.normal_consistency_plain(
            m.verts, m.faces, m.face_mask)}[which]
    v1 = mesh.verts.detach().clone().requires_grad_()
    v2 = mesh.verts.detach().clone().requires_grad_()
    yk = kern(mesh._replace(verts=v1))
    yp = plain(mesh._replace(verts=v2))
    torch.cuda.synchronize()
    torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-6)
    (gk,) = torch.autograd.grad(yk, v1)
    (gp,) = torch.autograd.grad(yp, v2)
    _close_to(gk, gp, 1e-4)


@pytest.mark.parametrize("max_tris,open_surface", [(40000, False),
                                                   (40000, True),
                                                   (900, False)])
def test_marching_tets_slots_and_pairs(dev, max_tris, open_surface):
    """The forward's slots equal the plain version's, and normal
    consistency's pairs from the static topology are the plain version's
    sorted-key pairs: closed and open (the grid's boundary) surfaces and a
    max_tris overflow (triangles dropped)."""
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    grid, pos, sdf, tets, te, ue = _tet_inputs(dev, open_surface=open_surface)
    mk = K8.marching_tets(pos, sdf, tets, te, ue, max_tris)
    ts, fi = K8.mesh_slots_plain(sdf, tets, max_tris)
    has = (ts.reshape(-1, 2) >= 0).any(1).repeat_interleave(2)
    assert torch.equal(mk.slots.tri_slot[has], ts[has])
    assert torch.equal(mk.slots.face_info, fi)
    # the true face count, the slots past max_tris included
    mp = K8.marching_tets_plain(pos, sdf, tets, te, ue, max_tris)
    assert int(mk.n_faces) == int(mp.n_faces) >= int(mk.face_mask.sum())
    loss, partner = K8.normal_consistency_cuda(mk)
    torch.cuda.synchronize()
    assert torch.equal(partner, K8.nc_partners_plain(mk.faces, mk.face_mask,
                                                     mk.slots))
    s = torch.arange(partner.shape[0], device=dev)[:, None].expand_as(partner)
    live = partner >= 0
    a, b = s[live], partner[live].long()
    got = torch.unique(torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                                   -1), dim=0)
    assert torch.equal(got, K8.nc_pairs_plain(mk.faces, mk.face_mask,
                                              ue.shape[0]))
    ref = K8.normal_consistency_plain(mk.verts, mk.faces, mk.face_mask)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)


def test_mesh_kernels_repeat_and_are_deterministic(dev):
    """The look-back flags and the last-block counters reset themselves:
    three calls in a row give the same bits."""
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    grid, pos, sdf, tets, te, ue = _tet_inputs(dev)
    outs = []
    for _ in range(3):
        m = K8.marching_tets(pos, sdf, tets, te, ue, 40000)
        outs.append((m.faces, m.face_mask, m.slots.face_info,
                     K8.laplacian_smooth_loss(m),
                     K8.normal_consistency_loss(m)))
    torch.cuda.synchronize()
    for o in outs[1:]:
        for x, y in zip(o, outs[0]):
            assert torch.equal(x, y)


def test_k7_k8_wrappers_count_their_launches(dev):
    from dreamfusion_tpu_torch.models.dmtet import DMTetRenderer
    from dreamfusion_tpu_torch.mesh.tets import generate_tet_grid
    from dreamfusion_tpu_torch.training.data import circle_view_batch
    from dreamfusion_tpu_torch.config import Config
    r = DMTetRenderer(generate_tet_grid(8), max_tris=4096, device=dev)
    p = r.init_params_sphere(0.45)
    p = p._replace(sdf=p.sdf.requires_grad_(), deform=p.deform.requires_grad_())
    b = circle_view_batch(Config(), 0, 1, 64, 64, dev)
    kernels.reset_launch_counts()
    out = r.render(p, lambda x: torch.sigmoid(x), b.mvp[0], 64, 64,
                   b.rays_o[0], b.rays_d[0], shading="lambertian",
                   ambient_ratio=0.5, need_regularizers=True)
    loss = out["image"].sum() + out["normal_loss"] + out["lap_loss"]
    loss.backward()
    # one view: the mesh, the raster and two interpolates (positions and
    # normals), the normals and the two regularizers, each one launch
    want = {"raster_fwd": 1, "raster_bwd": 1, "interpolate_fwd": 2,
            "interpolate_bwd": 2, "marching_tets_fwd": 1,
            "marching_tets_bwd": 1, "vertex_normals_fwd": 1,
            "vertex_normals_bwd": 1, "laplacian_fwd": 1, "laplacian_bwd": 1,
            "normal_consistency_fwd": 1, "normal_consistency_bwd": 1}
    assert {k: kernels.LAUNCHES[k] for k in want} == want
    assert float(p.sdf.grad.abs().max()) > 0


# ---- K6 hash grid -----------------------------------------------------------

def _hash_inputs(dev, spec, N, seed=5):
    g = _gen(dev, seed)
    x = torch.rand(N, 3, device=dev, generator=g)
    x[0] = torch.tensor([1.5, 0.5, 0.5])            # outside the box
    x[1] = torch.tensor([0.5, -1e-3, 0.5])
    x[2:40, 0] = 0.0                                  # on the faces
    x[40:80, 1] = 1.0
    x[80:90] = torch.tensor([1.0, 1.0, 0.0])
    table = (torch.rand(spec.table_size, spec.level_dim, device=dev,
                        generator=g) - 0.5) * 0.2
    return x, table, g


@pytest.mark.parametrize("L,C,log2,res,interp,hash_,max_level,dtype", [
    (4, 8, 19, 2048, "smoothstep", "affine", None, torch.bfloat16),  # flagship
    (4, 8, 12, 256, "linear", "affine", 0.5, torch.float32),
    (16, 2, 19, 2048, "linear", "xor", None, torch.float32),         # tcnn
    (16, 2, 12, 512, "smoothstep", "xor", 0.3, torch.bfloat16),
    (8, 4, 14, 512, "smoothstep", "affine", None, torch.float32),
    (8, 4, 10, 128, "linear", "xor", None, torch.bfloat16),
])
def test_hashgrid_kernel(dev, L, C, log2, res, interp, hash_, max_level,
                         dtype):
    from dreamfusion_tpu_torch.models.nerf import make_grid_spec
    from dreamfusion_tpu_torch.ops.hashgrid import (hash_bwd_plain,
                                                    hash_encode,
                                                    hash_fwd_plain,
                                                    n_active_levels)
    spec = make_grid_spec(L, C, log2, res, interp, hash_)
    N = 5003
    x, table, g = _hash_inputs(dev, spec, N)
    n_act = n_active_levels(spec, max_level)
    tab = table.clone().requires_grad_()
    feat, jac = hash_encode(x, tab, spec, max_level=max_level,
                            out_dtype=dtype, need_jacobian=True)
    torch.cuda.synchronize()
    ref = hash_fwd_plain(x, table, spec, n_act, True)
    for a, b in zip((feat, *jac), ref):
        if dtype == torch.float32:
            _close_to(a, b, 1e-6)
        else:       # one bf16 ulp, plus fp32 sums of terms that cancel
            torch.testing.assert_close(
                a.float(), b.to(dtype).float(), rtol=2 ** -7,
                atol=1e-6 + 1e-6 * float(b.abs().max()))
    for o in (feat, *jac):
        assert not o[:2].any()                        # outside: zeros
        assert not o[:, n_act * C:].any()             # masked levels
    assert not jac[0][2:40].any()                     # the face band
    cots = [torch.randn(N, L * C, device=dev, generator=g) for _ in range(4)]
    loss = sum((o.float() * c).sum() for o, c in zip((feat, *jac), cots))
    (dt,) = torch.autograd.grad(loss, [tab])
    ref_dt = hash_bwd_plain(x, spec, n_act, cots[0].to(dtype),
                            [c.to(dtype) for c in cots[1:]])
    _close_to(dt, ref_dt, 1e-5)


@pytest.mark.parametrize("hash_", ["affine", "xor"])
def test_hashgrid_position_grad(dev, hash_):
    from dreamfusion_tpu_torch.models.nerf import make_grid_spec
    from dreamfusion_tpu_torch.ops.hashgrid import hash_encode
    spec = make_grid_spec(4, 8, 14, 512, "smoothstep", hash_)
    x, table, g = _hash_inputs(dev, spec, 4099)
    cot = torch.randn(4099, spec.output_dim, device=dev, generator=g)
    xk = x.clone().requires_grad_()
    (dk,) = torch.autograd.grad(hash_encode(xk, table, spec), [xk], cot)
    xp = x.cpu().requires_grad_()
    (dp,) = torch.autograd.grad(hash_encode(xp, table.cpu(), spec), [xp],
                                cot.cpu())
    _close_to(dk.cpu(), dp, 1e-5)
    assert not dk[:2].any()


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,case", FIELD_CASES)
@pytest.mark.parametrize("L,C,log2,res,hash_,max_level", [
    (4, 8, 19, 2048, "affine", None), (16, 2, 19, 2048, "xor", None),
    (8, 4, 12, 256, "affine", 0.6)])
def test_hashgrid_bwd_routes(dev, L, C, log2, res, hash_, max_level, N, case,
                             gdtype, monkeypatch):
    """hashgrid_bwd (4 cotangents) and hashgrid_bwd_dx (the features') in
    one launch each, against their plain versions."""
    from dreamfusion_tpu_torch.models.nerf import make_grid_spec
    from dreamfusion_tpu_torch.ops import hashgrid as K6
    from dreamfusion_tpu_torch.ops.hashgrid import (hash_bwd_cuda,
                                                    hash_bwd_dx_cuda,
                                                    hash_bwd_dx_plain,
                                                    hash_bwd_plain,
                                                    n_active_levels)
    spec = make_grid_spec(L, C, log2, res, "smoothstep", hash_)
    n_act = n_active_levels(spec, max_level)
    g = _gen(dev, 4)
    table = (torch.rand(spec.table_size, C, device=dev, generator=g)
             - 0.5) * 0.2
    x = _field_positions(dev, g, N, case)
    cots = [_field_cots(dev, g, x, L * C, case, gdtype) for _ in range(4)]
    kernels.reset_launch_counts()
    dk = hash_bwd_cuda(x, spec, n_act, cots[0], cots[1:])
    dtk, dxk = hash_bwd_dx_cuda(x, table, spec, n_act, cots[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_bwd"] == 1
    assert kernels.LAUNCHES["hashgrid_bwd_dx"] == 1
    dp = hash_bwd_plain(x, spec, n_act, cots[0], cots[1:])
    mag = _term_magnitudes(monkeypatch, K6, hash_bwd_plain, x, spec, n_act,
                           cots[0], cots[1:])
    _close_to_terms(dk, dp, mag, 1e-4)
    dtp, dxp = hash_bwd_dx_plain(x, table, spec, n_act, cots[0])
    mag = _term_magnitudes(monkeypatch, K6, hash_bwd_plain, x, spec, n_act,
                           cots[0], (None,) * 3)
    _close_to_terms(dtk, dtp, mag, 1e-4)
    # dx: a sum over L levels x 8 corners x C channels a sample
    _close_to(dxk, dxp, 1e-5)
    if case == "ties":
        assert not dxk[:2].any() and not dxk[40:90].any()


def _dmtet_view_launches(dev, backbone):
    """Launch counts of one DMTet view's albedo query and its backward: a
    small tet grid, the field's albedo at the rasterized surface points."""
    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.mesh.tets import generate_tet_grid
    from dreamfusion_tpu_torch.models.dmtet import DMTetRenderer
    from dreamfusion_tpu_torch.training.data import circle_view_batch
    from dreamfusion_tpu_torch.training.trainer import build_renderer
    cfg = finalize(Config(guidance=("oracle",), backbone=backbone,
                          grid_log2_hashmap_size=14, triplane_resolution=32,
                          triplane_channels=8, hidden_dim=16))
    nerf = build_renderer(cfg)
    nerf.field.reset_parameters(torch.Generator().manual_seed(0))
    nerf.to(dev)
    r = DMTetRenderer(generate_tet_grid(8), max_tris=4096, device=dev)
    p = r.init_params_sphere(0.45)
    p = p._replace(sdf=p.sdf.requires_grad_(),
                   deform=p.deform.requires_grad_())
    b = circle_view_batch(Config(), 0, 1, 64, 64, dev)
    kernels.reset_launch_counts()
    out = r.render(p, lambda x: nerf.field.density(x)["albedo"], b.mvp[0],
                   64, 64, b.rays_o[0], b.rays_d[0], shading="lambertian",
                   ambient_ratio=0.5)
    out["image"].sum().backward()
    torch.cuda.synchronize()
    assert float(p.deform.grad.abs().max()) > 0
    table = nerf.field.grid_table if backbone == "grid" else \
        nerf.field.triplanes[0]
    assert float(table.grad.abs().max()) > 0
    return dict(kernels.LAUNCHES)


@pytest.mark.parametrize("backbone,enc", [("triplane", "triplane"),
                                          ("grid", "hashgrid")])
def test_a_dmtet_view_launches_one_forward_and_one_dx_backward(dev, backbone,
                                                               enc):
    """The albedo query's positions take a gradient: one encoder forward
    and one backward that gives the table's and the positions' gradients
    (no second, jacobian forward)."""
    n = _dmtet_view_launches(dev, backbone)
    assert n[f"{enc}_fwd"] == 1
    assert n[f"{enc}_bwd_dx"] == 1
    assert n[f"{enc}_bwd"] == 0


@pytest.mark.parametrize("L,C,log2,res,hash_", [
    (4, 8, 19, 2048, "affine"), (16, 2, 19, 2048, "xor"),
    (8, 4, 12, 256, "affine")])
def test_hashgrid_tv_wd_kernels(dev, L, C, log2, res, hash_):
    from dreamfusion_tpu_torch.models.nerf import make_grid_spec
    from dreamfusion_tpu_torch.ops.hashgrid import (draw_tv_cells,
                                                    hash_tv_bwd_plain,
                                                    hash_tv_plain,
                                                    hash_wd_bwd_plain,
                                                    hash_wd_plain,
                                                    hashgrid_tv_loss,
                                                    hashgrid_wd_loss)
    spec = make_grid_spec(L, C, log2, res, "smoothstep", hash_)
    _, table, g = _hash_inputs(dev, spec, 8)
    cells = draw_tv_cells(g, spec, dev)
    tab = table.clone().requires_grad_()
    tv = hashgrid_tv_loss(cells, tab, spec)
    wd = hashgrid_wd_loss(tab, spec)
    torch.cuda.synchronize()
    torch.testing.assert_close(tv, hash_tv_plain(table, cells, spec),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(wd, hash_wd_plain(table, spec), rtol=1e-5,
                               atol=0)
    (gt,) = torch.autograd.grad(2.5 * tv, [tab])
    (gw,) = torch.autograd.grad(0.5 * wd, [tab])
    two, half = (torch.tensor(v, device=dev) for v in (2.5, 0.5))
    _close_to(gt, hash_tv_bwd_plain(table, cells, spec, two), 1e-5)
    _close_to(gw, hash_wd_bwd_plain(table, spec, half), 1e-6)


def test_k6_wrappers_count_their_launches(dev):
    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.training.trainer import build_renderer
    cfg = finalize(Config(guidance=("oracle",), backbone="grid",
                          grid_log2_hashmap_size=14, hidden_dim=16))
    r = build_renderer(cfg)
    r.field.reset_parameters(torch.Generator().manual_seed(0))
    r.to(dev)
    x = torch.rand(1000, 3, device=dev) * 2 - 1
    kernels.reset_launch_counts()
    s, a, n = r.field.common_with_normal(x)
    (s.sum() + a.sum() + n.sum()).backward()
    assert kernels.LAUNCHES["hashgrid_fwd"] == 1
    assert kernels.LAUNCHES["hashgrid_bwd"] == 1
    assert float(r.field.grid_table.grad.abs().max()) > 0


# ---- K5 gradient clamp and K9 signed distance ------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (96, 96, 3),
                                   (1, 512, 512, 3), (5, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("limit", [0.05, 0.0])
def test_clip_grad_kernel(dev, shape, dtype, limit):
    """K5's CUDA kernel through autograd: 16-byte vectors and a scalar tail
    (105 values: 1 fp32 and 1 bf16 leftover), NaN kept, limit 0 gives
    zeros."""
    from dreamfusion_tpu_torch.ops.clip_grad import clip_grad, clip_grad_plain
    g = _gen(dev, 7)
    cot = (torch.randn(shape, device=dev, generator=g) * 0.1).to(dtype)
    cot.view(-1)[:3] = float("nan")
    x = torch.rand(shape, device=dev, generator=g).to(dtype).requires_grad_()
    kernels.reset_launch_counts()
    (gx,) = torch.autograd.grad(clip_grad(x, limit), [x], cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["clip_grad_bwd"] == 1
    assert gx.dtype == dtype
    want = clip_grad_plain(cot, limit)
    # a clamp is exact: equal values, NaN where the cotangent is NaN
    torch.testing.assert_close(gx, want, rtol=0, atol=0, equal_nan=True)
    assert int(gx.isnan().sum()) == 3
    if limit == 0:
        assert not gx.nan_to_num().any()


def _uv_sphere(n_theta=12, n_phi=18, radius=1.0):
    """A watertight UV sphere → (verts [V,3] float32, tris [T,3] int32)."""
    th = torch.pi * torch.arange(1, n_theta) / n_theta
    ph = 2 * torch.pi * torch.arange(n_phi) / n_phi
    ring = torch.stack([torch.outer(th.sin(), ph.cos()),
                        torch.outer(th.sin(), ph.sin()),
                        torch.outer(th.cos(), torch.ones_like(ph))], -1)
    verts = torch.cat([torch.tensor([[0.0, 0, 1]]), ring.reshape(-1, 3),
                       torch.tensor([[0.0, 0, -1]])]) * radius
    r = lambda i, j: 1 + i * n_phi + j % n_phi             # 0-based
    tris = [(0, r(0, j), r(0, j + 1)) for j in range(n_phi)]
    for i in range(n_theta - 2):
        for j in range(n_phi):
            tris += [(r(i, j), r(i + 1, j), r(i + 1, j + 1)),
                     (r(i, j), r(i + 1, j + 1), r(i, j + 1))]
    bot = len(verts) - 1
    tris += [(bot, r(n_theta - 2, j + 1), r(n_theta - 2, j))
             for j in range(n_phi)]
    return verts.float(), torch.tensor(tris, dtype=torch.int32)


def _with_slivers(verts, tris):
    """Add a degenerate (repeated vertex), a sliver (two vertices 1e-7
    apart) and a collinear triangle, as a decimated export has."""
    extra = torch.tensor([[0.1, 0.2, 0.3], [0.1 + 1e-7, 0.2, 0.3],
                          [0.3, -0.2, 0.1], [0.0, 0.0, 0.0],
                          [0.25, 0.25, 0.25], [0.5, 0.5, 0.5]])
    V = len(verts)
    more = torch.tensor([[V, V, V + 2], [V, V + 1, V + 2],
                         [V + 3, V + 4, V + 5]], dtype=torch.int32)
    return torch.cat([verts, extra]), torch.cat([tris, more])


@pytest.mark.parametrize("slivers", [False, True])
def test_signed_distance_kernel(dev, slivers):
    from dreamfusion_tpu_torch.mesh.sdf import (signed_distance,
                                                signed_distance_plain)
    verts, tris = _uv_sphere(radius=0.4)
    if slivers:
        verts, tris = _with_slivers(verts, tris)
    g = torch.Generator().manual_seed(3)
    pts = torch.cat([torch.rand(5000, 3, generator=g) * 1.2 - 0.6,
                     verts[:50], (verts[tris[:50, 0]] + verts[tris[:50, 1]])
                     / 2])
    kernels.reset_launch_counts()
    sd, wn = signed_distance(pts.to(dev), verts.to(dev), tris.to(dev),
                             return_winding=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["signed_distance"] == 1
    sdp, wnp = signed_distance_plain(pts, verts, tris, chunk=256,
                                     return_winding=True)
    sd, wn = sd.cpu(), wn.cpu()
    assert not sd.isnan().any() and not wn.isnan().any()
    tol = 1e-5 + 1e-5 * sdp.abs()
    assert bool(((sd.abs() - sdp.abs()).abs() <= tol).all())
    # signs agree where the winding number is clear of 0.5: the signed
    # values, as a point on the surface has sd = ±0 and a winding number
    # that the sign of a zero determinant decides
    clear = (wnp - 0.5).abs() > 1e-4
    assert bool(((sd - sdp).abs()[clear] <= tol[clear]).all())
    off = sdp.abs() > 1e-4
    torch.testing.assert_close(wn[off], wnp[off], atol=1e-4, rtol=0)
    # away from the surface, the sphere's own signed distance
    far = (pts.norm(dim=-1) - 0.4).abs() > 0.05
    want = pts.norm(dim=-1) - 0.4
    assert bool((sd[far].sign() == want[far].sign()).all())


def _sd_route(dev, pts, verts, tris, **kw):
    from dreamfusion_tpu_torch.mesh.sdf import signed_distance_cuda
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    sd, wn = signed_distance_cuda(pts.to(dev), verts.to(dev), tris.to(dev),
                                  True, count=count, **kw)
    torch.cuda.synchronize()
    return sd, wn, int(count)


@pytest.mark.parametrize("slivers", [False, True])
def test_signed_distance_culling_is_exact(dev, slivers):
    """K9 with the distance part culled by the triangle records' spheres
    against the kernel that runs the distance part for every pair (the
    per-pair arithmetic of the kernel before the records): sd and the
    winding number bit for bit, on a mesh of more than two 256-triangle
    tiles (with slivers, a degenerate and a collinear triangle) and a point
    count that is no multiple of a block; the culled kernel runs the
    distance part for fewer pairs.  The plain twin at its tolerances."""
    from dreamfusion_tpu_torch.mesh.sdf import signed_distance_plain
    verts, tris = _uv_sphere(n_theta=24, n_phi=24, radius=0.4)
    if slivers:
        verts, tris = _with_slivers(verts, tris)
    assert tris.shape[0] > 512
    g = torch.Generator().manual_seed(4)
    pts = torch.cat([torch.rand(3001, 3, generator=g) * 1.2 - 0.6,
                     verts[:40], (verts[tris[-3:, 0]] + verts[tris[-3:, 1]])
                     / 2])
    P, T = pts.shape[0], tris.shape[0]
    assert P % 128
    full = _sd_route(dev, pts, verts, tris, cull=False)
    assert full[2] == P * T
    got = _sd_route(dev, pts, verts, tris)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert got[2] < P * T
    sdp, wnp = signed_distance_plain(pts, verts, tris, chunk=256,
                                     return_winding=True)
    sd, wn = full[0].cpu(), full[1].cpu()
    tol = 1e-5 + 1e-5 * sdp.abs()
    assert bool(((sd.abs() - sdp.abs()).abs() <= tol).all())
    clear = (wnp - 0.5).abs() > 1e-4
    assert bool(((sd - sdp).abs()[clear] <= tol[clear]).all())


def test_signed_distance_culls_all_but_the_nearest_triangle(dev):
    """Points near the first triangle and 1000 triangles far from them:
    after the first pair sets each point's minimum, every other triangle's
    sphere lies beyond it, so the distance part runs once a point; the
    result is the unculled kernel's, bit for bit, and the plain twin's."""
    from dreamfusion_tpu_torch.mesh.sdf import signed_distance_plain
    g = torch.Generator().manual_seed(5)
    near_tri = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0],
                             [0.0, 0.1, 0.0]])
    far_v = torch.rand(3000, 3, generator=g) * 0.05 + 3.0
    verts = torch.cat([near_tri, far_v])
    tris = torch.arange(3003, dtype=torch.int32).reshape(-1, 3)
    pts = torch.rand(777, 3, generator=g) * 0.04 + 0.01
    P = pts.shape[0]
    got = _sd_route(dev, pts, verts, tris)
    full = _sd_route(dev, pts, verts, tris, cull=False)
    assert got[2] == P
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    sdp = signed_distance_plain(pts, verts, tris, chunk=256)
    torch.testing.assert_close(got[0].cpu(), sdp, atol=1e-5, rtol=1e-5)



def test_signed_distance_refuses_bad_indices_and_counts(dev):
    """The dispatcher checks the triangles' indices before the kernel
    gathers their corners, and the route with a launch count takes only an
    int64 counter."""
    from dreamfusion_tpu_torch.mesh.sdf import (signed_distance,
                                                signed_distance_cuda)
    verts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]], device=dev)
    pts = torch.zeros(5, 3, device=dev)
    for bad in ([[0, 1, 3]], [[0, -1, 2]]):
        with pytest.raises(ValueError, match="out of range"):
            signed_distance(pts, verts, torch.tensor(bad, device=dev))
    tris = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
    for count in (torch.zeros(1, dtype=torch.int32, device=dev),
                  torch.zeros(0, dtype=torch.int64, device=dev)):
        with pytest.raises(ValueError, match="int64"):
            signed_distance_cuda(pts, verts, tris, count=count)


# ---------------------------------------------------------------------------
# Zero-1-to-3's shapes: K10 over one key, the ViT's patch conv, K11 and K12
# at the 32² UNet and the 256² VAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,H,D", [(2, 1024, 8, 40), (6, 1024, 8, 40),
                                     (2, 256, 8, 80), (2, 64, 8, 160),
                                     (2, 16, 8, 160), (1, 77, 3, 64)])
def test_attention_over_one_key_kernel(dev, B, N, H, D):
    """zero123's cross-attention attends over one context token: the one
    KV row by TMA, the rest of the tile zero-filled and masked; P = 1, so
    the output is v bit for bit and lse the one logit (against float64),
    through the wrapper too."""
    g = _gen(dev, D + N)
    bf = torch.bfloat16
    q = (torch.randn(B, N, H, D, device=dev, generator=g) * 3).to(bf)
    k, v = (torch.randn(B, 1, H, D, device=dev, generator=g).to(bf)
            for _ in range(2))
    scale = D ** -0.5
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"attention_fwd_wgmma{'' if D == 64 else f'_d{D}'}"
                            ] == 1
    assert torch.equal(o, v.expand_as(o))
    logit = torch.einsum("bnhd,bmhd->bhn", q.double(), k.double()) * scale
    torch.testing.assert_close(lse.double(), logit, atol=1e-4, rtol=1e-5)
    assert torch.equal(attention(q, k, v), o)
    assert torch.equal(attention_plain(q, k, v, scale), o)


@pytest.mark.parametrize("patch,O", [(14, 1024), (16, 768)])
def test_patch_conv_on_the_mma_route(dev, patch, O):
    """The CLIP vision towers' patch embeddings (ViT-L/14, ViT-B/16): k =
    s = the patch on 3 channels, no bias, at 224²: conv_fwd_mma, one
    launch, within a bf16 ulp of the plain version."""
    g = _gen(dev, patch)
    bf = torch.bfloat16
    x = torch.randn(1, 224, 224, 3, device=dev, generator=g).to(bf)
    w = (torch.randn(O, patch, patch, 3, device=dev, generator=g) /
         (3 * patch * patch) ** 0.5).to(bf)
    assert conv_route(bf, 3, O, (patch, patch), patch * patch) == \
        "conv_fwd_mma"
    kernels.reset_launch_counts()
    y = conv2d(x, w, None, patch, 0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_fwd_mma"] == 1 and y.shape == (
        1, 224 // patch, 224 // patch, O)
    _within_ulp(y, conv2d_plain(x, w, None, (patch, patch), norm_padding(0),
                                bf))


@pytest.mark.parametrize("patch,O", [(16, 768), (14, 1024)])
@pytest.mark.parametrize("B", [1, 2])
def test_patch_conv_forward_and_dgrad_on_the_mma_routes(dev, patch, O, B):
    """CLIP guidance's per-step patch conv (ViT-B/16; zero123's ViT-L/14
    too): the forward on conv_fwd_mma and the input gradient through
    autograd on conv_dgrad (stride = the patch: patch² parity classes of
    one tap), one launch each, within a bf16 ulp of the plain versions;
    twice with other inputs, so the 3 → 8 channel padding is zero on every
    call, not only the first."""
    g = _gen(dev, patch + B)
    bf = torch.bfloat16
    w = (torch.randn(O, patch, patch, 3, device=dev, generator=g) /
         (3 * patch * patch) ** 0.5).to(bf)
    n = 224 // patch
    for _ in range(2):
        x = torch.randn(B, 224, 224, 3, device=dev, generator=g).to(bf)
        xr = x.clone().requires_grad_()
        kernels.reset_launch_counts()
        y = conv2d(xr, w, None, patch, 0)
        dy = torch.randn(y.shape, device=dev, generator=g).to(bf)
        (dx,) = torch.autograd.grad(y, xr, dy)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["conv_fwd_mma"] == 1
        assert kernels.LAUNCHES["conv_dgrad"] == 1
        assert y.shape == (B, n, n, O) and dx.shape == x.shape
        assert dx.dtype == bf
        _within_ulp(y, conv2d_plain(x, w, None, (patch, patch),
                                    norm_padding(0), bf))
        _within_ulp(dx, _dgrad_plain(dy, w, x.shape, patch, 0))


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad,dgrad", [
    (2, 32, 32, 8, 320, 3, 1, 1, False),        # the UNet's 8-channel conv_in
    (6, 32, 32, 320, 320, 3, 1, 1, False),      # K = 3 references
    (2, 4, 4, 1280, 1280, 3, 1, 1, False),      # the 4² level: split-K
    (2, 8, 8, 1280, 1280, 3, 2, 1, False),
    (1, 256, 256, 3, 128, 3, 1, 1, True),       # the VAE at 256²
    (1, 256, 256, 128, 128, 3, 1, 1, True),
    (1, 256, 256, 128, 128, 3, 2, ((0, 1), (0, 1)), True),
    (1, 32, 32, 512, 8, 3, 1, 1, True),         # its fp32 conv_out
])
def test_conv_at_zero123_shapes(dev, B, H, W, I, O, k, stride, pad, dgrad):
    """K12's forward (and the VAE's dgrad) at zero123's shapes on the
    routes ``conv_route`` and ``dgrad_route`` give, one launch each."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                conv2d_fwd_cuda,
                                                dgrad_route)
    g = _gen(dev, H + I)
    dt = torch.float32 if O == 8 else torch.bfloat16
    pads = norm_padding(pad)
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(dt)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(dt)
    bias = torch.randn(O, device=dev, generator=g)
    route = conv_route(dt, I, O, (stride, stride), k * k)
    kernels.reset_launch_counts()
    y = conv2d_fwd_cuda(x, w, bias, (stride, stride), pads, dt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 1 and route != "conv_fwd_mma"
    ref = conv2d_plain(x, w, bias, (stride, stride), pads, dt)
    if dt == torch.float32:
        _close_to(y, ref, 1e-5)
    else:
        _within_ulp(y, ref)
    if not dgrad:
        return
    route = dgrad_route(dt, I, O, (stride, stride), (k, k))
    dy = torch.randn(y.shape, device=dev, generator=g).to(dt)
    kernels.reset_launch_counts()
    dx = conv2d_dgrad_cuda(dy, w, x.shape, (stride, stride), pads, dt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 1 and route != "conv_dgrad"
    ref = _dgrad_plain(dy, w, x.shape, stride, pad)
    if dt == torch.float32:
        _close_to(dx, ref, 1e-5)
    else:
        _within_ulp(dx, ref)


@pytest.mark.parametrize("B,H,W,C,silu,bwd", [
    (2, 32, 32, 320, True, False), (6, 32, 32, 320, True, False),
    (2, 16, 16, 1920, True, False), (2, 4, 4, 2560, True, False),
    (1, 256, 256, 128, True, True), (1, 128, 128, 256, True, True),
    (1, 32, 32, 512, False, True), (3, 256, 256, 128, True, False),
])
def test_groupnorm_at_zero123_shapes(dev, B, H, W, C, silu, bwd):
    """K11 at zero123's UNet (CFG batch 2 and 6) and 256² VAE shapes
    (forward and backward; batch 3: the embedding of three references),
    each one launch of its route."""
    g = _gen(dev, C + H)
    bf = torch.bfloat16
    G = groups_for(C)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3 + 1).to(bf)
    wt, bs = (torch.randn(C, device=dev, generator=g).to(bf)
              for _ in range(2))
    sms = kernels.sm_count(dev)
    fwd = group_norm_route(tuple(x.shape), bf, False, G, sms)
    xr = x.clone().requires_grad_(bwd)
    kernels.reset_launch_counts()
    y = group_norm(xr, wt, bs, G, 1e-6, silu)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[fwd.name] == 1
    _close_to(y, group_norm_plain(x, wt, bs, G, 1e-6, silu), 1e-2)
    if not bwd:
        return
    route = group_norm_route(tuple(x.shape), bf, True, G, sms)
    dy = torch.randn(y.shape, device=dev, generator=g).to(bf)
    (dx,) = torch.autograd.grad(y, xr, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route.name] == 1
    x32 = x.float().requires_grad_()
    (dxp,) = torch.autograd.grad(group_norm_plain(x32, wt, bs, G, 1e-6,
                                                  silu), x32, dy.float())
    _close_to(dx, dxp, 2e-2)


# ---------------------------------------------------------------------------
# DeepFloyd-IF's shapes: K10 over [77 text + N spatial] keys, K12 at the
# IF-I-XL UNet's widths, and a narrow IF UNet on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,M,H", [(2, 1024, 1101, 20), (2, 256, 333, 40),
                                     (2, 64, 141, 40), (4, 64, 141, 40),
                                     (4, 256, 333, 40)])
def test_attention_at_if_key_counts(dev, B, N, M, H):
    """IF's attention: d = 64 over 77 text keys then N spatial ones (M
    never a multiple of the KV tile: the last tile zero-filled by TMA and
    masked; the first mixes text and spatial keys), at CFG batch 2 and
    Perp-Neg's 4: o within a bf16 ulp-ish of the plain version and lse the
    fp32 logits' logsumexp."""
    g = _gen(dev, N + M)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, 64, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    scale = 64 ** -0.5
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd_wgmma"] == 1
    _close_to(o, attention_plain(q, k, v, scale), 2e-2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1),
                               atol=1e-4, rtol=1e-5)
    assert torch.equal(attention(q, k, v), o)


@pytest.mark.parametrize("B,H,W,I,O,k", [
    (2, 64, 64, 3, 640, 3),         # conv_in: the narrow-input route
    (2, 64, 64, 1920, 640, 3),      # the 64² up level's first skip concat
    (2, 64, 64, 1280, 640, 1),      # a 1x1 shortcut
    (2, 32, 32, 640, 1280, 1),
    (2, 16, 16, 3840, 2560, 3),
    (2, 8, 8, 5120, 2560, 3),       # a 236 MB weight; split-K
    (2, 8, 8, 5120, 2560, 1),
    (2, 64, 64, 640, 6, 3),         # conv_out: fp32
])
def test_conv_at_if_shapes(dev, B, H, W, I, O, k):
    """K12's forward at IF-I-XL's widths, one launch of the route
    ``conv_route`` gives (never mma.sync), within a bf16 ulp (fp32: 1e-5)
    of the plain version."""
    g = _gen(dev, I + O + k)
    dt = torch.float32 if O == 6 else torch.bfloat16
    pad = k // 2
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(dt)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(dt)
    bias = torch.randn(O, device=dev, generator=g)
    route = conv_route(dt, I, O, (1, 1), k * k)
    assert route == ("conv_fwd_fp32" if dt == torch.float32 else
                     "conv_fwd_wgmma_i8" if I == 3 else "conv_fwd_wgmma")
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, 1, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 1 and y.shape == (B, H, W, O)
    ref = conv2d_plain(x, w, bias, (1, 1), norm_padding(pad), dt)
    if dt == torch.float32:
        _close_to(y, ref, 1e-5)
    else:
        _within_ulp(y, ref)


def test_narrow_if_unet_on_the_card(dev):
    """A narrow IF UNet (64/128 channels, head dim 64) in bf16 on the card
    against the same weights on the CPU's plain versions; every conv and
    attention one launch of its route."""
    from dreamfusion_tpu_torch.models.if_unet import IFUNet, IFUNetConfig
    cfg = IFUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                       attn_levels=(False, True), head_dim=64,
                       cross_attention_dim=64, encoder_hid_dim=96,
                       addition_num_heads=4)
    torch.manual_seed(0)
    cpu = IFUNet(cfg, torch.bfloat16)
    for p in cpu.parameters():
        p.copy_(torch.randn(p.shape) * 0.05)
    card = IFUNet(cfg, torch.bfloat16).to(dev)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 3, generator=g)
    t = torch.tensor([20, 731])
    ctx = torch.randn(2, 77, 96, generator=g)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = card(x.to(dev), t.to(dev), ctx.to(dev))
        torch.cuda.synchronize()
        want = cpu(x, t, ctx)
    # 2 resnets down and the downsampler, 2 mid, 4 up and the upsampler:
    # 10 x 2 convs and 5 shortcuts, then conv_in, conv_out; the attentions
    # at 8²: 1 down, 1 mid, 2 up
    assert kernels.LAUNCHES["conv_fwd_wgmma"] == 25
    assert kernels.LAUNCHES["conv_fwd_wgmma_i8"] == 1
    assert kernels.LAUNCHES["conv_fwd_fp32"] == 1
    assert kernels.LAUNCHES["attention_fwd_wgmma"] == 4
    assert kernels.LAUNCHES["conv_fwd_mma"] == 0
    _close_to(got.cpu(), want, 5e-2)


# the SD VAE decoder's shapes that no encoder or UNet row has (512², and
# zero123's at 256²): B, H, W, I, O; 3x3, stride 1, pad 1
DECODER_CONVS = [(1, 64, 64, 4, 512), (1, 256, 256, 512, 512),
                 (1, 256, 256, 512, 256), (1, 512, 512, 256, 256),
                 (1, 512, 512, 256, 128), (1, 128, 128, 512, 256),
                 (1, 256, 256, 256, 128), (1, 32, 32, 4, 512)]


@pytest.mark.parametrize("B,H,W,I,O", DECODER_CONVS)
def test_conv_at_the_decoder_shapes(dev, B, H, W, I, O):
    """K12's forward at the decoder's shapes, one launch of its route,
    within a bf16 ulp of the plain version."""
    g = _gen(dev, 21)
    bf = torch.bfloat16
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(bf)
    w = (torch.randn(O, 3, 3, I, device=dev, generator=g) /
         (9 * I) ** 0.5).to(bf)
    bias = torch.randn(O, device=dev, generator=g)
    route = conv_route(bf, I, O, (1, 1), 9)
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, 1, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    _within_ulp(y, conv2d_plain(x, w, bias, (1, 1), norm_padding(1), bf))


def test_conv_out_of_the_decoder_in_fp32(dev):
    """The decoder's conv_out at 512² (fp32, 128 → 3): K12's fp32 route."""
    g = _gen(dev, 22)
    x = torch.randn(1, 512, 512, 128, device=dev, generator=g)
    w = torch.randn(3, 3, 3, 128, device=dev, generator=g) / 34.0
    bias = torch.randn(3, device=dev, generator=g)
    kernels.reset_launch_counts()
    y = conv2d(x, w, bias, 1, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_fwd_fp32"] == 1
    _close_to(y, conv2d_plain(x, w, bias, (1, 1), norm_padding(1),
                              torch.float32), 1e-5)


@pytest.mark.parametrize("B,H,W,C,silu", [
    (1, 512, 512, 256, True), (1, 256, 256, 512, True),
    (1, 512, 512, 128, True), (1, 256, 256, 256, True),
    (1, 128, 128, 512, True), (1, 64, 64, 512, False)])
def test_groupnorm_at_the_decoder_shapes(dev, B, H, W, C, silu):
    """K11's forward at the decoder's norms (eps 1e-6), one launch of the
    route group_norm_route names (streaming above its resident limit)."""
    g = _gen(dev, 23)
    G = groups_for(C)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3 + 1).to(
        torch.bfloat16)
    wt = torch.randn(C, device=dev, generator=g).to(torch.bfloat16)
    bs = torch.randn(C, device=dev, generator=g).to(torch.bfloat16)
    route = group_norm_route(tuple(x.shape), torch.bfloat16, False, G,
                             kernels.sm_count(dev))
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = group_norm(x, wt, bs, G, 1e-6, silu)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route.name] == 1
    if H * W * C * 2 > 64 << 20:
        assert route.name == "groupnorm_fwd_stream"
    _close_to(y, group_norm_plain(x, wt.float(), bs.float(), G, 1e-6, silu),
              1e-2)


def test_narrow_vae_decoder_on_the_card(dev):
    """A narrow SD-topology VAE decoder (64 channels, 4 levels: three
    nearest-2x upsamples, the mid-block attention at d = 64) in bf16 on the
    card against the same weights on the CPU's plain versions; every conv,
    norm and attention one launch of its route."""
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    cfg = VAEConfig(ch=64, ch_mult=(1, 1, 1, 1))
    torch.manual_seed(0)
    cpu = AutoencoderKL(cfg)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape) * 0.05)
    card = AutoencoderKL(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    z = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = card.decode(z.to(dev))
        torch.cuda.synchronize()
        want = cpu.decode(z)
    assert got.shape == (1, 128, 128, 3)
    # 2 mid resnets + 4 levels x 3 resnets, 2 convs each; 3 upsample convs;
    # conv_in (4 channels) and conv_out (fp32)
    assert kernels.LAUNCHES["conv_fwd_wgmma"] == 31
    assert kernels.LAUNCHES["conv_fwd_wgmma_i8"] == 1
    assert kernels.LAUNCHES["conv_fwd_fp32"] == 1
    assert kernels.LAUNCHES["attention_fwd_wgmma"] == 1
    assert sum(v for k, v in kernels.LAUNCHES.items()
               if k.startswith("groupnorm_fwd")) == 30
    _close_to(got.cpu(), want, 5e-2)


@pytest.mark.parametrize("B,N,M,H", [
    (1, 577, 577, 12),       # the DPT's ViT-B at 384²
    (2, 65, 1, 3),           # one key; a query tile of one row
    (1, 50, 130, 2),         # ragged query and key tiles
    (2, 97, 65, 3),          # 32-row query tiles, the last of one row; a
                             # last key tile of one key: its upper key half
                             # all masked
])
def test_attention_fp32_kernel(dev, B, N, M, H):
    """K10's fp32 forward (the DPT's, JAX's dense branch): out against the
    plain version at 1e-5 of its largest, lse against the fp32 logits'
    logsumexp, two launches bit for bit (the two key halves of a block
    merge in a fixed order); fp32 q, k, v of d != 64 refuse, and the
    backward through autograd takes ``attention_bwd_fp32``."""
    g = _gen(dev, 21)
    q = torch.randn(B, N, H, 64, device=dev, generator=g)
    k, v = (torch.randn(B, M, H, 64, device=dev, generator=g)
            for _ in range(2))
    kernels.reset_launch_counts()
    o, lse = attention_fwd_cuda(q, k, v, 0.125)
    o2, lse2 = attention_fwd_cuda(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd_fp32"] == 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = attention_plain(q, k, v, 0.125)
    torch.testing.assert_close(o, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * 0.125
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)
    if M == 1:
        assert torch.allclose(o, v.expand_as(o), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        attention_fwd_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), 0.125)
    qr = q.clone().requires_grad_()
    kernels.reset_launch_counts()
    attention(qr, k, v).sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_bwd_fp32"] == 1
    assert qr.grad.dtype == torch.float32


# ---------------------------------------------------------------------------
# the towers' backward to their weights: K12's wgrad, K11's affine
# gradients, K10's backward at the UNets' head dims
# ---------------------------------------------------------------------------

def _rel_close(got, want, ulp, floor):
    """|got - want| <= ulp·|want| + floor·max|want| everywhere."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=floor * scale,
                               rtol=ulp)


@pytest.mark.parametrize("B,H,W,I,O,k,stride,pad,dt,want", [
    (2, 64, 64, 320, 320, 3, 1, 1, "bf16", "split"),  # the UNet's 64² level
    (2, 8, 8, 1280, 1280, 3, 1, 1, "bf16", "one"),    # 8²: no split
    (2, 32, 32, 320, 640, 1, 1, 0, "bf16", "split"),  # 1x1, I = 320: K 2.5
    (2, 64, 64, 320, 320, 3, 2, 1, "bf16", "wgmma"),  # a UNet downsampler
    (1, 512, 512, 128, 128, 3, 1, 1, "bf16", "split"),  # the VAE's 512²
    (1, 512, 512, 128, 128, 3, 2, ((0, 1), (0, 1)), "bf16", "wgmma"),
    (1, 34, 30, 128, 64, 3, 2, ((0, 1), (0, 1)), "bf16", "wgmma"),  # ragged
    (2, 6, 6, 128, 64, 3, 1, 1, "bf16", "wgmma"),     # a ragged 8x8 box
    (2, 4, 4, 256, 136, 3, 1, 1, "bf16", "wgmma"),    # 4x4x4: past B, O
    (3, 5, 7, 64, 72, 3, 1, 1, "bf16", "wgmma"),      # ragged x, y and B
    (1, 512, 512, 3, 128, 3, 1, 1, "bf16", "i8"),     # the VAE conv_in
    (2, 64, 64, 4, 320, 3, 1, 1, "bf16", "i8"),       # SD's conv_in
    (2, 32, 32, 8, 320, 3, 1, 1, "bf16", "i8"),       # zero123's conv_in
    (1, 37, 45, 3, 64, 3, 1, 1, "bf16", "i8"),        # 1,665 pixels: ragged
    (2, 13, 70, 4, 72, 3, 1, 1, "bf16", "i8"),        # O past a 64 box
    (1, 20, 9, 8, 16, 3, 1, 1, "bf16", "i8"),         # I = 8, one split
    (1, 16, 16, 3, 8, 1, 1, 0, "bf16", "i8"),         # 1x1: one tap
    (1, 17, 15, 3, 16, 3, 2, 1, "bf16", "mma"),       # narrow at stride 2
    (2, 64, 64, 320, 4, 3, 1, 1, "fp32", "fp32"),     # the UNet's conv_out
    (1, 64, 64, 512, 8, 3, 1, 1, "fp32", "fp32"),     # the VAE's conv_out
    (1, 9, 11, 24, 40, 3, 2, 1, "bf16", "mma"),       # ragged tiles
    (2, 7, 5, 12, 20, 3, 1, 1, "bf16", "mma"),        # O, I % 8 != 0
    (1, 8, 8, 64, 12, 3, 1, 1, "bf16", "mma"),        # O % 8 != 0
    (1, 13, 9, 5, 7, 3, 2, ((0, 1), (0, 1)), "fp32", "fp32"),
    (1, 6, 6, 16, 12, 1, 1, 0, "fp32", "fp32"),
])
def test_conv_wgrad_kernel(dev, B, H, W, I, O, k, stride, pad, dt, want):
    """K12's weight gradient on its route (`want`: wgmma, with one split or
    several; its narrow-input form for the conv_ins' I <= 8 at stride 1;
    mma.sync for the other bf16 shapes; the tiled fp32 GEMM)
    against the transposed shifted einsum in fp32: bf16 dW within one bf16
    ulp plus 2^-8 of its largest entry, fp32 within 1e-5 relative plus
    1e-4 of its largest; two launches bit for bit (the splits summed in
    order); then through autograd with x and the weight and bias asking:
    one wgrad and one dgrad launch, Σ dy for the bias."""
    from dreamfusion_tpu_torch.ops.conv import (conv2d_wgrad_cuda,
                                                conv2d_wgrad_plain,
                                                dgrad_route, wgmma_wgrad_splits,
                                                wgrad_boxes, wgrad_route)
    dtype = torch.float32 if dt == "fp32" else torch.bfloat16
    g = _gen(dev, 31)
    pads = norm_padding(pad)
    x = torch.randn(B, H, W, I, device=dev, generator=g).to(dtype)
    w = (torch.randn(O, k, k, I, device=dev, generator=g) /
         (k * k * I) ** 0.5).to(dtype)
    Ho, Wo = ((H + sum(pads[0]) - k) // stride + 1,
              (W + sum(pads[1]) - k) // stride + 1)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g).to(dtype)
    route = wgrad_route(dtype, I, O, (stride, stride), k * k)
    assert route == {"split": "conv_wgrad_wgmma", "one": "conv_wgrad_wgmma",
                     "wgmma": "conv_wgrad_wgmma", "mma": "conv_wgrad_mma",
                     "i8": "conv_wgrad_wgmma_i8",
                     "fp32": "conv_wgrad_fp32_tiled"}[want]
    if want in ("split", "one"):
        splits = wgmma_wgrad_splits(O, k * k * I, wgrad_boxes(B, Ho, Wo),
                                    kernels.sm_count(dev))
        assert (splits > 1) == (want == "split")
    kernels.reset_launch_counts()
    dw = conv2d_wgrad_cuda(x, dy, w.shape, (stride, stride), pads, dtype)
    dw2 = conv2d_wgrad_cuda(x, dy, w.shape, (stride, stride), pads, dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 2 and sum(kernels.LAUNCHES.values()) \
        == 2
    assert dw.dtype == dtype and torch.equal(dw, dw2)
    ref = conv2d_wgrad_plain(x, dy, w.shape, (stride, stride), pads)
    if dtype == torch.float32:
        _rel_close(dw, ref, 1e-5, 1e-4)
    else:
        _rel_close(dw, ref, 2 ** -7, 2 ** -8)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    bias = torch.zeros(O, device=dev, dtype=dtype, requires_grad=True)
    y = conv2d(xr, wr, bias, stride, pad)
    kernels.reset_launch_counts()
    dx, dwa, db = torch.autograd.grad(y, (xr, wr, bias), dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 1
    assert kernels.LAUNCHES[dgrad_route(dtype, I, O, (stride, stride),
                                        (k, k))] == 1
    assert torch.equal(dwa, dw) and dx.shape == x.shape
    _rel_close(db, dy.float().sum((0, 1, 2)), 2 ** -7, 1e-5)


def test_conv_wgrad_refuses_what_it_cannot_take(dev):
    """A misaligned view on the tensor-core route, a dy of another grid and
    an fp16 input raise instead of launching."""
    from dreamfusion_tpu_torch.ops.conv import conv2d_wgrad_cuda
    bf = torch.bfloat16
    buf = torch.randn(2 * 6 * 6 * 16 + 1, device=dev).to(bf)
    x = buf[1:].view(2, 6, 6, 16)
    dy = torch.randn(2, 6, 6, 8, device=dev).to(bf)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        conv2d_wgrad_cuda(x, dy, (8, 3, 3, 16), (1, 1), norm_padding(1), bf)
    with pytest.raises(ValueError):
        conv2d_wgrad_cuda(x.clone(), dy[:, :5], (8, 3, 3, 16), (1, 1),
                          norm_padding(1), bf)
    with pytest.raises(ValueError):
        conv2d_wgrad_cuda(x.clone().half(), dy.half(), (8, 3, 3, 16),
                          (1, 1), norm_padding(1), torch.float16)
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("B,H,W,C,eps,silu,dtype,wdt", [
    (2, 64, 64, 320, 1e-5, True, torch.bfloat16, torch.bfloat16),
    (2, 8, 8, 1280, 1e-6, False, torch.bfloat16, torch.bfloat16),
    (2, 16, 16, 2560, 1e-5, True, torch.bfloat16, torch.bfloat16),
    (1, 64, 64, 512, 1e-6, True, torch.bfloat16, torch.bfloat16),
    (1, 512, 512, 128, 1e-6, True, torch.bfloat16, torch.bfloat16),  # stream
    (1, 256, 256, 256, 1e-6, True, torch.bfloat16, torch.bfloat16),  # stream
    (2, 5, 7, 40, 1e-6, False, torch.float32, torch.float32),
    (1, 200, 190, 24, 1e-6, True, torch.float32, torch.float32),     # Cg 3
    (1, 400, 400, 32, 1e-6, False, torch.float32, torch.float32),    # stream
    (2, 32, 32, 1920, 1e-5, True, torch.bfloat16, torch.float32),    # Cg 60
])
def test_groupnorm_affine_kernel(dev, B, H, W, C, eps, silu, dtype, wdt):
    """K11's backward with the affine gradients (resident and streaming
    routes, Cg = 1, 3, 10, 40, 60, 80, bf16 and fp32 weights): dx as the
    frozen route's bit for bit, dscale and dbias against autograd of the
    plain version in fp32 within one ulp of their dtype plus 2^-8 (bf16)
    or 1e-4 (fp32) of their largest entry; one launch of the route's
    ``_affine`` entry point; two launches bit for bit."""
    from dreamfusion_tpu_torch.ops.groupnorm import (group_norm_bwd_cuda,
                                                     group_norm_fwd_cuda)
    g = _gen(dev, 32)
    G = groups_for(C)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3 + 1).to(dtype)
    wt = (1 + 0.3 * torch.randn(C, device=dev, generator=g)).to(wdt)
    bs = (0.3 * torch.randn(C, device=dev, generator=g)).to(wdt)
    dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    route = group_norm_route(tuple(x.shape), dtype, True, G,
                             kernels.sm_count(dev))
    _, stats = group_norm_fwd_cuda(x, wt, bs, G, eps, silu)
    kernels.reset_launch_counts()
    dx, dw, db = group_norm_bwd_cuda(x, wt, bs, stats, dy, G, silu,
                                     affine=True)
    dx2, dw2, db2 = group_norm_bwd_cuda(x, wt, bs, stats, dy, G, silu,
                                        affine=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route.name + "_affine"] == 2
    assert sum(kernels.LAUNCHES.values()) == 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert dw.dtype == wdt and db.dtype == wdt
    assert torch.equal(dx, group_norm_bwd_cuda(x, wt, bs, stats, dy, G,
                                               silu))
    ins = [t.float().requires_grad_() for t in (x, wt, bs)]
    want = torch.autograd.grad(group_norm_plain(*ins, G, eps, silu), ins,
                               dy.float())
    ulp, floor = (1e-5, 1e-4) if wdt == torch.float32 else (2 ** -7,
                                                            2 ** -8)
    _rel_close(dw, want[1], ulp, floor)
    _rel_close(db, want[2], ulp, floor)
    _close_to(dx, want[0], 1e-4 if dtype == torch.float32 else 2e-2)
    # through autograd: the affine route once, in the parameters' dtype
    xr = x.clone().requires_grad_()
    wr, br = wt.clone().requires_grad_(), bs.clone().requires_grad_()
    y = group_norm(xr, wr, br, G, eps, silu)
    kernels.reset_launch_counts()
    gx, gw, gb = torch.autograd.grad(y, (xr, wr, br), dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route.name + "_affine"] == 1
    assert torch.equal(gw, dw) and torch.equal(gb, db) and torch.equal(gx, dx)


@pytest.mark.parametrize("B,N,M,H,D,rq", [
    (2, 4096, 4096, 8, 40, True),      # SD 1.5's 64² self (chunked)
    (2, 4096, 77, 8, 40, False),       # its cross-attention
    (2, 4096, 4096, 5, 64, False),     # SD 2.1's 64² self
    (2, 4096, 77, 5, 64, False),       # its cross-attention: query splits
    (2, 256, 256, 20, 64, False),
    (1, 257, 77, 2, 64, False),        # N = 257: a ragged query tile
    (1, 257, 1, 2, 64, False),
    (1, 257, 300, 3, 40, True),        # ragged both sides, rounded q·scale
    (1, 1000, 77, 1, 40, False),       # ragged N over 4 query splits
    (2, 1024, 1024, 8, 80, False),
    (2, 1024, 77, 8, 80, False),
    (2, 256, 256, 8, 160, False),
    (2, 64, 77, 8, 160, False),        # the 8² cross-attention
    (2, 1024, 1, 8, 40, False),        # zero123's one key
    (2, 64, 1, 8, 160, False),
    (1, 300, 512, 2, 80, True),        # rounded q·scale at d = 80
    (2, 200, 130, 3, 40, False),       # ragged query and key tiles
    (1, 100, 77, 2, 160, True),
])
def test_attention_bwd_sd15_head_dims_kernel(dev, B, N, M, H, D, rq):
    """K10's flash-style backward at the UNets' head dims 40, 64, 80 and
    160 (the k steps over d in 64 columns, TMA's zero fill past d; query
    splits of the dK/dV pass where its blocks leave SMs idle), with rq the
    logits of bf16(q·scale) (JAX's chunked branch): dQ, dK and dV against
    the kernels' arithmetic in torch (``attention_bwd_plain`` on the same
    branch) within one bf16 ulp plus 2^-8 of their largest entry; one
    launch of the head dim's route; two launches bit for bit; over one key
    dQ and dK are 0 in exact arithmetic (dS = P (dP - D) with P = 1):
    within 2^-8 of dV's largest entry."""
    g = _gen(dev, D + M)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    q = (q.float() * 3).to(bf)          # logits of a few units
    scale = D ** -0.5
    o, lse = attention_fwd_cuda(q, k, v, scale, rq)
    do = torch.randn(o.shape, device=dev, generator=g).to(bf)
    route = attention_bwd_route(D)
    assert route == ("attention_bwd_flash" if D == 64 else
                     f"attention_bwd_flash_d{D}")
    kernels.reset_launch_counts()
    got = attention_bwd_cuda(q, k, v, o, lse, do, scale, rq)
    got2 = attention_bwd_cuda(q, k, v, o, lse, do, scale, rq)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == 2 and sum(kernels.LAUNCHES.values()) \
        == 2
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    want = attention_bwd_plain(q, k, v, o, do, scale, rq)
    for name, a, b in zip("qkv", got, want):
        if M == 1 and name in "qk":
            ref = float(want[2].float().abs().max())
            assert float(a.float().abs().max()) <= 2 ** -8 * ref, name
            continue
        _within_ulp(a, b, 2 ** -8)
    if rq:
        # the rounded q·scale is the one the forward used: the unrounded
        # logits' backward lies measurably further off
        off = attention_bwd_plain(q, k, v, o, do, scale, False)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        other = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, off))
        assert err <= other, (err, other)


def test_narrow_unet_gradients_on_the_card(dev):
    """The sd15-form UNet at test width (head dims 40 and 80, 32² latents,
    bf16, every parameter trainable) on the card against the same weights
    on the CPU's plain versions: every parameter's gradient and the
    input's, each within 5e-2 of its largest entry (bf16 activations and
    weights, rounded at other places on the two sides); each K10-K12
    backward route launched as often as the forward calls its layer."""
    from dreamfusion_tpu_torch.models.unet import (GroupNorm32,
                                                   UNet2DCondition,
                                                   UNetConfig)
    cfg = UNetConfig(model_channels=80, channel_mult=(1, 2),
                     num_res_blocks=1, attn_levels=(True, True), num_heads=2,
                     head_dim=None, context_dim=768, dtype=torch.bfloat16)
    torch.manual_seed(0)
    cpu = UNet2DCondition(cfg)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            norm = name.endswith("weight") and p.ndim == 1
            p.copy_((1 + 0.1 * torch.randn(p.shape)) if norm else
                    torch.randn(p.shape) * 0.05)
    card = UNet2DCondition(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([20, 731])
    ctx = torch.randn(2, 77, 768, generator=gen)
    ct = torch.randn(2, 32, 32, 4, generator=gen)
    grads = {}
    for name, net, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        net.requires_grad_(True)
        xr = x.to(d, copy=True).requires_grad_()
        out = net(xr, t.to(d), ctx.to(d))
        kernels.reset_launch_counts()
        (out.float() * ct.to(d)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        grads[name] = {"input": xr.grad, **{
            n: p.grad for n, p in net.named_parameters()}}
    convs = sum(1 for m in card.modules() if type(m).__name__ == "Conv2d")
    norms = sum(1 for m in card.modules() if isinstance(m, GroupNorm32))
    assert launches["conv_wgrad_wgmma"] + launches["conv_wgrad_mma"] + \
        launches["conv_wgrad_wgmma_i8"] + launches["conv_wgrad_fp32_tiled"] \
        == convs
    assert launches["conv_wgrad_fp32_tiled"] == 1
    assert launches["conv_wgrad_wgmma_i8"] == 1          # the conv_in
    assert sum(v for k, v in launches.items()
               if k.startswith("groupnorm_bwd") and k.endswith("_affine")) \
        == norms
    assert launches["attention_bwd_flash_d40"] > 0
    assert launches["attention_bwd_flash_d80"] > 0
    assert launches["conv_dgrad"] + launches["conv_dgrad_wgmma"] + \
        launches["conv_dgrad_fp32"] + launches["conv_dgrad_narrow"] == convs
    worst = []
    for n, want in grads["cpu"].items():
        got = grads["card"][n]
        assert got is not None and bool(torch.isfinite(got).all()), n
        scale = float(want.float().abs().max())
        err = float((got.cpu().float() - want.float()).abs().max())
        worst.append((err / max(scale, 1e-30), n))
    worst.sort(reverse=True)
    print("narrow UNet gradients, worst err / max:", worst[:5])
    assert worst[0][0] <= 5e-2, worst[:5]


# ---------------------------------------------------------------------------
# the DPT's backward (K10's fp32 backward, K12's tiled fp32 dgrad and its
# fp32 wgrad) and K1's and K6's second derivative into the positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,M,H", [
    (1, 577, 577, 12),       # the DPT's ViT-B at 384²
    (2, 65, 1, 3),           # one key
    (1, 50, 130, 2),         # ragged query and key blocks
    (2, 97, 65, 3),          # a last block of one query, of one key
])
def test_attention_bwd_fp32_kernel(dev, B, N, M, H):
    """K10's fp32 backward (``attention_bwd_fp32``) against the plain
    version (P and dS unrounded in fp32): dq, dk, dv within 1e-5 relative
    plus 1e-4 of each one's largest; two launches bit for bit (no atomics);
    over one key dQ and dK are 0 in exact arithmetic and are held to dV's
    largest."""
    g = _gen(dev, 41)
    q, do = (torch.randn(B, N, H, 64, device=dev, generator=g)
             for _ in range(2))
    k, v = (torch.randn(B, M, H, 64, device=dev, generator=g)
            for _ in range(2))
    o, lse = attention_fwd_cuda(q, k, v, 0.125)
    kernels.reset_launch_counts()
    got = attention_bwd_cuda(q, k, v, o, lse, do, 0.125)
    again = attention_bwd_cuda(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_bwd_fp32"] == 2
    assert sum(kernels.LAUNCHES.values()) == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = attention_bwd_plain(q, k, v, o, do, 0.125)
    if M == 1:
        ref = float(want[2].abs().max())
        for a in got[:2]:
            assert float(a.abs().max()) <= 1e-4 * ref
        _rel_close(got[2], want[2], 1e-5, 1e-4)
    else:
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            _rel_close(a, b, 1e-5, 1e-4)
    with pytest.raises(ValueError):
        attention_bwd_cuda(q, k, v, o, lse, do, 0.125, round_q=True)


# (B, H, W, I, O, k, stride): TF-SAME pads as the DPT takes them
DGRAD_FP32_TILED_CASES = [
    (1, 38, 38, 3, 64, 7, 2),        # the stem: a 3-channel dx
    (1, 16, 18, 64, 256, 1, 2),      # the downsample: 3 classes of zeros
    (1, 24, 24, 32, 48, 3, 2),       # post4_down's form
    (2, 9, 11, 40, 72, 3, 1),        # stride 1, ragged tiles
    (1, 6, 6, 256, 256, 3, 1),       # split over K
    (1, 13, 11, 6, 5, 3, 2),         # 4-byte copies of a 5-channel dy
    (1, 12, 12, 768, 256, 3, 1),     # the 12² convs' widths
]


@pytest.mark.parametrize("B,H,W,I,O,k,stride", DGRAD_FP32_TILED_CASES)
def test_conv_dgrad_fp32_tiled_kernel(dev, B, H, W, I, O, k, stride):
    """K12's tiled fp32 input gradient over dx's parity classes against
    autograd of the plain forward: within 1e-5 relative plus 1e-4 of the
    largest, the borders too; two launches bit for bit (the splits summed
    in order); through autograd with the weight asking, one dgrad and one
    wgrad launch."""
    from dreamfusion_tpu_torch.models.dpt import same_pads
    from dreamfusion_tpu_torch.ops.conv import (conv2d_dgrad_cuda,
                                                dgrad_route, out_size)
    assert dgrad_route(torch.float32, I, O, (stride, stride), (k, k)) == \
        "conv_dgrad_fp32_tiled"
    g = _gen(dev, 43)
    pads = (same_pads(H, k, stride), same_pads(W, k, stride))
    w = torch.randn(O, k, k, I, device=dev, generator=g) / (k * k * I) ** 0.5
    Ho, Wo = out_size(H, W, k, k, (stride, stride), pads)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g)
    kernels.reset_launch_counts()
    dx = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads,
                           torch.float32)
    dx2 = conv2d_dgrad_cuda(dy, w, (B, H, W, I), (stride, stride), pads,
                            torch.float32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_dgrad_fp32_tiled"] == 2
    assert kernels.LAUNCHES["conv_dgrad"] == 0
    assert torch.equal(dx, dx2)
    xr = torch.zeros(B, H, W, I, device=dev, requires_grad=True)
    (ref,) = torch.autograd.grad(conv2d_plain(
        xr, w, None, (stride, stride), pads, torch.float32), xr, dy)
    _rel_close(dx, ref, 1e-5, 1e-4)
    _rel_close(_border(dx), _border(ref), 1e-5, 1e-4)
    xg = torch.randn(B, H, W, I, device=dev, generator=g,
                     requires_grad=True)
    wg = w.clone().requires_grad_()
    kernels.reset_launch_counts()
    torch.autograd.grad(conv2d(xg, wg, None, stride, pads), (xg, wg), dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_dgrad_fp32_tiled"] == 1
    assert kernels.LAUNCHES["conv_wgrad_fp32_tiled"] == 1


@pytest.mark.parametrize("B,H,W,I,O,k,stride", [
    (1, 24, 24, 256, 256, 3, 1), (1, 48, 48, 64, 128, 3, 1),
    (1, 38, 38, 3, 64, 7, 2), (1, 16, 16, 512, 256, 1, 2),
    (1, 384, 384, 3, 64, 7, 2),                # the stem
    (1, 6, 384, 128, 32, 3, 1),                # O = 32 at 384²'s width
    (1, 12, 12, 768, 256, 3, 1),               # one 9-step split
    (2, 64, 64, 320, 4, 3, 1), (1, 64, 64, 512, 8, 3, 1),  # the conv_outs
    (1, 20, 18, 6, 36, 3, 1),                  # I % 4 != 0, 4-byte copies
    (2, 9, 7, 16, 10, 3, 2),                   # O % 4 != 0
])
def test_conv_wgrad_fp32_at_dpt_widths(dev, B, H, W, I, O, k, stride):
    """K12's fp32 weight gradient (``conv_wgrad_fp32_tiled``) at the DPT's
    widths (O = 32-768, the stem's 3 input channels, TF-SAME pads) and the
    conv_outs' O = 4 and 8 against the transposed shifted einsum: 1e-5
    relative plus 1e-4 of the largest; two launches bit for bit."""
    from dreamfusion_tpu_torch.models.dpt import same_pads
    from dreamfusion_tpu_torch.ops.conv import (conv2d_wgrad_cuda,
                                                conv2d_wgrad_plain, out_size)
    g = _gen(dev, 47)
    pads = (same_pads(H, k, stride), same_pads(W, k, stride))
    x = torch.randn(B, H, W, I, device=dev, generator=g)
    Ho, Wo = out_size(H, W, k, k, (stride, stride), pads)
    dy = torch.randn(B, Ho, Wo, O, device=dev, generator=g)
    kernels.reset_launch_counts()
    dw = conv2d_wgrad_cuda(x, dy, (O, k, k, I), (stride, stride), pads,
                           torch.float32)
    dw2 = conv2d_wgrad_cuda(x, dy, (O, k, k, I), (stride, stride), pads,
                            torch.float32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_wgrad_fp32_tiled"] == 2
    assert sum(kernels.LAUNCHES.values()) == 2
    assert torch.equal(dw, dw2)
    _rel_close(dw, conv2d_wgrad_plain(x, dy, (O, k, k, I), (stride, stride),
                                      pads), 1e-5, 1e-4)


def _jac_cots(dev, g, x, D, case, gdtype, with_feat):
    cots = [_field_cots(dev, g, x, D, case, gdtype) for _ in range(4)]
    if not with_feat:
        cots[0] = None
    return cots


@pytest.mark.parametrize("with_feat", [True, False])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,case", FIELD_CASES[:3])
@pytest.mark.parametrize("R,C", [(64, 16), (17, 6)])
def test_triplane_bwd_dx_with_jacobian_cotangents(dev, R, C, N, case, gdtype,
                                                  with_feat):
    """triplane_bwd_dx with cotangents on the jacobian (the second
    derivative into the positions, and the planes' gradient from all
    four) in one launch, against the plain version: the planes within
    1e-5 of the largest, dx within 1e-5 relative plus 1e-5 of the largest
    (fp32 sums in another order, reductions in any order)."""
    g = _gen(dev, 5)
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    x = _field_positions(dev, g, N, case)
    cots = _jac_cots(dev, g, x, 3 * C, case, gdtype, with_feat)
    kernels.reset_launch_counts()
    dpk, dxk = triplane_bwd_dx_cuda(x, planes, cots[0], cots[1:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["triplane_bwd_dx"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    dpp, dxp = triplane_bwd_dx_plain(x, planes, cots[0], cots[1:])
    _close_to(dpk, dpp, 1e-5)
    _close_to(dxk, dxp, 1e-5)
    if case == "ties":
        assert not dxk[:2].any() and not dxk[40:90].any()


@pytest.mark.parametrize("with_feat", [True, False])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,case", FIELD_CASES[:3])
@pytest.mark.parametrize("L,C,log2,res,hash_,interp,max_level", [
    (4, 8, 19, 2048, "affine", "smoothstep", None),
    (16, 2, 19, 2048, "xor", "smoothstep", None),
    (8, 4, 12, 256, "affine", "linear", 0.6)])
def test_hashgrid_bwd_dx_with_jacobian_cotangents(dev, L, C, log2, res, hash_,
                                                  interp, max_level, N, case,
                                                  gdtype, with_feat):
    """hashgrid_bwd_dx with cotangents on the jacobian (the second
    derivative into the positions: the mixed terms and, under smoothstep,
    the pure one; the table's gradient from all four) in one launch,
    against the plain version, as the triplane's."""
    from dreamfusion_tpu_torch.models.nerf import make_grid_spec
    from dreamfusion_tpu_torch.ops.hashgrid import (hash_bwd_dx_cuda,
                                                    hash_bwd_dx_plain,
                                                    n_active_levels)
    spec = make_grid_spec(L, C, log2, res, interp, hash_)
    n_act = n_active_levels(spec, max_level)
    g = _gen(dev, 6)
    table = (torch.rand(spec.table_size, C, device=dev, generator=g)
             - 0.5) * 0.2
    x = _field_positions(dev, g, N, case)
    cots = _jac_cots(dev, g, x, L * C, case, gdtype, with_feat)
    kernels.reset_launch_counts()
    dtk, dxk = hash_bwd_dx_cuda(x, table, spec, n_act, cots[0], cots[1:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_bwd_dx"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    dtp, dxp = hash_bwd_dx_plain(x, table, spec, n_act, cots[0], cots[1:])
    _close_to(dtk, dtp, 1e-5)
    _close_to(dxk, dxp, 1e-5)
    if case == "ties":
        assert not dxk[:2].any() and not dxk[40:90].any()


def test_a_dpt_backward_on_the_card_launches_its_kernels(dev):
    """A narrow DPT (the CPU tests' tiny config at 64²) with every weight
    and the input trainable: one forward and backward launches
    ``attention_bwd_fp32`` once a ViT block and one
    ``conv_dgrad_fp32_tiled`` and one ``conv_wgrad_fp32_tiled`` a K12 conv, no
    ``conv_dgrad``; its gradients against the same model's on the CPU
    (plain versions) within 1e-3 of each one's largest."""
    from dreamfusion_tpu_torch.models import dpt as D
    cfg = D.DPTConfig(num_channels=3, features=32, vit_dim=64, vit_depth=2,
                      vit_heads=1, vit_mlp=128, hooks=(0, 1),
                      resnet_depths=(1, 1, 1), grid=6)
    torch.manual_seed(0)
    cpu = D.DPTDepthModel(cfg)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            p.copy_(torch.randn(p.shape) * (p[0].numel() ** -0.5
                                            if p.dim() >= 2 else 0.05))
    card = D.DPTDepthModel(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    ct = torch.randn(1, 64, 64, 3)
    grads = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        m.requires_grad_(True)
        xr = x.to(d).clone().requires_grad_()
        kernels.reset_launch_counts()
        (m.forward_grad(xr) * ct.to(d)).sum().backward()
        grads.append([xr.grad] + [p.grad for p in m.parameters()])
    torch.cuda.synchronize()
    n_conv = sum(1 for mod in card.modules() if isinstance(mod, D.Conv) and
                 not (mod.k == 1 and mod.stride == 1))
    assert kernels.LAUNCHES["attention_bwd_fp32"] == cfg.vit_depth
    assert kernels.LAUNCHES["conv_dgrad_fp32_tiled"] == n_conv
    assert kernels.LAUNCHES["conv_wgrad_fp32_tiled"] == n_conv
    assert kernels.LAUNCHES["conv_dgrad"] == 0
    for a, b in zip(*grads):
        if a is None:
            assert b is None
            continue
        _close_to(b.cpu(), a, 1e-3)
