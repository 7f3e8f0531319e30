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
from dreamfusion_tpu_torch.ops.activation import (field_head,
                                                  field_head_bwd_plain,
                                                  field_head_fwd_plain)
from dreamfusion_tpu_torch.ops.composite import (composite_bwd_plain,
                                                 composite_fwd_plain,
                                                 composite_rays)
from dreamfusion_tpu_torch.ops.occupancy import (march_cuda, march_plain,
                                                 probe_edges)
from dreamfusion_tpu_torch.ops.attention import attention, attention_plain
from dreamfusion_tpu_torch.ops.conv import conv2d, conv2d_plain, norm_padding
from dreamfusion_tpu_torch.ops.groupnorm import (group_norm, group_norm_plain,
                                                 groups_for)
from dreamfusion_tpu_torch.ops.triplane import (TriplaneSpec,
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
                                         (17, 6, 33, torch.float32)])
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
    k = march_cuda(ro, rd, near, far, occ, 1.0, edges, u, mode)
    torch.cuda.synchronize()
    p = march_plain(ro, rd, near, far, occ, 1.0, edges, u, mode)
    same = (k.mask == p.mask).all(-1)
    assert same.float().mean() >= 0.999
    hit = (far[:, 0] < 1e8) & same
    # the kernel and the plain version form the CDF in the same order
    torch.testing.assert_close(k.z_vals[hit], p.z_vals[hit], atol=1e-5,
                               rtol=1e-6)
    torch.testing.assert_close(k.deltas[hit], p.deltas[hit], atol=1e-5,
                               rtol=1e-6)


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
    """K12 forward and dgrad: odd sizes, a partial N tile (48, 136, 160),
    stride 2 with symmetric and the VAE's (0, 1) padding, a 3-channel input
    (padded to 8 channels forward, a 3-column N tile in its dgrad), a bf16
    dgrad with 12 channels (CUDA cores), fp32, and split-K (few output
    tiles, long K) forward and dgrad."""
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


@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 100, 100, 2, 64),     # ragged query and key tiles
    (2, 130, 77, 3, 64),      # 77-token cross-attention tail
    (1, 70, 70, 1, 512),      # the VAE mid-block's width
    (1, 64, 40, 2, 512),
])
def test_attention_kernel(dev, B, N, M, H, D):
    g = _gen(dev, 5)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, n, H, D, device=dev, generator=g).to(bf)
               for n in (N, M, M))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention(*qkv)
    ref = attention_plain(q, k, v, D ** -0.5)
    _close_to(o, ref, 2e-2)
    do = torch.randn(o.shape, device=dev, generator=g).to(bf)
    grads = torch.autograd.grad(o, qkv, do)
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
])
def test_groupnorm_kernel(dev, B, H, W, C, eps, silu, dtype):
    g = _gen(dev, 6)
    G = groups_for(C)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 3 + 1).to(dtype)
    wt = torch.randn(C, device=dev, generator=g)
    bs = torch.randn(C, device=dev, generator=g)
    xr = x.clone().requires_grad_()
    y = group_norm(xr, wt, bs, G, eps, silu)
    ref = group_norm_plain(x, wt, bs, G, eps, silu)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    _close_to(y, ref, rel)
    dy = torch.randn(y.shape, device=dev, generator=g).to(dtype)
    (dx,) = torch.autograd.grad(y, xr, dy)
    x32 = x.float().requires_grad_()
    (dxp,) = torch.autograd.grad(group_norm_plain(x32, wt, bs, G, eps, silu),
                                 x32, dy.float())
    _close_to(dx, dxp, 1e-4 if dtype == torch.float32 else 2e-2)


def test_new_wrappers_count_their_launches(dev):
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 8, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(16, 3, 3, 16, device=dev, dtype=torch.bfloat16)
    one = torch.ones(16, device=dev)
    h = group_norm(conv2d(x, w, None, 1, 1), one, one * 0, 8, 1e-6, True)
    q = h.reshape(1, 64, 1, 16).repeat(1, 1, 1, 4)
    attention(q, q, q).float().sum().backward()
    for name in ("conv_fwd", "conv_dgrad", "groupnorm_fwd", "groupnorm_bwd",
                 "attention_fwd", "attention_bwd"):
        assert kernels.LAUNCHES[name] == 1, name
