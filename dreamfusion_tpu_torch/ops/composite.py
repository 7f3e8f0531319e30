"""K3: transmittance compositing with the renderer's epilogue
(``dreamfusion_tpu/ops/composite.py::composite_rays`` and the tail of
``dreamfusion_tpu/models/renderer.py::_shade_and_composite``).

``composite_rays`` turns per-sample density and colour into per-ray
weights, weight sum, depth and image, adds the background where asked, and,
given the normals, the orient loss.  On a CUDA tensor it is one launch of
the forward kernel in ``csrc/composite.cu`` and one of the backward; on a
CPU tensor the plain version runs.  Gradients reach sigma and rgb from
cotangents on every output, ``weights`` included (the entropy regularizer
reads it); the normals take the orient loss's, and the background MLP's
colour its own where the step draws it.

The background: ``image + (1 - weights_sum) · bg``, with bg ``bg_color``
(a number, or a tensor broadcastable to [R, 3]: a [3] colour, one a ray)
or, where ``use_bg_net`` ([] bool, read on the device) is true,
``bg_net`` [R, 3] (the net's colour needs the choice: without one it is
not drawn).  ``bg_color`` None (and no net) leaves the image as
composited.  The orient loss: mean over rays of
Σₛ w · max(⟨n, d⟩, 0)², d = safe_normalize(rays_d), w taken as a constant.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.math import safe_normalize
from . import kernels

_RAYS_PER_BLOCK = 8           # csrc/composite.cu's kWarps: the orient partials


class CompositeOut(NamedTuple):
    image: torch.Tensor        # [R, 3], the background added where given
    depth: torch.Tensor        # [R]
    weights: torch.Tensor      # [R, S]
    weights_sum: torch.Tensor  # [R]
    loss_orient: Optional[torch.Tensor] = None   # [] when normals are given


def _sdt_T(sigmas, deltas, mask, t_thresh):
    """sigma·delta (0 where masked), exp(-sdt) and exclusive transmittance
    (0 below t_thresh)."""
    sdt = sigmas * deltas
    if mask is not None:
        sdt = torch.where(mask, sdt, 0.0)
    excl = torch.cumsum(sdt, -1) - sdt
    T = torch.exp(-excl)
    if t_thresh > 0.0:
        T = torch.where(T >= t_thresh, T, 0.0)
    return sdt, T


def _bg(bg_color, bg_net, use_bg_net):
    """The colour behind each ray (broadcastable to [R, 3]), or None."""
    if bg_net is None:
        return bg_color
    return torch.where(use_bg_net, bg_net, 0.0 if bg_color is None
                       else bg_color)


def composite_fwd_plain(sigmas, rgbs, z_vals, deltas, mask=None,
                        t_thresh: float = 0.0, binarize: bool = False,
                        bg_color=None, bg_net=None, use_bg_net=None,
                        normals=None, rays_d=None) -> CompositeOut:
    sdt, T = _sdt_T(sigmas, deltas, mask, t_thresh)
    alphas = 1.0 - torch.exp(-sdt)
    if binarize:
        alphas = (alphas > 0.5).to(alphas.dtype)
    weights = alphas * T
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    wsum = weights.sum(-1)
    image = (weights[..., None] * rgbs).sum(-2)
    bg = _bg(bg_color, bg_net, use_bg_net)
    if bg is not None:
        image = image + (1.0 - wsum)[..., None] * bg
    loss = None
    if normals is not None:
        dirs = safe_normalize(rays_d)[:, None, :]
        dot = torch.clamp((normals * dirs).sum(-1), min=0.0)
        loss = (weights * dot ** 2).sum(-1).mean()
    return CompositeOut(image, (weights * z_vals).sum(-1), weights, wsum,
                        loss)


def composite_bwd_plain(sigmas, rgbs, z_vals, deltas, mask, weights,
                        g_image, g_depth, g_weights, g_wsum,
                        t_thresh: float = 0.0, bg_color=None, bg_net=None,
                        use_bg_net=None, normals=None, rays_d=None,
                        g_loss=None):
    """Closed form → (g_sigma, g_rgb, g_normals, g_bg_net), the last two None
    without normals (or g_loss) and without a net.  With
    g^_i = g_w_i + g_wsum − ⟨g_img, bg⟩ + g_depth z_i + ⟨g_img, rgb_i⟩,
    dL/dsdt_k = g^_k T_k e^{-sdt_k} − Σ_{i>k} g^_i w_i.  A None cotangent
    reads as 0."""
    R, S = sigmas.shape
    zero = sigmas.new_zeros(())
    g_image = torch.zeros(R, 3, device=sigmas.device) if g_image is None \
        else g_image
    g_wsum = zero if g_wsum is None else g_wsum[:, None]
    g_depth = zero if g_depth is None else g_depth[:, None]
    g_weights = zero if g_weights is None else g_weights
    sdt, T = _sdt_T(sigmas, deltas, mask, t_thresh)
    bg = _bg(bg_color, bg_net, use_bg_net)
    if bg is not None:
        g_wsum = g_wsum - (g_image * bg).sum(-1, keepdim=True)
    gh = (g_weights + g_wsum + g_depth * z_vals
          + (g_image[:, None, :] * rgbs).sum(-1))
    gw = gh * weights
    suffix = gw.flip(-1).cumsum(-1).flip(-1) - gw             # Σ_{i>k}
    g_sdt = gh * T * torch.exp(-sdt) - suffix
    if mask is not None:
        g_sdt = torch.where(mask, g_sdt, 0.0)
    g_normals = g_net = None
    if normals is not None and g_loss is not None:
        dirs = safe_normalize(rays_d)[:, None, :]
        dot = torch.clamp((normals * dirs).sum(-1, keepdim=True), min=0.0)
        g_normals = g_loss / R * 2.0 * weights[..., None] * dot * dirs
    if bg_net is not None:
        g_net = torch.where(use_bg_net,
                            g_image * (1.0 - weights.sum(-1))[:, None], 0.0)
    return (g_sdt * deltas, weights[..., None] * g_image[:, None, :],
            g_normals, g_net)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/composite.cu)

P = kernels.ptr


def _bg_args(bg_color, bg_net, use_bg_net, R):
    """The background's C arguments: (colour pointer, constant, ray stride,
    channel stride, net pointer, choice pointer)."""
    if torch.is_tensor(bg_color):
        b = bg_color.expand(R, 3)          # strided: no copy of a broadcast
        if b.dtype != torch.float32 or not b.is_cuda:
            raise ValueError("composite: bg_color must be fp32 on the card")
        color, value, rs, cs = P(b), 0.0, b.stride(0), b.stride(1)
    else:
        color, value, rs, cs = None, float(bg_color or 0.0), 0, 0
    use = None
    if bg_net is not None:
        if bg_net.shape != (R, 3) or use_bg_net.dtype != torch.bool:
            raise ValueError("composite: bg_net must be [R, 3], use_bg_net "
                             "a [] bool")
        kernels.check_cuda(bg_net, use_bg_net)
        use = use_bg_net.view(torch.uint8)
    return color, value, rs, cs, P(bg_net), P(use)


def _orient_args(normals, rays_d, R, S):
    if normals is None:
        return None, None
    if normals.shape != (R, S, 3) or rays_d is None or \
            rays_d.shape != (R, 3):
        raise ValueError("composite: the orient loss needs normals "
                         "[R, S, 3] and rays_d [R, 3]")
    kernels.check_cuda(normals, rays_d)
    return normals, rays_d


def _composite_fwd_cuda(sigmas, rgbs, z_vals, deltas, mask, t_thresh,
                        binarize, bg_color=None, bg_net=None, use_bg_net=None,
                        normals=None, rays_d=None):
    mask8 = None if mask is None else mask.contiguous().view(torch.uint8)
    kernels.check_cuda(sigmas, rgbs, z_vals, deltas, mask8)
    R, S = sigmas.shape
    if R == 0:
        raise ValueError("composite: no rays")
    dev = sigmas.device
    bg = _bg_args(bg_color, bg_net, use_bg_net, R)
    normals, rays_d = _orient_args(normals, rays_d, R, S)
    weights = torch.empty(R, S, device=dev, dtype=torch.float32)
    wsum = torch.empty(R, device=dev, dtype=torch.float32)
    depth = torch.empty_like(wsum)
    image = torch.empty(R, 3, device=dev, dtype=torch.float32)
    partials = done = loss = None
    if normals is not None:
        partials = torch.empty(-(-R // _RAYS_PER_BLOCK), device=dev)
        done = kernels.zeroed(dev, "composite_done", 1)
        loss = torch.empty((), device=dev)
    kernels.launch("composite_fwd", P(sigmas), P(rgbs), P(z_vals),
                   P(deltas), P(mask8), R, S, float(t_thresh), int(binarize),
                   *bg, P(normals), P(rays_d), P(weights), P(wsum), P(depth),
                   P(image), P(partials), P(done), P(loss))
    return CompositeOut(image, depth, weights, wsum, loss)


def _composite_bwd_cuda(sigmas, rgbs, z_vals, deltas, mask, weights,
                        g_image, g_depth, g_weights, g_wsum, t_thresh,
                        bg_color=None, bg_net=None, use_bg_net=None,
                        normals=None, rays_d=None, g_loss=None, wsum=None):
    """(g_sigma, g_rgb, g_normals, g_bg_net) as ``composite_bwd_plain``;
    `wsum` (the forward's) is needed with a net."""
    mask8 = None if mask is None else mask.contiguous().view(torch.uint8)
    g_image, g_depth, g_weights, g_wsum = (
        None if g is None else g.float().contiguous()
        for g in (g_image, g_depth, g_weights, g_wsum))
    kernels.check_cuda(sigmas, rgbs, z_vals, deltas, mask8, weights, g_image,
                       g_depth, g_weights, g_wsum)
    R, S = sigmas.shape
    bg = _bg_args(bg_color, bg_net, use_bg_net, R)
    normals, rays_d = _orient_args(normals if g_loss is not None else None,
                                   rays_d, R, S)
    g_sigma = torch.empty_like(sigmas)
    g_rgb = torch.empty_like(rgbs)
    g_normals = None if normals is None else torch.empty_like(normals)
    g_net = None
    if bg_net is not None:
        kernels.check_cuda(wsum)
        g_net = torch.empty_like(bg_net)
    kernels.launch("composite_bwd", P(sigmas), P(rgbs), P(z_vals),
                   P(deltas), P(mask8), P(weights), P(wsum), R, S,
                   float(t_thresh), P(g_image), P(g_depth), P(g_weights),
                   P(g_wsum), *bg, P(normals), P(rays_d), P(g_loss),
                   P(g_sigma), P(g_rgb), P(g_normals), P(g_net))
    return g_sigma, g_rgb, g_normals, g_net


class _Composite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sigmas, rgbs, z_vals, deltas, mask, bg_color, bg_net,
                use_bg_net, normals, rays_d, t_thresh, binarize):
        ctx.set_materialize_grads(False)
        args = (sigmas, rgbs, z_vals, deltas, mask, t_thresh, binarize,
                bg_color, bg_net, use_bg_net, normals, rays_d)
        if sigmas.is_cuda:
            out = _composite_fwd_cuda(*args)
        elif sigmas.device.type == "cpu":
            out = composite_fwd_plain(*args)
        else:
            raise ValueError(f"unsupported device {sigmas.device}")
        color = bg_color if torch.is_tensor(bg_color) else None
        ctx.bg_value = None if torch.is_tensor(bg_color) else bg_color
        ctx.save_for_backward(sigmas, rgbs, z_vals, deltas, mask, out.weights,
                              out.weights_sum, color, bg_net, use_bg_net,
                              normals, rays_d)
        ctx.t_thresh = t_thresh
        return tuple(out)

    @staticmethod
    def backward(ctx, g_image, g_depth, g_weights, g_wsum, g_loss):
        (sigmas, rgbs, z_vals, deltas, mask, weights, wsum, bg_color, bg_net,
         use_bg_net, normals, rays_d) = ctx.saved_tensors
        if bg_color is None:
            bg_color = ctx.bg_value
        args = (sigmas, rgbs, z_vals, deltas, mask, weights, g_image,
                g_depth, g_weights, g_wsum, ctx.t_thresh, bg_color, bg_net,
                use_bg_net, normals, rays_d, g_loss)
        if sigmas.is_cuda:
            g_sigma, g_rgb, g_normals, g_net = _composite_bwd_cuda(
                *args, wsum=wsum)
        else:
            g_sigma, g_rgb, g_normals, g_net = composite_bwd_plain(*args)
        g_color = None
        if ctx.needs_input_grad[5] and g_image is not None:
            # a colour that asks for a gradient (off every path)
            keep = g_image * (1.0 - wsum)[:, None]
            if bg_net is not None:
                keep = torch.where(use_bg_net, 0.0, keep)
            g_color = keep
        return (g_sigma, g_rgb, None, None, None, g_color, g_net, None,
                g_normals, None, None, None)


def composite_rays(sigmas: torch.Tensor, rgbs: torch.Tensor,
                   z_vals: torch.Tensor, deltas: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   t_thresh: float = 0.0, binarize: bool = False,
                   bg_color=None, bg_net: Optional[torch.Tensor] = None,
                   use_bg_net: Optional[torch.Tensor] = None,
                   normals: Optional[torch.Tensor] = None,
                   rays_d: Optional[torch.Tensor] = None) -> CompositeOut:
    """sigmas [R,S], rgbs [R,S,3], z_vals/deltas [R,S], mask [R,S] bool
    (False = padded sample), all fp32; the background and the orient loss
    as the module docstring says (normals [R, S, 3], rays_d [R, 3], which
    takes no gradient)."""
    R = sigmas.shape[0]
    sigmas, rgbs = sigmas.float().contiguous(), rgbs.float().contiguous()
    z_vals, deltas = z_vals.contiguous(), deltas.contiguous()
    if torch.is_tensor(bg_color):
        bg_color = bg_color.float().expand(R, 3)
    if bg_net is None or use_bg_net is None:
        bg_net = use_bg_net = None          # the net's colour is not drawn
    else:
        bg_net = bg_net.float().contiguous()
    if normals is not None:
        if rays_d is None or rays_d.requires_grad:
            raise ValueError("composite: the orient loss needs rays_d, "
                             "which takes no gradient")
        normals = normals.float().contiguous()
        rays_d = rays_d.float().contiguous()
    return CompositeOut(*_Composite.apply(
        sigmas, rgbs, z_vals, deltas, mask, bg_color, bg_net, use_bg_net,
        normals, rays_d, t_thresh, binarize))
