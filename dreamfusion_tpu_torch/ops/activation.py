"""K4: the field head — trunc_exp density with the origin blob and sigmoid
albedo, alone (``field_head``) or with the closed-form normals and the
shading select folded in (``field_shade``).

Replaces ``dreamfusion_tpu/ops/activation.py::trunc_exp`` (a custom_vjp)
with the epilogue of ``NeRFField.common`` and, in ``field_shade``, the tail
of ``NeRFField.common_with_normal`` and ``__call__``'s shading select
(``dreamfusion_tpu/models/nerf.py:244-252``, ``:333-344``).  For h [N, 4]
(the MLP's output, bf16 or fp32), x [N, 3] world positions and the MLP's
forward-mode tangents t [3, N, 4] (column 0 read):

    pre    = h0 + blob(x)            blob = density * exp(-|x|² / (2 r²)),
                                     no gradient (the reference's no_grad)
    sigma  = exp(pre)                gradient clamped: exp(min(pre, 15))
    albedo = sigmoid(h1:4)
    dsig   = exp(min(pre, 15))       its own gradient exp(pre)·[pre < 15]
    normal = nan_to_num(safe_normalize(-t0 · dsig / (2 bound)))
    lam    = ratio + (1 - ratio) · max(<normal, light>, 0)
    color  = albedo, lam, (normal + 1) / 2 or albedo · lam by the shading id

``max`` passes half the gradient at 0, as JAX's ``maximum`` does (normal
0, where the density's gradient vanishes, meets it).  The light is one
direction [3] or one a ray [R, 3] (N = R·S samples in ray order); ratio
and the shading id are numbers or [] tensors on the device, read there (no
host read).  Neither the light nor the ratio takes a gradient.

On a CUDA tensor each entry point is one launch of a kernel in
``csrc/field_head.cu`` each way (``field_head_fwd``/``_bwd``,
``field_shade_fwd``/``_bwd``, each counted apart); the backward writes the
gradients in h's and t's dtype, t's columns 1-3 as zeros in the same
launch.  On a CPU tensor the plain twins run: ``field_head_*_plain`` in
closed form, ``field_shade_fwd_plain`` as plain torch whose autograd
defines the backward (``field_shade_bwd_plain``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.math import safe_normalize
from . import kernels

_CLAMP = 15.0
# the shading ids (the JAX field's)
SHADING_ALBEDO, SHADING_LAMBERTIAN = 0, 1
SHADING_TEXTURELESS, SHADING_NORMAL = 2, 3


def _pre(h, x, blob_density: float, blob_radius: float):
    d = (x * x).sum(-1)
    return h.float()[:, 0] + blob_density * torch.exp(
        -d / (2 * blob_radius ** 2))


def field_head_fwd_plain(h, x, blob_density: float, blob_radius: float):
    pre = _pre(h, x, blob_density, blob_radius)
    return torch.exp(pre), torch.sigmoid(h.float()[:, 1:])


def field_head_bwd_plain(h, x, blob_density: float, blob_radius: float,
                         g_sigma, g_albedo):
    """g_h [N, 4] fp32; a None cotangent reads as 0."""
    pre = _pre(h, x, blob_density, blob_radius)
    s = torch.sigmoid(h.float()[:, 1:])
    g0 = torch.zeros_like(pre) if g_sigma is None else \
        g_sigma * torch.exp(torch.clamp(pre, max=_CLAMP))
    ga = torch.zeros_like(s) if g_albedo is None else g_albedo * s * (1 - s)
    return torch.cat([g0[:, None], ga], -1)


def _trunc_exp(pre):
    """exp(pre) whose gradient is exp(min(pre, 15)) (trunc_exp's rule)."""
    p = pre.detach()
    return torch.exp(p) + (pre - p) * torch.exp(torch.clamp(p, max=_CLAMP))


def _relu(v):
    """max(v, 0) with half the gradient at 0 (JAX's ``maximum``)."""
    return 0.5 * (v + v.abs())


def _per_sample(light_d, N):
    """The light direction of each of N samples: [3] for all, or [R, 3] one
    a ray (N = R·S in ray order)."""
    if light_d.ndim == 1:
        return light_d
    R = light_d.shape[0]
    return light_d[:, None].expand(R, N // R, 3).reshape(N, 3)


def field_shade_fwd_plain(h, t, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          bound: float):
    """(sigma [N], color [N, 3], normal [N, 3]), fp32, differentiable into
    h and t (see the module docstring)."""
    pre = _pre(h, x, blob_density, blob_radius)
    sigma = _trunc_exp(pre)
    albedo = torch.sigmoid(h.float()[:, 1:])
    dsig = torch.exp(torch.where(pre < _CLAMP, pre, _CLAMP))
    g = t[..., 0].float().T * dsig[:, None] / (2 * bound)
    normal = torch.nan_to_num(safe_normalize(-g))
    light = torch.zeros(3, device=x.device) if light_d is None else \
        _per_sample(light_d, x.shape[0])
    lam = ratio + (1 - ratio) * _relu((normal * light).sum(-1))
    shading = torch.as_tensor(shading, device=x.device)
    color = torch.where(
        shading == SHADING_ALBEDO, albedo,
        torch.where(shading == SHADING_TEXTURELESS,
                    lam[:, None].expand_as(albedo),
                    torch.where(shading == SHADING_NORMAL, (normal + 1.0) / 2.0,
                                albedo * lam[:, None])))
    return sigma, color, normal


def field_shade_bwd_plain(h, t, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          bound: float, g_sigma, g_color, g_normal):
    """(g_h [N, 4], g_t [3, N, 4]) in h's and t's dtype: the autograd of
    ``field_shade_fwd_plain``; a None cotangent reads as 0."""
    with torch.enable_grad():
        hh = h.detach().requires_grad_()
        tt = t.detach().requires_grad_()
        outs = field_shade_fwd_plain(hh, tt, x, light_d, ratio, shading,
                                     blob_density, blob_radius, bound)
        pairs = [(o, g) for o, g in zip(outs, (g_sigma, g_color, g_normal))
                 if g is not None]
        grads = (None, None) if not pairs else torch.autograd.grad(
            [o for o, _ in pairs], [hh, tt], [g for _, g in pairs],
            allow_unused=True)
    return tuple(torch.zeros_like(v) if gv is None else gv
                 for v, gv in zip((h, t), grads))


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/field_head.cu)

P = kernels.ptr


def _head_args(h, x, blob_density, blob_radius):
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"field head: h must be fp32 or bf16, not {h.dtype}")
    if x.dtype != torch.float32:
        raise ValueError("field head: x must be fp32")
    kernels.check_aligned(h)
    return (h.shape[0], int(h.dtype == torch.bfloat16), float(blob_density),
            float(2 * blob_radius ** 2))


def field_head_fwd_cuda(h, x, blob_density: float, blob_radius: float):
    kernels.check_cuda(h, x)
    N, bf16, bd, denom = _head_args(h, x, blob_density, blob_radius)
    sigma = torch.empty(N, device=h.device)
    albedo = torch.empty(N, 3, device=h.device)
    kernels.launch("field_head_fwd", P(h), P(x), N, bf16, bd, denom, P(sigma),
                   P(albedo))
    return sigma, albedo


def _cot(g):
    return None if g is None else g.float().contiguous()


def field_head_bwd_cuda(h, x, blob_density: float, blob_radius: float,
                        g_sigma, g_albedo):
    """g_h [N, 4] in h's dtype."""
    g_sigma, g_albedo = _cot(g_sigma), _cot(g_albedo)
    kernels.check_cuda(h, x, g_sigma, g_albedo)
    N, bf16, bd, denom = _head_args(h, x, blob_density, blob_radius)
    g_h = torch.empty_like(h)
    kernels.launch("field_head_bwd", P(h), P(x), N, bf16, bd, denom,
                   P(g_sigma), P(g_albedo), P(g_h))
    return g_h


def _shade_args(h, t, x, light_d, ratio, shading, blob_density, blob_radius,
                bound):
    """The shading's C arguments, after the field head's: tensors stay on
    the device (their pointers), numbers go by value."""
    N, bf16, bd, denom = _head_args(h, x, blob_density, blob_radius)
    if t.shape != (3, N, 4) or t.dtype != h.dtype:
        raise ValueError(f"field shade: t must be [3, {N}, 4] {h.dtype}")
    kernels.check_aligned(t)
    per_ray = 0
    if light_d is not None:
        if light_d.dtype != torch.float32:
            raise ValueError("field shade: light_d must be fp32")
        if light_d.ndim == 2:
            R = light_d.shape[0]
            if R == 0 or N % R or light_d.shape[1] != 3:
                raise ValueError(f"field shade: light_d {tuple(light_d.shape)}"
                                 f" is not one direction a ray of {N} samples")
            per_ray = N // R
        elif light_d.shape != (3,):
            raise ValueError("field shade: light_d must be [3] or [R, 3]")
    tensors = [light_d]
    ratio_p, ratio_v = None, 0.0
    if torch.is_tensor(ratio):
        ratio_p = ratio.float().contiguous()
        tensors.append(ratio_p)
    else:
        ratio_v = float(ratio)
    id_p, id_v = None, 0
    if torch.is_tensor(shading):
        id_p = shading.to(torch.int64).contiguous()
        tensors.append(id_p)
    else:
        id_v = int(shading)
    kernels.check_cuda(h, t, x, *tensors)
    return (N, bf16, P(light_d), per_ray, P(ratio_p), ratio_v, P(id_p), id_v,
            bd, denom, float(2 * bound)), (ratio_p, id_p)


def field_shade_fwd_cuda(h, t, x, light_d, ratio, shading,
                         blob_density: float, blob_radius: float,
                         bound: float):
    # `alive` holds the device scalars made here until their launch
    args, alive = _shade_args(h, t, x, light_d, ratio, shading, blob_density,
                              blob_radius, bound)
    N = h.shape[0]
    sigma = torch.empty(N, device=h.device)
    color = torch.empty(N, 3, device=h.device)
    normal = torch.empty(N, 3, device=h.device)
    kernels.launch("field_shade_fwd", P(h), P(t), P(x), *args, P(sigma),
                   P(color), P(normal))
    del alive
    return sigma, color, normal


def field_shade_bwd_cuda(h, t, x, light_d, ratio, shading,
                         blob_density: float, blob_radius: float,
                         bound: float, g_sigma, g_color, g_normal):
    """(g_h [N, 4], g_t [3, N, 4]) in h's and t's dtype."""
    g_sigma, g_color, g_normal = _cot(g_sigma), _cot(g_color), _cot(g_normal)
    kernels.check_cuda(h, g_sigma, g_color, g_normal)
    args, alive = _shade_args(h, t, x, light_d, ratio, shading,
                              blob_density, blob_radius, bound)
    g_h = torch.empty_like(h)
    g_t = torch.empty_like(t)
    kernels.launch("field_shade_bwd", P(h), P(t), P(x), *args, P(g_sigma),
                   P(g_color), P(g_normal), P(g_h), P(g_t))
    del alive
    return g_h, g_t


def _route(h, name):
    if h.is_cuda:
        return globals()[name + "_cuda"]
    if h.device.type == "cpu":
        return globals()[name + "_plain"]
    raise ValueError(f"unsupported device {h.device}")


class _FieldHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, x, blob_density, blob_radius):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h, x)
        ctx.blob = (blob_density, blob_radius)
        return _route(h, "field_head_fwd")(h, x, blob_density, blob_radius)

    @staticmethod
    def backward(ctx, g_sigma, g_albedo):
        h, x = ctx.saved_tensors
        g_h = _route(h, "field_head_bwd")(h, x, *ctx.blob, g_sigma, g_albedo)
        return g_h.to(h.dtype), None, None, None


class _FieldShade(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, t, x, light_d, ratio, shading, blob, bound):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h, t, x, light_d)
        ctx.shading = (ratio, shading, *blob, bound)
        return _route(h, "field_shade_fwd")(h, t, x, light_d, ratio, shading,
                                            *blob, bound)

    @staticmethod
    def backward(ctx, g_sigma, g_color, g_normal):
        h, t, x, light_d = ctx.saved_tensors
        g_h, g_t = _route(h, "field_shade_bwd")(
            h, t, x, light_d, *ctx.shading, g_sigma, g_color, g_normal)
        return g_h, g_t, None, None, None, None, None, None


def field_head(h: torch.Tensor, x: torch.Tensor, blob_density: float,
               blob_radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, 4], x [N, 3] → (sigma [N], albedo [N, 3]), fp32."""
    return _FieldHead.apply(h.contiguous(), x.float().contiguous(),
                            blob_density, blob_radius)


def field_shade(h: torch.Tensor, t: torch.Tensor, x: torch.Tensor,
                light_d: Optional[torch.Tensor], ratio, shading,
                blob_density: float, blob_radius: float, bound: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [N, 4], the MLP's tangents t [3, N, 4], x [N, 3], light_d [3] or
    [R, 3] (or None: no light; for the albedo and normal ids), ratio a
    number or [] tensor, shading an id or [] tensor → (sigma [N], color
    [N, 3], normal [N, 3]), fp32."""
    if light_d is not None and light_d.requires_grad or \
            torch.is_tensor(ratio) and ratio.requires_grad:
        raise ValueError("field_shade: the light and the ratio take no "
                         "gradient")
    if light_d is not None:
        light_d = light_d.float().contiguous()
    return _FieldShade.apply(h.contiguous(), t.contiguous(),
                             x.float().contiguous(), light_d, ratio, shading,
                             (blob_density, blob_radius), bound)
