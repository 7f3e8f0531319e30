"""K4: the field head — the density activation with the origin blob and
sigmoid albedo, alone (``field_head``), with the closed-form normals and
the shading select folded in (``field_shade``), or with given normals and
the select (``field_select``: the finite-difference normals).

Replaces ``dreamfusion_tpu/ops/activation.py::trunc_exp`` (a custom_vjp)
and ``biased_softplus`` with the epilogue of ``NeRFField.common``, the
density blob and, in ``field_shade`` and ``field_select``, the tail of
``NeRFField.common_with_normal`` and ``__call__``'s shading select
(``dreamfusion_tpu/models/nerf.py:189-197``, ``:244-252``, ``:332-344``).
For h [N, 4] (the MLP's output, bf16 or fp32), x [N, 3] world positions and
the MLP's forward-mode tangents t [3, N, 4] (column 0 read):

    pre    = h0 + blob(x)            no gradient (the reference's no_grad)
    sigma  = act(pre)
    albedo = sigmoid(h1:4)
    dsig   = act'(pre)               with its own gradient act''(pre)
    normal = nan_to_num(safe_normalize(-t0 · dsig / (2 bound)))
    lam    = ratio + (1 - ratio) · max(<normal, light>, 0)
    color  = albedo, lam, (normal + 1) / 2 or albedo · lam by the shading id

The activation ``act`` is ``"exp"``: trunc_exp, exp(pre) whose gradient is
exp(min(pre, 15)), with the Gaussian blob density · exp(-|x|² / (2 r²));
or ``"softplus"``: softplus(pre + 1) (``biased_softplus`` at bias -1),
gradient sigmoid(pre + 1), with the linear blob density · (1 - |x| / r),
unclamped.  The tangents are derivatives in u = (x + bound) / (2 bound),
as every backbone's encoder gives them.  ``max`` passes half the gradient at 0,
as JAX's ``maximum`` does (normal 0, where the density's gradient
vanishes, meets it).  The light is one direction [3] or one a ray [R, 3]
(N = R·S samples in ray order); ratio and the shading id are numbers or
[] tensors on the device, read there (no host read).  Neither the light
nor the ratio takes a gradient.  ``field_select`` takes the normals [N, 3]
as given and passes the select's gradient into them.

On a CUDA tensor each entry point is one launch of a kernel in
``csrc/field_head.cu`` each way (``field_head_fwd``/``_bwd``,
``field_shade_fwd``/``_bwd``, ``field_select_fwd``/``_bwd``, each counted
apart); the backward writes the gradients in h's and t's dtype, t's
columns 1-3 as zeros in the same launch.  On a CPU tensor the plain twins
run: ``field_head_*_plain`` in closed form, ``field_shade_fwd_plain`` and
``field_select_fwd_plain`` as plain torch whose autograd defines the
backwards (``field_shade_bwd_plain``, ``field_select_bwd_plain``).
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
# the density activations, by their C code
ACTIVATIONS = {"exp": 0, "softplus": 1}


def _pre(h, x, blob_density: float, blob_radius: float, act: str = "exp"):
    d = (x * x).sum(-1)
    if act == "exp":
        blob = blob_density * torch.exp(-d / (2 * blob_radius ** 2))
    else:
        blob = blob_density * (1 - torch.sqrt(d) / blob_radius)
    return h.float()[:, 0] + blob


def _softplus(v):
    """softplus as ``jax.nn.softplus`` computes it: max(v, 0) +
    log1p(exp(-|v|))."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _dact(pre, act: str):
    """The activation's gradient at pre (trunc_exp's clamped rule)."""
    if act == "exp":
        return torch.exp(torch.clamp(pre, max=_CLAMP))
    return torch.sigmoid(pre + 1.0)


def _act(pre, act: str):
    """act(pre) whose gradient is ``_dact`` (trunc_exp's rule; softplus's
    sigmoid, also at the kink of the max form)."""
    p = pre.detach()
    value = torch.exp(p) if act == "exp" else _softplus(p + 1.0)
    return value + (pre - p) * _dact(p, act)


def _dsig(pre, act: str):
    """act'(pre) with its own gradient: exp(pre)·[pre < 15] under
    trunc_exp, sigmoid' under softplus."""
    if act == "exp":
        return torch.exp(torch.where(pre < _CLAMP, pre, _CLAMP))
    return torch.sigmoid(pre + 1.0)


def field_head_fwd_plain(h, x, blob_density: float, blob_radius: float,
                         act: str = "exp"):
    pre = _pre(h, x, blob_density, blob_radius, act)
    sigma = torch.exp(pre) if act == "exp" else _softplus(pre + 1.0)
    return sigma, torch.sigmoid(h.float()[:, 1:])


def field_head_bwd_plain(h, x, blob_density: float, blob_radius: float,
                         g_sigma, g_albedo, act: str = "exp"):
    """g_h [N, 4] fp32; a None cotangent reads as 0."""
    pre = _pre(h, x, blob_density, blob_radius, act)
    s = torch.sigmoid(h.float()[:, 1:])
    g0 = torch.zeros_like(pre) if g_sigma is None else \
        g_sigma * _dact(pre, act)
    ga = torch.zeros_like(s) if g_albedo is None else g_albedo * s * (1 - s)
    return torch.cat([g0[:, None], ga], -1)


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


def _select(albedo, normal, x, light_d, ratio, shading):
    """``__call__``'s colour select from albedo and normal [N, 3]."""
    light = torch.zeros(3, device=x.device) if light_d is None else \
        _per_sample(light_d, x.shape[0])
    lam = ratio + (1 - ratio) * _relu((normal * light).sum(-1))
    shading = torch.as_tensor(shading, device=x.device)
    return torch.where(
        shading == SHADING_ALBEDO, albedo,
        torch.where(shading == SHADING_TEXTURELESS,
                    lam[:, None].expand_as(albedo),
                    torch.where(shading == SHADING_NORMAL, (normal + 1.0) / 2.0,
                                albedo * lam[:, None])))


def field_shade_fwd_plain(h, t, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          bound: float, act: str = "exp"):
    """(sigma [N], color [N, 3], normal [N, 3]), fp32, differentiable into
    h and t (see the module docstring)."""
    pre = _pre(h, x, blob_density, blob_radius, act)
    sigma = _act(pre, act)
    albedo = torch.sigmoid(h.float()[:, 1:])
    g = t[..., 0].float().T * _dsig(pre, act)[:, None] / (2 * bound)
    normal = torch.nan_to_num(safe_normalize(-g))
    return sigma, _select(albedo, normal, x, light_d, ratio, shading), normal


def field_select_fwd_plain(h, normal, x, light_d, ratio, shading,
                           blob_density: float, blob_radius: float,
                           act: str = "exp"):
    """(sigma [N], color [N, 3]) from the head h and given normals [N, 3],
    fp32, differentiable into h and the normals."""
    pre = _pre(h, x, blob_density, blob_radius, act)
    albedo = torch.sigmoid(h.float()[:, 1:])
    return _act(pre, act), _select(albedo, normal.float(), x, light_d, ratio,
                                   shading)


def _autograd_bwd(fwd, inputs, cots):
    """The gradients of ``fwd(*inputs)`` for cotangents `cots` (None reads
    as 0), in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_() for v in inputs]
        outs = fwd(*leaves)
        pairs = [(o, g) for o, g in zip(outs, cots) if g is not None]
        grads = (None,) * len(leaves) if not pairs else torch.autograd.grad(
            [o for o, _ in pairs], leaves, [g for _, g in pairs],
            allow_unused=True)
    return tuple(torch.zeros_like(v) if gv is None else gv.to(v.dtype)
                 for v, gv in zip(inputs, grads))


def field_shade_bwd_plain(h, t, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          bound: float, g_sigma, g_color, g_normal,
                          act: str = "exp"):
    """(g_h [N, 4], g_t [3, N, 4]) in h's and t's dtype: the autograd of
    ``field_shade_fwd_plain``; a None cotangent reads as 0."""
    return _autograd_bwd(
        lambda hh, tt: field_shade_fwd_plain(hh, tt, x, light_d, ratio,
                                             shading, blob_density,
                                             blob_radius, bound, act),
        (h, t), (g_sigma, g_color, g_normal))


def field_select_bwd_plain(h, normal, x, light_d, ratio, shading,
                           blob_density: float, blob_radius: float,
                           g_sigma, g_color, act: str = "exp"):
    """(g_h [N, 4], g_normal [N, 3]) in h's and the normals' dtype: the
    autograd of ``field_select_fwd_plain``."""
    return _autograd_bwd(
        lambda hh, nn: field_select_fwd_plain(hh, nn, x, light_d, ratio,
                                              shading, blob_density,
                                              blob_radius, act),
        (h, normal), (g_sigma, g_color))


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/field_head.cu)

P = kernels.ptr


def _head_args(h, x, blob_density, blob_radius, act):
    """(N, bf16, act, blob density, blob scale): the scale is 2 r² for the
    Gaussian blob, r for the linear one."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"field head: h must be fp32 or bf16, not {h.dtype}")
    if x.dtype != torch.float32:
        raise ValueError("field head: x must be fp32")
    if act not in ACTIVATIONS:
        raise ValueError(f"field head: unknown activation {act!r}")
    kernels.check_aligned(h)
    scale = 2 * blob_radius ** 2 if act == "exp" else blob_radius
    return (h.shape[0], int(h.dtype == torch.bfloat16), ACTIVATIONS[act],
            float(blob_density), float(scale))


def field_head_fwd_cuda(h, x, blob_density: float, blob_radius: float,
                        act: str = "exp"):
    kernels.check_cuda(h, x)
    head = _head_args(h, x, blob_density, blob_radius, act)
    N = head[0]
    sigma = torch.empty(N, device=h.device)
    albedo = torch.empty(N, 3, device=h.device)
    kernels.launch("field_head_fwd", P(h), P(x), *head, P(sigma), P(albedo))
    return sigma, albedo


def _cot(g):
    return None if g is None else g.float().contiguous()


def field_head_bwd_cuda(h, x, blob_density: float, blob_radius: float,
                        g_sigma, g_albedo, act: str = "exp"):
    """g_h [N, 4] in h's dtype."""
    g_sigma, g_albedo = _cot(g_sigma), _cot(g_albedo)
    kernels.check_cuda(h, x, g_sigma, g_albedo)
    head = _head_args(h, x, blob_density, blob_radius, act)
    g_h = torch.empty_like(h)
    kernels.launch("field_head_bwd", P(h), P(x), *head, P(g_sigma),
                   P(g_albedo), P(g_h))
    return g_h


def _shading_args(N, light_d, ratio, shading):
    """The shading's C arguments: tensors stay on the device (their
    pointers), numbers go by value → (args, tensors to keep alive and
    check)."""
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
    ratio_p, ratio_v = None, 0.0
    if torch.is_tensor(ratio):
        ratio_p = ratio.float().contiguous()
    else:
        ratio_v = float(ratio)
    id_p, id_v = None, 0
    if torch.is_tensor(shading):
        id_p = shading.to(torch.int64).contiguous()
    else:
        id_v = int(shading)
    return (P(light_d), per_ray, P(ratio_p), ratio_v, P(id_p), id_v), \
        [light_d, ratio_p, id_p]


def _shade_args(h, t, x, light_d, ratio, shading, blob_density, blob_radius,
                bound, act):
    """The field shade's C arguments after h, t and x, and the device
    scalars made here (held until the launch)."""
    head = _head_args(h, x, blob_density, blob_radius, act)
    N = head[0]
    if t.shape != (3, N, 4) or t.dtype != h.dtype:
        raise ValueError(f"field shade: t must be [3, {N}, 4] {h.dtype}")
    kernels.check_aligned(t)
    sh, alive = _shading_args(N, light_d, ratio, shading)
    kernels.check_cuda(h, t, x, *alive)
    return (*head[:3], *sh, *head[3:], float(2 * bound)), alive


def field_shade_fwd_cuda(h, t, x, light_d, ratio, shading,
                         blob_density: float, blob_radius: float,
                         bound: float, act: str = "exp"):
    args, alive = _shade_args(h, t, x, light_d, ratio, shading, blob_density,
                              blob_radius, bound, act)
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
                         bound: float, g_sigma, g_color, g_normal,
                         act: str = "exp"):
    """(g_h [N, 4], g_t [3, N, 4]) in h's and t's dtype."""
    g_sigma, g_color, g_normal = _cot(g_sigma), _cot(g_color), _cot(g_normal)
    kernels.check_cuda(h, g_sigma, g_color, g_normal)
    args, alive = _shade_args(h, t, x, light_d, ratio, shading,
                              blob_density, blob_radius, bound, act)
    g_h = torch.empty_like(h)
    g_t = torch.empty_like(t)
    kernels.launch("field_shade_bwd", P(h), P(t), P(x), *args, P(g_sigma),
                   P(g_color), P(g_normal), P(g_h), P(g_t))
    del alive
    return g_h, g_t


def _select_args(h, normal, x, light_d, ratio, shading, blob_density,
                 blob_radius, act):
    head = _head_args(h, x, blob_density, blob_radius, act)
    N = head[0]
    if normal.shape != (N, 3) or normal.dtype != torch.float32:
        raise ValueError(f"field select: normal must be [{N}, 3] fp32")
    sh, alive = _shading_args(N, light_d, ratio, shading)
    kernels.check_cuda(h, normal, x, *alive)
    return (*head[:3], *sh, *head[3:]), alive


def field_select_fwd_cuda(h, normal, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          act: str = "exp"):
    args, alive = _select_args(h, normal, x, light_d, ratio, shading,
                               blob_density, blob_radius, act)
    N = h.shape[0]
    sigma = torch.empty(N, device=h.device)
    color = torch.empty(N, 3, device=h.device)
    kernels.launch("field_select_fwd", P(h), P(normal), P(x), *args,
                   P(sigma), P(color))
    del alive
    return sigma, color


def field_select_bwd_cuda(h, normal, x, light_d, ratio, shading,
                          blob_density: float, blob_radius: float,
                          g_sigma, g_color, act: str = "exp"):
    """(g_h [N, 4] in h's dtype, g_normal [N, 3] fp32)."""
    g_sigma, g_color = _cot(g_sigma), _cot(g_color)
    kernels.check_cuda(h, g_sigma, g_color)
    args, alive = _select_args(h, normal, x, light_d, ratio, shading,
                               blob_density, blob_radius, act)
    g_h = torch.empty_like(h)
    g_normal = torch.empty_like(normal)
    kernels.launch("field_select_bwd", P(h), P(normal), P(x), *args,
                   P(g_sigma), P(g_color), P(g_h), P(g_normal))
    del alive
    return g_h, g_normal


def _route(h, name):
    if h.is_cuda:
        return globals()[name + "_cuda"]
    if h.device.type == "cpu":
        return globals()[name + "_plain"]
    raise ValueError(f"unsupported device {h.device}")


class _FieldHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, x, blob, act):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h, x)
        ctx.blob, ctx.act = blob, act
        return _route(h, "field_head_fwd")(h, x, *blob, act=act)

    @staticmethod
    def backward(ctx, g_sigma, g_albedo):
        h, x = ctx.saved_tensors
        g_h = _route(h, "field_head_bwd")(h, x, *ctx.blob, g_sigma, g_albedo,
                                          act=ctx.act)
        return g_h.to(h.dtype), None, None, None


class _FieldShade(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, t, x, light_d, ratio, shading, blob, bound, act):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h, t, x, light_d)
        ctx.shading = (ratio, shading, *blob, bound)
        ctx.act = act
        return _route(h, "field_shade_fwd")(h, t, x, light_d, ratio, shading,
                                            *blob, bound, act=act)

    @staticmethod
    def backward(ctx, g_sigma, g_color, g_normal):
        h, t, x, light_d = ctx.saved_tensors
        g_h, g_t = _route(h, "field_shade_bwd")(
            h, t, x, light_d, *ctx.shading, g_sigma, g_color, g_normal,
            act=ctx.act)
        return g_h, g_t, None, None, None, None, None, None, None


class _FieldSelect(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, normal, x, light_d, ratio, shading, blob, act):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h, normal, x, light_d)
        ctx.shading = (ratio, shading, *blob)
        ctx.act = act
        return _route(h, "field_select_fwd")(h, normal, x, light_d, ratio,
                                             shading, *blob, act=act)

    @staticmethod
    def backward(ctx, g_sigma, g_color):
        h, normal, x, light_d = ctx.saved_tensors
        g_h, g_n = _route(h, "field_select_bwd")(
            h, normal, x, light_d, *ctx.shading, g_sigma, g_color,
            act=ctx.act)
        return g_h, g_n, None, None, None, None, None, None


def field_head(h: torch.Tensor, x: torch.Tensor, blob_density: float,
               blob_radius: float, act: str = "exp"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, 4], x [N, 3] → (sigma [N], albedo [N, 3]), fp32."""
    return _FieldHead.apply(h.contiguous(), x.float().contiguous(),
                            (blob_density, blob_radius), act)


def _light(light_d, ratio, what):
    if light_d is not None and light_d.requires_grad or \
            torch.is_tensor(ratio) and ratio.requires_grad:
        raise ValueError(f"{what}: the light and the ratio take no gradient")
    return None if light_d is None else light_d.float().contiguous()


def field_shade(h: torch.Tensor, t: torch.Tensor, x: torch.Tensor,
                light_d: Optional[torch.Tensor], ratio, shading,
                blob_density: float, blob_radius: float, bound: float,
                act: str = "exp"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [N, 4], the MLP's tangents t [3, N, 4] (in units of (x + bound) /
    (2 bound)), x [N, 3], light_d [3] or [R, 3]
    (or None: no light; for the albedo and normal ids), ratio a number or
    [] tensor, shading an id or [] tensor → (sigma [N], color [N, 3],
    normal [N, 3]), fp32."""
    light_d = _light(light_d, ratio, "field_shade")
    return _FieldShade.apply(h.contiguous(), t.contiguous(),
                             x.float().contiguous(), light_d, ratio, shading,
                             (blob_density, blob_radius), bound, act)


def field_select(h: torch.Tensor, normal: torch.Tensor, x: torch.Tensor,
                 light_d: Optional[torch.Tensor], ratio, shading,
                 blob_density: float, blob_radius: float, act: str = "exp"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, 4], given unit normals [N, 3] (the finite-difference ones),
    x [N, 3], the light, ratio and shading as ``field_shade`` → (sigma
    [N], color [N, 3]), fp32; the colour's gradient reaches the normals."""
    light_d = _light(light_d, ratio, "field_select")
    return _FieldSelect.apply(h.contiguous(), normal.float().contiguous(),
                              x.float().contiguous(), light_d, ratio,
                              shading, (blob_density, blob_radius), act)
