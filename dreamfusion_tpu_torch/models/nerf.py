"""NeRF field, hash-grid, triplane and vanilla backbones
(``dreamfusion_tpu/models/nerf.py``).

Hash-grid (K6) or triplane (K1) encode → ReLU MLP, or (vanilla) the
frequency encoding at degree 12 → ResMLP (a Dense + ReLU, three ResBlocks
of Dense → LayerNorm → (+ skip) → SiLU, a Dense) → field head (K4: the
head alone, with the normals and the shading, ``field_shade``, or with the
finite-difference normals and the select, ``field_select``).  The density
activation is trunc_exp (the Gaussian blob) or softplus(x + 1) (the linear
blob).
Parameters are fp32; with ``compute_dtype=torch.bfloat16`` the MLP runs in
bf16 as the JAX package's ``Dense(dtype=bfloat16)`` does (inputs, weights
and bias cast, output bf16), while sigma, normals and everything after stay
fp32.

Normals are -∇σ in closed form: the encoder (K6, K1 or the frequency
encoding) emits the features' spatial jacobian, three tangents go forward
through the MLP (``t ← W t`` masked by the ReLU derivative; through the
ResMLP also LayerNorm's jvp, the skip and SiLU's derivative), and the
field head turns them into the normals with dσ/dpre, then shades.  Under
``normal_mode="finite_difference"`` the grid and the triplane take JAX's
central differences of σ instead (six probes, clipped to the box, in one
field query); the vanilla field ignores it, as JAX's does.  The closed
form equals the JAX main step's autograd normal (for the triplane
``common_with_normal`` is proved equal in ``tests/test_triplane.py``; for
the grid ``tests/test_torch_nerf.py`` and for the vanilla field
``tests/test_torch_vanilla.py`` hold it against ``jax.grad``) and needs
only first-order autograd, so a loss on the normals differentiates into
the table, the planes and the weights through the kernels' ordinary
backwards.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.math import safe_normalize
from ..ops.activation import (SHADING_ALBEDO, SHADING_LAMBERTIAN,  # noqa
                              SHADING_NORMAL, SHADING_TEXTURELESS,
                              field_head, field_select, field_shade)
from ..ops.freq import freq_encode, freq_encode_dim
from ..ops.hashgrid import HashGridSpec, hash_encode, init_hashgrid
from ..ops.triplane import TriplaneSpec, init_triplane, triplane_encode

# the background encoding's degree: the JAX field's own 6 (its Config's
# freq_multires_bg is not read there)
BG_FREQ_DEGREE = 6
# the vanilla field's: NeRFField's own 12 (the trainer does not pass the
# Config's freq_multires, 6), and its ResMLP's depth
VANILLA_FREQ_DEGREE = 12
VANILLA_NUM_LAYERS = 5
# flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
FD_EPS = 1e-2                   # the finite-difference normals' step


def make_grid_spec(grid_levels: int, grid_features_per_level: int,
                   grid_log2_hashmap_size: int, grid_desired_resolution: int,
                   grid_interpolation: str, grid_hash: str,
                   bound: float = 1.0) -> HashGridSpec:
    """The field's hash-grid spec, built as the JAX field builds it: the
    desired resolution scales with the bound, and the base resolution is
    the spec's own 16 (the JAX field does not pass
    ``grid_base_resolution``)."""
    return HashGridSpec(
        num_levels=grid_levels, level_dim=grid_features_per_level,
        log2_hashmap_size=grid_log2_hashmap_size,
        desired_resolution=int(grid_desired_resolution * bound),
        interpolation=grid_interpolation,
        gridtype="affine" if grid_hash == "affine" else "hash")


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default Dense kernel init: truncated normal (±2σ) with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        w.normal_(generator=generator)
        while True:
            bad = w.abs() > 2.0
            if not bad.any():
                break
            w[bad] = torch.randn(int(bad.sum()), generator=generator)
        w.mul_(std)


class BasicMLP(nn.Module):
    """Linear→ReLU stack with a plain final layer."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in self.layers:
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                tangents: Optional[torch.Tensor] = None):
        """x [N, D] → [N, out] in `dtype`.  With tangents [K, N, D], also
        their forward-mode image [K, N, out] (no bias, ReLU-masked)."""
        x = x.to(dtype)
        t = None if tangents is None else tangents.to(dtype)
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            W = lin.weight.to(dtype)
            x = F.linear(x, W, lin.bias.to(dtype))
            if t is not None:
                t = F.linear(t, W)
            if i < last:
                if t is not None:
                    t = t * (x > 0).to(dtype)
                x = F.relu(x)
        return x if tangents is None else (x, t)


def _dense(lin: nn.Linear, x, t, dtype):
    """A Dense in `dtype` as flax's: the product rounded to `dtype`, then
    the bias added (inputs, weight and bias cast); and its tangent image
    (no bias)."""
    W = lin.weight.to(dtype)
    y = F.linear(x, W)
    if lin.bias is not None:
        y = y + lin.bias.to(dtype)
    return y, None if t is None else F.linear(t, W)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: statistics in float32 with E[x²] - E[x]²
    (clipped at 0), epsilon 1e-6, the scale and bias in float32, the
    result cast back to x's dtype; with tangents [K, N, D] also their
    forward-mode image (jvp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, t=None):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mu * mu
        r = torch.rsqrt(torch.clamp(var, min=0.0) + LN_EPS)
        mul = r * self.scale
        y = ((xf - mu) * mul + self.bias).to(x.dtype)
        if t is None:
            return y, None
        tf = t.float()
        dmu = tf.mean(-1, keepdim=True)
        dvar = (2.0 * xf * tf).mean(-1, keepdim=True) - 2.0 * mu * dmu
        # maximum(0, var)'s gradient: 1 above 0, 1/2 at it
        dvar = dvar * (var > 0).float() + 0.5 * dvar * (var == 0).float()
        dr = -0.5 * r * r * r * dvar
        dy = (tf - dmu) * mul + (xf - mu) * self.scale * dr
        return y, dy.to(t.dtype)


class ResBlock(nn.Module):
    """Dense → LayerNorm → (+ a bias-free skip Dense where the widths
    differ) → SiLU."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim_out)
        self.norm = LayerNorm(dim_out)
        self.skip = nn.Linear(dim_in, dim_out, bias=False) \
            if dim_in != dim_out else None

    def forward(self, x, t, dtype):
        h, th = _dense(self.dense, x, t, dtype)
        h, th = self.norm(h, th)
        if self.skip is not None:
            x, t = _dense(self.skip, x, t, dtype)
        z = h + x
        out = z * torch.sigmoid(z)          # flax's silu, rounded as it is
        if t is None:
            return out, None
        sg = torch.sigmoid(z.float())
        dsilu = sg * (1.0 + z.float() * (1.0 - sg))
        return out, ((th + t).float() * dsilu).to(dtype)


class ResMLP(nn.Module):
    """Dense + ReLU → ResBlocks → Dense (``num_layers`` in all), in
    `dtype`; with tangents [K, N, D] also their forward-mode image
    [K, N, out]."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int):
        super().__init__()
        self.first = nn.Linear(dim_in, dim_hidden)
        self.blocks = nn.ModuleList(ResBlock(dim_hidden, dim_hidden)
                                    for _ in range(num_layers - 2))
        self.last = nn.Linear(dim_hidden, dim_out)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernels, zero biases, LayerNorm's
        unit scale."""
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                _lecun_normal_(lin.weight, generator)
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
            elif isinstance(lin, LayerNorm):
                nn.init.ones_(lin.scale)
                nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                tangents: Optional[torch.Tensor] = None):
        x = x.to(dtype)
        t = None if tangents is None else tangents.to(dtype)
        x, t = _dense(self.first, x, t, dtype)
        if t is not None:
            t = t * (x > 0).to(dtype)
        x = F.relu(x)
        for block in self.blocks:
            x, t = block(x, t, dtype)
        x, t = _dense(self.last, x, t, dtype)
        return x if tangents is None else (x, t)


class NeRFField(nn.Module):
    def __init__(self, backbone: str = "grid", bound: float = 1.0,
                 hidden_dim: int = 64, num_layers: int = 3,
                 density_act: str = "exp", blob_density: float = 5.0,
                 blob_radius: float = 0.2, grid_levels: int = 4,
                 grid_features_per_level: int = 8,
                 grid_log2_hashmap_size: int = 19,
                 grid_desired_resolution: int = 2048,
                 grid_interpolation: str = "smoothstep",
                 grid_hash: str = "affine",
                 triplane_resolution: int = 256, triplane_channels: int = 16,
                 triplane_scales: int = 1, bg_radius: float = -1.0,
                 hidden_dim_bg: int = 32, num_layers_bg: int = 2,
                 normal_mode: str = "autograd",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if density_act not in ("exp", "softplus"):
            raise ValueError(f"unknown density activation {density_act!r}")
        if backbone not in ("grid", "triplane", "vanilla"):
            raise ValueError(f"unknown backbone {backbone!r}")
        self.backbone = backbone
        self.bound = bound
        self.density_act = density_act
        self.blob_density = blob_density
        self.blob_radius = blob_radius
        self.compute_dtype = compute_dtype
        # JAX's vanilla field ignores the finite-difference mode
        self.finite_difference = normal_mode == "finite_difference" and \
            backbone != "vanilla"
        if backbone == "vanilla":
            self.spec = None
            self.sigma_net = ResMLP(freq_encode_dim(3, VANILLA_FREQ_DEGREE),
                                    4, hidden_dim, VANILLA_NUM_LAYERS)
        else:
            if backbone == "grid":
                self.spec = make_grid_spec(
                    grid_levels, grid_features_per_level,
                    grid_log2_hashmap_size, grid_desired_resolution,
                    grid_interpolation, grid_hash, bound)
                self.grid_table = nn.Parameter(
                    torch.zeros(self.spec.table_size, self.spec.level_dim))
            else:
                self.spec = TriplaneSpec(resolution=triplane_resolution,
                                         channels=triplane_channels,
                                         num_scales=triplane_scales)
                self.triplanes = nn.ParameterList(
                    nn.Parameter(torch.zeros(3, r, r, triplane_channels))
                    for r in self.spec.resolutions)
            self.sigma_net = BasicMLP(self.spec.output_dim, 4, hidden_dim,
                                      num_layers)
        # background colour from the ray direction (bg_radius > 0)
        self.bg_net = BasicMLP(freq_encode_dim(3, BG_FREQ_DEGREE), 3,
                               hidden_dim_bg, num_layers_bg) \
            if bg_radius > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.backbone == "grid":
                self.grid_table.copy_(init_hashgrid(self.spec, generator))
            elif self.backbone == "triplane":
                for p, init in zip(self.triplanes,
                                   init_triplane(self.spec, generator)):
                    p.copy_(init)
        self.sigma_net.reset_parameters(generator)
        if self.bg_net is not None:
            self.bg_net.reset_parameters(generator)

    def background(self, d: torch.Tensor) -> torch.Tensor:
        """Unit ray directions [R, 3] → background colour [R, 3] fp32."""
        enc = freq_encode(d, BG_FREQ_DEGREE)
        return torch.sigmoid(self.bg_net(enc, self.compute_dtype).float())

    def _unit(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.bound) / (2 * self.bound)

    def encode(self, x: torch.Tensor, max_level: Optional[float] = None,
               need_jacobian: bool = False):
        """The backbone's features of x [N,3] in [-bound, bound] (and, with
        ``need_jacobian``, their jacobian along u = (x + bound) / (2 bound),
        for every backbone)."""
        if self.backbone == "grid":
            return hash_encode(self._unit(x), self.grid_table, self.spec,
                               max_level=max_level,
                               out_dtype=self.compute_dtype,
                               need_jacobian=need_jacobian)
        if self.backbone == "triplane":
            return triplane_encode(self._unit(x), list(self.triplanes),
                                   self.spec, max_level=max_level,
                                   out_dtype=self.compute_dtype,
                                   need_jacobian=need_jacobian)
        out = freq_encode(x.float(), VANILLA_FREQ_DEGREE, max_level,
                          need_jacobian, unit=2 * self.bound)
        if need_jacobian:
            return out[0].to(self.compute_dtype), out[1]
        return out.to(self.compute_dtype)

    def _head(self, h, x):
        return field_head(h, x, self.blob_density, self.blob_radius,
                          self.density_act)

    def common(self, x: torch.Tensor, max_level: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3] in [-bound, bound] → (sigma [N], albedo [N,3])."""
        feat = self.encode(x, max_level)
        h = self.sigma_net(feat, self.compute_dtype)
        return self._head(h, x)

    def density(self, x: torch.Tensor, max_level: Optional[float] = None):
        sigma, albedo = self.common(x, max_level)
        return {"sigma": sigma, "albedo": albedo}

    def _shade(self, x, max_level, light_d, ratio, shading):
        feat, jac = self.encode(x, max_level, need_jacobian=True)
        h, t = self.sigma_net(feat, self.compute_dtype,
                              tangents=torch.stack(jac))
        return field_shade(h, t, x, light_d, ratio, shading,
                           self.blob_density, self.blob_radius, self.bound,
                           self.density_act)

    def _finite_difference_normal(self, x, max_level):
        """Unit -∇σ by central differences: six probes x ± eps·e_a clipped
        to the box, in one field query."""
        eye = torch.eye(3, device=x.device) * FD_EPS
        offsets = torch.cat([eye, -eye])                          # [6, 3]
        probes = torch.clamp(x[None] + offsets[:, None], -self.bound,
                             self.bound)
        sigma = self.common(probes.reshape(-1, 3), max_level)[0]
        sigma = sigma.reshape(6, -1)
        grad = (sigma[0:3] - sigma[3:6]) * (0.5 / FD_EPS)          # [3, N]
        return torch.nan_to_num(safe_normalize(-grad.T))

    def common_with_normal(self, x: torch.Tensor,
                           max_level: Optional[float] = None):
        """(sigma [N], albedo [N,3], normal [N,3]) from one encode."""
        return self._shade(x, max_level, None, 1.0, SHADING_ALBEDO)

    def normal(self, x: torch.Tensor, max_level: Optional[float] = None
               ) -> torch.Tensor:
        """Unit -∇σ at x [N,3] (the closed form of ``common_with_normal``,
        or the finite differences), differentiable into the encoder and the
        MLP."""
        if self.finite_difference:
            return self._finite_difference_normal(x, max_level)
        return self.common_with_normal(x, max_level)[2]

    def forward(self, x: torch.Tensor, light_d: torch.Tensor,
                ratio, shading, max_level: Optional[float] = None):
        """x [N,3], light_d [3] or one a ray [R,3] (N = R·S samples in ray
        order); ratio a number or [] tensor; shading an int or a [] tensor
        of shading ids → (sigma [N], color [N,3], normal [N,3] or None).  A
        Python-int albedo shading skips the normals; any other value
        computes them and selects the colour per id on the device (K4's
        ``field_shade``, or ``field_select`` from the finite-difference
        normals), as the JAX step does under jit."""
        if isinstance(shading, int) and shading == SHADING_ALBEDO:
            sigma, albedo = self.common(x, max_level)
            return sigma, albedo, None
        if not self.finite_difference:
            return self._shade(x, max_level, light_d, ratio, shading)
        h = self.sigma_net(self.encode(x, max_level), self.compute_dtype)
        normal = self._finite_difference_normal(x, max_level)
        sigma, color = field_select(h, normal, x, light_d, ratio, shading,
                                    self.blob_density, self.blob_radius,
                                    self.density_act)
        return sigma, color, normal
