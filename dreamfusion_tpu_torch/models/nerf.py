"""NeRF field, hash-grid and triplane backbones
(``dreamfusion_tpu/models/nerf.py``).

Hash-grid (K6) or triplane (K1) encode → ReLU MLP → field head (K4: the
head alone, or with the normals and the shading, ``field_shade``).
Parameters are fp32; with ``compute_dtype=torch.bfloat16`` the MLP runs in
bf16 as the JAX package's ``Dense(dtype=bfloat16)`` does (inputs, weights
and bias cast, output bf16), while sigma, normals and everything after stay
fp32.

Normals are -∇σ in closed form: the encoder (K6 or K1) emits the
features' spatial jacobian, three tangents go forward through the MLP
(``t ← W t`` masked by the ReLU derivative), and the field head turns
them into the normals with dσ/dpre, then shades.  This equals the JAX main step's autograd normal (for the
triplane ``common_with_normal`` is proved equal in
``tests/test_triplane.py``; for the grid ``tests/test_torch_nerf.py``
holds it against ``jax.grad``) and needs only first-order autograd, so a
loss on the normals differentiates into the table or planes and the
weights through the kernels' ordinary backwards.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activation import (SHADING_ALBEDO, SHADING_LAMBERTIAN,  # noqa
                              SHADING_NORMAL, SHADING_TEXTURELESS,
                              field_head, field_shade)
from ..ops.freq import freq_encode, freq_encode_dim
from ..ops.hashgrid import HashGridSpec, hash_encode, init_hashgrid
from ..ops.triplane import TriplaneSpec, init_triplane, triplane_encode

# the background encoding's degree: the JAX field's own 6 (its Config's
# freq_multires_bg is not read there)
BG_FREQ_DEGREE = 6


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
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if density_act != "exp":
            raise NotImplementedError(
                "density_activation 'softplus' is not ported (ROADMAP "
                "queue 1: The vanilla backbone and the small field options)")
        if backbone not in ("grid", "triplane"):
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported (ROADMAP queue 1: "
                f"The vanilla backbone and the small field options)")
        self.backbone = backbone
        self.bound = bound
        self.blob_density = blob_density
        self.blob_radius = blob_radius
        self.compute_dtype = compute_dtype
        if backbone == "grid":
            self.spec = make_grid_spec(
                grid_levels, grid_features_per_level, grid_log2_hashmap_size,
                grid_desired_resolution, grid_interpolation, grid_hash, bound)
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
            else:
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
        ``need_jacobian``, their jacobian in [0,1] units)."""
        if self.backbone == "grid":
            return hash_encode(self._unit(x), self.grid_table, self.spec,
                               max_level=max_level,
                               out_dtype=self.compute_dtype,
                               need_jacobian=need_jacobian)
        return triplane_encode(self._unit(x), list(self.triplanes), self.spec,
                               max_level=max_level,
                               out_dtype=self.compute_dtype,
                               need_jacobian=need_jacobian)

    def common(self, x: torch.Tensor, max_level: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3] in [-bound, bound] → (sigma [N], albedo [N,3])."""
        feat = self.encode(x, max_level)
        h = self.sigma_net(feat, self.compute_dtype)
        return field_head(h, x, self.blob_density, self.blob_radius)

    def density(self, x: torch.Tensor, max_level: Optional[float] = None):
        sigma, albedo = self.common(x, max_level)
        return {"sigma": sigma, "albedo": albedo}

    def _shade(self, x, max_level, light_d, ratio, shading):
        feat, jac = self.encode(x, max_level, need_jacobian=True)
        h, t = self.sigma_net(feat, self.compute_dtype,
                              tangents=torch.stack(jac))
        return field_shade(h, t, x, light_d, ratio, shading,
                           self.blob_density, self.blob_radius, self.bound)

    def common_with_normal(self, x: torch.Tensor,
                           max_level: Optional[float] = None):
        """(sigma [N], albedo [N,3], normal [N,3]) from one encode."""
        return self._shade(x, max_level, None, 1.0, SHADING_ALBEDO)

    def normal(self, x: torch.Tensor, max_level: Optional[float] = None
               ) -> torch.Tensor:
        """Unit -∇σ at x [N,3] (the closed form of ``common_with_normal``),
        differentiable into the encoder and the MLP."""
        return self.common_with_normal(x, max_level)[2]

    def forward(self, x: torch.Tensor, light_d: torch.Tensor,
                ratio, shading, max_level: Optional[float] = None):
        """x [N,3], light_d [3] or one a ray [R,3] (N = R·S samples in ray
        order); ratio a number or [] tensor; shading an int or a [] tensor
        of shading ids → (sigma [N], color [N,3], normal [N,3] or None).  A
        Python-int albedo shading skips the normals; any other value
        computes them and selects the colour per id on the device (K4's
        ``field_shade``), as the JAX step does under jit."""
        if isinstance(shading, int) and shading == SHADING_ALBEDO:
            sigma, albedo = self.common(x, max_level)
            return sigma, albedo, None
        return self._shade(x, max_level, light_d, ratio, shading)
