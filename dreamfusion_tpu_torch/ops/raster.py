"""K7: tile-binned differentiable triangle rasterizer
(``dreamfusion_tpu/ops/raster.py``: ``project_verts``, ``rasterize``,
``interpolate``).

``rasterize`` maps clip-space vertices to the screen in torch (the
clip → NDC → screen divide, differentiable by autograd) and hands screen
x, y and NDC z per vertex to the kernel part: per 32×32 tile, the first
``tile_cap`` triangles (by index) whose padded bounding box overlaps the
tile; per pixel, the nearest covering triangle among them (ties to the
lowest index) and the largest soft-edge margin over all of them.  On a CUDA
tensor the kernel part is ``csrc/raster.cu`` (forward and a closed-form
backward into the per-vertex screen coordinates); on a CPU tensor the
plain version runs, selecting under ``no_grad`` and recomputing the
winners' barycentrics, depth and margin with autograd (their values in the
kernel's coefficient form, their gradient in the better-conditioned edge
form, ``_edge_form``).

Semantics kept from the JAX version: the bounding-box pad is
``soft_edge_px + 1``, tile ranges come from ``floor``; a triangle is dropped
when its mask is false or any vertex has w <= 0; |w| < 1e-9 → 1e-9 and
|den| < 1e-9 → +1e-9 (no gradient through either); inside means
bu, bv, bw >= 0; a miss has depth 1.0, tri_id -1 (and, here, bary 0: the
JAX version leaves slot 0's barycentrics there, which ``interpolate``
masks); alpha = sigmoid(4·max margin / soft_edge_px) over every listed
triangle, covering or not, with unlisted slots at −1e9, or the hit mask
when ``soft_edge_px`` is 0; row 0 is the top of the image.  Gradients flow
through bary, depth and alpha; at exact ties of a min or max the gradient
goes to the first, where JAX splits it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels


class RasterOut(NamedTuple):
    bary: torch.Tensor     # [H, W, 3] barycentrics (w0, u, v) of the winner
    tri_id: torch.Tensor   # [H, W] int32 (-1 = background)
    depth: torch.Tensor    # [H, W] NDC depth of the hit (1.0 on a miss)
    alpha: torch.Tensor    # [H, W] coverage (soft if soft_edge_px > 0)


def project_verts(verts: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """world [V,3] → clip [V,4] (v_clip = mvp @ v)."""
    vh = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    return torch.einsum("ij,vj->vi", mvp, vh)


def screen_coords(clip_verts: torch.Tensor, faces: torch.Tensor,
                  face_mask: torch.Tensor, H: int, W: int):
    """clip [V,4] → (sx, sy, sz [V], valid [T] bool); differentiable."""
    w = clip_verts[:, 3]
    ndc = clip_verts[:, :3] / torch.where(w.abs() < 1e-9, 1e-9, w)[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * W
    sy = (-ndc[:, 1] * 0.5 + 0.5) * H
    behind = (w[faces] <= 0).any(-1)
    return sx, sy, ndc[:, 2], face_mask & ~behind


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _face_coeffs(sx, sy, sz, faces):
    """Per face: bu, bv and z as a·px + b·py + c (coefficient rows cu, cv,
    cz [T,3]), sqrt|den| [T] and the screen bounding box [T,2] x2."""
    q = torch.stack([sx, sy], -1)[faces]                       # [T, 3, 2]
    z = sz[faces]                                              # [T, 3]
    q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]
    e0, e1 = q1 - q0, q2 - q0
    den = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    den = torch.where(den.abs() < 1e-9, 1e-9, den)
    inv = 1.0 / den
    cu = torch.stack([e1[:, 1] * inv, -e1[:, 0] * inv,
                      (q0[:, 1] * e1[:, 0] - q0[:, 0] * e1[:, 1]) * inv], -1)
    cv = torch.stack([-e0[:, 1] * inv, e0[:, 0] * inv,
                      (q0[:, 0] * e0[:, 1] - q0[:, 1] * e0[:, 0]) * inv], -1)
    cz = cu * (z[:, 1] - z[:, 0])[:, None] + cv * (z[:, 2] - z[:, 0])[:, None]
    cz = torch.cat([cz[:, :2], cz[:, 2:] + z[:, :1]], -1)
    bb_min = torch.minimum(torch.minimum(q0, q1), q2)
    bb_max = torch.maximum(torch.maximum(q0, q1), q2)
    return cu, cv, cz, torch.sqrt(den.abs()), bb_min, bb_max


def _eval(c, px, py):
    """a·px + b·py + c, in the kernel's order of operations."""
    return c[..., 0] * px + c[..., 1] * py + c[..., 2]


def _edge_form(sx, sy, sz, faces, t, px, py):
    """bu, bv and z of triangles ``t`` at pixels (px, py) in the edge form,
    bu = ((p − q0) × e1) / den: the same functions as ``_eval`` of the
    coefficient rows, better conditioned.  On a sliver triangle the
    coefficient form cancels terms of size |p|/den and loses most of its
    digits in fp32, in its values and in its autograd gradient."""
    f = faces[t]
    x, y, z = sx[f], sy[f], sz[f]                              # [..., 3]
    e0x, e0y = x[..., 1] - x[..., 0], y[..., 1] - y[..., 0]
    e1x, e1y = x[..., 2] - x[..., 0], y[..., 2] - y[..., 0]
    den = e0x * e1y - e0y * e1x
    den = torch.where(den.abs() < 1e-9, 1e-9, den)
    dx, dy = px - x[..., 0], py - y[..., 0]
    bu = (dx * e1y - dy * e1x) / den
    bv = (dy * e0x - dx * e0y) / den
    return bu, bv, z[..., 0] + bu * (z[..., 1] - z[..., 0]) + \
        bv * (z[..., 2] - z[..., 0])


def _st(value, grad_form):
    """``value``'s value with ``grad_form``'s gradient (x − x.detach() is
    exactly 0.0).  The plain version's outputs take their values from the
    coefficient form (the kernel's and JAX's forward arithmetic, so the
    selections and values agree bit for bit) and their gradients from the
    edge form (the kernel's closed-form backward)."""
    return value.detach() + (grad_form - grad_form.detach())


def _margin(bu, bv):
    return torch.minimum(torch.minimum(bu, bv), 1.0 - bu - bv)


def tile_lists(bb_min, bb_max, valid, H: int, W: int, tile: int,
               tile_cap: int, soft_edge_px: float):
    """Per tile, the first ``tile_cap`` overlapping triangles by index →
    (ids [G, C] with C = min(tile_cap, T), listed [G, C] bool)."""
    T = valid.shape[0]
    nty, ntx = -(-H // tile), -(-W // tile)
    pad = soft_edge_px + 1.0
    tx0 = torch.floor((bb_min[:, 0] - pad) / tile).to(torch.int32)
    tx1 = torch.floor((bb_max[:, 0] + pad) / tile).to(torch.int32)
    ty0 = torch.floor((bb_min[:, 1] - pad) / tile).to(torch.int32)
    ty1 = torch.floor((bb_max[:, 1] + pad) / tile).to(torch.int32)
    dev = valid.device
    tyi = torch.arange(nty, device=dev)[:, None, None]
    txi = torch.arange(ntx, device=dev)[None, :, None]
    overlap = (valid & (tx0 <= txi) & (tx1 >= txi) & (ty0 <= tyi)
               & (ty1 >= tyi)).reshape(nty * ntx, T)
    C = min(tile_cap, T)
    order = torch.sort((~overlap).to(torch.uint8), dim=1, stable=True)[1]
    ids = order[:, :C]
    return ids, torch.gather(overlap, 1, ids)


def raster_plain(sx, sy, sz, faces, valid, H: int, W: int, tile: int = 32,
                 tile_cap: int = 512, soft_edge_px: float = 1.0,
                 batch_elems: int = 1 << 25) -> RasterOut:
    """The plain version of the kernel part: screen coordinates [V] (sx,
    sy, NDC z), faces [T,3], valid [T] → RasterOut, differentiable in sx,
    sy and sz.  ``batch_elems`` bounds the live pixel × triangle sweep."""
    faces = faces.long()
    dev = sx.device
    if faces.shape[0] == 0:
        z = sx.sum() * 0.0          # keeps the graph: zero gradients
        return RasterOut(torch.zeros(H, W, 3, device=dev) + z,
                         torch.full((H, W), -1, dtype=torch.int32,
                                    device=dev),
                         torch.ones(H, W, device=dev) + z,
                         torch.zeros(H, W, device=dev) + z)
    cu, cv, cz, scale, bb_min, bb_max = _face_coeffs(sx, sy, sz, faces)
    nty, ntx = -(-H // tile), -(-W // tile)
    G, P = nty * ntx, tile * tile
    with torch.no_grad():
        ids, listed = tile_lists(bb_min, bb_max, valid, H, W, tile, tile_cap,
                                 soft_edge_px)
        C = ids.shape[1]
        counts = listed.sum(1)                                 # [G]
        lp = torch.arange(tile, device=dev, dtype=torch.float32) + 0.5
        gy = torch.arange(nty, device=dev).repeat_interleave(ntx)
        gx = torch.arange(ntx, device=dev).repeat(nty)
        win = torch.full((G, P), -1, dtype=torch.int64, device=dev)
        marg = torch.full((G, P), -1, dtype=torch.int64, device=dev)
        cd = [c.detach() for c in (cu, cv, cz, scale)]
        step = max(1, batch_elems // max(P * C, 1))
        for g0 in range(0, G, step):
            g = slice(g0, min(G, g0 + step))
            # listed triangles come first: sweep only as far as the
            # fullest tile of the batch
            cmax = max(1, int(counts[g].max()))
            px = (lp[None, None, :] + (gx[g] * tile).float()[:, None, None]
                  ).expand(-1, tile, tile).reshape(-1, P, 1)
            py = (lp[None, :, None] + (gy[g] * tile).float()[:, None, None]
                  ).expand(-1, tile, tile).reshape(-1, P, 1)
            gid = ids[g, :cmax]
            ok = listed[g, None, :cmax]                        # [b, 1, c]
            bu = _eval(cd[0][gid][:, None], px, py)            # [b, P, c]
            bv = _eval(cd[1][gid][:, None], px, py)
            zz = _eval(cd[2][gid][:, None], px, py)
            bw = 1.0 - bu - bv
            inside = (bu >= 0) & (bv >= 0) & (bw >= 0) & ok
            best = torch.where(inside, zz, torch.inf).argmin(-1)   # [b, P]
            hit = torch.gather(inside, 2, best[..., None])[..., 0]
            win[g] = torch.where(hit, torch.gather(gid, 1, best), -1)
            if soft_edge_px > 0:
                m = torch.minimum(torch.minimum(bu, bv), bw) * \
                    cd[3][gid][:, None]
                m = torch.where(ok, m, -1e9)
                mbest = m.argmax(-1)
                real = torch.gather(ok.expand_as(m), 2,
                                    mbest[..., None])[..., 0]
                # a tile with unlisted slots has a −1e9 among its margins
                real &= (torch.gather(m, 2, mbest[..., None])[..., 0] > -1e9) \
                    | (counts[g] >= C)[:, None]
                marg[g] = torch.where(real, torch.gather(gid, 1, mbest), -1)

    def untile(x):
        x = x.reshape(nty, ntx, tile, tile).transpose(1, 2)
        return x.reshape(nty * tile, ntx * tile)[:H, :W]

    win, marg = untile(win), untile(marg)
    j, i = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32),
                          indexing="ij")
    px, py = i + 0.5, j + 0.5
    hit = win >= 0
    t = win.clamp(min=0)
    bu, bv, zz = (_st(_eval(c[t], px, py), e) for c, e in zip(
        (cu, cv, cz), _edge_form(sx, sy, sz, faces, t, px, py)))
    bary = torch.where(hit[..., None],
                       torch.stack([1.0 - bu - bv, bu, bv], -1), 0.0)
    depth = torch.where(hit, zz, 1.0)
    if soft_edge_px > 0:
        t = marg.clamp(min=0)
        bu_e, bv_e, _ = _edge_form(sx, sy, sz, faces, t, px, py)
        m = _st(_margin(_eval(cu[t], px, py), _eval(cv[t], px, py)) *
                scale[t], _margin(bu_e, bv_e) * scale[t])
        # no listed triangle: the −1e9 of an unlisted slot, sigmoid → 0
        m = torch.where(marg >= 0, m, -1e9)
        alpha = torch.sigmoid(m / soft_edge_px * 4.0)
    else:
        alpha = hit.float()
    return RasterOut(bary, win.to(torch.int32), depth, alpha)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster.cu)
# ---------------------------------------------------------------------------

def _raster_fwd_cuda(sx, sy, sz, faces, valid, H, W, tile, tile_cap, soft):
    valid8 = valid.contiguous().view(torch.uint8)
    kernels.check_cuda(sx, sy, sz, faces, valid8)
    if tile * tile % 32 or tile > 32 or tile_cap > 1024:
        raise ValueError("the raster kernel takes tile <= 32 (a multiple of "
                         "32 pixels) and tile_cap <= 1024")
    V, T = sx.shape[0], faces.shape[0]
    dev = sx.device
    coef = torch.empty(T, 12, device=dev)       # cu, cv, cz, scale, pad
    rng = torch.empty(T, 4, device=dev, dtype=torch.int32)
    bary = torch.empty(H, W, 3, device=dev)
    tri = torch.empty(H, W, device=dev, dtype=torch.int32)
    marg = torch.empty_like(tri)
    depth = torch.empty(H, W, device=dev)
    alpha = torch.empty_like(depth)
    p = kernels.ptr
    kernels.launch("raster_fwd", p(sx), p(sy), p(sz), p(faces), p(valid8), V,
                   T, H, W, tile, min(tile_cap, T), float(soft), p(coef),
                   p(rng), p(bary), p(tri), p(depth), p(alpha), p(marg))
    return RasterOut(bary, tri, depth, alpha), marg


class _RasterCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sx, sy, sz, faces, valid, H, W, tile, tile_cap, soft):
        out, marg = _raster_fwd_cuda(sx, sy, sz, faces, valid, H, W, tile,
                                     tile_cap, soft)
        ctx.save_for_backward(sx, sy, sz, faces, out.tri_id, marg, out.alpha)
        ctx.soft = soft
        ctx.mark_non_differentiable(out.tri_id)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_bary, _g_tri, g_depth, g_alpha):
        sx, sy, sz, faces, tri, marg, alpha = ctx.saved_tensors
        H, W = tri.shape
        gs = torch.zeros(3, sx.shape[0], device=sx.device)
        g_bary = torch.zeros(H, W, 3, device=sx.device) if g_bary is None \
            else g_bary.contiguous()
        g_depth = torch.zeros(H, W, device=sx.device) if g_depth is None \
            else g_depth.contiguous()
        g_alpha = torch.zeros(H, W, device=sx.device) if g_alpha is None \
            else g_alpha.contiguous()
        kernels.check_cuda(sx, sy, sz, faces, tri, marg, alpha, g_bary,
                           g_depth, g_alpha, gs)
        p = kernels.ptr
        kernels.launch("raster_bwd", p(sx), p(sy), p(sz), p(faces), p(tri),
                       p(marg), p(alpha), p(g_bary), p(g_depth), p(g_alpha),
                       H, W, float(ctx.soft), p(gs[0]), p(gs[1]), p(gs[2]))
        return gs[0], gs[1], gs[2], None, None, None, None, None, None, None


def raster_cuda(sx, sy, sz, faces, valid, H: int, W: int, tile: int = 32,
                tile_cap: int = 512, soft_edge_px: float = 1.0) -> RasterOut:
    """The kernel part on the card; same contract as ``raster_plain``."""
    out = _RasterCuda.apply(sx.contiguous(), sy.contiguous(),
                            sz.contiguous(), faces.contiguous(), valid, H, W,
                            tile, tile_cap, float(soft_edge_px))
    return RasterOut(*out)


def rasterize(clip_verts: torch.Tensor, faces: torch.Tensor,
              face_mask: torch.Tensor, H: int, W: int, tile: int = 32,
              tile_cap: int = 512, soft_edge_px: float = 1.0) -> RasterOut:
    """clip_verts [V,4] fp32, faces [T,3] int32, face_mask [T] bool."""
    faces = faces.to(torch.int32)
    sx, sy, sz, valid = screen_coords(clip_verts.float(), faces, face_mask,
                                      H, W)
    if clip_verts.is_cuda:
        return raster_cuda(sx, sy, sz, faces, valid, H, W, tile, tile_cap,
                           soft_edge_px)
    if clip_verts.device.type != "cpu":
        raise ValueError(f"unsupported device {clip_verts.device}")
    return raster_plain(sx, sy, sz, faces, valid, H, W, tile,
                        tile_cap, soft_edge_px)


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------

def interpolate_plain(attrs, bary, tri_id, faces) -> torch.Tensor:
    f = faces.long()[tri_id.clamp(min=0).long()]              # [H, W, 3]
    val = torch.einsum("hwk,hwkc->hwc", bary, attrs[f])
    return torch.where((tri_id >= 0)[..., None], val, 0.0)


class _InterpolateCuda(torch.autograd.Function):

    @staticmethod
    def forward(ctx, attrs, bary, tri_id, faces):
        kernels.check_cuda(attrs, bary, tri_id, faces)
        H, W = tri_id.shape
        V, C = attrs.shape
        out = torch.empty(H, W, C, device=attrs.device)
        p = kernels.ptr
        kernels.launch("interpolate_fwd", p(attrs), p(bary), p(tri_id),
                       p(faces), H * W, C, p(out))
        ctx.save_for_backward(attrs, bary, tri_id, faces)
        return out

    @staticmethod
    def backward(ctx, g_out):
        attrs, bary, tri_id, faces = ctx.saved_tensors
        g_out = g_out.contiguous()
        g_attrs = torch.zeros_like(attrs)
        g_bary = torch.empty_like(bary)
        p = kernels.ptr
        kernels.launch("interpolate_bwd", p(attrs), p(bary), p(tri_id),
                       p(faces), p(g_out), tri_id.numel(), attrs.shape[1],
                       p(g_attrs), p(g_bary))
        return g_attrs, g_bary, None, None


def interpolate(attrs: torch.Tensor, out: RasterOut,
                faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex attributes [V, C] → per-pixel [H, W, C] from the
    barycentrics; 0 where nothing hits.  Differentiable in attrs and
    bary."""
    if attrs.is_cuda:
        return _InterpolateCuda.apply(attrs.float().contiguous(),
                                      out.bary.contiguous(), out.tri_id,
                                      faces.to(torch.int32).contiguous())
    if attrs.device.type != "cpu":
        raise ValueError(f"unsupported device {attrs.device}")
    return interpolate_plain(attrs, out.bary, out.tri_id, faces)
