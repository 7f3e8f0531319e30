"""K12: NHWC 2-D convolution (``dreamfusion_tpu/ops/conv.py::mm_conv``).

``conv2d(x, w, bias, stride, padding)`` takes x ``[B, H, W, I]`` and the
weight in the port's layout ``[O, kh, kw, I]`` (input channels contiguous;
``utils/convert.py`` turns Flax's ``[kh, kw, I, O]`` into it), with padding
``((top, bottom), (left, right))`` that may be asymmetric: the VAE's
downsample is padding ((0, 1), (0, 1)) at stride 2, the same as JAX's
``jnp.pad`` then a VALID conv.  Products accumulate in fp32 and the bias is
added in fp32, as ``mm_conv`` + ``MMConv`` do; the output is x's dtype or
fp32.

On a CUDA tensor the forward is one launch of one of five routes of
``csrc/conv.cu``, chosen by ``conv_route`` on the shape alone: the Hopper
implicit GEMM (wgmma, operands by TMA; ``conv_fwd_wgmma``) for bf16 at
stride 1 or 2 with I % 64 == 0 (every conv of the UNet's and the VAE's
levels and their downsamplers), its narrow-input form
(``conv_fwd_wgmma_i8``) for bf16 stride-1 convs with I <= 8 (the 3- and
4-channel conv_ins: x zero-padded to 8 channels first, one more launch
where I < 8, the weight packed once and cached), the warp-per-pixel fp32
kernel for the narrow fp32 convs (O <= 8, I % 4 == 0), the tiled fp32
implicit GEMM on the CUDA cores (``conv_fwd_fp32_tiled``) for every other
fp32 conv (the DPT's 40), and the mma.sync implicit GEMM for the bf16
rest, which no SD-step shape reaches; the tensor-core routes and the tiled
fp32 one split over K where the output tiles alone cannot fill the card.
The input gradient is one launch of one of five routes, chosen by
``dgrad_route`` on the shape alone: the wgmma kernel over dx's parity
classes (``conv_dgrad_wgmma``; bf16, O % 64 == 0, stride 1 or 2: at stride
1 a forward conv of dy with the flipped, transposed weight, packed once per
weight version and cached: 70.6 MB for the SD VAE encoder, whose weights
are 65.8 MB), mma.sync with A fragments from device memory for the narrow
dx of the conv_ins (``conv_dgrad_narrow``), CUDA cores for the fp32
conv_outs (``conv_dgrad_fp32``), the tiled fp32 forward's design over dx's
parity classes for every other fp32 dgrad (``conv_dgrad_fp32_tiled``: the
DPT's 40, its 3-channel stem's dx and the 1x1 stride-2 downsamples, whose
three tapless classes come out as zeros, included; the same packed
weight), and mma.sync (``conv_dgrad``) for the bf16 rest, which no SD-step
shape reaches.  The weight gradient (``f_bwd``'s dk) is one launch of one
of four routes, chosen by ``wgrad_route`` on the dtype and shape: the
wgmma kernel with dy and x by TMA over 64-pixel boxes of the output grid
(``conv_wgrad_wgmma``; bf16, I % 64 == 0, O % 8 == 0, stride 1 or 2: every
UNet and VAE conv but the conv_ins), its narrow-input form
(``conv_wgrad_wgmma_i8``; bf16, I <= 8, O % 8 == 0, stride 1, at most 9
taps: the conv_ins' 3, 4 and 8 channels, x padded to 8 channels in the
launch, one wgmma n72 over the nine taps' 8 channels), mma.sync for the
other bf16 shapes (``conv_wgrad_mma``: the towers' test widths), and a
tiled GEMM on the CUDA cores for fp32 (``conv_wgrad_fp32_tiled``: the
DPT's 40 and the conv_outs), each split over the pixels where dW's tiles
alone cannot fill the card, the splits' partials summed in order in the
same launch; the bias's gradient is one sum of dy.  x is saved for
the backward only where the weight asks for a gradient (the frozen towers
keep none).  On a CPU tensor the plain versions run: the JAX package's
shifted-einsum form (``_einsum_conv``), for dx the kernels' own
decomposition through it (``conv2d_dgrad_plain``), for dW its transpose
(``conv2d_wgrad_plain``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from . import kernels

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def norm_padding(padding: Union[int, Sequence]) -> Pads:
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def out_size(H: int, W: int, kh: int, kw: int, stride: Tuple[int, int],
             pads: Pads) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return ((H + pt + pb - kh) // stride[0] + 1,
            (W + pl + pr - kw) // stride[1] + 1)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: Tuple[int, int],
                 pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """Sum over taps of shifted-slice einsums in fp32 (``_einsum_conv``)."""
    B, H, W, _ = x.shape
    _, kh, kw, _ = w.shape
    (pt, pb), (pl, pr) = pads
    sh, sw = stride
    Ho, Wo = out_size(H, W, kh, kw, stride, pads)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    wf = w.float()
    acc = None
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, i:i + (Ho - 1) * sh + 1:sh, j:j + (Wo - 1) * sw + 1:sw]
            term = torch.einsum("bhwc,oc->bhwo", sl, wf[:, i, j])
            acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = 128                    # output tile of both tensor-core routes
_BK_MMA, _BK_WGMMA = 32, 64    # their K steps
_NARROW_O = 8                  # widest output of the fp32 route
_FP32_BM, _FP32_BK = 128, 16   # the tiled fp32 route's pixels a tile, K step
_FP32_BLOCKS_PER_SM = 3        # its blocks an SM holds (168 registers)
_FP32_MIN_STEPS, _FP32_MAX_SPLITS = 8, 32   # K steps a split, splits
_NARROW_I, _NARROW_K = 8, 10   # the narrow-input route: 8 channels a tap,
                               # at most 10 taps (K chunks of 8)
_DX_NARROW_I, _DX_NARROW_O = 8, 256   # the narrow dgrad: dx <= 8 channels
                                      # (one n8 tile), dy <= 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def conv_route(dtype: torch.dtype, I: int, O: int,
               stride: Tuple[int, int], taps: int) -> str:
    """The launch counter (and kernel) of a forward conv with `taps` =
    kh * kw, by shape alone:
    "conv_fwd_wgmma" for bf16 at strides of 1 or 2 with I % 64 == 0 (a K
    block is 64 input channels; at stride 2 TMA walks every other pixel),
    "conv_fwd_wgmma_i8" for bf16 at stride 1 with I <= 8 and at most 10
    taps (the conv_ins), else "conv_fwd_mma" for bf16 (8 < I, I % 64 !=
    0 or a stride above 2); "conv_fwd_fp32" for fp32 with O <= 8 and I %
    4 == 0 (16-byte loads), else "conv_fwd_fp32_tiled" for fp32 at any
    stride, I and O (the DPT's convs, its 3-channel stem included).  No
    conv of the SD step or the DPT takes "conv_fwd_mma" (the towers' test
    widths and the ViT patch embeddings do)."""
    if dtype == torch.bfloat16:
        if I % 64 == 0 and max(stride) <= 2:
            return "conv_fwd_wgmma"
        if I <= _NARROW_I and tuple(stride) == (1, 1) and taps <= _NARROW_K:
            return "conv_fwd_wgmma_i8"
        return "conv_fwd_mma"
    if O <= _NARROW_O and I % 4 == 0:
        return "conv_fwd_fp32"
    return "conv_fwd_fp32_tiled"


def pixel_box(B: int, Ho: int, Wo: int) -> Tuple[int, int, int]:
    """The wgmma routes' 128 output pixels per tile as a box (bw, bh, bb)
    of the output grid: as wide as the row allows, then rows, then images
    (128x1x1 at W = 512, 64x2x1 at 64², 8x8x2 at 8²)."""
    bw = min(_TILE, _pow2_at_least(Wo))
    bh = min(_TILE // bw, _pow2_at_least(Ho))
    return bw, bh, _TILE // (bw * bh)


def split_k(tiles: int, k_steps: int, sms: int, min_steps: int,
            blocks_per_sm: float = 2.0) -> int:
    """Split-K factor of a tensor-core route on a card with `sms`
    multiprocessors: about `blocks_per_sm` blocks per SM when the `tiles`
    output tiles alone cannot fill the card, at least `min_steps` K steps
    per split (mma.sync: 8 of 32; wgmma: 4 of 64), at most 16 splits."""
    if tiles >= sms:
        return 1
    return max(1, min(int(blocks_per_sm * sms) // tiles,
                      k_steps // min_steps, 16))


def wgmma_tiling(B: int, Ho: int, Wo: int, O: int, k_steps: int, sms: int,
                 small_output: bool, classes: int = 1):
    """(pixel box, N tile, split-K factor) of the wgmma routes for an
    output [B, Ho, Wo, O] (per class: a dgrad's parity classes share a
    launch) and `k_steps` 64-wide K blocks.  The stride-1 convs and the
    dgrads take 128-wide N tiles and two blocks per SM of splits.  A
    `small_output` (stride 2: a quarter of the input's pixels; the
    narrow-input conv_ins) takes N tiles 64 wide where 128-wide ones would
    fill under half the SMs, and splits for one block per SM: these convs
    are bound by the tiles' traffic out of L2, which splits do not cut,
    while their partials and reduce pass add to it."""
    box = pixel_box(B, Ho, Wo)
    pix = _cdiv(Wo, box[0]) * _cdiv(Ho, box[1]) * _cdiv(B, box[2])
    if not small_output:
        return box, _TILE, split_k(pix * _cdiv(O, _TILE) * classes, k_steps,
                                   sms, 4)
    bn = 64 if 2 * pix * _cdiv(O, _TILE) < sms else _TILE
    return box, bn, split_k(pix * _cdiv(O, bn), k_steps, sms, 4, 1.0)


@functools.lru_cache(maxsize=None)
def fp32_tiling(M: int, O: int, K: int, sms: int) -> Tuple[int, int]:
    """(N tile, split-K factor) of the tiled fp32 route for M output
    pixels, O channels and K = kh*kw*I on a card with `sms`
    multiprocessors.  The N tile is 32 where O fits in it, else 64 (128
    lost to 64 at every DPT shape: 206-252 registers a thread left one
    block an SM).  The split is the one of fewest waves x K steps a wave
    (waves of three blocks an SM), fewest splits on a tie, among those
    that leave each split 8 K steps (at most 32 splits) and put at least
    `sms` blocks on the card, or the most splits where K cannot split that
    far."""
    ks = _cdiv(K, _FP32_BK)
    top = max(1, min(_FP32_MAX_SPLITS, ks // _FP32_MIN_STEPS))
    bn = 32 if O <= 32 else 64
    tiles = _cdiv(M, _FP32_BM) * _cdiv(O, bn)
    fill = [s for s in range(1, top + 1) if tiles * s >= sms] or [top]
    return bn, min(fill, key=lambda s: (
        _cdiv(tiles * s, _FP32_BLOCKS_PER_SM * sms) * _cdiv(ks, s), s))


def _workspace(splits: int, out_numel: int, device):
    if splits == 1:
        return None
    return torch.empty(splits * out_numel, device=device,
                       dtype=torch.float32)


def _pad_channels(x: torch.Tensor, w: torch.Tensor):
    """The mma.sync path reads 8 input channels at a time: pad narrower
    inputs with zero channels."""
    I = x.shape[-1]
    if I % 8 == 0:
        return x, w
    pad = 8 - I % 8
    return F.pad(x, (0, pad)), F.pad(w, (0, pad))


def pack_narrow_weight(w: torch.Tensor, bn: int) -> torch.Tensor:
    """[O, kh, kw, I] (I <= 8, kh*kw <= 10) → the narrow-input route's
    [ceil(O / bn), 10, bn, 8]: per N tile of bn output channels, chunk t
    holds tap t's channels (one N tile's B is one contiguous copy), zero
    past the taps, past I (x's zero channels) and past O."""
    O, kh, kw, I = w.shape
    tiles = _cdiv(O, bn)
    pk = w.new_zeros(tiles * bn, _NARROW_K, _NARROW_I)
    pk[:O, :kh * kw, :I] = w.reshape(O, kh * kw, I)
    return pk.reshape(tiles, bn, _NARROW_K, _NARROW_I).transpose(1, 2) \
        .contiguous()


# weight → {layout: (data_ptr, version, packed)}
_PACKED = WeakIdKeyDictionary()


def _cached_pack(w: torch.Tensor, layout, make) -> torch.Tensor:
    """``make()``, w in another layout, once per weight and `layout`:
    cached on the tensor and made afresh when its storage or version (an
    in-place update) moves."""
    packs = _PACKED.setdefault(w, {})
    hit = packs.get(layout)
    if hit is not None and hit[:2] == (w.data_ptr(), w._version):
        return hit[2]
    with torch.no_grad():          # a weight that wants a gradient: no graph
        pk = make()
    packs[layout] = (w.data_ptr(), w._version, pk)
    return pk


def _packed_narrow_weight(w: torch.Tensor, bn: int) -> torch.Tensor:
    """``pack_narrow_weight`` once per weight and N tile."""
    return _cached_pack(w, ("narrow", bn), lambda: pack_narrow_weight(w, bn))


def conv2d_fwd_cuda(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: Tuple[int, int],
                    pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv kernel takes fp32 or bf16 x and w of one "
                         f"dtype, got {x.dtype}, {w.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    if w.shape[-1] != x.shape[-1]:
        raise ValueError(f"weight {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    O, kh, kw, _ = w.shape
    route = conv_route(x.dtype, x.shape[-1], O, stride, kh * kw)
    x, w = x.contiguous(), w.contiguous()
    if route == "conv_fwd_mma":
        x, w = _pad_channels(x, w)
    bias = None if bias is None else bias.float().contiguous()
    kernels.check_cuda(x, w, bias)
    B, H, W, I = x.shape
    Ho, Wo = out_size(H, W, kh, kw, stride, pads)
    y = torch.empty(B, Ho, Wo, O, device=x.device, dtype=out_dtype)
    f32 = int(out_dtype == torch.float32)
    (pt, _), (pl, _) = pads
    # what the route reads in 16-byte units (the narrow-input route reads
    # x elementwise, into its padded copy, and packs w; the tiled fp32
    # route copies 4 bytes at a time where I % 4 != 0)
    direct = () if route == "conv_fwd_wgmma_i8" or (
        route == "conv_fwd_fp32_tiled" and I % 4) else (x, w)
    if route != "conv_fwd_mma" and any(t.data_ptr() % 16 for t in direct):
        raise ValueError(f"{route} reads x and w in 16-byte units: 16-byte "
                         "aligned tensors only")
    if route == "conv_fwd_fp32":
        kernels.launch(route, kernels.ptr(x), kernels.ptr(w),
                       kernels.ptr(bias), kernels.ptr(y), B, H, W, I, Ho, Wo,
                       O, kh, kw, stride[0], stride[1], pt, pl, f32)
        return y
    sms = kernels.sm_count(x.device)
    if route == "conv_fwd_fp32_tiled":
        bn, splits = fp32_tiling(B * Ho * Wo, O, kh * kw * I, sms)
        ws = _workspace(splits, y.numel(), x.device)
        kernels.launch(route, kernels.ptr(x), kernels.ptr(w),
                       kernels.ptr(bias), kernels.ptr(y), B, H, W, I, Ho, Wo,
                       O, kh, kw, stride[0], stride[1], pt, pl, bn, f32,
                       splits, kernels.ptr(ws))
        return y
    if route == "conv_fwd_wgmma_i8":
        (bw, bh, bb), bn, _ = wgmma_tiling(B, Ho, Wo, O, 1, sms, True)
        # x padded to 8 channels and by the taps' reach, in the launch, with
        # slack for the ragged pixel box's reads past its last row
        xp = torch.empty(B * (Ho + kh - 1) * (Wo + kw - 1) + 256, _NARROW_I,
                         device=x.device, dtype=x.dtype)
        kernels.launch(route, kernels.ptr(x), kernels.ptr(xp),
                       kernels.ptr(_packed_narrow_weight(w, bn)),
                       kernels.ptr(bias), kernels.ptr(y), B, H, W, I, Ho, Wo,
                       O, kh, kw, pt, pl, bw, bh, bb, bn, f32, sms)
        return y
    if route == "conv_fwd_wgmma":
        (bw, bh, bb), bn, splits = wgmma_tiling(
            B, Ho, Wo, O, kh * kw * I // _BK_WGMMA, sms,
            tuple(stride) != (1, 1))
        ws = _workspace(splits, y.numel(), x.device)
        kernels.launch(route, kernels.ptr(x), kernels.ptr(w),
                       kernels.ptr(bias), kernels.ptr(y), B, H, W, I, Ho, Wo,
                       O, kh, kw, stride[0], stride[1], pt, pl, bw, bh, bb, bn,
                       f32, splits, sms, kernels.ptr(ws))
        return y
    splits = split_k(_cdiv(B * Ho * Wo, _TILE) * _cdiv(O, _TILE),
                     kh * kw * I // _BK_MMA, sms, 8)
    ws = _workspace(splits, y.numel(), x.device)
    kernels.launch(route, kernels.ptr(x), kernels.ptr(w), kernels.ptr(bias),
                   kernels.ptr(y), B, H, W, I, Ho, Wo, O, kh, kw, stride[0],
                   stride[1], pt, pl, f32, splits, kernels.ptr(ws))
    return y


def dgrad_route(dtype: torch.dtype, I: int, O: int,
                stride: Tuple[int, int], kernel: Tuple[int, int]) -> str:
    """The launch counter (and kernel) of the input gradient dx [.., I] of
    a conv with O output channels and a kernel of `kernel` = (kh, kw) taps,
    by shape alone: "conv_dgrad_narrow" for bf16 at stride 1 with I <= 8,
    O <= 256, O % 32 == 0 and kh, kw <= 3 (the VAE's 3-channel conv_in),
    "conv_dgrad_wgmma" for other bf16 with O % 64 == 0 at strides of 1 or 2
    (a K block is 64 of dy's channels: every level and downsampler of the
    VAE encoder), else "conv_dgrad" for bf16 (mma.sync), which no dgrad of
    the SD step takes (the towers' test widths do); "conv_dgrad_fp32" for
    fp32 with O <= 8 and I % 4 == 0 (the conv_outs), else
    "conv_dgrad_fp32_tiled" for fp32 at any stride, I and O (the DPT's
    convs, its 3-channel stem included)."""
    kh, kw = kernel
    if dtype == torch.float32:
        if O <= _NARROW_O and I % 4 == 0:
            return "conv_dgrad_fp32"
        return "conv_dgrad_fp32_tiled"
    if (I <= _DX_NARROW_I and tuple(stride) == (1, 1) and O % 32 == 0
            and O <= _DX_NARROW_O and kh <= 3 and kw <= 3):
        return "conv_dgrad_narrow"
    if O % 64 == 0 and max(stride) <= 2:
        return "conv_dgrad_wgmma"
    return "conv_dgrad"


def _class_taps(k: int, s: int, p: int, q: int) -> Tuple[int, int, int]:
    """Along one axis (kernel k, stride s, leading pad p), the taps of the
    dx pixels at q mod s: (first tap r0, count n, dy offset o).  Pixel
    q + s*i reads dy at i + o - t through tap r0 + s*t, t < n."""
    r0 = (q + p) % s
    n = -(-(k - r0) // s) if r0 < k else 0
    return r0, n, (q + p - r0) // s


def dgrad_classes(H: int, W: int, kh: int, kw: int, stride: Tuple[int, int],
                  pads: Pads):
    """The parity classes of a dgrad at `stride` (one at stride 1): per
    class (py, px), its grid (Hc, Wc) = dx[:, py::sh, px::sw]'s, its taps
    (r0, nt, s0, nu) and, as a forward stride-1 conv of dy with the flipped
    sub-kernel, that conv's leading pads (nt - 1 - oy, nu - 1 - ox)."""
    sh, sw = stride
    (pt, _), (pl, _) = pads
    out = []
    for py in range(sh):
        for px in range(sw):
            r0, nt, oy = _class_taps(kh, sh, pt, py)
            s0, nu, ox = _class_taps(kw, sw, pl, px)
            out.append({"py": py, "px": px, "Hc": max(0, -(-(H - py) // sh)),
                        "Wc": max(0, -(-(W - px) // sw)), "r0": r0, "nt": nt,
                        "s0": s0, "nu": nu, "pt": nt - 1 - oy,
                        "pl": nu - 1 - ox})
    return out


def pack_dgrad_weight(w: torch.Tensor, stride: Tuple[int, int],
                      pads: Pads) -> torch.Tensor:
    """[O, kh, kw, I] → the dgrad's [sh*sw*I, kmax] (kmax: the most taps of
    a class x O, rounded up to 64): row c*I + i, column (t*nu + u)*O + o
    holds w[o, r0 + sh*(nt-1-t), s0 + sw*(nu-1-u), i] for class c, zero
    past its taps.  Per class, rows c*I.. are a forward weight [I, nt, nu,
    O] of the port's layout: the flipped, transposed (sub-)kernel."""
    O, kh, kw, I = w.shape
    sh, sw = stride
    classes = dgrad_classes(1, 1, kh, kw, stride, pads)
    kmax = _cdiv(max(c["nt"] * c["nu"] for c in classes) * O, 64) * 64
    pk = w.new_zeros(len(classes), I, kmax)
    for i, c in enumerate(classes):
        nt, nu = c["nt"], c["nu"]
        if nt * nu == 0:
            continue
        rows = [c["r0"] + sh * (nt - 1 - t) for t in range(nt)]
        cols = [c["s0"] + sw * (nu - 1 - u) for u in range(nu)]
        sub = w[:, rows][:, :, cols]                   # [O, nt, nu, I]
        pk[i, :, :nt * nu * O] = sub.permute(3, 1, 2, 0).reshape(I, -1)
    return pk.reshape(len(classes) * I, kmax)


def conv2d_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                       x_shape: Sequence[int], stride: Tuple[int, int],
                       pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """dx [B, H, W, I] from dy [B, Ho, Wo, O], the kernels' way: per parity
    class, a stride-1 ``conv2d_plain`` of dy with the class's flipped,
    transposed sub-kernel (``pack_dgrad_weight``), written to dx[:, py::sh,
    px::sw]; a class without taps gets zeros.  fp32 sums."""
    B, H, W, I = x_shape
    O = w.shape[0]
    _, Ho, Wo, _ = dy.shape
    kh, kw = w.shape[1:3]
    pk = pack_dgrad_weight(w.float(), stride, pads)
    dx = torch.zeros(B, H, W, I, device=dy.device, dtype=torch.float32)
    sh, sw = stride
    for i, c in enumerate(dgrad_classes(H, W, kh, kw, stride, pads)):
        nt, nu, Hc, Wc = c["nt"], c["nu"], c["Hc"], c["Wc"]
        if nt * nu == 0 or Hc * Wc == 0:
            continue
        wc = pk[i * I:(i + 1) * I, :nt * nu * O].reshape(I, nt, nu, O)
        # leading pads as given (negative: a crop), trailing ones so that
        # the class's grid comes out Hc x Wc
        cpads = ((c["pt"], Hc - Ho - c["pt"] + nt - 1),
                 (c["pl"], Wc - Wo - c["pl"] + nu - 1))
        dx[:, c["py"]::sh, c["px"]::sw] = conv2d_plain(
            dy, wc, None, (1, 1), cpads, torch.float32)
    return dx.to(out_dtype)


def _packed_dgrad_weight(w: torch.Tensor, stride: Tuple[int, int],
                         pads: Pads) -> torch.Tensor:
    """``pack_dgrad_weight`` once per weight, stride and class layout (the
    leading pads mod the stride)."""
    (pt, _), (pl, _) = pads
    layout = ("dgrad", tuple(stride), pt % stride[0], pl % stride[1])
    return _cached_pack(w, layout, lambda: pack_dgrad_weight(w, stride, pads))


def pack_dgrad_narrow_weight(w: torch.Tensor) -> torch.Tensor:
    """[O, kh, kw, I] (I <= 8, O % 32 == 0) → the narrow dgrad's B
    fragments [kh*kw, O/32, 32, 8]: for tap t, 32-channel group p and lane
    l = 4n + q, w[32p + 8q + j, t, n] for j < 8 (dy's channels by dx's
    channel n; the kernel's K order), zero past I."""
    O, kh, kw, I = w.shape
    wt = F.pad(w.reshape(O, kh * kw, I), (0, _DX_NARROW_I - I))
    g = wt.reshape(O // 32, 4, 8, kh * kw, _DX_NARROW_I)   # [p, q, j, t, n]
    return g.permute(3, 0, 4, 1, 2).reshape(kh * kw, O // 32, 32, 8) \
        .contiguous()


def conv2d_dgrad_cuda(dy: torch.Tensor, w: torch.Tensor,
                      x_shape: Sequence[int], stride: Tuple[int, int],
                      pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """dx [B, H, W, I] from dy [B, Ho, Wo, O] (dy is cast to w's dtype),
    one launch of the route ``dgrad_route`` names."""
    if w.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"conv dgrad takes fp32 or bf16, got {w.dtype}, "
                         f"{out_dtype}")
    dy = dy.to(w.dtype).contiguous()
    w = w.contiguous()
    B, H, W, I = x_shape
    O, kh, kw, _ = w.shape
    _, Ho, Wo, _ = dy.shape
    sh, sw = stride
    (pt, _), (pl, _) = pads
    route = dgrad_route(w.dtype, I, O, stride, (kh, kw))
    kernels.check_cuda(dy, w)
    # what the route reads in 16-byte units (the tiled fp32 route reads dy
    # 4 bytes at a time where O % 4 != 0, and its own packed weight)
    if route == "conv_dgrad":
        direct = ()
    elif route == "conv_dgrad_fp32_tiled":
        direct = (dy,) if O % 4 == 0 else ()
    else:
        direct = (dy, w)
    if any(t.data_ptr() % 16 for t in direct):
        raise ValueError(f"{route} reads dy and w in 16-byte units: 16-byte "
                         "aligned tensors only")
    f32 = int(out_dtype == torch.float32)
    sms = kernels.sm_count(dy.device)
    if route == "conv_dgrad_fp32_tiled":
        if out_dtype != torch.float32:
            raise ValueError("conv_dgrad_fp32_tiled writes an fp32 dx")
        pk = _packed_dgrad_weight(w, stride, pads)
        taps = max(c["nt"] * c["nu"] for c in
                   dgrad_classes(H, W, kh, kw, stride, pads))
        bn, splits = fp32_tiling(B * H * W, I, taps * O, sms)
        dx = torch.empty(B, H, W, I, device=dy.device, dtype=torch.float32)
        ws = _workspace(splits, dx.numel(), dy.device)
        kernels.launch(route, kernels.ptr(dy), kernels.ptr(pk),
                       kernels.ptr(dx), B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                       pt, pl, pk.shape[1], bn, splits, kernels.ptr(ws))
        return dx
    if route == "conv_dgrad_fp32":
        if out_dtype != torch.float32:
            raise ValueError("conv_dgrad_fp32 writes an fp32 dx")
        dx = torch.empty(B, H, W, I, device=dy.device, dtype=torch.float32)
        kernels.launch(route, kernels.ptr(dy), kernels.ptr(w),
                       kernels.ptr(dx), B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                       pt, pl)
        return dx
    dx = torch.empty(B, H, W, I, device=dy.device, dtype=out_dtype)
    if route == "conv_dgrad_narrow":
        wf = _cached_pack(w, ("dgrad_narrow",),
                          lambda: pack_dgrad_narrow_weight(w))
        kernels.launch(route, kernels.ptr(dy), kernels.ptr(wf),
                       kernels.ptr(dx), B, H, W, I, Ho, Wo, O, kh, kw, pt, pl,
                       f32, sms)
        return dx
    if route == "conv_dgrad_wgmma":
        pk = _packed_dgrad_weight(w, stride, pads)
        classes = dgrad_classes(H, W, kh, kw, stride, pads)
        taps = max(c["nt"] * c["nu"] for c in classes)
        # class (0, 0) has the largest grid
        (bw, bh, bb), bn, splits = wgmma_tiling(
            B, classes[0]["Hc"], classes[0]["Wc"], I,
            taps * O // _BK_WGMMA, sms, False, len(classes))
        ws = _workspace(splits, dx.numel(), dy.device)
        kernels.launch(route, kernels.ptr(dy), kernels.ptr(pk),
                       kernels.ptr(dx), B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                       pt, pl, pk.shape[1], bw, bh, bb, bn, f32, splits, sms,
                       kernels.ptr(ws))
        return dx
    wT = w.permute(3, 1, 2, 0).contiguous()          # [I, kh, kw, O]
    splits = 1
    if O % 8 == 0:
        tiles = (_cdiv(B * _cdiv(H, sh) * _cdiv(W, sw), _TILE) *
                 _cdiv(I, _TILE) * sh * sw)
        splits = split_k(tiles, _cdiv(kh, sh) * _cdiv(kw, sw) * O // _BK_MMA,
                         sms, 8)
    ws = _workspace(splits, dx.numel(), dy.device)
    kernels.launch(route, kernels.ptr(dy), kernels.ptr(wT),
                   kernels.ptr(dx), B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                   pt, pl, f32, splits, kernels.ptr(ws))
    return dx


# ---------------------------------------------------------------------------
# weight gradient
# ---------------------------------------------------------------------------

_WGRAD_TILE, _WGRAD_BK = 128, 32      # conv_wgrad_mma's dW tile, pixel step
_WGRAD_MIN_STEPS, _WGRAD_MAX_SPLITS = 16, 64
_WGRAD_PIX = 64                        # conv_wgrad_wgmma's pixels a step
# conv_wgrad_wgmma's split model: µs of a step of a 128 x 128 tile near the
# bf16 peak (2.1 MFLOP at 989 TFLOP/s over 132 SMs: 0.28), of a tile's
# start and epilogue, and bytes a µs of the partials' writes and reads
_WG_STEP_US, _WG_FILL_US, _WG_BYTES_PER_US = 0.3, 0.5, 3.0e6
_WG_MAX_SPLITS = 32
# conv_wgrad_wgmma_i8: B's columns (9 taps x 8 channels), boxes a split
_WGN_COLS, _WGN_TAPS, _WGN_MIN_STEPS = 72, 9, 4
# conv_wgrad_fp32_tiled: N tile → (columns a tile, blocks an SM: 127
# registers a thread, and the BN = 8 tile's 108 KB of shared memory)
_FW_TILES = {8: (512, 2), 32: (128, 6), 64: (128, 4)}
_FW_BK, _FW_MIN_STEPS, _FW_MAX_SPLITS = 16, 8, 64
_FW_SPLIT_ELEMS = 5e5   # dW elements whose partials (8 bytes) take a step


def wgrad_route(dtype: torch.dtype, I: int, O: int,
                stride: Tuple[int, int], taps: int) -> str:
    """The launch counter (and kernel) of a conv's weight gradient with
    `taps` = kh * kw, by shape: "conv_wgrad_wgmma" for bf16 with I % 64 ==
    0 (a 64-column box lies in one tap), O % 8 == 0 (dy's rows 16-byte
    multiples for TMA) at strides of 1 or 2 (every UNet and VAE conv but
    the conv_ins); "conv_wgrad_wgmma_i8" for bf16 with I <= 8, O % 8 == 0
    at stride 1 and at most 9 taps (the conv_ins' 3, 4 and 8 channels);
    else "conv_wgrad_mma" for bf16 (mma.sync: the towers' test widths);
    "conv_wgrad_fp32_tiled" for fp32 (the DPT's convs and the conv_outs;
    CUDA cores)."""
    if dtype == torch.bfloat16:
        if I % 64 == 0 and O % 8 == 0 and max(stride) <= 2:
            return "conv_wgrad_wgmma"
        if (I <= _NARROW_I and O % 8 == 0 and tuple(stride) == (1, 1)
                and taps <= _WGN_TAPS):
            return "conv_wgrad_wgmma_i8"
        return "conv_wgrad_mma"
    if dtype == torch.float32:
        return "conv_wgrad_fp32_tiled"
    raise ValueError(f"conv wgrad takes fp32 or bf16, got {dtype}")


def wgrad_splits(O: int, K: int, pixels: int, sms: int) -> int:
    """Split-K factor of ``conv_wgrad_mma`` over its `pixels` (the
    reduction) for dW [O, K] (K = kh*kw*I) on a card with `sms`
    multiprocessors: about two blocks an SM where dW's tiles alone leave
    SMs idle, at least 16 steps of 32 pixels a split, at most 64 splits."""
    tiles = _cdiv(O, _WGRAD_TILE) * _cdiv(K, _WGRAD_TILE)
    if tiles >= 2 * sms:
        return 1
    steps = _cdiv(pixels, _WGRAD_BK)
    return max(1, min(2 * sms // tiles, steps // _WGRAD_MIN_STEPS,
                      _WGRAD_MAX_SPLITS))


def wgrad_box(B: int, Ho: int, Wo: int) -> Tuple[int, int, int]:
    """``conv_wgrad_wgmma``'s 64 pixels a step as a box (bw, bh, bb) of the
    output grid, built as ``pixel_box``'s: as wide as the row allows, then
    rows, then images (64x1x1 at W = 64 and wider, 32x2 at 32², 8x8x1 at
    8², 4x4x4 at 4²)."""
    bw = min(_WGRAD_PIX, _pow2_at_least(Wo))
    bh = min(_WGRAD_PIX // bw, _pow2_at_least(Ho))
    return bw, bh, _WGRAD_PIX // (bw * bh)


def wgrad_boxes(B: int, Ho: int, Wo: int) -> int:
    """The pixel boxes (steps) of ``conv_wgrad_wgmma`` over [B, Ho, Wo]."""
    bw, bh, bb = wgrad_box(B, Ho, Wo)
    return _cdiv(Wo, bw) * _cdiv(Ho, bh) * _cdiv(B, bb)


@functools.lru_cache(maxsize=None)
def wgmma_wgrad_splits(O: int, K: int, steps: int, sms: int) -> int:
    """Split factor of ``conv_wgrad_wgmma`` for dW [O, K] over `steps`
    pixel boxes on `sms` multiprocessors (one persistent block an SM):
    the split of least modelled time, fewest on a tie; an SM's share of
    the tiles x splits takes their steps at ``_WG_STEP_US`` each plus
    ``_WG_FILL_US`` a tile, and a split above one adds its partials'
    traffic (written and read in fp32, dW written once) at
    ``_WG_BYTES_PER_US``."""
    tiles = _cdiv(O, _TILE) * _cdiv(K, _TILE)

    def cost(s):
        t = _cdiv(tiles * s, sms) * (_cdiv(steps, s) * _WG_STEP_US +
                                     _WG_FILL_US)
        return t + ((8 * s + 4) * O * K / _WG_BYTES_PER_US if s > 1 else 0)

    return min(range(1, max(1, min(_WG_MAX_SPLITS, steps)) + 1),
               key=lambda s: (cost(s), s))


def narrow_wgrad_splits(O: int, steps: int, sms: int) -> int:
    """Split factor of ``conv_wgrad_wgmma_i8`` for O output channels over
    `steps` pixel boxes on `sms` multiprocessors: a block a (128-channel
    tile of O, split), as many splits as fill the card once (the kernel
    streams dy, so one block an SM keeps it busy), at least 4 boxes a
    split."""
    return max(1, min(sms // _cdiv(O, _TILE), steps // _WGN_MIN_STEPS))


@functools.lru_cache(maxsize=None)
def fp32_wgrad_tiling(O: int, K: int, pixels: int,
                      sms: int) -> Tuple[int, int]:
    """(N tile, split factor) of ``conv_wgrad_fp32_tiled`` for dW [O, K]
    (K = kh*kw*I) over `pixels` on a card with `sms` multiprocessors.  The
    N tile follows O: 8 (the conv_outs' 4 and 8, tiles 512 columns wide),
    32 or 64 (128 columns).  The split is the one of least waves x steps of
    16 pixels a wave (waves of the blocks an SM holds: 2, 6, 4) plus its
    partials' traffic, a step for each ``_FW_SPLIT_ELEMS`` elements of dW a
    split writes and the reduce reads; fewest splits on a tie, at least 8
    steps a split where the pixels allow two, at most 64 splits."""
    bn = 8 if O <= 8 else 32 if O <= 32 else 64
    bm, per_sm = _FW_TILES[bn]
    steps = _cdiv(pixels, _FW_BK)
    tiles = _cdiv(K, bm) * _cdiv(O, bn)

    def cost(s):
        return (_cdiv(tiles * s, per_sm * sms) * _cdiv(steps, s) +
                (s * O * K / _FW_SPLIT_ELEMS if s > 1 else 0))

    top = max(1, min(_FW_MAX_SPLITS, steps // _FW_MIN_STEPS))
    return bn, min(range(1, top + 1), key=lambda s: (cost(s), s))


def conv2d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                       w_shape: Sequence[int], stride: Tuple[int, int],
                       pads: Pads) -> torch.Tensor:
    """dW [O, kh, kw, I] in fp32: the transpose of ``conv2d_plain``'s
    shifted-slice einsums (``_einsum_conv``'s, as ``mm_conv``'s custom_vjp
    transposes them), per tap dW[:, i, j] = dyᵀ · x's strided window."""
    O, kh, kw, I = w_shape
    (pt, pb), (pl, pr) = pads
    sh, sw = stride
    _, Ho, Wo, _ = dy.shape
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    dyf = dy.float()
    dw = torch.empty(O, kh, kw, I, device=dy.device, dtype=torch.float32)
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, i:i + (Ho - 1) * sh + 1:sh, j:j + (Wo - 1) * sw + 1:sw]
            dw[:, i, j] = torch.einsum("bhwo,bhwc->oc", dyf, sl)
    return dw


def conv2d_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor,
                      w_shape: Sequence[int], stride: Tuple[int, int],
                      pads: Pads, out_dtype: torch.dtype) -> torch.Tensor:
    """dW [O, kh, kw, I] in `out_dtype` from x [B, H, W, I] and dy [B,
    Ho, Wo, O] (dy is cast to x's dtype): one launch of the route
    ``wgrad_route`` names, its split partials summed in the launch."""
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"conv wgrad takes fp32 or bf16, got {x.dtype}, "
                         f"{out_dtype}")
    O, kh, kw, I = w_shape
    if x.shape[-1] != I or dy.shape[-1] != O:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} do "
                         f"not fit a weight {tuple(w_shape)}")
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    kernels.check_cuda(x, dy)
    route = wgrad_route(x.dtype, I, O, stride, kh * kw)
    if route == "conv_wgrad_fp32_tiled" and out_dtype != torch.float32:
        raise ValueError("conv_wgrad_fp32_tiled writes an fp32 dW")
    # what the route reads in 16-byte units (TMA: both, the narrow route x
    # only where it reads it unpadded (I == 8); mma.sync: x where I % 8 ==
    # 0, dy where O % 8 == 0; the fp32 route both where I and O are
    # multiples of 4)
    if route == "conv_wgrad_wgmma":
        direct = (x, dy)
    elif route == "conv_wgrad_wgmma_i8":
        direct = (x, dy) if I == _NARROW_I else (dy,)
    elif route == "conv_wgrad_mma":
        direct = tuple(t for t, n in ((x, I), (dy, O)) if n % 8 == 0)
    else:
        direct = (x, dy) if I % 4 == 0 and O % 4 == 0 else ()
    if any(t.data_ptr() % 16 for t in direct):
        raise ValueError(f"{route} reads x and dy in 16-byte units: 16-byte "
                         "aligned tensors only")
    B, H, W, _ = x.shape
    _, Ho, Wo, _ = dy.shape
    if (Ho, Wo) != out_size(H, W, kh, kw, stride, pads):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at stride {stride}, pads {pads}")
    (pt, _), (pl, _) = pads
    K = kh * kw * I
    sms = kernels.sm_count(x.device)
    dw = torch.empty(O, kh, kw, I, device=x.device, dtype=out_dtype)
    args = (kernels.ptr(x), kernels.ptr(dy), kernels.ptr(dw))
    shape = (B, H, W, I, Ho, Wo, O, kh, kw, stride[0], stride[1], pt, pl)
    f32 = int(out_dtype == torch.float32)
    if route == "conv_wgrad_wgmma":
        splits = wgmma_wgrad_splits(O, K, wgrad_boxes(B, Ho, Wo), sms)
        ws = _workspace(splits, O * K, x.device)
        kernels.launch(route, *args, kernels.ptr(ws), *shape,
                       *wgrad_box(B, Ho, Wo), f32, splits, sms)
    elif route == "conv_wgrad_wgmma_i8":
        splits = narrow_wgrad_splits(O, wgrad_boxes(B, Ho, Wo), sms)
        ws = _workspace(splits, O * _WGN_COLS, x.device)
        # x padded to 8 channels in the launch (zero123's 8 read as given)
        xp = x if I == _NARROW_I else torch.empty(
            B, H, W, _NARROW_I, device=x.device, dtype=x.dtype)
        kernels.launch(route, kernels.ptr(x), kernels.ptr(xp),
                       kernels.ptr(dy), kernels.ptr(dw), kernels.ptr(ws), B,
                       H, W, I, Ho, Wo, O, kh, kw, pt, pl,
                       *wgrad_box(B, Ho, Wo), f32, splits)
    elif route == "conv_wgrad_fp32_tiled":
        bn, splits = fp32_wgrad_tiling(O, K, B * Ho * Wo, sms)
        ws = _workspace(splits, O * K, x.device)
        kernels.launch(route, *args, kernels.ptr(ws), *shape, bn, splits)
    else:
        splits = wgrad_splits(O, K, B * Ho * Wo, sms)
        ws = _workspace(splits, O * K, x.device)
        kernels.launch(route, *args, kernels.ptr(ws), *shape, f32, splits)
    return dw


class _Conv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, stride, pads, out_dtype):
        # x only where the weight wants a gradient: the frozen towers'
        # backwards keep none
        ctx.save_for_backward(w, x if ctx.needs_input_grad[1] else None)
        ctx.cfg = (tuple(x.shape), x.dtype, stride, pads,
                   None if bias is None else bias.dtype)
        if x.is_cuda:
            return conv2d_fwd_cuda(x, w, bias, stride, pads, out_dtype)
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return conv2d_plain(x, w, bias, stride, pads, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        x_shape, x_dtype, stride, pads, bias_dtype = ctx.cfg
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            if dy.is_cuda:
                dx = conv2d_dgrad_cuda(dy, w, x_shape, stride, pads, x_dtype)
            else:
                dx = conv2d_dgrad_plain(dy.float(), w, x_shape, stride, pads,
                                        x_dtype)
        if need_w:
            if dy.is_cuda:
                dw = conv2d_wgrad_cuda(x, dy, w.shape, stride, pads, w.dtype)
            else:
                dw = conv2d_wgrad_plain(x, dy.to(x.dtype), w.shape, stride,
                                        pads).to(w.dtype)
        if need_b:
            # JAX adds the bias outside mm_conv: its gradient is Σ dy
            db = dy.sum(dim=(0, 1, 2), dtype=torch.float32).to(bias_dtype)
        return dx, dw, db, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Union[int, Sequence] = 0,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC conv; w [O, kh, kw, I]; output in ``out_dtype`` (default x's)."""
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    return _Conv2d.apply(x, w, bias, st, norm_padding(padding),
                         out_dtype or x.dtype)
