// K12: NHWC 2-D convolution, forward, input gradient (dgrad) and weight
// gradient (wgrad).
//
// Replaces dreamfusion_tpu/ops/conv.py::mm_conv (:58; shifted einsums on the
// TPU with a custom_vjp that transposes each einsum, :95), as MMConv calls
// it in every tower: among them the conv_ins and the stride-2 downsamplers
// of dreamfusion_tpu/models/unet.py (:324, :340) and models/vae.py (:89,
// :96-98, after the (0, 1) jnp.pad).  Here the
// convolution is an implicit GEMM: M = B*Ho*Wo output pixels, N = O output
// channels, K = kh*kw*I (tap, input channel); no im2col buffer exists.
//
// Bound on the card: operations at the UNet and VAE shapes (512x512x128 ->
// 128 at 3x3 is 77 GFLOP over 134 MB of traffic), bytes for the narrow
// fp32 conv_outs and the VAE's conv_in (a 64 MB output from 3 channels).
// Five forward routes, picked by shape alone (ops/conv.py::conv_route):
//
// wgmma (conv_fwd_wgmma; bf16, stride 1 or 2, I % 64 == 0: every 3x3 and
// 1x1 conv of the UNet's and the VAE's levels, and their downsamplers).
// Hopper's own machinery, since mma.sync reached only ~15% of the tensor
// cores' peak:
//  - a block owns 128 output pixels x BN output channels (BN 128, or 64
//    where 128-wide tiles would fill under half the SMs: the UNet's
//    downsamplers).  The pixels are a box of the output grid, bw x bh x bb
//    (x, y, batch; 128 x 1 at W = 512, 64 x 2 at 64², 8 x 8 x 2 at 8² and
//    B = 2), so one tap's A tile is one rectangle of the input;
//  - the K loop walks taps x I/64: one K block is 64 input channels, one
//    128-byte swizzled row.  A producer thread issues two TMA copies per
//    block: the A tile from a 4-D map over x [B, H, W, C] at (c0, x0*sw +
//    s - pl, y0*sh + r - pt, b0), whose out-of-bounds zero fill (negative
//    coordinates and past the end: the VAE's (0, 1) pad) is the padding;
//    the B tile from a 2-D map over w [O, kh*kw*I].  At stride 2 the map's
//    traversal strides (elementStrides 2 along W and H, a box of 2bw x 2bh)
//    load every other pixel, bw x bh of them: a strided tap is still one
//    copy, and the kernel is the stride-1 one.  A ring of 5 (BN 64: 8)
//    stages with full/empty mbarriers keeps the K blocks in flight;
//  - persistent blocks, one per SM, walk the tiles; their two consumer
//    warpgroups (setmaxnreg moves the producer's registers to them) take
//    the tiles in turns ("pingpong"), each running wgmma m64nBNk16 on all
//    128 pixels of its tile, so that one warpgroup's epilogue runs under
//    the other's products;
//  - epilogue: + bias in fp32, one rounding into a swizzled bf16 staging
//    tile, then TMA stores through a map over y, which clip the ragged
//    pixels and channels (fp32 output, split-K partials or O % 8 != 0:
//    stores straight from the registers, masked);
//  - split-K (the UNet's deep levels: 8x8x1280 at CFG batch 2 is 10 output
//    tiles for 132 SMs): fp32 partials, summed in split order by
//    conv_splitk_reduce (deterministic; no atomics).  Stride 1 splits for
//    two blocks per SM; stride 2 for one: the strided convs are bound by
//    their tiles' traffic out of L2, which a split does not cut.
//
// Narrow-input wgmma (conv_fwd_wgmma_i8; bf16, stride 1, I <= 8, at most
// 10 taps: the VAE's 3-channel and the UNet's 4-channel conv_in).  One tap
// of 8 channels is one 16-byte core-matrix column, and a wgmma k16 step
// takes two taps (K = 9 taps x 8 rounded to 80, the tenth chunk zero), from
// tiles without swizzle.  A first design loaded each tap's [128 pixels][8]
// box by TMA: ~2,400 box rows of 16 bytes per tile, 4.7x the VAE conv_in's
// byte bound.  So x is first copied by pad_channels8_kernel (in the same
// launch) to [B, Ho+kh-1, Wo+kw-1, 8], zero-padded in channels and space:
// then a tap's A rows for one row of the pixel box are contiguous, one 1-D
// bulk copy (bh x bb of them per tap), and the borders need no fill.  The
// weight is packed once per weight as [O/BN][10][BN][8] (ops/conv.py
// caches it by the weight's version): an N tile's B is one bulk copy.  A
// tile's whole K is one stage; the epilogue is the wgmma route's, TMA
// stores at full width (the VAE's 64 MB output).
//
// mma.sync (conv_fwd_mma; the bf16 rest: 8 < I, I % 64 != 0 or a stride
// above 2 -- no conv of the SD step: the ViT patch embeddings -- and
// conv_dgrad, the dgrads no route below takes): 128x128x32 tiles in shared
// memory, filled by 16-byte cp.async
// copies (zero-filled outside the image and past K) in a two-stage ring,
// fragments by ldmatrix, products by mma.sync m16n8k16 bf16 with fp32
// accumulation.  The weights are [O, kh, kw, I] (I contiguous), so a B tile
// row is one output channel's contiguous K slice; the path needs I % 8 == 0
// (the wrapper pads narrower inputs with zero channels).  The dgrads it
// cannot take (fp32; bf16 with O % 8 != 0) run one thread per value.
//
// fp32 tiled (conv_fwd_fp32_tiled; every fp32 conv but the narrow route's
// O <= 8 with I % 4 == 0, any stride: the 40
// convs of the DPT that preprocess_image runs, 123 GFLOP at 384², from the
// 3-channel 7x7 stem to 768 channels).  Bound by operations (the fp32 CUDA
// cores: 67 TFLOP/s; TF32 would keep ~3 digits, another function).  The
// one-thread-per-output loop it replaces ran ~0.5 TFLOP/s: no reuse of an
// operand, each thread streaming its own weight row at a stride of K.
// Here a classic register-blocked SIMT GEMM:
//  - a block owns 128 output pixels (a linear run of (b, oy, ox): the A
//    rows are gathered per pixel, so no box is needed) x BN output
//    channels, BN 64, or 32 where O fits in it; 2*BN threads, each an 8 x 8
//    block of outputs (pixels ty + 16 i, channels tx + BN/8 j), so a
//    float4 read of A and one of B feed 64 FMAs x 4.  168 registers a
//    thread: three blocks an SM at BN 64 (BN 128 took 206-252 and one
//    block an SM, and lost to 64 at every DPT shape);
//  - K (tap, channel) in steps of 16 through a 3-stage ring of cp.async
//    copies: A by implicit im2col (a table of the tile's pixels in shared
//    memory; zero fill outside the image, past K and past M), B one output
//    channel's contiguous K slice; 16 bytes a copy where I % 4 == 0 (4
//    channels of one tap), 4 bytes otherwise (the stem's I = 3).  Both
//    tiles are stored K-contiguous at a padded stride of 20 floats: the
//    inner loop's float4 reads are broadcasts (A) or 8 consecutive rows
//    over distinct banks (B).  One __syncthreads a K step;
//  - split-K where the tiles alone leave SMs idle (the 12² and 24² convs:
//    8-20 tiles) or leave the busiest SM a ragged last wave: the split of
//    fewest waves x K steps a wave, 8 K steps a split at least
//    (ops/conv.py::fp32_tiling);
//    fp32 partials summed in split order by conv_splitk_reduce
//    (deterministic);
//  - epilogue: + bias in fp32, fp32 stores.
//
// fp32 narrow (conv_fwd_fp32; fp32, O <= 8, I % 4 == 0: the UNet's and
// the VAE encoder's conv_out, the quant convs): a few hundred MFLOP over a
// few MB, bound by bytes and latency.  One warp per output pixel computes
// all O outputs: lanes stride the K = kh*kw*I reduction with 16-byte
// loads, fp32 FMAs, then a warp-shuffle sum per output.
//
// dgrad.  dx[b, y, x, c] = sum_{r, s, o} dy[b, oh, ow, o] * w[o, r, s, c] with
// y = oh*sh - pt + r.  For stride s > 1 only the taps with
// r = (y + pt) mod sh contribute to a given y, so the dx pixels split into
// sh*sw parity classes; in each class the pixel (i, j) at y = py + sh*i
// reads dy at oh = i + (py + pt - r0)/sh - t for tap r = r0 + sh*t.  Each
// class is then a stride-1 conv of dy with its sub-kernel, flipped (tap
// t' = nt-1-t) and transposed: a forward conv with source offset nt - 1 -
// (py + pt - r0)/sh, written to dx[:, py::sh, px::sw].  This scatters a
// strided (and asymmetrically padded) convolution exactly without
// multiplying by the zeros of a dilated dy; at stride 1 it is the one
// class, padding k - 1 - p.  Bottom and right padding only shape dy.
// Routes (ops/conv.py::dgrad_route):
//  - conv_dgrad_wgmma (bf16, O % 64 == 0, stride 1 or 2: every level and
//    downsampler of the VAE encoder): the wgmma kernel above, instantiated
//    with DGRAD so that a tile's class picks its taps, source offset, weight
//    rows and store map.  The weight comes packed once per weight as
//    [classes*I, taps*O] (ops/conv.py::pack_dgrad_weight, cached by the
//    weight's version): B tiles by TMA as the forward's.  A's map is dy's;
//    the stores go through one map per class over dx's strided view (base
//    (py*W + px)*I, strides sh*W*I and sw*I: any 16-byte multiples do), so
//    the ragged class grids clip there; all classes walk in one launch.
//  - conv_dgrad_narrow (bf16, stride 1, I <= 8: the VAE conv_in's 3-channel
//    dx, byte-bound): mma.sync with A fragments loaded straight from dy (see
//    its kernel); a wgmma tile would waste 125 of its 128 columns.
//  - conv_dgrad_fp32 (fp32, O <= 8: the conv_outs' dx): CUDA cores, fp32
//    FMAs, a thread per 4 channels x 8 pixels.
//  - conv_dgrad_fp32_tiled (every other fp32 dgrad: the DPT's 40, its
//    3-channel stem's dx included): the tiled fp32 forward's design below
//    (conv_dgrad_fp32_tiled_kernel).  Bound by operations, as the forward (the
//    DPT's 40: 123.19 GFLOP, 1.84 ms at 67 TFLOP/s).  A tile is 128 pixels
//    of one class's grid x 32 or 64 channels of dx; the A operand gathers
//    dy at the class's taps (a stride-1 conv of dy with its flipped
//    sub-kernel), B reads the class's rows of the packed weight (as the
//    wgmma dgrad's, cached); all classes and splits walk in one launch
//    (grid z = class x split), and a class without taps (three of the 1x1
//    stride-2 downsample's four) writes its zeros, so the split partials
//    cover dx and the split-K reduce sums them in order.
//  - conv_dgrad (bf16 only): mma.sync as above over the classes (grid z),
//    the weight transposed to [I, kh, kw, O] per call; one thread a value
//    where O % 8 != 0.
//
// wgrad (f_bwd's dk, :112-114: the transpose of the shifted einsums in the
// kernel).  dW[o, r, s, c] = sum_{b, oh, ow} dy[b, oh, ow, o] *
// x[b, oh*sh - pt + r, ow*sw - pl + s, c]: one GEMM per tap, [O x P] x
// [P x I] with P = B*Ho*Wo pixels, all taps in one N = kh*kw*I.  Its
// reduction is the pixels (8,192 at the UNet's 64² level at CFG batch 2,
// 262,144 at the VAE's 512²) and its output small (128 x 1,152 at the
// VAE's level 0: 9 tiles of 128 x 128), so split-K over the pixels is the
// design: each split writes its fp32 partial dW to a workspace and
// conv_wgrad_reduce sums them in split order (deterministic, no atomics)
// into dW's dtype; a launch of one split writes dW directly.  Bound by
// operations at the path's shapes (the forward's FLOPs: 77 GFLOP at the
// VAE's 512² level, 123 GFLOP over the DPT's 40 fp32 convs), by bytes at
// the conv_outs (O = 4 and 8).  Four routes (ops/conv.py::wgrad_route):
//  - conv_wgrad_wgmma (bf16, I % 64 == 0, O % 8 == 0, stride 1 or 2: every
//    UNet and VAE conv but the conv_ins).  The forward's machinery with the
//    roles turned: a block owns 128 output channels (M; two consumer
//    warpgroups of 64 rows) x 128 columns (N) of dW and walks its split's
//    pixels in boxes of 64 of the output grid (64 x 1 on wide rows, 8 x 8
//    at 8², across the batch where the grid is smaller;
//    ops/conv.py::wgrad_box), so that both operands of a step cover the
//    same pixels in the same order.  A producer thread issues per box one
//    TMA copy of dy from a 4-D map over [B, Ho, Wo, O] per 64 channels
//    (A = dyᵀ) and one of x per 64-column box from the forward's map over
//    x, at that box's tap (x0*sw + s - pl, y0*sh + r - pt; stride 2 by the
//    map's traversal strides, the padding and the ragged box by its zero
//    fill; I % 64 == 0 keeps a box in one tap).  Both tiles are
//    [64 pixels][64] channel-contiguous 128-byte-swizzled rows: MN-major A
//    and B, as K10's dV = Pᵀ·dO (wgmma_m64n128k16_ss_t<1, 1>).  A ring of
//    6 stages with full/empty mbarriers; persistent blocks, one an SM,
//    whose producer runs ahead into the next tile while the consumers
//    store the last (a bf16 dW through a swizzled staging tile and TMA
//    stores, fp32 partials from the registers); splits over the boxes by a
//    cost model of tiles a block, steps and the partials' traffic
//    (wgmma_wgrad_splits).
//  - conv_wgrad_wgmma_i8 (bf16, I <= 8, O % 8 == 0, stride 1, at most 9
//    taps: the conv_ins' 3, 4 and 8 channels).  Bound by reading dy once
//    (the VAE's [1, 512², 3 -> 128]: 67 MB, 0.0205 ms): N = kh*kw*I is
//    only 27 or 36 columns, so on the 128 x 128 tiles of conv_wgrad_mma
//    72-79% of every product was padding and x came by element loads (15x
//    the bound).  Here x is padded to 8 channels first (pad_channels8_kernel,
//    in the launch; zero123's 8 channels are read as they are), so one
//    tap's channels are one 16-byte core-matrix row, and N = 9 taps x 8 =
//    72 columns of one wgmma m64n72k16.  A = dyᵀ by TMA as conv_wgrad_wgmma's
//    ([64 pixels][64 o] boxes, MN-major, 128-byte swizzle); B = x at the
//    nine tap offsets, nine 1 KB boxes [64 pixels][8] a step from a map
//    over the padded x without swizzle (MN-major core matrices 128 bytes
//    apart along the pixels, 1 KB along the taps), whose zero fill is the
//    padding and the ragged box.  A block owns 128 o (two consumer
//    warpgroups of 64) and walks its split's boxes through an 8-stage ring
//    (25 KB a stage: enough bytes in flight to stream dy at the card's
//    rate); the splits (narrow_wgrad_splits: one wave of blocks, at least
//    4 boxes each) write fp32 partials [O][72], which
//    conv_wgrad_i8_reduce_kernel sums in split order (no atomics) into dW
//    [O, kh, kw, I], the padded channels dropped; one split writes dW.
//  - conv_wgrad_mma (the bf16 rest: the towers' test widths, off-path
//    shapes): mma.sync m16n8k16 on 128 x 128 tiles of dW, dy and the
//    tap-shifted x by 16-byte cp.async into [32 pixels][128] tiles (two
//    stages), both read by ldmatrix.trans; the padding is the copies' zero
//    fill; x by element loads where I % 8 != 0.  Splits for two blocks an
//    SM, at least 16 steps of 32 pixels each (wgrad_splits).
//  - conv_wgrad_fp32_tiled (every fp32 wgrad: the DPT's 40, the conv_outs):
//    the tiled fp32 forward's design (ft_gemm) with the gather moved from
//    the output side to the reduction: M = the kh*kw*I columns of dW, N =
//    O, the reduction the pixels in steps of 16.  Per step, dy's rows
//    [16 pixels][BN channels] and x at each column's tap offset [16][BM]
//    (zero outside the image) by cp.async, 16 bytes where I and O are
//    multiples of 4, in a 3-stage ring; both tiles pixel-major, so each
//    thread's 8 columns x 8 channels are two float4 reads of each.  The N
//    tile follows O: 64 (BM 128, 128 threads), 32 (BM 128, 64 threads) or 8
//    for the conv_outs (BM 512, 64 threads); splits by fp32_wgrad_tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using dft::cp_async16;
using bf16 = __nv_bfloat16;

struct ConvParams {
  const void* x;      // source activations [B, SH, SW, C]
  const void* w;      // [N, KH, KW, C]
  const float* bias;  // [N] or null
  void* y;            // [B, OH, OW, N]
  int B, SH, SW, C;   // source grid: input (fwd) or dy (dgrad)
  int OH, OW, N;      // written grid: output (fwd) or dx (dgrad)
  int KH, KW, sh, sw, pt, pl;
  int out_f32;
  int splits;         // split-K factor of the tensor-core path
  float* ws;          // [splits, B*OH*OW*N] fp32 partial sums when splits > 1
};

// The tap set and pixel grid of one dgrad parity class (or the whole forward
// problem).  Source row of row-grid pixel (cy, cx) at tap (t, u):
//   fwd:   (cy*sh - pt + t, cx*sw - pl + u), weight tap (t, u)
//   dgrad: (cy + oy - t,    cx + ox - u),    weight tap (r0 + sh*t, s0 + sw*u)
// and it writes the output pixel (py + sh*cy, px + sw*cx) (fwd: py = px = 0
// and sh = sw = 1 for the written grid).
struct ConvClass {
  int nt, nu;      // taps along y and x
  int r0, s0;      // first weight tap
  int rstep, sstep;
  int Hc, Wc;      // row-grid size
  int py, px;      // output offset (dgrad)
  int ystep, xstep;
  int oy, ox;      // dgrad source offset
};

template <bool DGRAD>
__device__ __forceinline__ ConvClass conv_class(const ConvParams& p, int cls) {
  ConvClass c;
  if (!DGRAD) {
    c.nt = p.KH; c.nu = p.KW; c.r0 = 0; c.s0 = 0; c.rstep = 1; c.sstep = 1;
    c.Hc = p.OH; c.Wc = p.OW; c.py = 0; c.px = 0; c.ystep = 1; c.xstep = 1;
    c.oy = 0; c.ox = 0;
    return c;
  }
  c.py = cls / p.sw;
  c.px = cls % p.sw;
  c.r0 = (c.py + p.pt) % p.sh;
  c.s0 = (c.px + p.pl) % p.sw;
  c.nt = c.r0 < p.KH ? (p.KH - c.r0 + p.sh - 1) / p.sh : 0;
  c.nu = c.s0 < p.KW ? (p.KW - c.s0 + p.sw - 1) / p.sw : 0;
  c.rstep = p.sh;
  c.sstep = p.sw;
  c.Hc = p.OH > c.py ? (p.OH - c.py + p.sh - 1) / p.sh : 0;
  c.Wc = p.OW > c.px ? (p.OW - c.px + p.sw - 1) / p.sw : 0;
  c.ystep = p.sh;
  c.xstep = p.sw;
  c.oy = (c.py + p.pt - c.r0) / p.sh;
  c.ox = (c.px + p.pl - c.s0) / p.sw;
  return c;
}

// source coordinates of row-grid pixel (cy, cx) at tap (t, u)
template <bool DGRAD>
__device__ __forceinline__ void conv_src(const ConvParams& p,
                                         const ConvClass& c, int cy, int cx,
                                         int t, int u, int& sy, int& sx) {
  if (DGRAD) {
    sy = cy + c.oy - t;
    sx = cx + c.ox - u;
  } else {
    sy = cy * p.sh - p.pt + t;
    sx = cx * p.sw - p.pl + u;
  }
}

// ---------------------------------------------------------------------------
// tensor-core implicit GEMM (bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8, kThreads = 256;

template <bool DGRAD>
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(ConvParams p) {
  __shared__ __align__(16) bf16 sA[2][BM * LDS];
  __shared__ __align__(16) bf16 sB[2][BN * LDS];

  const int split = blockIdx.z % p.splits;
  const ConvClass cc = conv_class<DGRAD>(p, blockIdx.z / p.splits);
  const int M = p.B * cc.Hc * cc.Wc;
  const int m_base = blockIdx.x * BM;
  const int n_base = blockIdx.y * BN;
  if (m_base >= M) return;
  const int ntaps = cc.nt * cc.nu;
  const int Ktot = ntaps * p.C;
  const int KT_all = (Ktot + BK - 1) / BK;
  const int kt0 = (int)((int64_t)KT_all * split / p.splits);
  const int KT = (int)((int64_t)KT_all * (split + 1) / p.splits) - kt0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* __restrict__ X = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ Wt = static_cast<const bf16*>(p.w);
  const int64_t wrow = (int64_t)p.KH * p.KW * p.C;

  // this thread's two A rows and two B rows, one 8-wide k vector each
  const int kv = (tid % 4) * 8;
  int a_b[2], a_cy[2], a_cx[2];
  bool a_ok[2];
  const bf16* b_ptr[2];
  bool b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = tid / 4 + 64 * i;
    const int m = m_base + row;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_cx[i] = mm % cc.Wc;
    a_cy[i] = (mm / cc.Wc) % cc.Hc;
    a_b[i] = mm / (cc.Wc * cc.Hc);
    const int n = n_base + row;
    b_ok[i] = n < p.N;
    b_ptr[i] = Wt + (int64_t)(b_ok[i] ? n : 0) * wrow;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k = (kt0 + kt) * BK + kv;
    const bool k_ok = k < Ktot;
    const int tap = k_ok ? k / p.C : 0;
    const int ch = k_ok ? k - tap * p.C : 0;
    const int t = tap / cc.nu, u = tap - (tap / cc.nu) * cc.nu;
    const int r = cc.r0 + cc.rstep * t, s = cc.s0 + cc.sstep * u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tid / 4 + 64 * i;
      int sy, sx;
      conv_src<DGRAD>(p, cc, a_cy[i], a_cx[i], t, u, sy, sx);
      const bool ok = a_ok[i] && k_ok && sy >= 0 && sy < p.SH && sx >= 0 &&
                      sx < p.SW;
      const bf16* src =
          ok ? X + (((int64_t)a_b[i] * p.SH + sy) * p.SW + sx) * p.C + ch : X;
      cp_async16(&sA[stage][row * LDS + kv], src, ok);
      const bool okb = b_ok[i] && k_ok;
      const bf16* wsrc =
          okb ? b_ptr[i] + (int64_t)(r * p.KW + s) * p.C + ch : Wt;
      cp_async16(&sB[stage][row * LDS + kv], wsrc, okb);
    }
  };

  const int wm = warp / 4, wn = warp % 4;   // 2 x 4 warps, 64 x 32 each
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (KT > 0) load_stage(0, 0);
  dft::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, kt + 1);
    dft::cp_async_commit();
    dft::cp_async_wait<1>();
    __syncthreads();
    const bf16* tA = sA[kt & 1];
    const bf16* tB = sB[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        dft::load_a_frag(af[mi], tA + (wm * 64 + mi * 16) * LDS + ks * 16,
                         LDS, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        dft::load_b_frag_nk(bfr[nj], tB + (wn * 32 + nj * 16) * LDS + ks * 16,
                            LDS, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          dft::mma_bf16(acc[mi][ni], af[mi], &bfr[ni / 2][(ni % 2) * 2]);
    }
    __syncthreads();
  }

  // epilogue: + bias, write bf16 or fp32
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      const int cx = m % cc.Wc, cy = (m / cc.Wc) % cc.Hc,
                b = m / (cc.Wc * cc.Hc);
      const int oy = cc.py + cc.ystep * cy, ox = cc.px + cc.xstep * cx;
      const int64_t obase = (((int64_t)b * p.OH + oy) * p.OW + ox) * p.N;
      float* part = p.splits > 1
          ? p.ws + (int64_t)split * p.B * p.OH * p.OW * p.N + obase : nullptr;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n_base + wn * 32 + ni * 8 + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= p.N) continue;
          float v = acc[mi][ni][2 * h + e];
          if (part) {
            part[n + e] = v;
            continue;
          }
          if (p.bias) v += p.bias[n + e];
          if (p.out_f32)
            static_cast<float*>(p.y)[obase + n + e] = v;
          else
            static_cast<bf16*>(p.y)[obase + n + e] = __float2bfloat16(v);
        }
      }
    }
  }
}

// y = sum over splits of the partials + bias, in split order
__global__ void conv_splitk_reduce(ConvParams p) {
  const int64_t total = (int64_t)p.B * p.OH * p.OW * p.N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < p.splits; ++s) v += p.ws[s * total + idx];
  if (p.bias) v += p.bias[idx % p.N];
  if (p.out_f32)
    static_cast<float*>(p.y)[idx] = v;
  else
    static_cast<bf16*>(p.y)[idx] = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// CUDA-core path of the bf16 dgrads mma.sync cannot take (O % 8 != 0): one
// thread per value
// ---------------------------------------------------------------------------

template <bool DGRAD>
__global__ void conv_simple_kernel(ConvParams p) {
  const ConvClass cc = conv_class<DGRAD>(p, blockIdx.y);
  const int64_t total = (int64_t)p.B * cc.Hc * cc.Wc * p.N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % p.N;
  const int64_t m = idx / p.N;
  const int cx = m % cc.Wc, cy = (m / cc.Wc) % cc.Hc,
            b = m / ((int64_t)cc.Wc * cc.Hc);
  const bf16* __restrict__ X = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ Wt =
      static_cast<const bf16*>(p.w) + (int64_t)n * p.KH * p.KW * p.C;
  float acc = 0.f;
  for (int t = 0; t < cc.nt; ++t) {
    for (int u = 0; u < cc.nu; ++u) {
      int sy, sx;
      conv_src<DGRAD>(p, cc, cy, cx, t, u, sy, sx);
      if (sy < 0 || sy >= p.SH || sx < 0 || sx >= p.SW) continue;
      const int r = cc.r0 + cc.rstep * t, s = cc.s0 + cc.sstep * u;
      const bf16* xp = X + (((int64_t)b * p.SH + sy) * p.SW + sx) * p.C;
      const bf16* wp = Wt + (int64_t)(r * p.KW + s) * p.C;
      for (int c = 0; c < p.C; ++c)
        acc = fmaf(dft::to_f32(xp[c]), dft::to_f32(wp[c]), acc);
    }
  }
  if (p.bias) acc += p.bias[n];
  const int oy = cc.py + cc.ystep * cy, ox = cc.px + cc.xstep * cx;
  const int64_t o = (((int64_t)b * p.OH + oy) * p.OW + ox) * p.N + n;
  if (p.out_f32)
    static_cast<float*>(p.y)[o] = acc;
  else
    static_cast<bf16*>(p.y)[o] = __float2bfloat16(acc);
}

// ---------------------------------------------------------------------------
// fp32 tiled implicit GEMM on the CUDA cores (conv_fwd_fp32_tiled, and its
// input gradient conv_dgrad_fp32_tiled)
// ---------------------------------------------------------------------------

namespace ft {
constexpr int BM = 128, BK = 16, LDK = BK + 4, STAGES = 3;
constexpr int kFarRow = -(1 << 29);   // a pixel past M: every tap misses
// A block of 2*BN threads (BN 64 or 32) is a 16 x BN/8 grid, each thread
// 8 pixels x 8 channels: pixels ty + 16 i, channels tx + (BN/8) j.  A warp
// spans the BN/8 threads along N, so that one float4 read of B covers
// BN/8 consecutive rows (conflict-free at the padded stride LDK) and one
// of A at most 32/(BN/8) rows.
template <int BN>
struct Cfg {
  static_assert(BN == 32 || BN == 64, "a warp spans the N tile");
  static constexpr int kThreads = 2 * BN;
  static constexpr int TX = BN / 8;
  static constexpr size_t kSmem =
      (size_t)STAGES * (BM + BN) * LDK * sizeof(float) +
      BM * (sizeof(int64_t) + 2 * sizeof(int));
};
}  // namespace ft

template <bool VEC>
__device__ __forceinline__ void ft_copy(float* dst, const float* src,
                                        bool ok) {
  if (VEC)
    dft::cp_async16(dst, src, ok);
  else
    dft::cp_async4(dst, src, ok);
}

// The implicit GEMM both tiled kernels run: acc[i][j] = sum_k A[m, k] B[n, k]
// over the tile's pixels m = m0 + ty + 16 i of a GH x GW grid on each of the
// p.B images and channels n = n0 + tx + TX j, for the K steps of split
// `split` of p.splits; k = (tap, channel) over KW-wide rows of taps and the
// p.C channels of X (p.x [B, SH, SW, C]), K = taps * C.  A gathers X at
// pixel (oy * ys - y0 + r, ox * xs - x0 + s) for tap (r, s) (zeros outside
// the image, past K or past M); B reads rows n0.. of Wt, ldw floats apart
// (zeros past p.N).  VEC: C % 4 == 0, each copy 4 channels of one tap.
// Sets tx, ty (the thread's place in the tile) first: computed by the
// caller instead, the forward's 32-channel tile ran 7% slower on an H100.
template <int BN, bool VEC>
__device__ __forceinline__ void ft_gemm(const ConvParams& p,
                                        const float* __restrict__ Wt, int ldw,
                                        int GH, int GW, int ys, int y0, int xs,
                                        int x0, int KW, int K, int m0, int n0,
                                        int split, int& tx, int& ty,
                                        float (&acc)[8][8]) {
  using Cf = ft::Cfg<BN>;
  constexpr int TBM = ft::BM, TBK = ft::BK, LDK = ft::LDK,
                STAGES = ft::STAGES;
  constexpr int T = Cf::kThreads;
  extern __shared__ __align__(16) unsigned char ft_smem[];
  float* As = reinterpret_cast<float*>(ft_smem);   // [STAGES][TBM][LDK]
  float* Bs = As + STAGES * TBM * LDK;              // [STAGES][BN][LDK]
  int64_t* pix_img = reinterpret_cast<int64_t*>(Bs + STAGES * BN * LDK);
  int* pix_y = reinterpret_cast<int*>(pix_img + TBM);
  int* pix_x = pix_y + TBM;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  tx = lane % Cf::TX;
  ty = warp * (32 / Cf::TX) + lane / Cf::TX;
  const int M = p.B * GH * GW;
  const int KT_all = (K + TBK - 1) / TBK;
  const int kt0 = (int)((int64_t)KT_all * split / p.splits);
  const int KT = (int)((int64_t)KT_all * (split + 1) / p.splits) - kt0;
  const float* __restrict__ X = static_cast<const float*>(p.x);

  // the tile's pixels: their image's offset and tap (0, 0)'s source pixel
  for (int r = tid; r < TBM; r += T) {
    const int m = m0 + r;
    const bool in = m < M;
    const int mm = in ? m : 0;
    const int ox = mm % GW, oy = (mm / GW) % GH, b = mm / (GW * GH);
    pix_img[r] = (int64_t)b * p.SH * p.SW * p.C;
    pix_y[r] = in ? oy * ys - y0 : ft::kFarRow;
    pix_x[r] = ox * xs - x0;
  }
  __syncthreads();

  // each thread copies one fixed k column of the tile (VEC: 4 floats) for
  // rows row0 + i * ROWS; outside the image, past K and past O: zeros
  constexpr int CW = VEC ? 4 : 1;
  constexpr int CPR = TBK / CW;                 // copies per tile row
  constexpr int ROWS = T / CPR;
  constexpr int A_COPIES = TBM / ROWS, B_COPIES = BN / ROWS;
  const int kc = (tid % CPR) * CW, row0 = tid / CPR;
  auto load_stage = [&](int slot, int kt) {
    const int k = (kt0 + kt) * TBK + kc;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / p.C : 0;
    const int c = k - tap * p.C;
    const int r = tap / KW, s = tap - r * KW;
    float* as = As + slot * TBM * LDK;
    float* bs = Bs + slot * BN * LDK;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int row = row0 + i * ROWS;
      const int iy = pix_y[row] + r, ix = pix_x[row] + s;
      const bool ok = k_ok && (unsigned)iy < (unsigned)p.SH &&
                      (unsigned)ix < (unsigned)p.SW;
      const float* src =
          ok ? X + pix_img[row] + ((int64_t)iy * p.SW + ix) * p.C + c : X;
      ft_copy<VEC>(as + row * LDK + kc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int row = row0 + i * ROWS;
      const bool ok = k_ok && n0 + row < p.N;
      const float* src = ok ? Wt + (int64_t)(n0 + row) * ldw + k : Wt;
      ft_copy<VEC>(bs + row * LDK + kc, src, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    dft::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // K step kt has landed, and every thread is done with step kt - 1,
    // whose slot the next copy refills
    dft::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    dft::cp_async_commit();
    const float* at = As + (kt % STAGES) * TBM * LDK + ty * LDK;
    const float* bt = Bs + (kt % STAGES) * BN * LDK + tx * LDK;
#pragma unroll
    for (int kq = 0; kq < TBK; kq += 4) {
      float a[8][4], b[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(at + i * 16 * LDK + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(bt + j * Cf::TX * LDK + kq);
        b[j][0] = v.x; b[j][1] = v.y; b[j][2] = v.z; b[j][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
  }
}

// y[m, n] = sum_k A[m, k] w[n, k] + bias[n] over pixels m = (b, oy, ox) and
// k = (tap, channel), for the K steps of split blockIdx.z (partials to ws
// when p.splits > 1).  VEC: I % 4 == 0, each copy 4 channels of one tap.
template <int BN, bool VEC>
__global__ void __launch_bounds__(ft::Cfg<BN>::kThreads)
    conv_fp32_tiled_kernel(ConvParams p) {
  using Cf = ft::Cfg<BN>;
  int tx, ty;
  const int M = p.B * p.OH * p.OW;
  const int K = p.KH * p.KW * p.C;
  const int m0 = blockIdx.x * ft::BM, n0 = blockIdx.y * BN,
            split = blockIdx.z;
  float acc[8][8];
  ft_gemm<BN, VEC>(p, static_cast<const float*>(p.w), K, p.OH, p.OW, p.sh,
                   p.pt, p.sw, p.pl, p.KW, K, m0, n0, split, tx, ty, acc);

  // epilogue: + bias in fp32, or this split's partial sums
  float* part =
      p.splits > 1 ? p.ws + (int64_t)split * M * p.N : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + i * 16 + ty;
    if (m >= M) continue;
    const int64_t row = (int64_t)m * p.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j * Cf::TX + tx;
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (part) {
        part[row + n] = v;
        continue;
      }
      if (p.bias) v += p.bias[n];
      if (p.out_f32)
        static_cast<float*>(p.y)[row + n] = v;
      else
        static_cast<bf16*>(p.y)[row + n] = __float2bfloat16(v);
    }
  }
}

// The input gradient on the forward's tiles, ring and inner loop
// (conv_dgrad_fp32_tiled; ft_gemm above).  p as conv_dgrad's (x: dy [B, SH,
// SW, C], w: the packed weight [classes * N, ldw] of
// ops/conv.py::pack_dgrad_weight, y: dx [B, OH, OW, N]).  blockIdx.z is
// class * splits + split; a class is a stride-1 conv of dy with its flipped
// sub-kernel (nt x nu taps, K = nt nu C, its weight rows class * N ..) over
// its grid Hc x Wc, each pixel written to dx[:, py::sh, px::sw]; a class
// without taps writes zeros (its partials too).  VEC: C (and ldw) a
// multiple of 4, each copy 4 channels of one tap.
template <int BN, bool VEC>
__global__ void __launch_bounds__(ft::Cfg<BN>::kThreads)
    conv_dgrad_fp32_tiled_kernel(ConvParams p, int ldw) {
  using Cf = ft::Cfg<BN>;
  int tx, ty;
  const int split = blockIdx.z % p.splits;
  const ConvClass cls = conv_class<true>(p, blockIdx.z / p.splits);
  // this class's grid
  const int GH = cls.Hc, GW = cls.Wc;
  const int M = p.B * GH * GW;
  const int m0 = blockIdx.x * ft::BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;                     // a smaller class's ragged grid
  const float* Wt = static_cast<const float*>(p.w) +
                    (int64_t)(blockIdx.z / p.splits) * p.N * ldw;
  float acc[8][8];
  // tap (0, 0)'s source offset, as a stride-1 conv of dy with the flipped
  // sub-kernel
  ft_gemm<BN, VEC>(p, Wt, ldw, GH, GW, 1, cls.nt - 1 - cls.oy, 1,
                   cls.nu - 1 - cls.ox, cls.nu, cls.nt * cls.nu * p.C, m0, n0,
                   split, tx, ty, acc);

  // epilogue: dx, or this split's partial sums (over all of dx)
  float* part = p.splits > 1
                    ? p.ws + (int64_t)split * p.B * p.OH * p.OW * p.N
                    : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + i * 16 + ty;
    if (m >= M) continue;
    // the class's pixel → its place in dx
    const int cx = m % GW, cy = (m / GW) % GH, b = m / (GW * GH);
    const int64_t row = (((int64_t)b * p.OH + cls.py + p.sh * cy) * p.OW +
                         cls.px + p.sw * cx) * p.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j * Cf::TX + tx;
      if (n >= p.N) continue;
      (part ? part : static_cast<float*>(p.y))[row + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path for the narrow fp32 convs: one warp per output pixel
// ---------------------------------------------------------------------------

constexpr int kNarrowO = 8;

__global__ void __launch_bounds__(256) conv_narrow_kernel(ConvParams p) {
  const int64_t pix = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (int64_t)p.B * p.OH * p.OW) return;
  const int ox = pix % p.OW, oy = (pix / p.OW) % p.OH;
  const int b = pix / ((int64_t)p.OW * p.OH);
  const float* __restrict__ X = static_cast<const float*>(p.x);
  const float* __restrict__ Wt = static_cast<const float*>(p.w);
  const int64_t wrow = (int64_t)p.KH * p.KW * p.C;
  float acc[kNarrowO];
#pragma unroll
  for (int o = 0; o < kNarrowO; ++o) acc[o] = 0.f;
  for (int r = 0; r < p.KH; ++r) {
    const int sy = oy * p.sh - p.pt + r;
    if (sy < 0 || sy >= p.SH) continue;
    for (int t = 0; t < p.KW; ++t) {
      const int sx = ox * p.sw - p.pl + t;
      if (sx < 0 || sx >= p.SW) continue;
      const float* xp = X + (((int64_t)b * p.SH + sy) * p.SW + sx) * p.C;
      const float* wp = Wt + (int64_t)(r * p.KW + t) * p.C;
      for (int c = 4 * lane; c < p.C; c += 128) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + c);
#pragma unroll
        for (int o = 0; o < kNarrowO; ++o) {
          if (o >= p.N) break;
          const float4 wv =
              __ldg(reinterpret_cast<const float4*>(wp + o * wrow + c));
          acc[o] = fmaf(xv.x, wv.x, acc[o]);
          acc[o] = fmaf(xv.y, wv.y, acc[o]);
          acc[o] = fmaf(xv.z, wv.z, acc[o]);
          acc[o] = fmaf(xv.w, wv.w, acc[o]);
        }
      }
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int o = 0; o < kNarrowO; ++o) {
    float v = acc[o];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == o) mine = v;
  }
  if (lane >= p.N) return;
  if (p.bias) mine += p.bias[lane];
  const int64_t o = pix * p.N + lane;
  if (p.out_f32)
    static_cast<float*>(p.y)[o] = mine;
  else
    static_cast<bf16*>(p.y)[o] = __float2bfloat16(mine);
}

// ---------------------------------------------------------------------------
// CUDA-core dgrads: the 3-channel dx of the VAE's conv_in (bf16) and the
// fp32 conv_out's (see the dgrad note above)
// ---------------------------------------------------------------------------

constexpr int kDxNarrowI = 8;    // widest dx of conv_dgrad_narrow: one n8 tile
constexpr int kDxNarrowO = 256;  // widest dy
constexpr int kDxNarrowK = 3;    // largest kh, kw
constexpr int kDxNarrowWarps = 4;

// Tensor cores without shared memory: a warp takes 16 dx pixels along x,
// and per tap and 32 of dy's channels runs two mma.sync m16n8k16 whose A
// fragments (rows: the tap's 16 dy pixels) each lane loads from device
// memory itself, zero outside dy: 16 bytes of its row (8 channels) that
// fill its registers of both products, so that a row's 64 bytes are one
// load of 4 lanes.  The K order inside a product is free as long as A and
// B agree: lane q's slots (2q, 2q+1, 8+2q, 9+2q) take channels 32p + 8q
// + (0..3) in the first product and + (4..7) in the second.  The B
// fragments (those channels x the <= 8 dx channels of w's tap, zero past
// I) come packed per lane (ops/conv.py::pack_dgrad_narrow_weight,
// [kh*kw][O/32][32 lanes] x 16 bytes: one 16-byte load from L1, where the
// whole packed weight stays).  A load of a warp touches 8 dy pixels, 64
// bytes each, so every tap's pass over dy costs 8 L1 wavefronts per 512
// bytes.  dx[y, x] = sum_{r, s, o} dy[y + pt - r, x + pl - s, o]
// w[o, r, s, :].
__global__ void __launch_bounds__(kDxNarrowWarps * 32)
conv_dgrad_narrow_kernel(
    const bf16* __restrict__ dy, const uint4* __restrict__ bfrag, void* dx,
    int B, int H, int W, int I, int Ho, int Wo, int O, int kh, int kw,
    int pt, int pl, int out_f32) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int ps = O / 32;
  const int xt = (W + 15) / 16;
  const int64_t tasks = (int64_t)B * H * xt;
  const int64_t nwarps = (int64_t)gridDim.x * kDxNarrowWarps;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t task = (int64_t)blockIdx.x * kDxNarrowWarps + threadIdx.x / 32;
       task < tasks; task += nwarps) {
    const int x0 = (int)(task % xt) * 16;
    const int y = (int)(task / xt % H);
    const int64_t b = task / ((int64_t)xt * H);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < kh; ++r) {
      const int oh = y + pt - r;
      if (oh < 0 || oh >= Ho) continue;               // the whole warp
      const bf16* row = dy + (b * Ho + oh) * Wo * O + 8 * q;
      for (int s = 0; s < kw; ++s) {
        // rows g and g + 8 of A: dx pixels x0 + g and x0 + g + 8
        const int ow0 = x0 + g + pl - s, ow1 = ow0 + 8;
        const bool ok0 = x0 + g < W && ow0 >= 0 && ow0 < Wo;
        const bool ok1 = x0 + g + 8 < W && ow1 >= 0 && ow1 < Wo;
        const uint4* p0 = reinterpret_cast<const uint4*>(
            row + (int64_t)(ok0 ? ow0 : 0) * O);
        const uint4* p1 = reinterpret_cast<const uint4*>(
            row + (int64_t)(ok1 ? ow1 : 0) * O);
        const uint4* bf = bfrag + (int64_t)(r * kw + s) * ps * 32 + lane;
#pragma unroll 4
        for (int p = 0; p < ps; ++p) {
          const uint4 v0 = ok0 ? __ldg(p0 + 4 * p) : zero;
          const uint4 v1 = ok1 ? __ldg(p1 + 4 * p) : zero;
          const uint4 bb = __ldg(bf + 32 * p);
          const uint32_t a0[4] = {v0.x, v1.x, v0.y, v1.y};
          const uint32_t b0[2] = {bb.x, bb.y};
          dft::mma_bf16(acc, a0, b0);
          const uint32_t a1[4] = {v0.z, v1.z, v0.w, v1.w};
          const uint32_t b1[2] = {bb.z, bb.w};
          dft::mma_bf16(acc, a1, b1);
        }
      }
    }
    // acc: (row g, cols 2q, 2q + 1) then (row g + 8, the same cols)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + g + 8 * h;
      if (x >= W) continue;
      const int64_t o = ((b * H + y) * W + x) * I;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * q + e;
        if (n >= I) continue;
        if (out_f32)
          static_cast<float*>(dx)[o + n] = acc[2 * h + e];
        else
          static_cast<bf16*>(dx)[o + n] = __float2bfloat16(acc[2 * h + e]);
      }
    }
  }
}

constexpr int kDxFp32O = 8;      // widest dy of conv_dgrad_fp32
constexpr int kDxFp32Pix = 8;    // dx pixels along x a thread

// One thread per 4 dx channels x 8 pixels along x: per tap, the weights of
// its channels for every dy channel (16-byte loads of the untransposed w,
// neighbouring threads on neighbouring channels) serve all 8 pixels; dy's
// values are the same for the 32 threads of a warp (broadcast loads, 16
// bytes where O % 4 == 0).  S1: stride 1 (no divisions in the tap walk).
template <bool S1, bool VEC>
__global__ void __launch_bounds__(256) conv_dgrad_fp32_kernel(
    const float* __restrict__ dy, const float* __restrict__ w,
    float* __restrict__ dx, int B, int H, int W, int I, int Ho, int Wo, int O,
    int kh, int kw, int sh, int sw, int pt, int pl) {
  const int groups = I / 4;
  const int xg = (W + kDxFp32Pix - 1) / kDxFp32Pix;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * H * xg * groups) return;
  const int c = (int)(idx % groups) * 4;
  int64_t t = idx / groups;
  const int x0 = (int)(t % xg) * kDxFp32Pix;
  t /= xg;
  const int y = (int)(t % H);
  const int64_t b = t / H;
  float4 acc[kDxFp32Pix];
#pragma unroll
  for (int q = 0; q < kDxFp32Pix; ++q)
    acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < kh; ++r) {
    const int ohs = y + pt - r;
    if (ohs < 0 || (!S1 && ohs % sh)) continue;
    const int oh = S1 ? ohs : ohs / sh;
    if (oh >= Ho) continue;
    for (int s = 0; s < kw; ++s) {
      float4 wv[kDxFp32O];
#pragma unroll
      for (int o = 0; o < kDxFp32O; ++o)
        wv[o] = o < O ? __ldg(reinterpret_cast<const float4*>(
                            w + (((int64_t)o * kh + r) * kw + s) * I + c))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kDxFp32Pix; ++q) {
        const int ows = x0 + q + pl - s;
        if (x0 + q >= W || ows < 0 || (!S1 && ows % sw)) continue;
        const int ow = S1 ? ows : ows / sw;
        if (ow >= Wo) continue;
        const float* d = dy + ((b * Ho + oh) * Wo + ow) * O;
        float dv[kDxFp32O];
        if (VEC) {
#pragma unroll
          for (int o = 0; o < kDxFp32O; o += 4) {
            const float4 v = o < O ? __ldg(reinterpret_cast<const float4*>(
                                         d + o))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            dv[o] = v.x; dv[o + 1] = v.y; dv[o + 2] = v.z; dv[o + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int o = 0; o < kDxFp32O; ++o)
            dv[o] = o < O ? __ldg(d + o) : 0.f;
        }
#pragma unroll
        for (int o = 0; o < kDxFp32O; ++o) {
          if (o >= O) break;
          acc[q].x = fmaf(dv[o], wv[o].x, acc[q].x);
          acc[q].y = fmaf(dv[o], wv[o].y, acc[q].y);
          acc[q].z = fmaf(dv[o], wv[o].z, acc[q].z);
          acc[q].w = fmaf(dv[o], wv[o].w, acc[q].w);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kDxFp32Pix; ++q)
    if (x0 + q < W)
      *reinterpret_cast<float4*>(dx + ((b * H + y) * W + x0 + q) * I + c) =
          acc[q];
}

// ---------------------------------------------------------------------------
// Hopper path: implicit GEMM on wgmma, operands by TMA (see the note above)
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BK = 64, kThreads = 384;
constexpr int CORE = BM * 16;           // one 8-channel tap of 128 rows: 2 KB
constexpr int NARROW_K = 10;            // the narrow route's 8-channel K chunks
// A tile is 128 pixels x BN output channels (128, or 64 for the strided
// and narrow convs whose 128-wide tiles would fill under half the SMs).
template <bool NARROW, int BN>
struct Cfg {
  // wide: A [128 pixels][64] and B [BN channels][64]; narrow: A as
  // NARROW_K chunks of [128][8], B as NARROW_K chunks of [BN][8]
  static constexpr int TILE_A = NARROW ? NARROW_K * CORE : BM * BK * 2;
  static constexpr int TILE_B = NARROW ? NARROW_K * BN * 16 : BN * BK * 2;
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr int STAGES = NARROW ? (BN == 128 ? 4 : 5)
                                       : (BN == 128 ? 5 : 8);
  static constexpr int OUT = BM * BN * 2;   // a warpgroup's bf16 staging
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE + 2 * OUT +
                                  2 * STAGES * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "shared memory");
};
}  // namespace wg

// One problem of a launch, as a conv of the source grid: the forward conv,
// or one parity class of a dgrad (conv_dgrad_wgmma, see the note there).
// Its output pixel (cy, cx) reads source pixel (cy*sh - pt + t, cx*sw - pl +
// u) at tap (t, u) and is written at (py + ystep*cy, px + xstep*cx).
struct WgClass {
  int Hc, Wc;             // its output grid
  int py, px;             // where that grid starts in the written tensor
  int pt, pl;             // source offset (may be negative)
  int nu;                 // taps along x: tap index = t * nu + u
  int kblocks;            // taps * C / 64 (0: no tap, its pixels get zeros)
  int wrow;               // its first row in the weight map
  int tiles_x, tiles_y, tiles_pix;
  int tile0;              // its first tile in the launch
};

constexpr int kMaxClasses = 4;          // a stride-2 dgrad's parity classes

struct WgConv {
  int B, Ho, Wo, O;       // the written tensor [B, Ho, Wo, O]
  int C;                  // source channels (% 64 == 0; narrow: 8)
  int sh, sw;             // source strides of the tap walk (1 or 2)
  int ystep, xstep;       // output strides (dgrad classes: the conv's)
  int taps;               // kh * kw (the narrow route's A chunks)
  int bw, bh, bb;         // the pixel box of one tile (bw * bh * bb = 128)
  const unsigned char* xp;  // narrow: x padded [B, Hp, Wp, 8] and the
  const unsigned char* wp;  // packed weight [O/BN][10][BN][8]
  int Hp, Wp;
  int tiles_n, tiles;     // N tiles; tiles over all classes and splits
  int classes;
  WgClass cls[kMaxClasses];
  int splits;
  const float* bias;
  void* y;
  int out_f32;
  int tma_store;          // bf16 out, O % 8 == 0, no split: TMA stores
  float* ws;              // [splits, B*Ho*Wo*O] fp32 partials when splits > 1
};

// The store maps of a launch's classes: a dgrad's N <= kMaxClasses, the
// forward's one (its kernel's parameters stay as small as before).
template <int N>
struct WgStoreMaps {
  CUtensorMap m[N];
};

// A tile's place in the problem: its class, pixel box origin, N offset,
// K range.
struct WgTile {
  int cls, x0, y0, b0, n0, split, kb0, kb1;
  WgClass c;
};

template <int BN, bool DGRAD>
__device__ __forceinline__ WgTile wg_tile(const WgConv& p, int t) {
  WgTile w;
  // the class (a forward has one): static indices only, so p stays in the
  // parameter bank
  w.cls = 0;
  w.c = p.cls[0];
#pragma unroll
  for (int i = 1; i < kMaxClasses; ++i)
    if (DGRAD && i < p.classes && t >= p.cls[i].tile0) {
      w.cls = i;
      w.c = p.cls[i];
    }
  t -= w.c.tile0;
  w.n0 = (t % p.tiles_n) * BN;
  t /= p.tiles_n;
  const int pix = t % w.c.tiles_pix;
  w.split = t / w.c.tiles_pix;
  w.x0 = (pix % w.c.tiles_x) * p.bw;
  w.y0 = (pix / w.c.tiles_x % w.c.tiles_y) * p.bh;
  w.b0 = pix / (w.c.tiles_x * w.c.tiles_y) * p.bb;
  w.kb0 = (int)((int64_t)w.c.kblocks * w.split / p.splits);
  w.kb1 = (int)((int64_t)w.c.kblocks * (w.split + 1) / p.splits);
  return w;
}

// d[64 x BN] += A[64 x 16] B[16 x BN], both from shared memory
template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    hop::wgmma_m64n128k16_ss(d, da, db);
  else
    hop::wgmma_m64n64k16_ss(d, da, db);
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; its producer warp
// streams their K blocks through one ring, and its two consumer warpgroups
// take the tiles in turns ("pingpong"): while one runs its epilogue the
// other's products keep the tensor cores busy.  Named barriers 1 and 2
// pass the turn to issue a tile's products; 3 and 4 are each warpgroup's own.
// NARROW: the 8-channel route; a tile's whole K (its taps x 8 channels) is
// one stage of plain bulk copies (no tensor maps for x and w).
template <bool NARROW, int BN, bool DGRAD>
__global__ void __launch_bounds__(wg::kThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ WgStoreMaps<DGRAD ? kMaxClasses : 1>
                      ymaps,
                  WgConv p) {
  using C = wg::Cfg<NARROW, BN>;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  // the ring: stage s holds A then B; then each consumer's output staging,
  // BN / 64 swizzled [128][64] halves
  unsigned char* ring = base;
  bf16* stage_out = reinterpret_cast<bf16*>(base + C::STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::STAGES * C::STAGE +
                                               2 * C::OUT);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128);   // the consuming warpgroup's threads
    }
    hop::mbar_fence_init();
  }
  if (NARROW) {
    // A's chunks past the taps are never loaded: zero them once (their
    // weight rows are zero too, but 0 x stale bits may be NaN)
    for (int s = 0; s < C::STAGES; ++s) {
      uint4* a = reinterpret_cast<uint4*>(ring + s * C::STAGE);
      for (int i = p.taps * wg::CORE / 16 + tid; i < C::TILE_A / 16;
           i += wg::kThreads)
        a[i] = make_uint4(0, 0, 0, 0);
    }
    hop::fence_proxy_async();
  }
  __syncthreads();

  if (grp == 0) {
    // ---- producer: one thread streams every tile's K blocks ----
    hop::regs_dec<40>();
    if (tid != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const WgTile w = wg_tile<BN, DGRAD>(p, t);
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % C::STAGES;
        hop::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE;
        if (NARROW) {
          // per tap, one copy per row of the pixel box: pixels x0 + u ..
          // x0 + u + bw - 1 of padded row y + r (a row past the output or
          // an image past B reads row 0: its pixels are clipped at the
          // store, as are those past Wo, read from the next row or the
          // buffer's slack); then the N tile's weight, one copy
          const int seg = p.bw * 16;
          hop::mbar_expect_tx(&full[s],
                              p.taps * p.bh * p.bb * seg + C::TILE_B);
          for (int tap = 0; tap < p.taps; ++tap) {
            const int r = tap / w.c.nu, u = tap - r * w.c.nu;
            for (int row = 0; row < p.bh * p.bb; ++row) {
              const int y = w.y0 + row % p.bh, b = w.b0 + row / p.bh;
              const int64_t px =
                  y < p.Ho && b < p.B
                      ? ((int64_t)b * p.Hp + y + r) * p.Wp + w.x0 + u
                      : 0;
              hop::bulk_load(st + tap * wg::CORE + row * seg, p.xp + px * 16,
                             seg, &full[s]);
            }
          }
          hop::bulk_load(st + C::TILE_A,
                         p.wp + (int64_t)(w.n0 / BN) * C::TILE_B, C::TILE_B,
                         &full[s]);
        } else {
          const int cblocks = p.C / wg::BK;
          const int tap = kb / cblocks, cb = kb - tap * cblocks;
          const int r = tap / w.c.nu, u = tap - r * w.c.nu;
          // at stride 2 the map walks every other pixel (its traversal
          // strides): the box starts at the tap's first source pixel
          hop::mbar_expect_tx(&full[s], C::STAGE);
          hop::tma_load_4d(st, &xmap, &full[s], cb * wg::BK,
                           w.x0 * p.sw + u - w.c.pl,
                           w.y0 * p.sh + r - w.c.pt, w.b0);
          hop::tma_load_2d(st + C::TILE_A, &wmap, &full[s], kb * wg::BK,
                           w.c.wrow + w.n0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes every other tile of the block ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lt = tid % 128, lane = lt % 32, warp = lt / 32;
  const int g = lane / 4, q = lane % 4;
  auto my_turn = [&]() { hop::bar_sync(1 + cw, 256); };
  auto pass_turn = [&]() { hop::bar_arrive(2 - cw, 256); };
  if (cw == 1) pass_turn();          // warpgroup 0 goes first
  bf16* so = stage_out + cw * (C::OUT / 2);
  const int64_t total = (int64_t)p.B * p.Ho * p.Wo * p.O;
  int it = 0;
  for (int t = blockIdx.x, i = 0; t < p.tiles; t += gridDim.x, ++i) {
    const WgTile w = wg_tile<BN, DGRAD>(p, t);
    if (i % 2 != cw) {               // the other warpgroup's tile
      it += w.kb1 - w.kb0;
      continue;
    }
    float acc[2][BN / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[m][e] = 0.f;
    my_turn();
    int prev = -1;
    for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
      const int s = it % C::STAGES;
      hop::mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* st = ring + s * C::STAGE;
      // (descriptor + n moves its start by 16n bytes)
      if (NARROW) {
        // k16 step k: taps 2k and 2k + 1 (A +4 KB, B +2 BN * 16 bytes);
        // rows 64..127 at +1 KB
        const uint64_t da = hop::desc_plain(st, wg::CORE, 128);
        const uint64_t db = hop::desc_plain(st + C::TILE_A, BN * 16, 128);
        hop::wgmma_fence();
#pragma unroll
        for (int k = 0; k < wg::NARROW_K / 2; ++k) {
          wgmma_tile<BN>(acc[0], da + 256 * k, db + 2 * BN * k);
          wgmma_tile<BN>(acc[1], da + 64 + 256 * k, db + 2 * BN * k);
        }
      } else {
        const uint64_t da = hop::desc_sw128(st);
        const uint64_t db = hop::desc_sw128(st + C::TILE_A);
        hop::wgmma_fence();
#pragma unroll
        for (int k = 0; k < wg::BK / 16; ++k) {   // +32 bytes per k16 step
          wgmma_tile<BN>(acc[0], da + 2 * k, db + 2 * k);
          wgmma_tile<BN>(acc[1], da + 512 + 2 * k, db + 2 * k);
        }                                          // (+8 KB: rows 64..127)
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();          // the previous stage's products are done
      if (prev >= 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
    }
    pass_turn();
    hop::wgmma_wait<0>();
    if (prev >= 0) hop::mbar_arrive(&empty[prev]);

    // ---- epilogue: + bias in fp32, one rounding ----
    if (p.tma_store) {
      // bf16 into this warpgroup's staging (128-byte swizzle, as the map's),
      // then two TMA stores that clip the ragged pixels and channels
      if (lt == 0) hop::bulk_wait_read();
      hop::bar_sync(3 + cw, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = w.n0 + 8 * j + 2 * q;
        const float b0 = p.bias && n < p.O ? p.bias[n] : 0.f;
        const float b1 = p.bias && n + 1 < p.O ? p.bias[n + 1] : 0.f;
        bf16* half = so + (j / 8) * (wg::BM * 64);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m * 64 + warp * 16 + g + 8 * h;
            *reinterpret_cast<uint32_t*>(
                half + row * 64 + (((j % 8) ^ (row % 8)) * 8) + 2 * q) =
                dft::pack_bf16(acc[m][4 * j + 2 * h] + b0,
                               acc[m][4 * j + 2 * h + 1] + b1);
          }
      }
      hop::fence_proxy_async();
      hop::bar_sync(3 + cw, 128);
      if (lt == 0) {
        // the class's map (static indices: the maps stay parameters)
        const CUtensorMap* ym = &ymaps.m[0];
        if constexpr (DGRAD) {
#pragma unroll
          for (int i = 1; i < kMaxClasses; ++i)
            if (w.cls == i) ym = &ymaps.m[i];
        }
        hop::tma_store_4d(ym, so, w.n0, w.x0, w.y0, w.b0);
        if (BN == 128 && w.n0 + 64 < p.O)
          hop::tma_store_4d(ym, so + wg::BM * 64, w.n0 + 64, w.x0, w.y0,
                            w.b0);
        hop::bulk_commit();
      }
      continue;
    }
    // fp32 output, split-K partials or O % 8 != 0: straight from registers
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 64 + warp * 16 + g + 8 * h;
        const int x = w.x0 + row % p.bw, y = w.y0 + (row / p.bw) % p.bh;
        const int b = w.b0 + row / (p.bw * p.bh);
        if (x >= w.c.Wc || y >= w.c.Hc || b >= p.B) continue;
        // a dgrad class's pixel (x, y) is dx's (px + xstep*x, py + ystep*y)
        const int oy = DGRAD ? w.c.py + p.ystep * y : y;
        const int ox = DGRAD ? w.c.px + p.xstep * x : x;
        const int64_t o = (((int64_t)b * p.Ho + oy) * p.Wo + ox) * p.O;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = w.n0 + 8 * j + 2 * q;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= p.O) continue;
            float v = acc[m][4 * j + 2 * h + e];
            if (p.splits > 1) {
              p.ws[(int64_t)w.split * total + o + n + e] = v;
              continue;
            }
            if (p.bias) v += p.bias[n + e];
            if (p.out_f32)
              static_cast<float*>(p.y)[o + n + e] = v;
            else
              static_cast<bf16*>(p.y)[o + n + e] = __float2bfloat16(v);
          }
        }
      }
  }
  if (lt == 0) hop::bulk_wait();     // stores done before the block ends
}

// xp[b, y, x] = x[b, y - pt, x - pl, 0..I) then zero channels, zero outside
// x: [B, Hp, Wp, 8], one 16-byte row a pixel
__global__ void pad_channels8_kernel(const bf16* __restrict__ x,
                                     uint4* __restrict__ xp, int B, int H,
                                     int W, int I, int Hp, int Wp, int pt,
                                     int pl) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * Hp * Wp) return;
  const int xx = (int)(i % Wp) - pl, yy = (int)(i / Wp % Hp) - pt;
  const int64_t b = i / ((int64_t)Wp * Hp);
  const bool in = xx >= 0 && xx < W && yy >= 0 && yy < H;
  const bf16* src = x + ((b * H + (in ? yy : 0)) * W + (in ? xx : 0)) * I;
  __align__(16) bf16 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v[c] = in && c < I ? src[c] : __float2bfloat16(0.f);
  xp[i] = *reinterpret_cast<const uint4*>(v);
}

// Fills the tiling of `p` (each class's tiles over the box, O and the
// splits; the caller set the classes' grids, offsets and K blocks), encodes
// each class's store map when the epilogue stores by TMA (y's strided view
// [B, Hc, Wc, O] from pixel (py, px), steps ystep and xstep), and launches
// the kernel (and the split-K reduction) on at most `sms` persistent blocks.
template <bool NARROW, int BN, bool DGRAD = false>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap,
                 WgConv& p, int sms, cudaStream_t stream) {
  using C = wg::Cfg<NARROW, BN>;
  WgStoreMaps<DGRAD ? kMaxClasses : 1> ymaps;
  memset(&ymaps, 0, sizeof ymaps);   // unused without TMA stores
  p.tma_store = !p.out_f32 && p.splits == 1 && p.O % 8 == 0;
  p.tiles_n = (p.O + BN - 1) / BN;
  p.tiles = 0;
  for (int i = 0; i < p.classes; ++i) {
    WgClass& c = p.cls[i];
    c.tiles_x = (c.Wc + p.bw - 1) / p.bw;
    c.tiles_y = (c.Hc + p.bh - 1) / p.bh;
    c.tiles_pix = c.tiles_x * c.tiles_y * ((p.B + p.bb - 1) / p.bb);
    c.tile0 = p.tiles;
    p.tiles += c.tiles_pix * p.tiles_n * p.splits;
    if (!p.tma_store || c.tiles_pix == 0) continue;
    // boxes of 64 channels x the pixel box
    const cuuint64_t yd[4] = {(cuuint64_t)p.O, (cuuint64_t)c.Wc,
                              (cuuint64_t)c.Hc, (cuuint64_t)p.B};
    const cuuint64_t ys[3] = {(cuuint64_t)p.xstep * p.O * 2,
                              (cuuint64_t)p.ystep * p.Wo * p.O * 2,
                              (cuuint64_t)p.Ho * p.Wo * p.O * 2};
    const cuuint32_t yb[4] = {(cuuint32_t)wg::BK, (cuuint32_t)p.bw,
                              (cuuint32_t)p.bh, (cuuint32_t)p.bb};
    const bf16* base = static_cast<const bf16*>(p.y) +
                       ((int64_t)c.py * p.Wo + c.px) * p.O;
    if (!hop::encode_bf16_map(&ymaps.m[i], base, 4, yd, ys, yb))
      return (int)cudaErrorInvalidValue;
  }
  if (p.tiles == 0) return (int)cudaGetLastError();
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(conv_wgmma_kernel<NARROW, BN, DGRAD>, (int)C::kSmem,
                      smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  conv_wgmma_kernel<NARROW, BN, DGRAD>
      <<<grid, wg::kThreads, C::kSmem, stream>>>(xmap, wmap, ymaps, p);
  if (p.splits > 1) {
    ConvParams r{nullptr, nullptr, p.bias, p.y, p.B, 0, 0, 0, p.Ho, p.Wo,
                 p.O, 0, 0, 1, 1, 0, 0, p.out_f32, p.splits, p.ws};
    const int64_t total = (int64_t)p.B * p.Ho * p.Wo * p.O;
    conv_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        r);
  }
  return (int)cudaGetLastError();
}

// The forward as the one class of a launch: output grid Ho x Wo, source
// offset (pt, pl), kw taps along x, K blocks from the weight's row 0.
inline void forward_class(WgConv& p, int pt, int pl, int kw, int kblocks) {
  p.classes = 1;
  p.ystep = p.xstep = 1;
  WgClass& c = p.cls[0];
  c.Hc = p.Ho; c.Wc = p.Wo; c.py = 0; c.px = 0;
  c.pt = pt; c.pl = pl; c.nu = kw; c.kblocks = kblocks; c.wrow = 0;
}

template <bool DGRAD>
int launch_conv(const ConvParams& p, cudaStream_t stream) {
  const int classes = DGRAD ? p.sh * p.sw : 1;
  // rows of the largest class (class 0)
  const int Hc = DGRAD ? (p.OH + p.sh - 1) / p.sh : p.OH;
  const int Wc = DGRAD ? (p.OW + p.sw - 1) / p.sw : p.OW;
  const int64_t M = (int64_t)p.B * Hc * Wc;
  if (M == 0 || p.N == 0) return (int)cudaGetLastError();
  if (p.C % 8 == 0) {
    if (p.splits < 1 || (p.splits > 1 && p.ws == nullptr))
      return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((M + BM - 1) / BM), (p.N + BN - 1) / BN,
              classes * p.splits);
    conv_mma_kernel<DGRAD><<<grid, kThreads, 0, stream>>>(p);
    if (p.splits > 1) {
      const int64_t total = (int64_t)p.B * p.OH * p.OW * p.N;
      conv_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0,
                           stream>>>(p);
    }
  } else if constexpr (DGRAD) {
    const int threads = 256;
    dim3 grid((unsigned)((M * p.N + threads - 1) / threads), classes);
    conv_simple_kernel<DGRAD><<<grid, threads, 0, stream>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;   // the forward: bf16, I % 8 == 0
  }
  return (int)cudaGetLastError();
}

template <int BN, bool VEC>
int launch_fp32_tiled(const ConvParams& p, cudaStream_t stream) {
  using Cf = ft::Cfg<BN>;
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err = hop::allow_smem(conv_fp32_tiled_kernel<BN, VEC>,
                                          (int)Cf::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int64_t M = (int64_t)p.B * p.OH * p.OW;
  dim3 grid((unsigned)((M + ft::BM - 1) / ft::BM), (p.N + BN - 1) / BN,
            p.splits);
  conv_fp32_tiled_kernel<BN, VEC>
      <<<grid, Cf::kThreads, Cf::kSmem, stream>>>(p);
  if (p.splits > 1) {
    const int64_t total = M * p.N;
    conv_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        p);
  }
  return (int)cudaGetLastError();
}

template <int BN>
int launch_fp32_tiled_bn(const ConvParams& p, cudaStream_t stream) {
  return p.C % 4 == 0 ? launch_fp32_tiled<BN, true>(p, stream)
                      : launch_fp32_tiled<BN, false>(p, stream);
}

// the sh*sw parity classes in one launch, the grid over class (0, 0)'s (the
// largest), ldw the packed weight's row length
template <int BN, bool VEC>
int launch_dgrad_fp32_tiled(const ConvParams& p, int ldw,
                            cudaStream_t stream) {
  using Cf = ft::Cfg<BN>;
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err = hop::allow_smem(
      conv_dgrad_fp32_tiled_kernel<BN, VEC>, (int)Cf::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int64_t M = (int64_t)p.B * ((p.OH + p.sh - 1) / p.sh) *
                    ((p.OW + p.sw - 1) / p.sw);
  dim3 grid((unsigned)((M + ft::BM - 1) / ft::BM), (p.N + BN - 1) / BN,
            p.sh * p.sw * p.splits);
  conv_dgrad_fp32_tiled_kernel<BN, VEC>
      <<<grid, Cf::kThreads, Cf::kSmem, stream>>>(p, ldw);
  if (p.splits > 1) {
    const int64_t total = (int64_t)p.B * p.OH * p.OW * p.N;
    conv_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        p);
  }
  return (int)cudaGetLastError();
}

template <int BN>
int launch_dgrad_fp32_tiled_bn(const ConvParams& p, int ldw,
                               cudaStream_t stream) {
  return p.C % 4 == 0 && ldw % 4 == 0
             ? launch_dgrad_fp32_tiled<BN, true>(p, ldw, stream)
             : launch_dgrad_fp32_tiled<BN, false>(p, ldw, stream);
}

// ---------------------------------------------------------------------------
// weight gradient (wgrad, see the note above): a GEMM per tap, split over
// the pixels, partials summed in split order
// ---------------------------------------------------------------------------

struct WgradParams {
  const void* x;      // [B, H, W, I]
  const void* dy;     // [B, Ho, Wo, O]
  float* ws;          // [splits][O][kh*kw*I] partial sums (splits > 1)
  void* dw;           // [O][kh*kw*I], fp32 (out_f32) or bf16
  int B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl;
  int splits, out_f32;
};

// dW[i] = v when there is one split, else split `split`'s partial
__device__ __forceinline__ void wgrad_store(const WgradParams& p, int split,
                                            int64_t i, float v) {
  if (p.splits > 1)
    p.ws[(int64_t)split * p.O * p.kh * p.kw * p.I + i] = v;
  else if (p.out_f32)
    static_cast<float*>(p.dw)[i] = v;
  else
    static_cast<bf16*>(p.dw)[i] = __float2bfloat16(v);
}

namespace wgr {
constexpr int BM = 128, BN = 128, BK = 32, LDS = BM + 8, kThreads = 256;
}  // namespace wgr

// The bf16 route.  A block owns 128 output channels (M) x 128 columns
// (tap, input channel) of dW (N) and walks its split's pixels (K) 32 at a
// time through a two-stage ring: A = dy's [32 pixels][128 channels], B =
// x's [32 pixels][128 columns] at each column's tap offset (zero outside
// the image: the padding, the VAE's (0, 1) included), both stored with the
// M or N index contiguous, so ldmatrix.trans gives both fragments.  8
// warps of 64 x 32, mma.sync m16n8k16 with fp32 accumulation; the split's
// partial sums go to ws (one split: dW itself).  VA: O % 8 == 0 (dy by 16-byte cp.async);
// VB: I % 8 == 0 (8 columns of x are one tap's 16 bytes).  Otherwise
// element loads (the conv_ins' 3 and 4 channels).
template <bool VA, bool VB>
__global__ void __launch_bounds__(wgr::kThreads)
conv_wgrad_mma_kernel(WgradParams p) {
  // the forward's mma.sync tile constants share these names
  constexpr int BM = wgr::BM, BN = wgr::BN, BK = wgr::BK, LDS = wgr::LDS;
  __shared__ __align__(16) bf16 sA[2][BK * LDS];
  __shared__ __align__(16) bf16 sB[2][BK * LDS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m_base = blockIdx.x * BM, n_base = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int64_t P = (int64_t)p.B * p.Ho * p.Wo;
  const int Kn = p.kh * p.kw * p.I;
  const int64_t steps = (P + BK - 1) / BK;
  const int64_t s0 = steps * split / p.splits;
  const int64_t KT = steps * (split + 1) / p.splits - s0;
  const bf16* __restrict__ X = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ DY = static_cast<const bf16*>(p.dy);
  const bf16 zero = __float2bfloat16(0.f);

  // this thread's 8 columns of A and of B, pixel rows tid / 16 (+ 16)
  const int col = (tid % 16) * 8;
  int er[8], es[8], ec[8];              // (tap row, tap column, channel)
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n_base + col + (VB ? 0 : e);
    const int tap = n / p.I;
    er[e] = n < Kn ? tap / p.kw : -(1 << 29);   // past N: every read misses
    es[e] = tap - (tap / p.kw) * p.kw;
    ec[e] = n - tap * p.I;
  }

  auto load_stage = [&](int stage, int64_t kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tid / 16 + 16 * i;
      const int64_t pix = kt * BK + row;
      const bool in = pix < P;
      int b = 0, oy = 0, ox = 0;
      if (in) {
        ox = (int)(pix % p.Wo);
        const int64_t t = pix / p.Wo;
        oy = (int)(t % p.Ho);
        b = (int)(t / p.Ho);
      }
      bf16* da = &sA[stage][row * LDS + col];
      if (VA) {
        const bool ok = in && m_base + col < p.O;
        dft::cp_async16(da, ok ? DY + pix * p.O + m_base + col : DY, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int o = m_base + col + e;
          da[e] = in && o < p.O ? DY[pix * p.O + o] : zero;
        }
      }
      bf16* db = &sB[stage][row * LDS + col];
      const int y0 = oy * p.sh - p.pt, x0 = ox * p.sw - p.pl;
      const int64_t img = (int64_t)b * p.H;
      if (VB) {
        const int iy = y0 + er[0], ix = x0 + es[0];
        const bool ok = in && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        dft::cp_async16(db, ok ? X + ((img + iy) * p.W + ix) * p.I + ec[0]
                               : X, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int iy = y0 + er[e], ix = x0 + es[e];
          const bool ok = in && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
          db[e] = ok ? X[((img + iy) * p.W + ix) * p.I + ec[e]] : zero;
        }
      }
    }
  };

  const int wm = warp / 4, wn = warp % 4;   // 2 x 4 warps, 64 x 32 each
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (KT > 0) load_stage(0, s0);
  dft::cp_async_commit();
  for (int64_t kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, s0 + kt + 1);
    dft::cp_async_commit();
    dft::cp_async_wait<1>();
    __syncthreads();
    const bf16* tA = sA[kt & 1];
    const bf16* tB = sB[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        dft::load_a_frag_km(af[mi], tA + ks * 16 * LDS + wm * 64 + mi * 16,
                            LDS, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        dft::load_b_frag_kn(bfr[nj], tB + ks * 16 * LDS + wn * 32 + nj * 16,
                            LDS, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          dft::mma_bf16(acc[mi][ni], af[mi], &bfr[ni / 2][(ni % 2) * 2]);
    }
    __syncthreads();
  }

  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= p.O) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + wn * 32 + ni * 8 + 2 * q + e;
          if (n < Kn)
            wgrad_store(p, split, (int64_t)m * Kn + n, acc[mi][ni][2 * h + e]);
        }
    }
}

// dW = sum over splits of the partials, in split order, in dW's dtype
__global__ void conv_wgrad_reduce(const float* __restrict__ ws, void* dw,
                                  int64_t total, int splits, int out_f32) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += ws[s * total + idx];
  if (out_f32)
    static_cast<float*>(dw)[idx] = v;
  else
    static_cast<bf16*>(dw)[idx] = __float2bfloat16(v);
}

// the split partials of a launch of p.splits > 1, summed in split order
void wgrad_reduce(const WgradParams& p, cudaStream_t stream) {
  if (p.splits == 1) return;
  const int64_t total = (int64_t)p.O * p.kh * p.kw * p.I;
  conv_wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      p.ws, p.dw, total, p.splits, p.out_f32);
}

int launch_wgrad_mma(const WgradParams& p, cudaStream_t stream) {
  using wgr::BM;
  using wgr::BN;
  constexpr int kThreads = wgr::kThreads;
  const int Kn = p.kh * p.kw * p.I;
  dim3 grid((p.O + BM - 1) / BM, (Kn + BN - 1) / BN, p.splits);
  const bool va = p.O % 8 == 0, vb = p.I % 8 == 0;
  if (va && vb)
    conv_wgrad_mma_kernel<true, true><<<grid, kThreads, 0, stream>>>(p);
  else if (va)
    conv_wgrad_mma_kernel<true, false><<<grid, kThreads, 0, stream>>>(p);
  else if (vb)
    conv_wgrad_mma_kernel<false, true><<<grid, kThreads, 0, stream>>>(p);
  else
    conv_wgrad_mma_kernel<false, false><<<grid, kThreads, 0, stream>>>(p);
  wgrad_reduce(p, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 weight gradient: a tiled GEMM on the CUDA cores (see the note above)
// ---------------------------------------------------------------------------

namespace fw {
constexpr int BK = 16, STAGES = 3;   // pixels a step, ring stages
constexpr int kFar = -(1 << 29);     // a column past K: every tap misses
// A block of kThreads threads is a TM x TN grid (TN = BN / 8 along N), each
// thread 8 columns x 8 channels: columns 4 ty + {0..3} and BM/2 + 4 ty +
// {0..3}, channels 4 tx + {0..3} and BN/2 + 4 tx + {0..3}, so a float4
// read of each tile's row gives four of them.  A warp spans the TN
// threads along N: its A reads are 32/TN consecutive float4s (broadcast
// along N), its B reads TN consecutive ones.  TPR threads copy each pixel
// row of a step.
template <int BN>
struct Cfg {
  static_assert(BN == 8 || BN == 32 || BN == 64, "N tile");
  static constexpr int kThreads = BN == 64 ? 128 : 64;
  static constexpr int TN = BN / 8;
  static constexpr int TM = kThreads / TN;
  static constexpr int BM = 8 * TM;               // 128, 128, 512 columns
  static constexpr int TPR = kThreads / BK;
  static constexpr size_t kSmem =
      (size_t)STAGES * BK * (BM + BN) * sizeof(float) + BM * sizeof(int4);
};
}  // namespace fw

// dW[n, m] (n: output channel, m = (tap, channel) column) of a BM x BN
// tile over split blockIdx.z's pixel steps: A = x at each column's tap
// offset [BK pixels][BM], B = dy [BK pixels][BN], both pixel-major in a
// 3-stage cp.async ring (zeros outside the image, past P, past K and past
// O); sums in pixel order, partials to ws when p.splits > 1.  VEC: I and
// O multiples of 4, each copy 4 channels (16 bytes).
template <int BN, bool VEC>
__global__ void __launch_bounds__(fw::Cfg<BN>::kThreads)
conv_wgrad_fp32_tiled_kernel(WgradParams p) {
  using Cf = fw::Cfg<BN>;
  constexpr int BM = Cf::BM, BK = fw::BK, STAGES = fw::STAGES;
  constexpr int T = Cf::kThreads, TPR = Cf::TPR;
  extern __shared__ __align__(16) unsigned char fw_smem[];
  float* As = reinterpret_cast<float*>(fw_smem);         // [STAGES][BK][BM]
  float* Bs = As + STAGES * BK * BM;                     // [STAGES][BK][BN]
  int4* ctab = reinterpret_cast<int4*>(Bs + STAGES * BK * BN);   // [BM]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int Kn = p.kh * p.kw * p.I;
  const int64_t P = (int64_t)p.B * p.Ho * p.Wo;
  const int64_t steps = (P + BK - 1) / BK;
  const int64_t s0 = steps * split / p.splits;
  const int KT = (int)(steps * (split + 1) / p.splits - s0);
  const float* __restrict__ X = static_cast<const float*>(p.x);
  const float* __restrict__ DY = static_cast<const float*>(p.dy);

  // the tile's columns: x's offset from a pixel's tap (0, 0) source, the
  // tap (r, s)
  for (int m = tid; m < BM; m += T) {
    const int n = m0 + m;
    const int tap = n / p.I, c = n - tap * p.I;
    const int r = tap / p.kw, s = tap - r * p.kw;
    ctab[m] = n < Kn ? make_int4((r * p.W + s) * p.I + c, r, s, 0)
                     : make_int4(0, fw::kFar, 0, 0);
  }
  __syncthreads();

  // each thread copies pixel row `row` of a step: A's column groups part,
  // part + TPR, ..., B's likewise
  constexpr int CW = VEC ? 4 : 1;
  constexpr int A_GROUPS = BM / CW, B_GROUPS = BN / CW;
  static_assert(A_GROUPS % TPR == 0, "A copies");
  const int row = tid / TPR, part = tid % TPR;
  auto load_stage = [&](int slot, int kt) {
    const int64_t pix = (s0 + kt) * BK + row;
    const bool in = pix < P;
    int iy0 = fw::kFar, ix0 = 0;
    int64_t xrow = 0;
    if (in) {
      const int ox = (int)(pix % p.Wo);
      const int64_t t = pix / p.Wo;
      const int oy = (int)(t % p.Ho), b = (int)(t / p.Ho);
      iy0 = oy * p.sh - p.pt;
      ix0 = ox * p.sw - p.pl;
      xrow = (((int64_t)b * p.H + iy0) * p.W + ix0) * p.I;
    }
    float* as = As + (slot * BK + row) * BM;
#pragma unroll
    for (int j = 0; j < A_GROUPS / TPR; ++j) {
      const int gcol = (part + j * TPR) * CW;
      const int4 e = ctab[gcol];
      const int iy = iy0 + e.y, ix = ix0 + e.z;
      const bool ok = (unsigned)iy < (unsigned)p.H &&
                      (unsigned)ix < (unsigned)p.W;
      ft_copy<VEC>(as + gcol, ok ? X + xrow + e.x : X, ok);
    }
    float* bs = Bs + (slot * BK + row) * BN;
#pragma unroll
    for (int j = 0; j < (B_GROUPS + TPR - 1) / TPR; ++j) {
      const int gcol = (part + j * TPR) * CW;
      if (gcol >= BN) break;
      const bool ok = in && n0 + gcol < p.O;
      ft_copy<VEC>(bs + gcol, ok ? DY + pix * p.O + n0 + gcol : DY, ok);
    }
  };

  const int tx = tid % Cf::TN, ty = tid / Cf::TN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    dft::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // step kt has landed, and every thread is done with step kt - 1, whose
    // slot the next copy refills
    dft::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    dft::cp_async_commit();
    const float* at = As + (kt % STAGES) * BK * BM + 4 * ty;
    const float* bt = Bs + (kt % STAGES) * BK * BN + 4 * tx;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(at + k * BM);
      const float4 a1 =
          *reinterpret_cast<const float4*>(at + k * BM + BM / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(bt + k * BN);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bt + k * BN + BN / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: dW [O][Kn] (or this split's partial)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? 4 * tx + j : BN / 2 + 4 * tx + j - 4);
    if (n >= p.O) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
      if (m < Kn) wgrad_store(p, split, (int64_t)n * Kn + m, acc[i][j]);
    }
  }
}

template <int BN, bool VEC>
int launch_wgrad_fp32_tiled(const WgradParams& p, cudaStream_t stream) {
  using Cf = fw::Cfg<BN>;
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err = hop::allow_smem(
      conv_wgrad_fp32_tiled_kernel<BN, VEC>, (int)Cf::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int Kn = p.kh * p.kw * p.I;
  dim3 grid((Kn + Cf::BM - 1) / Cf::BM, (p.O + BN - 1) / BN, p.splits);
  conv_wgrad_fp32_tiled_kernel<BN, VEC>
      <<<grid, Cf::kThreads, Cf::kSmem, stream>>>(p);
  wgrad_reduce(p, stream);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgrad_fp32_tiled_bn(const WgradParams& p, cudaStream_t stream) {
  return p.I % 4 == 0 && p.O % 4 == 0
             ? launch_wgrad_fp32_tiled<BN, true>(p, stream)
             : launch_wgrad_fp32_tiled<BN, false>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16 weight gradient on wgmma, operands by TMA (see the note above)
// ---------------------------------------------------------------------------

namespace wgw {
constexpr int BM = 128, BN = 128, kThreads = 384, STAGES = 6;
constexpr int PIX = 64;                        // pixels a step (a box)
constexpr int BOX = PIX * 64 * 2;              // [64 pixels][64] bf16: 8 KB
constexpr int STAGE = 4 * BOX;                 // dy: 2 boxes, x: 2 boxes
constexpr int OUT = 2 * 64 * 64 * 2;           // a warpgroup's bf16 staging
constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE + 2 * OUT +
                         2 * STAGES * sizeof(uint64_t);
static_assert(kSmem <= 232448, "shared memory");
}  // namespace wgw

struct WgradBoxes {
  int O, I, Kn, kw, sh, sw, pt, pl;
  int bw, bh, bb;                // a step's pixel box (bw * bh * bb = 64)
  int tiles_x, tiles_y, steps;   // the boxes over [B, Ho, Wo]
  int tiles_n, tiles_m, splits;  // dW's tiles and the splits of the steps
  int out_f32;
  int tma_store;                 // bf16 dW, one split: TMA stores
  float* ws;                     // [splits][O][Kn] when splits > 1
  void* dw;                      // [O][Kn]
};

// A tile's place: its 128 x 128 corner of dW, its split's steps, the boxes
// of A (dy, na of 2) and B (x, nb of 2) it loads
struct WgradTile {
  int n0, m0, split, st0, st1, na, nb;
};

__device__ __forceinline__ WgradTile wgrad_tile(const WgradBoxes& p, int t) {
  WgradTile w;
  w.n0 = (t % p.tiles_n) * wgw::BN;
  t /= p.tiles_n;
  w.m0 = (t % p.tiles_m) * wgw::BM;
  w.split = t / p.tiles_m;
  w.st0 = (int)((int64_t)p.steps * w.split / p.splits);
  w.st1 = (int)((int64_t)p.steps * (w.split + 1) / p.splits);
  // boxes wholly past O (A) or K (B) are not loaded: the rows and columns
  // they would feed are not stored
  w.na = w.m0 + 64 < p.O ? 2 : 1;
  w.nb = w.n0 + 64 < p.Kn ? 2 : 1;
  return w;
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (a tile: 128 o x
// 128 columns of dW over one split of the pixel boxes; consecutive tiles
// share their dy boxes).  The producer thread streams every tile's boxes
// through one ring, running ahead into the next tile while the consumers
// finish one: per box dy's [64 pixels][64 o] (A, MN-major) for each 64
// rows of the tile and x's [64 pixels][64 channels] (B, MN-major) for
// each 64 columns at the columns' tap.  Consumer warpgroup cw runs wgmma
// m64n128k16 on rows 64 cw .. of every tile (none where they are past O:
// it only passes the stages on), then stores them: a bf16 dW of one
// split through a 128-byte-swizzled staging tile and two TMA stores (which
// clip the rows past O and the columns past K), partials and fp32 dW from
// its registers.  A form in which the two warpgroups took whole tiles in
// turns (the forward's "pingpong") ran 1.4-1.5x slower at the shapes of
// one or two long tiles a block.
__global__ void __launch_bounds__(wgw::kThreads, 1)
conv_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap dwmap,
                        WgradBoxes p) {
  // (the forward's mma.sync tile constants share the names)
  constexpr int STAGES = wgw::STAGES, STAGE = wgw::STAGE, BOX = wgw::BOX;
  constexpr int PIX = wgw::PIX;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  bf16* stage_out = reinterpret_cast<bf16*>(base + STAGES * STAGE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + STAGES * STAGE + 2 * wgw::OUT);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);   // both consumer warpgroups
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int tiles = p.tiles_n * p.tiles_m * p.splits;

  if (grp == 0) {
    // ---- producer: one thread streams every tile's boxes ----
    hop::regs_dec<40>();
    if (tid != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const WgradTile w = wgrad_tile(p, t);
      int bc[2], br[2], bs[2];          // the B boxes' channel and tap
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w.n0 + 64 * h, tap = col / p.I;
        bc[h] = col - tap * p.I;
        br[h] = tap / p.kw;
        bs[h] = tap - br[h] * p.kw;
      }
      for (int st = w.st0; st < w.st1; ++st, ++it) {
        const int s = it % STAGES;
        hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int row = st / p.tiles_x;
        const int x0 = (st - row * p.tiles_x) * p.bw;
        const int y0 = (row % p.tiles_y) * p.bh;
        const int b0 = row / p.tiles_y * p.bb;
        unsigned char* stg = base + s * STAGE;
        hop::mbar_expect_tx(&full[s], (w.na + w.nb) * BOX);
        for (int h = 0; h < w.na; ++h)
          hop::tma_load_4d(stg + h * BOX, &dymap, &full[s], w.m0 + 64 * h,
                           x0, y0, b0);
        // at stride 2 the map walks every other pixel (its traversal
        // strides): the box starts at the tap's first source pixel
        for (int h = 0; h < w.nb; ++h)
          hop::tma_load_4d(stg + (2 + h) * BOX, &xmap, &full[s], bc[h],
                           x0 * p.sw + bs[h] - p.pl,
                           y0 * p.sh + br[h] - p.pt, b0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows m0 + 64 cw .. of each tile ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lt = tid % 128, lane = lt % 32, warp = lt / 32;
  const int g = lane / 4, q = lane % 4;
  const int64_t total = (int64_t)p.O * p.Kn;
  bf16* so = stage_out + cw * (wgw::OUT / 2);   // [2 boxes][64][64]
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WgradTile w = wgrad_tile(p, t);
    const bool mine = cw < w.na;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    hop::fence_regs<64>(acc);
    int prev = -1;
#pragma unroll 1
    for (int st = w.st0; st < w.st1; ++st, ++it) {
      const int s = it % STAGES;
      const unsigned char* stg = base + s * STAGE;
      hop::mbar_wait(&full[s], (it / STAGES) & 1);
      if (mine) {
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PIX / 16; ++kk) {
          // both MN-major: 16 pixel rows (2048 bytes) a k16 step; B's two
          // 64-column boxes BOX apart (LBO)
          const uint64_t da = hop::desc_sw128(stg + cw * BOX + kk * 2048);
          const uint64_t db =
              hop::desc_sw128(stg + 2 * BOX + kk * 2048, BOX);
          hop::wgmma_m64n128k16_ss_t<1, 1>(acc, da, db);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();        // the previous stage's products
      }
      if (prev >= 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
    }
    if (mine) hop::wgmma_wait<0>();
    hop::fence_regs<64>(acc);
    if (prev >= 0) hop::mbar_arrive(&empty[prev]);
    if (!mine) continue;

    if (p.tma_store) {
      // ---- epilogue: bf16 into this warpgroup's staging (128-byte
      // swizzle, as the map's), the last tile's stores done reading it,
      // then one TMA store a 64-column box ----
      if (lt == 0) hop::bulk_wait_read();
      hop::bar_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        bf16* box = so + (j / 8) * (64 * 64);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + g + 8 * h;
          *reinterpret_cast<uint32_t*>(
              box + row * 64 + (((j % 8) ^ (row % 8)) * 8) + 2 * q) =
              dft::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      hop::fence_proxy_async();
      hop::bar_sync(1 + cw, 128);
      if (lt == 0) {
        for (int h = 0; h < w.nb; ++h)
          hop::tma_store_4d(&dwmap, so + h * (64 * 64), w.n0 + 64 * h,
                            w.m0 + 64 * cw, 0, 0);
        hop::bulk_commit();
      }
      continue;
    }
    // ---- epilogue: fp32 dW or this split's partial, two columns a store
    // (Kn and the column even) ----
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = w.n0 + 8 * j + 2 * q;
      if (col >= p.Kn) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = w.m0 + 64 * cw + warp * 16 + g + 8 * h;
        if (o >= p.O) continue;
        const int64_t idx = (int64_t)o * p.Kn + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (p.splits > 1)
          *reinterpret_cast<float2*>(p.ws + w.split * total + idx) =
              make_float2(v0, v1);
        else if (p.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.dw) + idx) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dw) + idx) =
              dft::pack_bf16(v0, v1);
      }
    }
  }
  if (lt == 0) hop::bulk_wait();     // stores done before the block ends
}

// ---------------------------------------------------------------------------
// the conv_ins' bf16 weight gradient on wgmma (see the note above)
// ---------------------------------------------------------------------------

namespace wgn {
constexpr int BM = 128, kThreads = 384, STAGES = 8;
constexpr int PIX = 64;                        // pixels a step (a box)
constexpr int TAPS = 9;                        // B's columns: 9 taps x 8 = 72
constexpr int NCOL = TAPS * 8;
constexpr int DYBOX = PIX * 64 * 2;            // dy's [64 pixels][64 o]: 8 KB
constexpr int XTAP = PIX * 16;                 // x's [64 pixels][8]: 1 KB
constexpr int STAGE = 2 * DYBOX + TAPS * XTAP;   // 25 KB
constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE +
                         2 * STAGES * sizeof(uint64_t);
static_assert(kSmem <= 232448, "shared memory");
static_assert(STAGE % 1024 == 0, "stages on swizzle-atom boundaries");
}  // namespace wgn

struct WgradNarrow {
  int O, I, taps, kw, pt, pl;
  int bw, bh, bb;                // a step's pixel box (bw * bh * bb = 64)
  int tiles_x, tiles_y, steps;   // the boxes over [B, Ho, Wo]
  int tiles_m, splits, out_f32;
  float* ws;                     // [splits][O][72] when splits > 1
  void* dw;                      // [O][taps * I]
};

// Block (128-channel tile of O, split) walks its split's 64-pixel boxes.
// Per box the producer thread copies dy's [64 pixels][64 o] (A = dyᵀ,
// MN-major, 128-byte swizzle) for each 64 rows of the tile and x's
// [64 pixels][8 channels] at each tap (B, MN-major without swizzle: one
// 1 KB box a tap from a map over x padded to 8 channels, whose zero fill
// is the conv's padding and the ragged box), through an 8-stage ring.
// Consumer warpgroup cw runs wgmma m64n72k16 on rows 64 cw .. of the tile
// (4 k16 steps a box; none where they are past O), then writes its split's
// partial [64 o][72] in fp32, or with one split dW itself without the
// padded channels.
__global__ void __launch_bounds__(wgn::kThreads, 1)
conv_wgrad_wgmma_i8_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap dymap,
                           WgradNarrow p) {
  constexpr int STAGES = wgn::STAGES, STAGE = wgn::STAGE;
  constexpr int DYBOX = wgn::DYBOX, XTAP = wgn::XTAP, NCOL = wgn::NCOL;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);   // both consumer warpgroups
    }
    hop::mbar_fence_init();
  }
  // B's columns past the conv's taps are never loaded: zero them once
  // (0 x stale bits may be NaN)
  for (int s = 0; s < STAGES; ++s) {
    uint4* xs = reinterpret_cast<uint4*>(base + s * STAGE + 2 * DYBOX);
    for (int i = p.taps * XTAP / 16 + tid; i < wgn::TAPS * XTAP / 16;
         i += wgn::kThreads)
      xs[i] = make_uint4(0, 0, 0, 0);
  }
  hop::fence_proxy_async();
  __syncthreads();

  const int m0 = (blockIdx.x % p.tiles_m) * wgn::BM;
  const int split = blockIdx.x / p.tiles_m;
  const int st0 = (int)((int64_t)p.steps * split / p.splits);
  const int st1 = (int)((int64_t)p.steps * (split + 1) / p.splits);
  // dy's second box wholly past O is not loaded: its rows are not stored
  const int na = m0 + 64 < p.O ? 2 : 1;

  if (grp == 0) {
    // ---- producer: one thread streams the split's boxes ----
    hop::regs_dec<40>();
    if (tid != 0) return;
    for (int st = st0; st < st1; ++st) {
      const int n = st - st0, s = n % STAGES;
      hop::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      const int row = st / p.tiles_x;
      const int x0 = (st - row * p.tiles_x) * p.bw;
      const int y0 = (row % p.tiles_y) * p.bh;
      const int b0 = row / p.tiles_y * p.bb;
      unsigned char* stg = base + s * STAGE;
      hop::mbar_expect_tx(&full[s], na * DYBOX + p.taps * XTAP);
      for (int h = 0; h < na; ++h)
        hop::tma_load_4d(stg + h * DYBOX, &dymap, &full[s], m0 + 64 * h, x0,
                         y0, b0);
      for (int t = 0; t < p.taps; ++t) {
        const int r = t / p.kw, u = t - r * p.kw;
        hop::tma_load_4d(stg + 2 * DYBOX + t * XTAP, &xmap, &full[s], 0,
                         x0 + u - p.pl, y0 + r - p.pt, b0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows m0 + 64 cw .. of the tile ----
  // (where they are past O its products read the stage's unloaded second
  // dy box and are not stored: no branch around the wgmmas, which ptxas
  // would serialize)
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lt = tid % 128, lane = lt % 32, warp = lt / 32;
  const int g = lane / 4, q = lane % 4;
  float acc[NCOL / 2];
#pragma unroll
  for (int e = 0; e < NCOL / 2; ++e) acc[e] = 0.f;
  hop::fence_regs<NCOL / 2>(acc);
  int prev = -1;
#pragma unroll 1
  for (int st = st0; st < st1; ++st) {
    const int n = st - st0, s = n % STAGES;
    const unsigned char* stg = base + s * STAGE;
    // A: 16 pixel rows (2048 bytes) a k16 step; B: the two 8-pixel core
    // matrices of a step 128 bytes apart (LBO), the taps 1 KB apart (SBO)
    const uint64_t da = hop::desc_sw128(stg + cw * DYBOX);
    const uint64_t db = hop::desc_plain(stg + 2 * DYBOX, 128, XTAP);
    hop::mbar_wait(&full[s], (n / STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < wgn::PIX / 16; ++kk)
      hop::wgmma_m64n72k16_ss_t<1, 1>(acc, da + kk * (2048 >> 4),
                                      db + kk * (256 >> 4));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();            // the previous box's products
    if (prev >= 0) hop::mbar_arrive(&empty[prev]);
    prev = s;
  }
  hop::wgmma_wait<0>();
  hop::fence_regs<NCOL / 2>(acc);
  if (prev >= 0) hop::mbar_arrive(&empty[prev]);
  if (cw >= na) return;

  // ---- epilogue: column 8 t + c is tap t's channel c ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = m0 + 64 * cw + warp * 16 + g + 8 * h;
    if (o >= p.O) continue;
#pragma unroll
    for (int t = 0; t < wgn::TAPS; ++t) {
      const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
      if (p.splits > 1) {
        *reinterpret_cast<float2*>(p.ws + ((int64_t)split * p.O + o) * NCOL +
                                   8 * t + 2 * q) = make_float2(v0, v1);
        continue;
      }
      if (t >= p.taps) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * q + e;
        if (c >= p.I) continue;
        const int64_t i = ((int64_t)o * p.taps + t) * p.I + c;
        const float v = e ? v1 : v0;
        if (p.out_f32)
          static_cast<float*>(p.dw)[i] = v;
        else
          static_cast<bf16*>(p.dw)[i] = __float2bfloat16(v);
      }
    }
  }
}

// dW[o, t, c] = sum over splits of the partials' column 8 t + c, in split
// order, in dW's dtype (the padded channels dropped)
__global__ void conv_wgrad_i8_reduce_kernel(const float* __restrict__ ws,
                                            void* dw, int O, int taps, int I,
                                            int splits, int out_f32) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)O * taps * I) return;
  const int o = (int)(idx / (taps * I));
  const int rem = (int)(idx - (int64_t)o * taps * I);
  const int t = rem / I, c = rem - t * I;
  const int64_t src = (int64_t)o * wgn::NCOL + 8 * t + c;
  const int64_t stride = (int64_t)O * wgn::NCOL;
  float v = 0.f;
#pragma unroll 32    // loads ahead of the ordered adds
  for (int s = 0; s < splits; ++s) v += ws[s * stride + src];
  if (out_f32)
    static_cast<float*>(dw)[idx] = v;
  else
    static_cast<bf16*>(dw)[idx] = __float2bfloat16(v);
}

}  // namespace

// y[B,Ho,Wo,O] = conv(x[B,H,W,I], w[O,kh,kw,I]) + bias; top/left padding
// pt/pl (bottom/right padding only sets Ho/Wo).  bf16 x and w with I % 8
// == 0 (ops/conv.py pads narrower inputs with zero channels); out_f32
// selects the output type.  splits > 1 needs ws, fp32 [splits * B*Ho*Wo*O].
extern "C" int conv_fwd_mma(const void* x, const void* w, const float* bias,
                            void* y, int B, int H, int W, int I, int Ho,
                            int Wo, int O, int kh, int kw, int sh, int sw,
                            int pt, int pl, int out_f32, int splits,
                            float* ws, cudaStream_t stream) {
  ConvParams p{x, w, bias, y, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl,
               out_f32, splits, ws};
  return launch_conv<false>(p, stream);
}

// dx[B,H,W,I] from bf16 dy[B,Ho,Wo,O] and the transposed weight
// wT[I,kh,kw,O]; splits and ws as for conv_fwd_mma (ws [splits * B*H*W*I]).
extern "C" int conv_dgrad(const void* dy, const void* wT, void* dx, int B,
                          int H, int W, int I, int Ho, int Wo, int O, int kh,
                          int kw, int sh, int sw, int pt, int pl, int out_f32,
                          int splits, float* ws, cudaStream_t stream) {
  ConvParams p{dy, wT, nullptr, dx, B, Ho, Wo, O, H, W, I, kh, kw, sh, sw,
               pt, pl, out_f32, splits, ws};
  return launch_conv<true>(p, stream);
}

// The Hopper route: y[B,Ho,Wo,O] = conv(x[B,H,W,I], w[O,kh,kw,I]) + bias at
// stride sh, sw (1 or 2), bf16 x and w, I % 64 == 0; the tile is a box of
// bw x bh x bb output pixels (product 128; bw * sw and bh * sh at most
// 256, TMA's box limit) by bn (128 or 64) output channels; persistent
// blocks on at most `sms` multiprocessors.  splits > 1 needs ws, fp32
// [splits * B*Ho*Wo*O].
extern "C" int conv_fwd_wgmma(const void* x, const void* w, const float* bias,
                              void* y, int B, int H, int W, int I, int Ho,
                              int Wo, int O, int kh, int kw, int sh, int sw,
                              int pt, int pl, int bw, int bh, int bb, int bn,
                              int out_f32, int splits, int sms, float* ws,
                              cudaStream_t stream) {
  if (I % wg::BK || bw * bh * bb != wg::BM || (bn != 128 && bn != 64) ||
      splits < 1 || sms < 1 || sh < 1 || sh > 2 || sw < 1 || sw > 2 ||
      bw * sw > 256 || bh * sh > 256 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Ho * Wo == 0 || O == 0) return (int)cudaGetLastError();
  CUtensorMap xmap, wmap;
  // x [B, H, W, C]: one tap's A tile is a box of bw x bh x bb pixels,
  // every sw-th along W and sh-th along H (the map's traversal strides)
  const cuuint64_t xd[4] = {(cuuint64_t)I, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)I * 2, (cuuint64_t)W * I * 2,
                            (cuuint64_t)H * W * I * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::BK, (cuuint32_t)(bw * sw),
                             (cuuint32_t)(bh * sh), (cuuint32_t)bb};
  const cuuint32_t elem[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  const cuuint64_t K = (cuuint64_t)kh * kw * I;
  const cuuint64_t wd[2] = {K, (cuuint64_t)O};
  const cuuint64_t wst[1] = {K * 2};
  const cuuint32_t wb[2] = {(cuuint32_t)wg::BK, (cuuint32_t)bn};
  if (!hop::encode_bf16_map(&xmap, x, 4, xd, xs, box, elem) ||
      !hop::encode_bf16_map(&wmap, w, 2, wd, wst, wb))
    return (int)cudaErrorInvalidValue;
  WgConv p{};
  p.B = B; p.Ho = Ho; p.Wo = Wo; p.O = O;
  p.C = I; p.sh = sh; p.sw = sw; p.taps = kh * kw;
  p.bw = bw; p.bh = bh; p.bb = bb;
  forward_class(p, pt, pl, kw, (int)(K / wg::BK));
  p.splits = splits;
  p.bias = bias; p.y = y; p.out_f32 = out_f32;
  p.ws = ws;
  return bn == 128 ? launch_wgmma<false, 128>(xmap, wmap, p, sms, stream)
                   : launch_wgmma<false, 64>(xmap, wmap, p, sms, stream);
}

// The narrow-input Hopper route (the 3- and 4-channel conv_ins): the same
// at stride 1 for x [B,H,W,I], I <= 8, kh*kw <= 10 taps, bn 128 or 64, and
// the weight packed as [ceil(O/bn)][10][bn][8] (chunk t = tap t's channels,
// zero past the taps, past I and past O).  xp is scratch of at least
// B*Hp*Wp + 256 rows of 16 bytes (Hp = Ho+kh-1, Wp = Wo+kw-1): x padded,
// and slack for the ragged box's reads past the last row.
extern "C" int conv_fwd_wgmma_i8(const void* x, void* xp, const void* w,
                                 const float* bias, void* y, int B, int H,
                                 int W, int I, int Ho, int Wo, int O, int kh,
                                 int kw, int pt, int pl, int bw, int bh,
                                 int bb, int bn, int out_f32, int sms,
                                 cudaStream_t stream) {
  if (kh * kw > wg::NARROW_K || bw * bh * bb != wg::BM || I < 1 || I > 8 ||
      (bn != 128 && bn != 64) || sms < 1)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Ho * Wo == 0 || O == 0) return (int)cudaGetLastError();
  WgConv p{};
  p.B = B; p.Ho = Ho; p.Wo = Wo; p.O = O;
  p.C = 8; p.sh = 1; p.sw = 1; p.taps = kh * kw;
  p.bw = bw; p.bh = bh; p.bb = bb;
  forward_class(p, 0, 0, kw, 1);
  p.xp = static_cast<const unsigned char*>(xp);
  p.wp = static_cast<const unsigned char*>(w);
  p.Hp = Ho + kh - 1;
  p.Wp = Wo + kw - 1;
  p.splits = 1;
  p.bias = bias; p.y = y; p.out_f32 = out_f32;
  p.ws = nullptr;
  const int64_t padded = (int64_t)B * p.Hp * p.Wp;
  pad_channels8_kernel<<<(unsigned)((padded + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<uint4*>(xp), B, H, W, I, p.Hp,
      p.Wp, pt, pl);
  CUtensorMap none;                  // x and w go by plain bulk copies
  memset(&none, 0, sizeof none);
  return bn == 128 ? launch_wgmma<true, 128>(none, none, p, sms, stream)
                   : launch_wgmma<true, 64>(none, none, p, sms, stream);
}

// The narrow fp32 route: fp32 x and w, O <= 8, I % 4 == 0, any stride and
// padding (top/left pt/pl as for conv_fwd_mma).
extern "C" int conv_fwd_fp32(const void* x, const void* w, const float* bias,
                             void* y, int B, int H, int W, int I, int Ho,
                             int Wo, int O, int kh, int kw, int sh, int sw,
                             int pt, int pl, int out_f32,
                             cudaStream_t stream) {
  if (O > kNarrowO || O < 1 || I % 4) return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)B * Ho * Wo;
  if (M == 0) return (int)cudaGetLastError();
  ConvParams p{x, w, bias, y, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl,
               out_f32, 1, nullptr};
  conv_narrow_kernel<<<(unsigned)((M + 7) / 8), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The fp32 tiled route: fp32 x and w (I % 4 == 0 copies 16 bytes, else 4;
// with 16 bytes x and w must be 16-byte aligned), any stride and top/left
// padding pt/pl as for conv_fwd_mma; output tiles of 128 pixels x bn
// channels (32 or 64); splits > 1 needs ws, fp32 [splits * B*Ho*Wo*O],
// summed in split order with the bias added.
extern "C" int conv_fwd_fp32_tiled(const void* x, const void* w,
                                   const float* bias, void* y, int B, int H,
                                   int W, int I, int Ho, int Wo, int O,
                                   int kh, int kw, int sh, int sw, int pt,
                                   int pl, int bn, int out_f32, int splits,
                                   float* ws, cudaStream_t stream) {
  if ((bn != 32 && bn != 64) || splits < 1 || sh < 1 ||
      sw < 1 || I < 1 || kh < 1 || kw < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Ho * Wo == 0 || O == 0) return (int)cudaGetLastError();
  const ConvParams p{x, w, bias, y, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                     pt, pl, out_f32, splits, ws};
  return bn == 64 ? launch_fp32_tiled_bn<64>(p, stream)
                  : launch_fp32_tiled_bn<32>(p, stream);
}

// The fp32 tiled input gradient: dx[B,H,W,I] from dy[B,Ho,Wo,O] (fp32; with
// O % 4 == 0, 16-byte aligned dy and wp) of a conv at any strides sh, sw
// with top/left padding pt, pl, as its sh*sw parity classes in one launch
// (the dgrad note above) on the tiled forward's design.  wp is the weight
// packed per class, [sh*sw*I, kmax] with kmax % 4 == 0
// (ops/conv.py::pack_dgrad_weight).  Tiles of 128 pixels of a class x bn
// (32 or 64) channels of dx; splits > 1 needs ws, fp32 [splits * B*H*W*I],
// summed in split order (a class without taps writes its zeros there too).
extern "C" int conv_dgrad_fp32_tiled(const void* dy, const void* wp,
                                     void* dx, int B, int H, int W, int I,
                                     int Ho, int Wo, int O, int kh, int kw,
                                     int sh, int sw, int pt, int pl,
                                     int kmax, int bn, int splits,
                                     float* ws, cudaStream_t stream) {
  if ((bn != 32 && bn != 64) || splits < 1 || sh < 1 || sw < 1 || O < 1 ||
      kh < 1 || kw < 1 || kmax < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int py = 0; py < sh; ++py)
    for (int px = 0; px < sw; ++px) {
      const int r0 = (py + pt) % sh, s0 = (px + pl) % sw;
      const int nt = r0 < kh ? (kh - r0 + sh - 1) / sh : 0;
      const int nu = s0 < kw ? (kw - s0 + sw - 1) / sw : 0;
      if ((int64_t)nt * nu * O > kmax) return (int)cudaErrorInvalidValue;
    }
  if ((int64_t)B * H * W == 0 || I == 0) return (int)cudaGetLastError();
  const ConvParams p{dy, wp, nullptr, dx, B, Ho, Wo, O, H, W, I, kh, kw, sh,
                     sw, pt, pl, 1, splits, ws};
  return bn == 64 ? launch_dgrad_fp32_tiled_bn<64>(p, kmax, stream)
                  : launch_dgrad_fp32_tiled_bn<32>(p, kmax, stream);
}

// The Hopper route of the input gradient: dx[B,H,W,I] from dy[B,Ho,Wo,O]
// (bf16, O % 64 == 0) of a conv at strides sh, sw (1 or 2) with top/left
// padding pt, pl, as its sh*sw parity classes in one launch (the dgrad note
// above).  wp is the weight packed per class, [sh*sw*I, kmax] with kmax a
// multiple of 64 (ops/conv.py::pack_dgrad_weight): row c*I + i, column
// (t*nu + u)*O + o holds w[o, r0 + sh*(nt-1-t), s0 + sw*(nu-1-u), i], zero
// past the class's nt x nu taps.  A tile is bw x bh x bb pixels of a class's
// grid (product 128) by bn (128) channels of dx; persistent blocks on
// at most `sms` multiprocessors; splits > 1 needs ws, fp32
// [splits * B*H*W*I].
extern "C" int conv_dgrad_wgmma(const void* dy, const void* wp, void* dx,
                                int B, int H, int W, int I, int Ho, int Wo,
                                int O, int kh, int kw, int sh, int sw, int pt,
                                int pl, int kmax, int bw, int bh, int bb,
                                int bn, int out_f32, int splits, int sms,
                                float* ws, cudaStream_t stream) {
  if (O % wg::BK || kmax % wg::BK || kmax < wg::BK ||
      bw * bh * bb != wg::BM || bw > 256 || bh > 256 ||
      bn != 128 || splits < 1 || sms < 1 || sh < 1 || sh > 2 || sw < 1 ||
      sw > 2 || sh * sw > kMaxClasses ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0 || I == 0) return (int)cudaGetLastError();
  WgConv p{};
  p.B = B; p.Ho = H; p.Wo = W; p.O = I;
  p.C = O; p.sh = 1; p.sw = 1;       // each class walks dy at stride 1
  p.ystep = sh; p.xstep = sw;
  p.bw = bw; p.bh = bh; p.bb = bb;
  p.classes = sh * sw;
  for (int cls = 0; cls < p.classes; ++cls) {
    const int py = cls / sw, px = cls % sw;
    const int r0 = (py + pt) % sh, s0 = (px + pl) % sw;
    const int nt = r0 < kh ? (kh - r0 + sh - 1) / sh : 0;
    const int nu = s0 < kw ? (kw - s0 + sw - 1) / sw : 0;
    if ((int64_t)nt * nu * O > kmax) return (int)cudaErrorInvalidValue;
    WgClass& c = p.cls[cls];
    c.Hc = H > py ? (H - py + sh - 1) / sh : 0;
    c.Wc = W > px ? (W - px + sw - 1) / sw : 0;
    c.py = py; c.px = px;
    // dx pixel (cy, cx) reads dy (cy + oy - t, cx + ox - u) at tap (t, u) of
    // the flipped sub-kernel: as a forward conv, source offset nt - 1 - oy
    c.pt = nt - 1 - (py + pt - r0) / sh;
    c.pl = nu - 1 - (px + pl - s0) / sw;
    c.nu = nu > 0 ? nu : 1;
    c.kblocks = nt * nu * O / wg::BK;
    c.wrow = cls * I;
  }
  CUtensorMap xmap, wmap;
  // dy [B, Ho, Wo, O]: one tap's A tile is a box of bw x bh x bb pixels
  const cuuint64_t xd[4] = {(cuuint64_t)O, (cuuint64_t)Wo, (cuuint64_t)Ho,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)O * 2, (cuuint64_t)Wo * O * 2,
                            (cuuint64_t)Ho * Wo * O * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::BK, (cuuint32_t)bw,
                             (cuuint32_t)bh, (cuuint32_t)bb};
  const cuuint64_t wd[2] = {(cuuint64_t)kmax, (cuuint64_t)p.classes * I};
  const cuuint64_t wst[1] = {(cuuint64_t)kmax * 2};
  const cuuint32_t wb[2] = {(cuuint32_t)wg::BK, (cuuint32_t)bn};
  if (!hop::encode_bf16_map(&xmap, dy, 4, xd, xs, box) ||
      !hop::encode_bf16_map(&wmap, wp, 2, wd, wst, wb))
    return (int)cudaErrorInvalidValue;
  p.splits = splits;
  p.bias = nullptr; p.y = dx; p.out_f32 = out_f32;
  p.ws = ws;
  return launch_wgmma<false, 128, true>(xmap, wmap, p, sms, stream);
}

// The narrow input gradient (the VAE conv_in's): dx[B,H,W,I] from
// dy[B,Ho,Wo,O] (bf16) at stride 1, top/left padding pt, pl; I <= 8, O <=
// 256 with O % 32 == 0, kh, kw <= 3; wf is the weight as B fragments
// (ops/conv.py::pack_dgrad_narrow_weight).  Grid: at most `sms` * 8 blocks
// of 4 warps, a warp 16 pixels at a time.
extern "C" int conv_dgrad_narrow(const void* dy, const void* wf, void* dx,
                                 int B, int H, int W, int I, int Ho, int Wo,
                                 int O, int kh, int kw, int pt, int pl,
                                 int out_f32, int sms, cudaStream_t stream) {
  if (I < 1 || I > kDxNarrowI || O < 32 || O > kDxNarrowO || O % 32 ||
      kh < 1 || kh > kDxNarrowK || kw < 1 || kw > kDxNarrowK || sms < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t tasks = (int64_t)B * H * ((W + 15) / 16);
  if (tasks == 0) return (int)cudaGetLastError();
  const int64_t want = (tasks + kDxNarrowWarps - 1) / kDxNarrowWarps;
  const unsigned grid =
      (unsigned)(want < (int64_t)sms * 8 ? want : (int64_t)sms * 8);
  conv_dgrad_narrow_kernel<<<grid, kDxNarrowWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const uint4*>(wf), dx, B, H,
      W, I, Ho, Wo, O, kh, kw, pt, pl, out_f32);
  return (int)cudaGetLastError();
}

// The fp32 input gradient of the narrow convs (the conv_outs'): dx[B,H,W,I]
// from dy[B,Ho,Wo,O] and w[O,kh,kw,I] (fp32, as the forward's), any stride
// and top/left padding pt, pl; O <= 8, I % 4 == 0.
extern "C" int conv_dgrad_fp32(const void* dy, const void* w, void* dx, int B,
                               int H, int W, int I, int Ho, int Wo, int O,
                               int kh, int kw, int sh, int sw, int pt, int pl,
                               cudaStream_t stream) {
  if (O < 1 || O > kDxFp32O || I % 4 || sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)B * H *
                          ((W + kDxFp32Pix - 1) / kDxFp32Pix) * (I / 4);
  if (threads == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const float* d = static_cast<const float*>(dy);
  const float* wt = static_cast<const float*>(w);
  float* x = static_cast<float*>(dx);
  const bool s1 = sh == 1 && sw == 1, vec = O % 4 == 0;
  if (s1 && vec)
    conv_dgrad_fp32_kernel<true, true><<<blocks, 256, 0, stream>>>(
        d, wt, x, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl);
  else if (s1)
    conv_dgrad_fp32_kernel<true, false><<<blocks, 256, 0, stream>>>(
        d, wt, x, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl);
  else if (vec)
    conv_dgrad_fp32_kernel<false, true><<<blocks, 256, 0, stream>>>(
        d, wt, x, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl);
  else
    conv_dgrad_fp32_kernel<false, false><<<blocks, 256, 0, stream>>>(
        d, wt, x, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl);
  return (int)cudaGetLastError();
}

// Arguments every weight-gradient route refuses; else 0.
static int wgrad_invalid(const WgradParams& p) {
  return p.splits < 1 || (p.splits > 1 && p.ws == nullptr) || p.sh < 1 ||
         p.sw < 1 || p.kh < 1 || p.kw < 1;
}

// dW has no element
static bool wgrad_empty(const WgradParams& p) {
  return (int64_t)p.O * p.kh * p.kw * p.I == 0;
}

// The weight gradient dW[O,kh,kw,I] (out_f32: fp32, else bf16) of a conv of
// x[B,H,W,I] with output gradient dy[B,Ho,Wo,O] at strides sh, sw and
// top/left padding pt, pl: bf16 x and dy on the tensor cores (16-byte
// aligned where I % 8 == 0, O % 8 == 0).  With splits > 1, ws fp32
// [splits * O*kh*kw*I]: each split's partial sums over its share of the
// B*Ho*Wo pixels, summed in split order into dW.
extern "C" int conv_wgrad_mma(const void* x, const void* dy, void* dw,
                              float* ws, int B, int H, int W, int I, int Ho,
                              int Wo, int O, int kh, int kw, int sh, int sw,
                              int pt, int pl, int out_f32, int splits,
                              cudaStream_t stream) {
  const WgradParams p{x, dy, ws, dw, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                      pt, pl, splits, out_f32};
  if (wgrad_invalid(p)) return (int)cudaErrorInvalidValue;
  if (wgrad_empty(p)) return (int)cudaGetLastError();
  return launch_wgrad_mma(p, stream);
}

// The same for fp32 x and dy on the CUDA cores, any I and O (16-byte
// aligned x and dy where I % 4 == 0 and O % 4 == 0), dW in fp32, as a
// tiled GEMM of bn (8, 32 or 64) output channels by 512, 128 or 128
// columns.
extern "C" int conv_wgrad_fp32_tiled(const void* x, const void* dy,
                                     void* dw, float* ws, int B, int H,
                                     int W, int I, int Ho, int Wo, int O,
                                     int kh, int kw, int sh, int sw, int pt,
                                     int pl, int bn, int splits,
                                     cudaStream_t stream) {
  const WgradParams p{x, dy, ws, dw, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                      pt, pl, splits, 1};
  if (wgrad_invalid(p) || (bn != 8 && bn != 32 && bn != 64))
    return (int)cudaErrorInvalidValue;
  if (wgrad_empty(p)) return (int)cudaGetLastError();
  return bn == 64   ? launch_wgrad_fp32_tiled_bn<64>(p, stream)
         : bn == 32 ? launch_wgrad_fp32_tiled_bn<32>(p, stream)
                    : launch_wgrad_fp32_tiled_bn<8>(p, stream);
}

// The bf16 weight gradient on wgmma: x[B,H,W,I] and dy[B,Ho,Wo,O] bf16,
// 16-byte aligned, I % 64 == 0, O % 8 == 0, strides 1 or 2; the pixels in
// boxes of bw x bh x bb of the output grid (product 64; bw * sw and
// bh * sh at most 256, TMA's box limit), splits as for conv_wgrad_mma;
// persistent blocks on at most `sms` multiprocessors.
extern "C" int conv_wgrad_wgmma(const void* x, const void* dy, void* dw,
                                float* ws, int B, int H, int W, int I,
                                int Ho, int Wo, int O, int kh, int kw,
                                int sh, int sw, int pt, int pl, int bw,
                                int bh, int bb, int out_f32, int splits,
                                int sms, cudaStream_t stream) {
  const WgradParams q{x, dy, ws, dw, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw,
                      pt, pl, splits, out_f32};
  if (wgrad_invalid(q) || I % 64 || O % 8 || sh > 2 || sw > 2 ||
      bw * bh * bb != wgw::PIX || bw * sw > 256 || bh * sh > 256 ||
      bb > 256 || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (wgrad_empty(q)) return (int)cudaGetLastError();
  const int64_t total = (int64_t)O * kh * kw * I;
  if ((int64_t)B * Ho * Wo == 0)     // no pixel: dW is zero
    return (int)cudaMemsetAsync(dw, 0, total * (out_f32 ? 4 : 2), stream);
  CUtensorMap xmap, dymap;
  // x [B, H, W, I]: a box of bw x bh x bb pixels, every sw-th along W and
  // sh-th along H (the map's traversal strides); dy [B, Ho, Wo, O]
  const cuuint64_t xd[4] = {(cuuint64_t)I, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)I * 2, (cuuint64_t)W * I * 2,
                            (cuuint64_t)H * W * I * 2};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)(bw * sw),
                              (cuuint32_t)(bh * sh), (cuuint32_t)bb};
  const cuuint32_t elem[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  const cuuint64_t dd[4] = {(cuuint64_t)O, (cuuint64_t)Wo, (cuuint64_t)Ho,
                            (cuuint64_t)B};
  const cuuint64_t ds[3] = {(cuuint64_t)O * 2, (cuuint64_t)Wo * O * 2,
                            (cuuint64_t)Ho * Wo * O * 2};
  const cuuint32_t dbox[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh,
                              (cuuint32_t)bb};
  if (!hop::encode_bf16_map(&xmap, x, 4, xd, xs, xbox, elem) ||
      !hop::encode_bf16_map(&dymap, dy, 4, dd, ds, dbox))
    return (int)cudaErrorInvalidValue;
  CUtensorMap dwmap;                 // dW [O, Kn] bf16: [64][64] boxes
  memset(&dwmap, 0, sizeof dwmap);   // unused without TMA stores
  const int tma_store = !out_f32 && splits == 1;
  const cuuint64_t Kn = (cuuint64_t)kh * kw * I;
  const cuuint64_t wd[4] = {Kn, (cuuint64_t)O, 1, 1};
  const cuuint64_t wst[3] = {Kn * 2, Kn * O * 2, Kn * O * 2};
  const cuuint32_t wbox[4] = {64, 64, 1, 1};
  if (tma_store && !hop::encode_bf16_map(&dwmap, dw, 4, wd, wst, wbox))
    return (int)cudaErrorInvalidValue;
  WgradBoxes p{};
  p.O = O; p.I = I; p.Kn = kh * kw * I; p.kw = kw;
  p.sh = sh; p.sw = sw; p.pt = pt; p.pl = pl;
  p.bw = bw; p.bh = bh; p.bb = bb;
  p.tiles_x = (Wo + bw - 1) / bw;
  p.tiles_y = (Ho + bh - 1) / bh;
  p.steps = p.tiles_x * p.tiles_y * ((B + bb - 1) / bb);
  p.tiles_n = (p.Kn + wgw::BN - 1) / wgw::BN;
  p.tiles_m = (O + wgw::BM - 1) / wgw::BM;
  p.splits = splits; p.out_f32 = out_f32; p.tma_store = tma_store;
  p.ws = ws; p.dw = dw;
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err = hop::allow_smem(conv_wgrad_wgmma_kernel,
                                          (int)wgw::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = p.tiles_n * p.tiles_m * splits;
  conv_wgrad_wgmma_kernel<<<tiles < sms ? tiles : sms, wgw::kThreads,
                            wgw::kSmem, stream>>>(xmap, dymap, dwmap, p);
  wgrad_reduce(q, stream);
  return (int)cudaGetLastError();
}

// The conv_ins' bf16 weight gradient on wgmma: x[B,H,W,I] with I <= 8,
// dy[B,Ho,Wo,O] with O % 8 == 0 (16-byte aligned), stride 1, top/left
// padding pt, pl, kh * kw <= 9 taps; the pixels in boxes of bw x bh x bb of
// the output grid (product 64, each at most 256) as for conv_wgrad_wgmma,
// splits over them (ws fp32 [splits * O * 72] when splits > 1).  xp is x
// padded to 8 channels, [B, H, W, 8] (16-byte aligned): written here first
// unless it is x itself (I == 8).
extern "C" int conv_wgrad_wgmma_i8(const void* x, void* xp, const void* dy,
                                   void* dw, float* ws, int B, int H, int W,
                                   int I, int Ho, int Wo, int O, int kh,
                                   int kw, int pt, int pl, int bw, int bh,
                                   int bb, int out_f32, int splits,
                                   cudaStream_t stream) {
  if (I < 1 || I > 8 || O % 8 || kh < 1 || kw < 1 ||
      kh * kw > wgn::TAPS || bw * bh * bb != wgn::PIX || bw > 256 ||
      bh > 256 || bb > 256 || splits < 1 || xp == nullptr ||
      (I < 8 && xp == x) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)O * kh * kw * I;
  if (total == 0) return (int)cudaGetLastError();
  if ((int64_t)B * Ho * Wo == 0)     // no pixel: dW is zero
    return (int)cudaMemsetAsync(dw, 0, total * (out_f32 ? 4 : 2), stream);
  WgradNarrow p{};
  p.O = O; p.I = I; p.taps = kh * kw; p.kw = kw; p.pt = pt; p.pl = pl;
  p.bw = bw; p.bh = bh; p.bb = bb;
  p.tiles_x = (Wo + bw - 1) / bw;
  p.tiles_y = (Ho + bh - 1) / bh;
  p.steps = p.tiles_x * p.tiles_y * ((B + bb - 1) / bb);
  p.tiles_m = (O + wgn::BM - 1) / wgn::BM;
  p.splits = splits; p.out_f32 = out_f32;
  p.ws = ws; p.dw = dw;
  if (splits > p.steps) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, dymap;
  // x [B, H, W, 8]: a box of bw x bh x bb pixels x 8 channels, 16-byte
  // rows, no swizzle; dy [B, Ho, Wo, O]: boxes of 64 channels
  const cuuint64_t xd[4] = {8, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {16, (cuuint64_t)W * 16, (cuuint64_t)H * W * 16};
  const cuuint32_t xbox[4] = {8, (cuuint32_t)bw, (cuuint32_t)bh,
                              (cuuint32_t)bb};
  const cuuint64_t dd[4] = {(cuuint64_t)O, (cuuint64_t)Wo, (cuuint64_t)Ho,
                            (cuuint64_t)B};
  const cuuint64_t ds[3] = {(cuuint64_t)O * 2, (cuuint64_t)Wo * O * 2,
                            (cuuint64_t)Ho * Wo * O * 2};
  const cuuint32_t dbox[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh,
                              (cuuint32_t)bb};
  if (!hop::encode_bf16_map(&xmap, xp, 4, xd, xs, xbox, nullptr,
                            CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hop::encode_bf16_map(&dymap, dy, 4, dd, ds, dbox))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err = hop::allow_smem(conv_wgrad_wgmma_i8_kernel,
                                          (int)wgn::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  if (xp != x) {
    const int64_t pixels = (int64_t)B * H * W;
    pad_channels8_kernel<<<(unsigned)((pixels + 255) / 256), 256, 0,
                           stream>>>(static_cast<const bf16*>(x),
                                     static_cast<uint4*>(xp), B, H, W, I, H,
                                     W, 0, 0);
  }
  conv_wgrad_wgmma_i8_kernel<<<p.tiles_m * splits, wgn::kThreads, wgn::kSmem,
                               stream>>>(xmap, dymap, p);
  if (splits > 1)
    conv_wgrad_i8_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  stream>>>(ws, dw, O, kh * kw, I, splits,
                                            out_f32);
  return (int)cudaGetLastError();
}
