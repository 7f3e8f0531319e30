// K12: NHWC 2-D convolution, forward and input gradient (dgrad).
//
// Replaces dreamfusion_tpu/ops/conv.py::mm_conv (shifted einsums on the TPU
// with a custom_vjp that transposes each einsum).  Here the convolution is an
// implicit GEMM: M = B*Ho*Wo output pixels, N = O output channels,
// K = kh*kw*I (tap, input channel); the A tile is gathered from the NHWC
// input on the fly, so no im2col buffer exists.
//
// Bound on the card: operations at the UNet and VAE shapes (e.g. 512x512x128
// -> 128 at 3x3 is 77 GFLOP over 134 MB of traffic), so the design feeds the
// tensor cores: 128x128x32 tiles in shared memory, filled by 16-byte cp.async
// copies (zero-filled outside the image and past K) in a two-stage ring,
// fragments by ldmatrix, products by mma.sync m16n8k16 bf16 with fp32
// accumulation, bias added in the fp32 epilogue, bf16 or fp32 written.
//
// Weights are [O, kh, kw, I] (I contiguous), so a B tile row is one output
// channel's contiguous K slice.  The MMA path needs I % 8 == 0 (the wrapper
// pads narrower inputs with zero channels).
//
// dgrad.  dx[b, y, x, c] = sum_{r, s, o} dy[b, oh, ow, o] * w[o, r, s, c] with
// y = oh*sh - pt + r.  For stride s > 1 only the taps with
// r = (y + pt) mod sh contribute to a given y, so the dx pixels are split
// into sh*sw parity classes (grid z); in each class the pixel (i, j) at
// y = py + sh*i reads dy at oh = i + (py + pt - r0)/sh - t for tap
// r = r0 + sh*t.  Each class is then an implicit GEMM over only its own taps,
// which scatters a strided (and asymmetrically padded) convolution exactly
// without multiplying by the zeros of a dilated dy.  The weight comes
// transposed to [I, kh, kw, O]; bottom and right padding only shape dy.
//
// Split-K.  The UNet's deep levels have few output tiles and a long K
// (8x8x1280 at CFG batch 2: M = 128, N = 1280, K = 11,520 to 23,040, i.e.
// 10 tiles for 132 SMs), so the wrapper may split K over `splits` blocks
// per tile; each writes fp32 partial sums and a second kernel adds them in
// a fixed order (deterministic), adds the bias and rounds.
//
// fp32 (the conv_out of the UNet and VAE, 4 or 8 channels, a few hundred
// MFLOP each, and their dgrad): one thread per output value, fp32 FMA over
// K.  Narrow bf16 outputs (the 3-channel dgrad of the VAE's conv_in) stay on
// the tensor cores: a 128-wide N tile with 3 live columns still beats CUDA
// cores there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// CUDA-core path: one thread per output value, fp32 FMA
// ---------------------------------------------------------------------------

template <typename T, bool DGRAD>
__global__ void conv_simple_kernel(ConvParams p) {
  const ConvClass cc = conv_class<DGRAD>(p, blockIdx.y);
  const int64_t total = (int64_t)p.B * cc.Hc * cc.Wc * p.N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % p.N;
  const int64_t m = idx / p.N;
  const int cx = m % cc.Wc, cy = (m / cc.Wc) % cc.Hc,
            b = m / ((int64_t)cc.Wc * cc.Hc);
  const T* __restrict__ X = static_cast<const T*>(p.x);
  const T* __restrict__ Wt =
      static_cast<const T*>(p.w) + (int64_t)n * p.KH * p.KW * p.C;
  float acc = 0.f;
  for (int t = 0; t < cc.nt; ++t) {
    for (int u = 0; u < cc.nu; ++u) {
      int sy, sx;
      conv_src<DGRAD>(p, cc, cy, cx, t, u, sy, sx);
      if (sy < 0 || sy >= p.SH || sx < 0 || sx >= p.SW) continue;
      const int r = cc.r0 + cc.rstep * t, s = cc.s0 + cc.sstep * u;
      const T* xp = X + (((int64_t)b * p.SH + sy) * p.SW + sx) * p.C;
      const T* wp = Wt + (int64_t)(r * p.KW + s) * p.C;
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

template <bool DGRAD>
int launch_conv(const ConvParams& p, int is_bf16, cudaStream_t stream) {
  const int classes = DGRAD ? p.sh * p.sw : 1;
  // rows of the largest class (class 0)
  const int Hc = DGRAD ? (p.OH + p.sh - 1) / p.sh : p.OH;
  const int Wc = DGRAD ? (p.OW + p.sw - 1) / p.sw : p.OW;
  const int64_t M = (int64_t)p.B * Hc * Wc;
  if (M == 0 || p.N == 0) return (int)cudaGetLastError();
  if (is_bf16 && p.C % 8 == 0) {
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
  } else {
    const int threads = 256;
    dim3 grid((unsigned)((M * p.N + threads - 1) / threads), classes);
    if (is_bf16)
      conv_simple_kernel<bf16, DGRAD><<<grid, threads, 0, stream>>>(p);
    else
      conv_simple_kernel<float, DGRAD><<<grid, threads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y[B,Ho,Wo,O] = conv(x[B,H,W,I], w[O,kh,kw,I]) + bias; top/left padding
// pt/pl (bottom/right padding only sets Ho/Wo).  is_bf16 selects bf16 x and
// w (else fp32); out_f32 selects the output type.  splits > 1 (tensor-core
// path only) needs ws, fp32 [splits * B*Ho*Wo*O].
extern "C" int conv_fwd(const void* x, const void* w, const float* bias,
                        void* y, int B, int H, int W, int I, int Ho, int Wo,
                        int O, int kh, int kw, int sh, int sw, int pt, int pl,
                        int is_bf16, int out_f32, int splits, float* ws,
                        cudaStream_t stream) {
  ConvParams p{x, w, bias, y, B, H, W, I, Ho, Wo, O, kh, kw, sh, sw, pt, pl,
               out_f32, splits, ws};
  return launch_conv<false>(p, is_bf16, stream);
}

// dx[B,H,W,I] from dy[B,Ho,Wo,O] and the transposed weight wT[I,kh,kw,O];
// splits and ws as for conv_fwd (ws [splits * B*H*W*I]).
extern "C" int conv_dgrad(const void* dy, const void* wT, void* dx, int B,
                          int H, int W, int I, int Ho, int Wo, int O, int kh,
                          int kw, int sh, int sw, int pt, int pl, int is_bf16,
                          int out_f32, int splits, float* ws,
                          cudaStream_t stream) {
  ConvParams p{dy, wT, nullptr, dx, B, Ho, Wo, O, H, W, I, kh, kw, sh, sw,
               pt, pl, out_f32, splits, ws};
  return launch_conv<true>(p, is_bf16, stream);
}
