// K11: GroupNorm with fp32 statistics and an optional fused SiLU, forward
// and backward.
//
// Replaces dreamfusion_tpu/models/unet.py::group_norm_fused (:100, its
// custom_vjp f_fwd :133 and f_bwd :143, dx :153) and GroupNorm32 (:177,
// flax nn.GroupNorm in fp32, then cast back), as the SD towers call it.
// x is channel-last [B, HW, C] (bf16 or fp32), the C/G channels of a group
// contiguous; weight and bias [C] fp32 or bf16:
//
//   y  = silu?((x - mean) * rstd * w + b)          rstd = 1/sqrt(var + eps)
//   dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)),
//        dxh = dy' * w,  dy' = dy * silu'(u),  xh = (x - mean) * rstd,
//        u = xh * w + b
//   dw = sum over batch and pixels of dy' * xh,  db = the same of dy'
//        (f_bwd's dscale, dbias :148-149; the _affine entry points)
//
// Bound on the card: memory (x read, y written forward; x and dy read, dx
// written backward; a few operations per element).  The design keeps each
// element's bytes to one read where the data fits on chip:
//  - Loads and stores are 16-byte vectors of a slab: the smallest run of
//    whole groups whose width is a multiple of 16 bytes (wider where the
//    footprint allows; ops/groupnorm.py::group_norm_route picks it), never
//    one group's stride (Cg = 10 would be 20 bytes at a 20-byte offset).
//    A thread keeps one 16-byte slot of a pixel's slab (slot = thread % Vp,
//    Vp = the slab's vectors rounded up to a power of two) and per-channel
//    statistics over the pixels it sees: Welford's mean and M2 forward, the
//    two sums backward.  They leave registers by warp shuffles (lanes with
//    the same slot), then shared memory (warps in order, then a warp per
//    group): per-group partials, merged with Chan's formula, in a fixed
//    order (the results do not depend on scheduling).
//  - Resident route (groupnorm_{fwd,bwd}_resident): one thread-block
//    cluster owns one (batch, slab) and keeps the slab (backward: x and dy)
//    in its CTAs' shared memory, each CTA a range of pixels, copied in by
//    cp.async in four commit groups so that the statistics start on the
//    first quarter.  The CTAs' group partials merge across the cluster
//    through distributed shared memory (every CTA merges all ranks in rank
//    order), and each CTA normalises its pixels from shared memory: x (and
//    dy) read once, y (dx) written once, one launch.
//  - Streaming route (groupnorm_{fwd,bwd}_stream): one cooperative launch
//    of one CTA per SM (per batch, a contiguous range of whole pixel rows:
//    coalesced).  Pass 1 writes each CTA's group partials; after a grid
//    barrier one CTA per group merges them once; after a second, pass 2
//    walks the CTA's range backwards, so that the rows pass 1 read last
//    (still in the 50 MB L2) are read again first.  Forward 3 transfers,
//    backward 5 at most.
//  Affine gradients (groupnorm_bwd_{resident,stream}_affine, where the
//  weights want gradients): beside its group sums, each thread keeps per
//  channel the sums of dy' and dy' * xh over its pixels; after the block's
//  group reduction they take the same shuffles and row-block order to one
//  partial per (CTA, channel), written to a workspace [batch x CTAs][C][2];
//  gn_affine_finish, in the same launch, sums each channel's partials in
//  row order (deterministic: no float atomics) into the weights' dtype.
//  ops/groupnorm.py::group_norm_route picks between them by shape.  On the
//  H100 the streaming route won above a few MB (15 MiB forward, 4 MiB
//  backward; bench_sd_kernels.py --only gn_routes): a resident CTA cannot
//  overlap its load, statistics and stores, and a slab's strided rows read
//  and write worse than whole rows.  Below, the resident route won: the
//  SD step's UNet calls and the VAE's 64² level.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;      // the opt-in limit of a block (227 KB)
constexpr int kMaxDevices = 64;

// ---- 16-byte vectors --------------------------------------------------------

template <typename T>
struct Vec16;

template <>
struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float param(const void* p, int c, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c])
                 : static_cast<const float*>(p)[c];
}

// 1 / (1 + e^-u).  The special-function unit issues 16 operations a clock
// per SM against 128 FMAs, so at 2 bytes an element it bounds the SiLU
// passes: bf16 takes one MUFU tanh (sigmoid(u) = (1 + tanh(u/2)) / 2,
// absolute error ~5e-4, under half a bf16 ulp of the output), fp32 an exp2
// and a reciprocal (a few ulp).  An IEEE division would cost ~20 more.
template <typename T>
__device__ __forceinline__ float sigmoid(float u);

template <>
__device__ __forceinline__ float sigmoid<bf16>(float u) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * u));
  return fmaf(0.5f, t, 0.5f);
}

template <>
__device__ __forceinline__ float sigmoid<float>(float u) {
  return __fdividef(1.f, 1.f + __expf(-u));
}

// ---- statistics -------------------------------------------------------------

// Chan's merge of (nb, mb, Mb) into (n, m, M2) for every channel of a thread
// (one count: every channel of a slot sees the same pixels).
template <int E>
__device__ __forceinline__ void chan_merge(float& n, float* m, float* M2,
                                           float nb, const float* mb,
                                           const float* Mb) {
  if (nb == 0.f) return;
  const float nn = n + nb, f = __fdividef(nb, nn), w = n * f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float d = mb[e] - m[e];
    m[e] = fmaf(d, f, m[e]);
    M2[e] += Mb[e] + d * d * w;
  }
  n = nn;
}

struct GnParams {
  const void* x;       // [B, HW, C]
  const void* dy;      // backward: [B, HW, C]
  void* out;           // y or dx, like x
  const void* w;       // [C], fp32 or bf16 (w_bf16)
  const void* b;
  float* stats;        // [B*G][2] mean, rstd (forward writes, backward reads)
  float* part;         // streaming: [B][R][G][3] the CTAs' partials
  float* fin;          // streaming backward: [B*G][2] mean(dxh), mean(dxh xh)
  float* apart;        // affine backward: [B * ctas][C][2] sums of dy', dy' xh
  int HW, C, G, Cg;
  int W;               // channels of a CTA's rows: the slab, or C (streaming)
  int V, Vp;           // 16-byte vectors of those channels; V rounded to 2^k
  int ctas;            // resident: the cluster's CTAs; streaming: per batch
  float eps;
  int silu, w_bf16;
};

// Row blocks of the scratch after the warp shuffles.
__host__ __device__ __forceinline__ int row_blocks(int threads, int Vp) {
  return Vp >= 32 ? threads / Vp : threads / 32;
}

// Floats of the statistics scratch (red, chan, gstat, fin) of a block.
__host__ __device__ __forceinline__ int scratch_floats(int threads, int W,
                                                       int Cg, int Vp,
                                                       bool bwd) {
  const int K = bwd ? 2 : 3, Gs = W / Cg;
  return row_blocks(threads, Vp) * W * K + W * K + Gs * K + Gs * 2;
}

// The block's per-thread, per-channel statistics (forward: count n, Welford
// mean a and M2 b; backward: sums a and b) → per channel of the block in
// chan [W][K] (forward: n, mean, M2; backward: the sums), over the threads
// of a slot in a fixed order.  red [row blocks][W][K] is scratch.
template <bool kBwd, int E>
__device__ void reduce_channels(const GnParams& p, float n, float* a,
                                float* b, float* red, float* chan) {
  constexpr int K = kBwd ? 2 : 3;
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int Vp = p.Vp, v = t & (Vp - 1), W = p.W;
  if (Vp < 32) {
    // lanes with the same slot: after offsets 16 .. Vp, lanes < Vp hold the
    // warp's statistics
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < Vp) break;
      float ab[E], bb[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ab[e] = __shfl_down_sync(0xffffffffu, a[e], off);
        bb[e] = __shfl_down_sync(0xffffffffu, b[e], off);
      }
      if (kBwd) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          a[e] += ab[e];
          b[e] += bb[e];
        }
      } else {
        const float nb = __shfl_down_sync(0xffffffffu, n, off);
        chan_merge<E>(n, a, b, nb, ab, bb);
      }
    }
  }
  const int rb = Vp >= 32 ? t / Vp : warp, nrb = row_blocks(T, Vp);
  if ((Vp >= 32 || lane < Vp) && v < p.V) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float* r = red + ((size_t)rb * W + v * E + e) * K;
      if (kBwd) {
        r[0] = a[e];
        r[1] = b[e];
      } else {
        r[0] = n;
        r[1] = a[e];
        r[2] = b[e];
      }
    }
  }
  __syncthreads();
  // per channel over the row blocks, in order
  for (int c = t; c < W; c += T) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < nrb; ++i) {
      const float* r = red + ((size_t)i * W + c) * K;
      if (kBwd) {
        s0 += r[0];
        s1 += r[1];
      } else {
        chan_merge<1>(s0, &s1, &s2, r[0], &r[1], &r[2]);
      }
    }
    chan[c * K] = s0;
    chan[c * K + 1] = s1;
    if (!kBwd) chan[c * K + 2] = s2;
  }
  __syncthreads();
}

// The same → per-group statistics of the block in gstat [W / Cg][K]
// (forward: n, mean, M2; backward: the sums); red and chan are scratch.
template <bool kBwd, int E>
__device__ void block_reduce(const GnParams& p, float n, float* a, float* b,
                             float* red, float* chan, float* gstat) {
  constexpr int K = kBwd ? 2 : 3;
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int W = p.W;
  reduce_channels<kBwd, E>(p, n, a, b, red, chan);
  // per group, a warp each: lanes over the group's channels, then a tree
  const int Gs = W / p.Cg, nwarps = T >> 5;
  for (int gi = warp; gi < Gs; gi += nwarps) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < p.Cg; c += 32) {
      const float* r = chan + (gi * p.Cg + c) * K;
      if (kBwd) {
        s0 += r[0];
        s1 += r[1];
      } else {
        chan_merge<1>(s0, &s1, &s2, r[0], &r[1], &r[2]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o0 = __shfl_down_sync(0xffffffffu, s0, off);
      const float o1 = __shfl_down_sync(0xffffffffu, s1, off);
      const float o2 = __shfl_down_sync(0xffffffffu, s2, off);
      if (kBwd) {
        s0 += o0;
        s1 += o1;
      } else {
        chan_merge<1>(s0, &s1, &s2, o0, &o1, &o2);
      }
    }
    if (lane == 0) {
      gstat[gi * K] = s0;
      gstat[gi * K + 1] = s1;
      if (!kBwd) gstat[gi * K + 2] = s2;
    }
  }
  __syncthreads();
}

// The affine sums of a thread's slot (sums of dy' and dy' xh per channel)
// → this CTA's partial per channel, row `row` of p.apart, channels c0 ..
// c0 + W - 1; red and chan are scratch (free after block_reduce).
template <int E>
__device__ void affine_partials(const GnParams& p, float* ga, float* gb,
                                float* red, float* chan, size_t row, int c0) {
  reduce_channels<true, E>(p, 0.f, ga, gb, red, chan);
  float* out = p.apart + (row * p.C + c0) * 2;
  for (int c = threadIdx.x; c < p.W * 2; c += blockDim.x) out[c] = chan[c];
}

// Per-channel constants of a thread's slot (channels c0 + v*E .. + E - 1 of
// the tensor; group statistics of the block's groups in fin [Gs][2] and
// the forward's [B*G][2] from gmean/grstd at group index g0 + gi).
template <int E>
struct Slot {
  float w[E], b[E], mean[E], rstd[E], m1[E], m2[E];
  float a[E], c[E];      // forward: y = x a + c (a = rstd w, c = b - mean a)
};

// Accumulate one 16-byte vector of x (and dy) into a thread's statistics
// (kAffine: and the sums of dy' and dy' xh into ga and gb).
template <typename T, bool kBwd, bool kAffine = false>
__device__ __forceinline__ void accumulate(const GnParams& p,
                                           const Slot<Vec16<T>::N>& s,
                                           const uint4& xv, const uint4& dv,
                                           float& n, float* a, float* b,
                                           float* ga = nullptr,
                                           float* gb = nullptr) {
  constexpr int E = Vec16<T>::N;
  float x[E];
  Vec16<T>::unpack(xv, x);
  if (!kBwd) {
    n += 1.f;
    const float inv = __fdividef(1.f, n);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = x[e] - a[e];
      a[e] = fmaf(d, inv, a[e]);
      b[e] = fmaf(d, x[e] - a[e], b[e]);
    }
  } else {
    float dy[E];
    Vec16<T>::unpack(dv, dy);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xh = (x[e] - s.mean[e]) * s.rstd[e];
      float g = dy[e];
      if (p.silu) {
        const float u = fmaf(xh, s.w[e], s.b[e]), sg = sigmoid<T>(u);
        g *= sg * (1.f + u * (1.f - sg));
      }
      const float dxh = g * s.w[e];
      a[e] += dxh;
      b[e] = fmaf(dxh, xh, b[e]);
      if (kAffine) {
        ga[e] += g;
        gb[e] = fmaf(g, xh, gb[e]);
      }
    }
  }
}

// y (forward) or dx (backward) of one vector.
template <typename T, bool kBwd>
__device__ __forceinline__ uint4 apply(const GnParams& p,
                                       const Slot<Vec16<T>::N>& s,
                                       const uint4& xv, const uint4& dv) {
  constexpr int E = Vec16<T>::N;
  float x[E], o[E];
  Vec16<T>::unpack(xv, x);
  if (!kBwd) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float u = fmaf(x[e], s.a[e], s.c[e]);
      o[e] = p.silu ? u * sigmoid<T>(u) : u;
    }
  } else {
    float dy[E];
    Vec16<T>::unpack(dv, dy);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xh = (x[e] - s.mean[e]) * s.rstd[e];
      float g = dy[e];
      if (p.silu) {
        const float u = fmaf(xh, s.w[e], s.b[e]), sg = sigmoid<T>(u);
        g *= sg * (1.f + u * (1.f - sg));
      }
      o[e] = s.rstd[e] * (g * s.w[e] - s.m1[e] - xh * s.m2[e]);
    }
  }
  return Vec16<T>::pack(o);
}

// The slot's weights, and (backward) the forward's statistics of its groups.
template <typename T, bool kBwd>
__device__ __forceinline__ void load_slot(const GnParams& p, int bidx, int c0,
                                          int v, Slot<Vec16<T>::N>& s) {
  constexpr int E = Vec16<T>::N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = min(c0 + v * E + e, p.C - 1);
    s.w[e] = param(p.w, c, p.w_bf16);
    s.b[e] = param(p.b, c, p.w_bf16);
    if (kBwd) {
      const float* st = p.stats + ((size_t)bidx * p.G + c / p.Cg) * 2;
      s.mean[e] = st[0];
      s.rstd[e] = st[1];
    }
  }
}

// The merged statistics of the slot's groups (fin [Gs][2], group index
// relative to the block's first channel c0).
template <typename T, bool kBwd>
__device__ __forceinline__ void finish_slot(const GnParams& p, int v,
                                            const float* fin,
                                            Slot<Vec16<T>::N>& s) {
  constexpr int E = Vec16<T>::N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int gi = min(v * E + e, p.W - 1) / p.Cg;
    if (kBwd) {
      s.m1[e] = fin[gi * 2];
      s.m2[e] = fin[gi * 2 + 1];
    } else {
      s.a[e] = fin[gi * 2 + 1] * s.w[e];
      s.c[e] = fmaf(-fin[gi * 2], s.a[e], s.b[e]);
    }
  }
}

// ---- resident route -----------------------------------------------------------

// Cluster (slab, batch = blockIdx.y); rank r of p.ctas holds pixels
// [HW r / n, HW (r + 1) / n) of the slab's W channels.  Shared memory: the
// slab's vectors [P][V] of x (and dy), then the scratch.
template <typename T, bool kBwd, bool kAffine = false>
__global__ void __launch_bounds__(kMaxThreads)
gn_resident_kernel(const GnParams p) {
  constexpr int E = Vec16<T>::N, K = kBwd ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = p.ctas, rank = (int)cl.block_rank();
  const int t = threadIdx.x, T_ = blockDim.x;
  const int bidx = blockIdx.y, slab = blockIdx.x / n;
  const int c0 = slab * p.W, V = p.V, Vp = p.Vp, v = t & (Vp - 1);
  const int pix0 = (int)((int64_t)p.HW * rank / n);
  const int P = (int)((int64_t)p.HW * (rank + 1) / n) - pix0;
  const int Pmax = (p.HW + n - 1) / n;
  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint4* sdy = sx + (size_t)Pmax * V;
  float* red = reinterpret_cast<float*>(sx + (size_t)Pmax * V * (kBwd ? 2 : 1));
  float* chan = red + (size_t)row_blocks(T_, Vp) * p.W * K;
  const int Gs = p.W / p.Cg;
  float* gstat = chan + p.W * K;
  float* fin = gstat + Gs * K;

  // ---- copy the CTA's pixels in, four commit groups ----
  const size_t rs = (size_t)p.C * sizeof(T);          // bytes per pixel
  const size_t base = ((size_t)bidx * p.HW + pix0) * rs + c0 * sizeof(T);
  const char* gx = static_cast<const char*>(p.x) + base;
  const char* gdy = kBwd ? static_cast<const char*>(p.dy) + base : nullptr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i1 = P * (k + 1) / 4 * V;
    for (int i = P * k / 4 * V + t; i < i1; i += T_) {
      const int px = i / V, vv = i - px * V;
      cp_async16(sx + i, gx + px * rs + vv * 16);
      if (kBwd) cp_async16(sdy + i, gdy + px * rs + vv * 16);
    }
    cp_async_commit();
  }

  Slot<E> s;
  if (v < V) load_slot<T, kBwd>(p, bidx, c0, v, s);
  float cnt = 0.f, a[E], b[E], ga[E], gb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = b[e] = ga[e] = gb[e] = 0.f;
  const int RP = T_ / Vp;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == 0) cp_async_wait<3>();
    else if (k == 1) cp_async_wait<2>();
    else if (k == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    if (v < V) {
      const int r1 = P * (k + 1) / 4;
#pragma unroll 4
      for (int r = P * k / 4 + t / Vp; r < r1; r += RP) {
        const int i = r * V + v;
        accumulate<T, kBwd, kAffine>(p, s, sx[i], kBwd ? sdy[i] : sx[i],
                                     cnt, a, b, ga, gb);
      }
    }
  }
  block_reduce<kBwd, E>(p, cnt, a, b, red, chan, gstat);
  if (kAffine)
    affine_partials<E>(p, ga, gb, red, chan, (size_t)bidx * n + rank, c0);

  // ---- merge the cluster's partials (every CTA, ranks in order) ----
  cl.sync();
  for (int gi = t; gi < Gs; gi += T_) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < n; ++r) {
      const float* o = cl.map_shared_rank(gstat, r) + gi * K;
      if (kBwd) {
        s0 += o[0];
        s1 += o[1];
      } else {
        chan_merge<1>(s0, &s1, &s2, o[0], &o[1], &o[2]);
      }
    }
    if (kBwd) {
      const float inv = 1.f / ((float)p.HW * p.Cg);
      fin[gi * 2] = s0 * inv;
      fin[gi * 2 + 1] = s1 * inv;
    } else {
      const float rstd = 1.f / sqrtf(s2 / s0 + p.eps);
      fin[gi * 2] = s1;
      fin[gi * 2 + 1] = rstd;
      if (rank == 0) {
        float* st = p.stats + ((size_t)bidx * p.G + c0 / p.Cg + gi) * 2;
        st[0] = s1;
        st[1] = rstd;
      }
    }
  }
  __syncthreads();

  // ---- normalise from shared memory ----
  if (v < V) {
    finish_slot<T, kBwd>(p, v, fin, s);
    char* go = static_cast<char*>(p.out) + base;
#pragma unroll 4
    for (int r = t / Vp; r < P; r += RP) {
      const int i = r * V + v;
      *reinterpret_cast<uint4*>(go + r * rs + v * 16) =
          apply<T, kBwd>(p, s, sx[i], kBwd ? sdy[i] : sx[i]);
    }
  }
  cl.sync();     // no CTA leaves while another reads its partials
}

// ---- streaming route --------------------------------------------------------

// 16-byte loads in flight per thread (and per tensor: the backward holds
// x and dy, so half as many rows)
template <bool kBwd>
constexpr int kUnroll = kBwd ? 4 : 8;

// CTA (r, batch = blockIdx.y) of p.ctas per batch: pixels [HW r / R,
// HW (r + 1) / R), all C channels.  One cooperative launch.  (Two CTAs an
// SM, at 64 registers a thread, spilled and ran slower.)
template <typename T, bool kBwd, bool kAffine = false>
__global__ void __launch_bounds__(kMaxThreads)
gn_stream_kernel(const GnParams p) {
  constexpr int E = Vec16<T>::N, K = kBwd ? 2 : 3, U = kUnroll<kBwd>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int R = p.ctas, r = blockIdx.x, bidx = blockIdx.y;
  const int t = threadIdx.x, T_ = blockDim.x, lane = t & 31;
  const int V = p.V, Vp = p.Vp, v = t & (Vp - 1), RP = T_ / Vp;
  const int pix0 = (int)((int64_t)p.HW * r / R);
  const int P = (int)((int64_t)p.HW * (r + 1) / R) - pix0;
  float* red = reinterpret_cast<float*>(smem);
  float* chan = red + (size_t)row_blocks(T_, Vp) * p.W * K;
  float* gstat = chan + p.W * K;
  float* fin = gstat + p.G * K;

  const size_t rs = (size_t)p.C * sizeof(T);
  const size_t base = ((size_t)bidx * p.HW + pix0) * rs;
  const char* gx = static_cast<const char*>(p.x) + base;
  const char* gdy = kBwd ? static_cast<const char*>(p.dy) + base : nullptr;
  const bool on = v < V;

  Slot<E> s;
  if (kBwd && on) load_slot<T, kBwd>(p, bidx, 0, v, s);
  float cnt = 0.f, a[E], b[E], ga[E], gb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = b[e] = ga[e] = gb[e] = 0.f;
  const int r0 = t / Vp, step = RP * U;
  // ---- pass 1: statistics, rows ascending ----
  for (int rb = r0; rb < P; rb += step) {
    uint4 xb[U], db[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = rb + u * RP;
      if (on && row < P) {
        xb[u] = ldg16(gx + row * rs + v * 16);
        if (kBwd) db[u] = ldg16(gdy + row * rs + v * 16);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = rb + u * RP;
      if (on && row < P)
        accumulate<T, kBwd, kAffine>(p, s, xb[u], kBwd ? db[u] : xb[u], cnt,
                                     a, b, ga, gb);
    }
  }
  block_reduce<kBwd, E>(p, cnt, a, b, red, chan, gstat);
  if (kAffine)
    affine_partials<E>(p, ga, gb, red, chan, (size_t)bidx * R + r, 0);
  float* part = p.part + ((size_t)bidx * R + r) * p.G * 3;
  for (int i = t; i < p.G; i += T_)
#pragma unroll
    for (int k = 0; k < K; ++k) part[i * 3 + k] = gstat[i * K + k];
  grid.sync();

  // ---- merge: a CTA per group, a thread per partial, then trees ----
  const int nblk = gridDim.x * gridDim.y, nwarps = T_ >> 5, warp = t >> 5;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  auto tree = [&](float& s0, float& s1, float& s2) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o0 = __shfl_down_sync(0xffffffffu, s0, off);
      const float o1 = __shfl_down_sync(0xffffffffu, s1, off);
      const float o2 = __shfl_down_sync(0xffffffffu, s2, off);
      if (kBwd) {
        s0 += o0;
        s1 += o1;
      } else {
        chan_merge<1>(s0, &s1, &s2, o0, &o1, &o2);
      }
    }
  };
  for (int j = blk; j < (int)gridDim.y * p.G; j += nblk) {
    const int jb = j / p.G, jg = j - jb * p.G;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int i = t; i < R; i += T_) {
      const float* o = p.part + (((size_t)jb * R + i) * p.G + jg) * 3;
      if (kBwd) {
        s0 += o[0];
        s1 += o[1];
      } else {
        chan_merge<1>(s0, &s1, &s2, o[0], &o[1], &o[2]);
      }
    }
    tree(s0, s1, s2);
    if (lane == 0) {
      red[warp * 3] = s0;
      red[warp * 3 + 1] = s1;
      red[warp * 3 + 2] = s2;
    }
    __syncthreads();
    if (warp == 0) {
      s0 = s1 = s2 = 0.f;
      if (lane < nwarps) {
        s0 = red[lane * 3];
        s1 = red[lane * 3 + 1];
        s2 = red[lane * 3 + 2];
      }
      tree(s0, s1, s2);
      if (lane == 0) {
        if (kBwd) {
          const float inv = 1.f / ((float)p.HW * p.Cg);
          p.fin[j * 2] = s0 * inv;
          p.fin[j * 2 + 1] = s1 * inv;
        } else {
          p.stats[j * 2] = s1;
          p.stats[j * 2 + 1] = 1.f / sqrtf(s2 / s0 + p.eps);
        }
      }
    }
    __syncthreads();
  }
  grid.sync();
  const float* merged = (kBwd ? p.fin : p.stats) + (size_t)bidx * p.G * 2;
  for (int i = t; i < p.G * 2; i += T_) fin[i] = merged[i];
  __syncthreads();

  // ---- pass 2: normalise, rows descending ----
  if (!on) return;
  if (!kBwd) load_slot<T, kBwd>(p, bidx, 0, v, s);
  finish_slot<T, kBwd>(p, v, fin, s);
  char* go = static_cast<char*>(p.out) + base;
  const int last = P - 1 - r0;
  for (int rb = last; rb >= 0; rb -= step) {
    uint4 xb[U], db[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = rb - u * RP;
      if (row >= 0) {
        xb[u] = ldg16(gx + row * rs + v * 16);
        if (kBwd) db[u] = ldg16(gdy + row * rs + v * 16);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = rb - u * RP;
      if (row >= 0)
        *reinterpret_cast<uint4*>(go + row * rs + v * 16) =
            apply<T, kBwd>(p, s, xb[u], kBwd ? db[u] : xb[u]);
    }
  }
}

// dscale and dbias per channel: the affine partials' `rows` summed in row
// order, in the weights' dtype (w_bf16)
__global__ void gn_affine_finish(const float* __restrict__ apart, int rows,
                                 int C, void* dw, void* db, int w_bf16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sb = 0.f, sw = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float* a = apart + ((size_t)r * C + c) * 2;
    sb += a[0];
    sw += a[1];
  }
  if (w_bf16) {
    static_cast<bf16*>(dw)[c] = __float2bfloat16(sw);
    static_cast<bf16*>(db)[c] = __float2bfloat16(sb);
  } else {
    static_cast<float*>(dw)[c] = sw;
    static_cast<float*>(db)[c] = sb;
  }
}

// ---- host ---------------------------------------------------------------------

int vectors(int W, int elt) { return W * elt / 16; }

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// Fills p's shape fields; false when the shape does not fit the kernels.
bool shape_ok(GnParams& p, int B, int HW, int C, int G, int W, int threads,
              int elt) {
  if (B < 1 || HW < 1 || G < 1 || C % G || W < 1 || C % W) return false;
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.Cg = C / G;
  p.W = W;
  if (W % p.Cg || (W * elt) % 16) return false;
  p.V = vectors(W, elt);
  p.Vp = pow2_at_least(p.V);
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         threads % p.Vp == 0;
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// Attributes set once per device and kernel: the dynamic shared memory
// limit, and (clusters) sizes above the portable 8.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool cluster, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// A (cluster size, shared memory, threads) the card has accepted for a
// kernel, remembered so that the occupancy query runs once per key.
struct ClusterOk {
  int dev, n, smem, threads;
};
constexpr int kOkSlots = 64;

template <typename T, bool kBwd, bool kAffine>
int launch_resident(GnParams p, int B, int threads, cudaStream_t stream) {
  const int n = p.ctas;
  if (n < 1 || n > 16 || p.HW < n) return (int)cudaErrorInvalidValue;
  const int Pmax = (p.HW + n - 1) / n;
  const size_t smem =
      (size_t)Pmax * p.V * 16 * (kBwd ? 2 : 1) +
      (size_t)scratch_floats(threads, p.W, p.Cg, p.Vp, kBwd) * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gn_resident_kernel<T, kBwd, kAffine>;
  static bool done[kMaxDevices] = {};
  cudaError_t err = prepare(kernel, true, done);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.C / p.W * n), (unsigned)B, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the card must be able to hold one such cluster; refused → an error
  static ClusterOk ok[kOkSlots] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned key = ((unsigned)dev * 131u + (unsigned)n * 31u +
                        (unsigned)smem * 7u + (unsigned)threads) % kOkSlots;
  ClusterOk& slot = ok[key];
  if (!(slot.dev == dev + 1 && slot.n == n && slot.smem == (int)smem &&
        slot.threads == threads)) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    slot = {dev + 1, n, (int)smem, threads};
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kBwd, bool kAffine>
int launch_stream(GnParams p, int B, int threads, cudaStream_t stream) {
  if (p.ctas < 1 || p.part == nullptr || (kBwd && p.fin == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)scratch_floats(threads, p.W, p.Cg, p.Vp, kBwd) * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gn_stream_kernel<T, kBwd, kAffine>;
  static bool done[kMaxDevices] = {};
  cudaError_t err = prepare(kernel, false, done);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.ctas, (unsigned)B, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kBwd>
int launch_route(bool resident, bool affine, const GnParams& p, int B,
                 int threads, cudaStream_t stream) {
  if constexpr (kBwd) {
    if (affine)
      return resident ? launch_resident<T, true, true>(p, B, threads, stream)
                      : launch_stream<T, true, true>(p, B, threads, stream);
  }
  return resident ? launch_resident<T, kBwd, false>(p, B, threads, stream)
                  : launch_stream<T, kBwd, false>(p, B, threads, stream);
}

// affine (backward): apart, dw and db given; the finish runs after the
// route's kernel
template <bool kBwd>
int groupnorm_launch(bool resident, const void* x, const void* dy,
                     const void* w, const void* b, float* stats, float* part,
                     float* fin, void* out, int B, int HW, int C, int G,
                     int W, int ctas, int threads, float eps, int silu,
                     int fp32, int w_bf16, cudaStream_t stream,
                     float* apart = nullptr, void* dw = nullptr,
                     void* db = nullptr) {
  GnParams p = {};
  const int elt = fp32 ? 4 : 2;
  if (!shape_ok(p, B, HW, C, G, resident ? W : C, threads, elt))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out) || (kBwd && !aligned16(dy)) ||
      stats == nullptr)
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.dy = dy;
  p.out = out;
  p.w = w;
  p.b = b;
  p.stats = stats;
  p.part = part;
  p.fin = fin;
  p.ctas = ctas;
  p.eps = eps;
  p.silu = silu;
  p.w_bf16 = w_bf16;
  p.apart = apart;
  const bool affine = apart != nullptr;
  if (affine && (!kBwd || dw == nullptr || db == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = fp32 ? launch_route<float, kBwd>(resident, affine, p, B,
                                                    threads, stream)
                       : launch_route<bf16, kBwd>(resident, affine, p, B,
                                                   threads, stream);
  if (err != 0 || !affine) return err;
  gn_affine_finish<<<(C + 255) / 256, 256, 0, stream>>>(apart, B * ctas, C,
                                                        dw, db, w_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, HW, C] → y, and stats [B*G][2] (mean, rstd) for the backward: one
// cluster of `cluster` CTAs per (slab of W channels, batch).
extern "C" int groupnorm_fwd_resident(const void* x, const void* w,
                                      const void* b, void* y, float* stats,
                                      int B, int HW, int C, int G, int W,
                                      int cluster, int threads, float eps,
                                      int silu, int fp32, int w_bf16,
                                      cudaStream_t stream) {
  return groupnorm_launch<false>(true, x, nullptr, w, b, stats, nullptr,
                                 nullptr, y, B, HW, C, G, W, cluster,
                                 threads, eps, silu, fp32, w_bf16, stream);
}

// dx from x, dy and the forward's stats, the same layout.
extern "C" int groupnorm_bwd_resident(const void* x, const void* dy,
                                      const void* w, const void* b,
                                      float* stats, void* dx, int B, int HW,
                                      int C, int G, int W, int cluster,
                                      int threads, int silu, int fp32,
                                      int w_bf16, cudaStream_t stream) {
  return groupnorm_launch<true>(true, x, dy, w, b, stats, nullptr, nullptr,
                                dx, B, HW, C, G, W, cluster, threads, 0.f,
                                silu, fp32, w_bf16, stream);
}

// The streaming forward: `ctas` CTAs per batch (all co-resident: one
// cooperative launch, refused otherwise); part fp32 [B * ctas * G * 3] is
// scratch.
extern "C" int groupnorm_fwd_stream(const void* x, const void* w,
                                    const void* b, void* y, float* stats,
                                    float* part, int B, int HW, int C, int G,
                                    int ctas, int threads, float eps,
                                    int silu, int fp32, int w_bf16,
                                    cudaStream_t stream) {
  return groupnorm_launch<false>(false, x, nullptr, w, b, stats, part,
                                 nullptr, y, B, HW, C, G, C, ctas, threads,
                                 eps, silu, fp32, w_bf16, stream);
}

// The streaming backward; fin fp32 [B * G * 2] is scratch too.
extern "C" int groupnorm_bwd_stream(const void* x, const void* dy,
                                    const void* w, const void* b,
                                    float* stats, float* part, float* fin,
                                    void* dx, int B, int HW, int C, int G,
                                    int ctas, int threads, int silu,
                                    int fp32, int w_bf16,
                                    cudaStream_t stream) {
  return groupnorm_launch<true>(false, x, dy, w, b, stats, part, fin, dx, B,
                                HW, C, G, C, ctas, threads, 0.f, silu, fp32,
                                w_bf16, stream);
}

// The resident backward with the affine gradients: dx as
// groupnorm_bwd_resident, and dw, db [C] in the weights' dtype; apart fp32
// [B * cluster * C * 2] is scratch.
extern "C" int groupnorm_bwd_resident_affine(
    const void* x, const void* dy, const void* w, const void* b, float* stats,
    void* dx, float* apart, void* dw, void* db, int B, int HW, int C, int G,
    int W, int cluster, int threads, int silu, int fp32, int w_bf16,
    cudaStream_t stream) {
  return groupnorm_launch<true>(true, x, dy, w, b, stats, nullptr, nullptr,
                                dx, B, HW, C, G, W, cluster, threads, 0.f,
                                silu, fp32, w_bf16, stream, apart, dw, db);
}

// The streaming backward with the affine gradients; apart fp32
// [B * ctas * C * 2] is scratch.
extern "C" int groupnorm_bwd_stream_affine(
    const void* x, const void* dy, const void* w, const void* b, float* stats,
    float* part, float* fin, void* dx, float* apart, void* dw, void* db,
    int B, int HW, int C, int G, int ctas, int threads, int silu, int fp32,
    int w_bf16, cudaStream_t stream) {
  return groupnorm_launch<true>(false, x, dy, w, b, stats, part, fin, dx, B,
                                HW, C, G, C, ctas, threads, 0.f, silu, fp32,
                                w_bf16, stream, apart, dw, db);
}
