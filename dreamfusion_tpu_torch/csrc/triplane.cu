// K1: triplane feature encode, forward (features + spatial jacobian) and
// backward (the planes' gradient and, on its own route, the positions').
//
// Replaces dreamfusion_tpu/ops/triplane.py::triplane_encode and
// ::triplane_encode_with_xgrad (with _bilinear_plane, _bilinear_plane_with_grad
// and _quad_pack), and their autodiff VJPs into the planes and into x.  The
// TPU version packs the 2x2 bilinear corners into one gathered row
// (_quad_pack) because TPU gathers are priced per row; on the card the four
// corners are read directly.
//
// Bound on the card: memory.  The forward reads 4 corner rows of C channels
// per (sample, plane) from planes that fit in L2 (3 x 256 x 256 x 16 fp32 =
// 12.6 MB of the 50 MB) and writes 1 or 4 [N, 3C] outputs; the backward
// reads the cotangents and reduces 4 corner rows per (sample, plane) into
// the planes' gradient.  Design: the forward takes a thread per (sample,
// plane, chunk of V channels: 8 where C allows, so C = 16 is 2 lanes), the
// chunk fastest: each lane computes the bilinear setup once, reads its
// piece of the 4 corner rows as 16-byte loads and writes its piece of each
// output row as 16-byte stores (8 bf16, or 2 x 4 fp32) in the caller's
// dtype, neighbouring lanes on neighbouring addresses.  The backward takes
// a warp per (plane, 32 consecutive samples), a thread walking its (sample,
// plane)'s channels in chunks of V with one bilinear setup.  It reads the
// cotangents in their own dtype (bf16 or fp32), skips the samples whose
// cotangents are all zero (the DMTet query's missed pixels, 61% of a 512²
// view, all at one point), merges the contributions of neighbouring lanes
// in the same cell (csrc/field.cuh) and adds each corner chunk with float4
// reductions.  triplane_bwd_dx gives, in the same walk, dL/dx = sum g *
// dfeat/dx from the corner values it reads, and with cotangents on the
// jacobian the second derivative sum g_j * dj/dx too (jax.grad over
// triplane_encode_with_xgrad): per plane, d ju / d v = d jv / d u = (R-1)^2
// (v00 - v01 - v10 + v11), each masked by the jacobian's strict rule on its
// own axis and by the autodiff rule on the other (d2/du2 = 0: bilinear).  A
// block holds the three planes of 64 samples, and their (u, v) partials are
// summed in shared memory.
//
// Rules kept from _bilinear_plane_with_grad: coordinates are clipped to
// [0,1]; the jacobian along a plane axis is zero unless 0 < coord < 1
// strictly; a sample with any coordinate outside [0,1] gives zeros on every
// output and no gradient.  Plane p uses axes (u, v) = (x,y), (x,z), (y,z).
// The position gradient follows JAX's autodiff of triplane_encode instead,
// which clips twice (in triplane_encode and in _bilinear_plane), each clip
// passing half of the slope at its tie: a quarter of the interior slope at a
// coordinate exactly 0, and 0 at 1 (where the two corners coincide) and
// outside.

#include "field.cuh"

namespace {

constexpr int kGroups = 2;                   // 32-sample groups per block
constexpr int kThreads = 3 * 32 * kGroups;   // backward: a warp per (plane,
                                             // group)
constexpr int kFwdThreads = 256;

struct Setup {
  int64_t off[4];   // element offset of corner k, channel 0
  float w[4];       // bilinear weights
  float du[4];      // d w / d u, scaled by (R-1) and the strict inside mask
  float dv[4];      // d w / d v, likewise
  float su, sv;     // (R-1) times the strict inside masks of u and v
  float fy, fx;     // fractional positions along u and v
  unsigned cell;    // i0 * R + j0: the merge key
};

__device__ __forceinline__ void plane_axes(int p, int& a, int& b) {
  a = (p == 2) ? 1 : 0;
  b = (p == 0) ? 1 : 2;
}

// (sample, plane) of this thread: warp w of the block is plane w % 3 of the
// block's sample group w / 3
__device__ __forceinline__ void thread_of(int& n, int& p, int& grp) {
  const int warp = threadIdx.x >> 5;
  p = warp % 3;
  grp = warp / 3;
  n = (blockIdx.x * kGroups + grp) * 32 + (threadIdx.x & 31);
}

__device__ __forceinline__ bool sample_oob(const float* x, int n) {
  const float a = x[3 * n], b = x[3 * n + 1], c = x[3 * n + 2];
  return a < 0.f || a > 1.f || b < 0.f || b > 1.f || c < 0.f || c > 1.f;
}

__device__ __forceinline__ Setup setup(float u, float v, int p, int R, int C) {
  const float mu = (u > 0.f && u < 1.f) ? 1.f : 0.f;
  const float mv = (v > 0.f && v < 1.f) ? 1.f : 0.f;
  const float scale = (float)(R - 1);
  const float pu = __fmul_rn(fminf(fmaxf(u, 0.f), 1.f), scale);
  const float pv = __fmul_rn(fminf(fmaxf(v, 0.f), 1.f), scale);
  const float fu0 = floorf(pu), fv0 = floorf(pv);
  const float fy = pu - fu0, fx = pv - fv0;
  const int i0 = (int)fu0, j0 = (int)fv0;
  const int i1 = min(i0 + 1, R - 1), j1 = min(j0 + 1, R - 1);
  Setup q;
  const int64_t base = (int64_t)p * R * R;
  q.off[0] = (base + (int64_t)i0 * R + j0) * C;
  q.off[1] = (base + (int64_t)i0 * R + j1) * C;
  q.off[2] = (base + (int64_t)i1 * R + j0) * C;
  q.off[3] = (base + (int64_t)i1 * R + j1) * C;
  q.w[0] = (1.f - fy) * (1.f - fx);
  q.w[1] = (1.f - fy) * fx;
  q.w[2] = fy * (1.f - fx);
  q.w[3] = fy * fx;
  const float su = scale * mu, sv = scale * mv;
  q.su = su;
  q.sv = sv;
  q.du[0] = -(1.f - fx) * su;
  q.du[1] = -fx * su;
  q.du[2] = (1.f - fx) * su;
  q.du[3] = fx * su;
  q.dv[0] = -(1.f - fy) * sv;
  q.dv[1] = (1.f - fy) * sv;
  q.dv[2] = -fy * sv;
  q.dv[3] = fy * sv;
  q.fy = fy;
  q.fx = fx;
  q.cell = (unsigned)(i0 * R + j0);
  return q;
}

// JAX's autodiff slope factor at a coordinate: 1 inside, 1/4 at exactly 0
// (two clips, each halving at its tie), 0 at 1 and outside
__device__ __forceinline__ float tie_factor(float c) {
  return (c > 0.f && c < 1.f) ? 1.f : (c == 0.f ? 0.25f : 0.f);
}

// A thread per (sample, plane, chunk of V channels), the chunk fastest: the
// C / V lanes of a (sample, plane) read neighbouring 16-byte pieces of each
// corner row and write neighbouring 16-byte pieces of each output row.
template <typename T, int V>
__global__ void __launch_bounds__(kFwdThreads)
    triplane_fwd_kernel(const float* __restrict__ planes,
                        const float* __restrict__ x, int N, int R, int C,
                        T* __restrict__ feat, T* __restrict__ jx,
                        T* __restrict__ jy, T* __restrict__ jz) {
  const int lanes = C / V;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)N * 3 * lanes) return;
  const int c0 = (int)(idx % lanes) * V;
  const int p = (int)((idx / lanes) % 3);
  const int n = (int)(idx / ((int64_t)lanes * 3));
  int a, b;
  plane_axes(p, a, b);
  const bool oob = sample_oob(x, n);
  const Setup q = setup(x[3 * n + a], x[3 * n + b], p, R, C);
  float f[V], fu[V], fv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = fu[i] = fv[i] = 0.f;
  if (!oob) {
    float val[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      field::load_f32<V>(planes + q.off[k] + c0, val[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[i] += val[k][i] * q.w[k];
        fu[i] += val[k][i] * q.du[k];
        fv[i] += val[k][i] * q.dv[k];
      }
    }
  }
  const int64_t at = ((int64_t)n * 3 + p) * C + c0;
  field::store_row<T, V>(feat + at, f);
  if (jx != nullptr) {
    // plane p's u derivative goes to axis a, its v derivative to axis b,
    // and the third axis gets zeros
    float zero[V];
#pragma unroll
    for (int i = 0; i < V; ++i) zero[i] = 0.f;
    field::store_row<T, V>((a == 0 ? jx : jy) + at, fu);
    field::store_row<T, V>((b == 1 ? jy : jz) + at, fv);
    field::store_row<T, V>((p == 0 ? jz : p == 1 ? jy : jx) + at, zero);
  }
}

// The planes' gradient for cotangents on feat and on jx, jy, jz (any may be
// null), and with DX the positions' gradient dx [N, 3] from all of them (g_feat
// through the first derivative, the jacobians' through the second).
template <typename G, int V, bool DX>
__global__ void __launch_bounds__(kThreads)
    triplane_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ planes, int N, int R, int C,
                        const G* __restrict__ g_feat,
                        const G* __restrict__ g_jx,
                        const G* __restrict__ g_jy,
                        const G* __restrict__ g_jz,
                        float* __restrict__ dplanes, float* __restrict__ dx) {
  // (u, v) partials of dx per (group, plane, lane)
  __shared__ float part[DX ? kGroups * 3 * 32 * 2 : 1];
  int n, p, grp;
  thread_of(n, p, grp);
  const int lane = threadIdx.x & 31;
  int a, b;
  plane_axes(p, a, b);
  const G* gu = a == 0 ? g_jx : g_jy;
  const G* gv = b == 1 ? g_jy : g_jz;
  const int64_t row = ((int64_t)n * 3 + p) * C;
  float u = 0.f, v = 0.f;
  bool active = n < N && !sample_oob(x, n);
  if (active) {
    u = x[3 * n + a];
    v = x[3 * n + b];
    // a sample whose cotangents are all zero adds nothing anywhere
    bool nz = false;
    for (int c0 = 0; c0 < C && !nz; c0 += V) {
      float t[V];
      if (g_feat) {
        field::load_cot<V>(g_feat + row + c0, t);
        nz |= field::any_nonzero(t);
      }
      if (gu) {
        field::load_cot<V>(gu + row + c0, t);
        nz |= field::any_nonzero(t);
      }
      if (gv) {
        field::load_cot<V>(gv + row + c0, t);
        nz |= field::any_nonzero(t);
      }
    }
    active = nz;
  }
  float su = 0.f, sv = 0.f;      // sum_c g_feat * dfeat/du (and dv), unscaled
  if (__any_sync(field::kFull, active)) {
    Setup q = setup(u, v, p, R, C);
    const unsigned key[1] = {q.cell};
    const field::Run run = field::lane_runs(key, active);
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += V) {
      float gf[V], ga[V], gb[V];
#pragma unroll
      for (int i = 0; i < V; ++i) gf[i] = ga[i] = gb[i] = 0.f;
      if (active) {
        if (g_feat) field::load_cot<V>(g_feat + row + c0, gf);
        if (gu) field::load_cot<V>(gu + row + c0, ga);
        if (gv) field::load_cot<V>(gv + row + c0, gb);
      }
      if (DX && active) {
        float val[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          field::load_f32<V>(planes + q.off[k] + c0, val[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float fu = (1.f - q.fx) * (val[2][i] - val[0][i]) +
                           q.fx * (val[3][i] - val[1][i]);
          const float fv = (1.f - q.fy) * (val[1][i] - val[0][i]) +
                           q.fy * (val[3][i] - val[2][i]);
          su += gf[i] * fu;
          sv += gf[i] * fv;
        }
        // the jacobian's cotangents: d jv / d u and d ju / d v, the mixed
        // term (untouched, bit for bit, where both are null)
        if (gu || gv) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float mixed =
                (val[0][i] - val[1][i]) - (val[2][i] - val[3][i]);
            if (gv) su += gb[i] * mixed * q.sv;
            if (gu) sv += ga[i] * mixed * q.su;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float coef[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          coef[i] = active ? q.w[k] * gf[i] + q.du[k] * ga[i] +
                                 q.dv[k] * gb[i]
                           : 0.f;
        field::merge_runs<V>(coef, run);
        if (active && run.head)
          field::red_add<V>(dplanes + q.off[k] + c0, coef);
      }
    }
  }
  if constexpr (DX) {
    const float scale = (float)(R - 1);
    float* mine = part + ((grp * 3 + p) * 32 + lane) * 2;
    mine[0] = active ? su * scale * tie_factor(u) : 0.f;
    mine[1] = active ? sv * scale * tie_factor(v) : 0.f;
    __syncthreads();
    if (p == 0 && n < N) {
      // x: u of planes xy, xz; y: v of xy, u of yz; z: v of xz, v of yz
      const float* pp = part + grp * 3 * 32 * 2 + lane * 2;
      const float* p0 = pp;
      const float* p1 = pp + 32 * 2;
      const float* p2 = pp + 2 * 32 * 2;
      dx[3 * n] = p0[0] + p1[0];
      dx[3 * n + 1] = p0[1] + p2[0];
      dx[3 * n + 2] = p1[1] + p2[1];
    }
  }
}

inline unsigned blocks_for(int N) {
  return (unsigned)((N + 32 * kGroups - 1) / (32 * kGroups));
}

// channels per chunk: 8, 4, 2 or 1, the widest that divides C
inline int chunk_of(int C) {
  return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
}

template <typename T>
cudaError_t fwd_dispatch(int V, cudaStream_t s, const float* planes,
                         const float* x, int N, int R, int C, void* feat,
                         void* jx, void* jy, void* jz) {
  const int64_t total = (int64_t)N * 3 * (C / V);
  const unsigned blocks = (unsigned)((total + kFwdThreads - 1) / kFwdThreads);
#define TP_FWD(VV)                                                          \
  triplane_fwd_kernel<T, VV><<<blocks, kFwdThreads, 0, s>>>(               \
      planes, x, N, R, C, (T*)feat, (T*)jx, (T*)jy, (T*)jz)
  switch (V) {
    case 8: TP_FWD(8); break;
    case 4: TP_FWD(4); break;
    case 2: TP_FWD(2); break;
    default: TP_FWD(1); break;
  }
#undef TP_FWD
  return cudaSuccess;
}

template <typename G, bool DX>
void bwd_dispatch(int V, cudaStream_t s, const float* x, const float* planes,
                  int N, int R, int C, const void* g_feat, const void* g_jx,
                  const void* g_jy, const void* g_jz, float* dplanes,
                  float* dx) {
#define TP_BWD(VV)                                                          \
  triplane_bwd_kernel<G, VV, DX><<<blocks_for(N), kThreads, 0, s>>>(       \
      x, planes, N, R, C, (const G*)g_feat, (const G*)g_jx,                \
      (const G*)g_jy, (const G*)g_jz, dplanes, dx)
  switch (V) {
    case 8: TP_BWD(8); break;
    case 4: TP_BWD(4); break;
    case 2: TP_BWD(2); break;
    default: TP_BWD(1); break;
  }
#undef TP_BWD
}

}  // namespace

extern "C" int triplane_fwd(const float* planes, const float* x, int N, int R,
                            int C, void* feat, void* jx, void* jy, void* jz,
                            int out_bf16, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (out_bf16)
      fwd_dispatch<__nv_bfloat16>(chunk_of(C), s, planes, x, N, R, C, feat,
                                  jx, jy, jz);
    else
      fwd_dispatch<float>(chunk_of(C), s, planes, x, N, R, C, feat, jx, jy,
                          jz);
  }
  return (int)cudaGetLastError();
}

extern "C" int triplane_bwd(const float* x, int N, int R, int C,
                            const void* g_feat, const void* g_jx,
                            const void* g_jy, const void* g_jz, int g_bf16,
                            float* dplanes, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g_bf16)
      bwd_dispatch<__nv_bfloat16, false>(chunk_of(C), s, x, nullptr, N, R, C,
                                         g_feat, g_jx, g_jy, g_jz, dplanes,
                                         nullptr);
    else
      bwd_dispatch<float, false>(chunk_of(C), s, x, nullptr, N, R, C, g_feat,
                                 g_jx, g_jy, g_jz, dplanes, nullptr);
  }
  return (int)cudaGetLastError();
}

// dplanes and dx for cotangents on feat and on jx, jy, jz (any may be null;
// with the three jacobian ones null, the first derivative alone)
extern "C" int triplane_bwd_dx(const float* x, const float* planes, int N,
                               int R, int C, const void* g_feat,
                               const void* g_jx, const void* g_jy,
                               const void* g_jz, int g_bf16, float* dplanes,
                               float* dx, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g_bf16)
      bwd_dispatch<__nv_bfloat16, true>(chunk_of(C), s, x, planes, N, R, C,
                                        g_feat, g_jx, g_jy, g_jz, dplanes,
                                        dx);
    else
      bwd_dispatch<float, true>(chunk_of(C), s, x, planes, N, R, C, g_feat,
                                g_jx, g_jy, g_jz, dplanes, dx);
  }
  return (int)cudaGetLastError();
}
