// K2: the occupancy-guided march region in one launch: the cube's near/far,
// the probes, the inverse-CDF resampling and the clamped sample positions.
// No gradient.
//
// Replaces dreamfusion_tpu/ops/occupancy.py::march_rays_occupancy (with
// occupancy_lookup and mip_from_pos), the sampling half of
// dreamfusion_tpu/core/sampling.py::sample_pdf, core/sampling.py::
// near_far_from_bound (kind "cube") and the sample positions of
// models/renderer.py::_shade_and_composite (xyzs = clip(o + d z)).  The TPU
// version ranks draws against the CDF with a dense [R, S, P+1]
// compare-and-sum and fetches the bracketing values with one-hot einsums,
// because TPU gathers and searches are slow.
//
// Bound on the card: at the step's 4096 rays, the latency of one small
// launch; per ray the work is P grid lookups (the bool grid, 2 MB per
// cascade at 128^3, stays in L2), two serial P-term sums and S inverse-CDF
// lookups.  Design: one warp per ray, 8 rays a block (4096 rays fill 512
// blocks over the 132 SMs).  Each warp forms its ray's near/far and the z
// of its P + 1 probe edges (in shared memory); lane i probes interval i
// (and i + 32 for P > 32); a ballot gives the 64-bit occupancy mask.  The
// CDF keeps the plain version's rounding (a sequential total, then
// cdf[j+1] = cdf[j] + w_j / total), which the CPU parity with JAX depends
// on: the serial sums are the one part that does not spread over lanes, so
// lane l of warp 0 forms them for the block's ray l (the weights take two
// values, chosen by the mask) into shared memory, one chain a ray instead
// of 32 copies of it.  Lane k then places sample k (32-sample chunks for
// S > 32): #(cdf <= u_k) and #(edges <= z_k) by a binary search of the
// shared rows (the CDF always ascends; edges that do not, as when min_near
// clamps near past far, are counted by ballots instead), deltas[k] =
// z[k+1] - z[k] by a shuffle down.  Every store is lane-contiguous; the
// [S, 3] positions go out as the warp's 3n contiguous floats (``store3``).
// Why not ballots and the CDF in
// every lane: each lane issues those instructions, and that form measured
// 1.4 ms at 640,000 rays on the H100, slower than a thread a ray (1.0).
//
// Numbers kept from the JAX version: inv_d = 1 / (d + 1e-15), the slabs'
// min/max, near = far = 1e9 for a miss, near clamped to min_near; PDF weight
// (occ + 1e-3) + 1e-5, the "denominator < 1e-5 -> 1" rule (a draw above
// cdf[P] takes below = P and lands on the last edge), the trailing delta
// (far - near) / S, the validity mask from the probe interval each draw fell
// into (rank - 1, clipped), and "& any probe occupied".  Products and sums
// are rounded one by one (no fused multiply-add), as eager torch rounds
// them: a probe position that moves by an ulp can cross a grid cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rays a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lookup(const uint8_t* __restrict__ grid,
                                       int cascade, int G, float bound,
                                       float x, float y, float z) {
  // one cascade: the mip is 0 whatever the position (the clamp)
  int mip = 0;
  if (cascade > 1) {
    const float mx = fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z)));
    float c = ceilf(log2f(fmaxf(mx, 1e-8f)));
    c = fminf(fmaxf(c, 0.f), (float)(cascade - 1));
    mip = (int)c;
  }
  const float mb = fminf(exp2f((float)mip), bound);
  // x / mb: a power-of-two mb divides exactly, as its reciprocal multiplies
  const bool pow2 = (__float_as_uint(mb) & 0x807fffffu) == 0u &&
                    mb >= 1.17549435e-38f && mb <= 1.70141183e38f;
  const float inv = pow2 ? __frcp_rn(mb) : 0.f;
  const float p[3] = {x, y, z};
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q = pow2 ? __fmul_rn(p[a], inv) : __fdiv_rn(p[a], mb);
    const float t = __fadd_rn(__fmul_rn(q, 0.5f), 0.5f);
    int ci = (int)floorf(__fmul_rn(t, (float)G));
    cell[a] = min(max(ci, 0), G - 1);
  }
  const bool inside = fabsf(x) <= bound && fabsf(y) <= bound &&
                      fabsf(z) <= bound;
  const int64_t off =
      (((int64_t)mip * G + cell[0]) * G + cell[1]) * (int64_t)G + cell[2];
  return inside && grid[off] != 0;
}

__device__ __forceinline__ float edge_z(float near, float span,
                                        const float* __restrict__ edges,
                                        int i) {
  return __fadd_rn(near, __fmul_rn(span, edges[i]));
}

// torch.minimum / maximum / clamp: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// core/sampling.py::near_far_from_bound, kind "cube", in its order
__device__ __forceinline__ void cube_near_far(const float o[3],
                                              const float d[3], float bound,
                                              float min_near, float* near,
                                              float* far) {
  float nr = 0.f, fr = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = __frcp_rn(__fadd_rn(d[a], 1e-15f));
    const float t0 = __fmul_rn(__fsub_rn(-bound, o[a]), inv);
    const float t1 = __fmul_rn(__fsub_rn(bound, o[a]), inv);
    const float lo = min_nan(t0, t1), hi = max_nan(t0, t1);
    nr = a == 0 ? lo : max_nan(nr, lo);
    fr = a == 0 ? hi : min_nan(fr, hi);
  }
  if (fr < nr) nr = fr = 1e9f;
  *near = nr != nr ? nr : fmaxf(nr, min_near);
  *far = fr;
}

// Lane k's three floats to p[3k..3k+2], stored by the warp side by side
// (the first `n` floats).
__device__ __forceinline__ void store3(float* __restrict__ p, int n, int lane,
                                       const float v[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = lane + 32 * i;
    const int src = j / 3, c = j - 3 * src;
    const float a = __shfl_sync(kFull, v[0], src);
    const float b = __shfl_sync(kFull, v[1], src);
    const float e = __shfl_sync(kFull, v[2], src);
    if (j < n) p[j] = c == 0 ? a : (c == 1 ? b : e);
  }
}

// #(a[j] <= x) over a non-decreasing a[0..n-1] (binary lifting: the same
// steps in every lane)
__device__ __forceinline__ int count_le_sorted(const float* a, int n,
                                               float x) {
  int lo = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1)
    if (lo + step <= n && a[lo + step - 1] <= x) lo += step;
  return lo;
}

// #(a[j] <= x) over any a[0..n-1], for the x of lane t, in lane t: a
// ballot a value (edges that are not sorted, as when min_near clamps
// near past far)
__device__ __forceinline__ int count_le_ballot(const float* a, int n,
                                               int lane, float x_mine,
                                               int n_x) {
  int out = 0;
  for (int t = 0; t < n_x; ++t) {
    const float x = __shfl_sync(kFull, x_mine, t);
    int cnt = 0;
    for (int j0 = 0; j0 < n; j0 += 32)
      cnt += __popc(__ballot_sync(kFull, j0 + lane < n && a[j0 + lane] <= x));
    if (lane == t) out = cnt;
  }
  return out;
}

constexpr int kMaxP = 64;
constexpr int kRow = kMaxP + 1;           // a ray's edges or CDF values

__global__ void __launch_bounds__(kThreads)
march_kernel(const float* __restrict__ rays_o, int64_t o_sr, int64_t o_sc,
             const float* __restrict__ rays_d, int64_t d_sr, int64_t d_sc,
             float min_near,
             const uint8_t* __restrict__ grid, int cascade, int G,
             float bound, const float* __restrict__ edges, int P,
             const float* __restrict__ u, int64_t u_sr, int S, int R,
             int mode_mask, float* __restrict__ z_out,
             float* __restrict__ deltas, uint8_t* __restrict__ mask,
             float* __restrict__ xyzs) {
  __shared__ float s_edge[kWarps][kRow];    // the rays' z at the edges
  __shared__ float s_cdf[kWarps][kRow];
  __shared__ uint64_t s_occ[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + w;
  const bool valid = r < R;                 // the whole warp
  const int64_t row = (int64_t)r * S;

  // ---- each warp: its ray's near/far, edges and probes ----
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float nr = 0.f, fr = 0.f;
  uint64_t occ = 0;
  bool sorted = true;
  if (valid) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = rays_o[r * o_sr + a * o_sc];
      d[a] = rays_d[r * d_sr + a * d_sc];
    }
    cube_near_far(o, d, bound, min_near, &nr, &fr);
  }
  const float span = fr - nr;
  if (valid) {
    for (int j = lane; j <= P; j += 32)
      s_edge[w][j] = edge_z(nr, span, edges, j);
    __syncwarp();
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      bool hit = false, up = true;
      float zm = 0.f, p[3] = {0.f, 0.f, 0.f};
      if (i < P) {
        const float z_lo = s_edge[w][i], z_hi = s_edge[w][i + 1];
        up = z_lo <= z_hi;
        zm = __fmul_rn(0.5f, __fadd_rn(z_hi, z_lo));
#pragma unroll
        for (int a = 0; a < 3; ++a)
          p[a] = __fadd_rn(o[a], __fmul_rn(d[a], zm));
        hit = lookup(grid, cascade, G, bound, p[0], p[1], p[2]);
        if (mode_mask) {          // S == P: the probes are the samples
          z_out[row + i] = zm;
          deltas[row + i] = z_hi - z_lo;
          mask[row + i] = hit ? 1 : 0;
        }
      }
      if (mode_mask) {
#pragma unroll
        for (int a = 0; a < 3; ++a) p[a] = clamp_nan(p[a], -bound, bound);
        store3(xyzs + 3 * (row + base), 3 * min(32, P - base), lane, p);
      }
      occ |= (uint64_t)__ballot_sync(kFull, hit) << base;
      sorted = sorted && __all_sync(kFull, up);
    }
    if (lane == 0) s_occ[w] = occ;
  }
  if (mode_mask) return;                    // block-uniform
  __syncthreads();

  // ---- warp 0, lane l: ray l's CDF by the plain version's serial sums
  // (sequential total, cdf[j+1] = cdf[j] + w_j / total) ----
  if (w == 0 && lane < kWarps && blockIdx.x * kWarps + lane < R) {
    const uint64_t m = s_occ[lane];
    const float w0 = __fadd_rn(__fadd_rn(0.f, 1e-3f), 1e-5f);
    const float w1 = __fadd_rn(__fadd_rn(1.f, 1e-3f), 1e-5f);
    float total = 0.f;
    uint64_t bits = m;
#pragma unroll 8
    for (int j = 0; j < P; ++j, bits >>= 1)
      total = __fadd_rn(total, bits & 1 ? w1 : w0);
    const float p0 = __fdiv_rn(w0, total), p1 = __fdiv_rn(w1, total);
    float* cdf = s_cdf[lane];
    float c = 0.f;
    cdf[0] = 0.f;
    bits = m;
#pragma unroll 8
    for (int j = 0; j < P; ++j, bits >>= 1) {
      c = __fadd_rn(c, bits & 1 ? p1 : p0);
      cdf[j + 1] = c;
    }
  }
  __syncthreads();
  if (!valid) return;

  // ---- samples: lane k places sample k, 32 at a time ----
  const float* cdf = s_cdf[w];
  const float* ze = s_edge[w];
  const bool any_occ = occ != 0;
  const float last_delta = __fdiv_rn(span, (float)S);
  float z_prev_last = 0.f;                  // lane 31: the last chunk's z
  for (int base = 0; base < S; base += 32) {
    const int k = base + lane;
    const int n = min(32, S - base);
    const bool live = lane < n;
    const float uk = live ? u[r * u_sr + k] : 0.f;
    // below = #(cdf <= u) - 1 (the CDF is non-decreasing: each term adds a
    // positive weight), above = min(below + 1, P)
    const int below = max(count_le_sorted(cdf, P + 1, uk) - 1, 0);
    const int above = min(below + 1, P);
    float denom = cdf[above] - cdf[below];
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(uk - cdf[below], denom);
    const float b_lo = ze[below], b_hi = ze[above];
    const float zk = __fadd_rn(b_lo, __fmul_rn(t, b_hi - b_lo));
    // the probe interval z fell into: rank = #(edges <= z)
    const int rank = sorted ? count_le_sorted(ze, P + 1, zk)
                            : count_le_ballot(ze, P + 1, lane, zk, n);
    const int interval = min(max(rank - 1, 0), P - 1);
    const float z_next = __shfl_down_sync(kFull, zk, 1);
    const float z_first = __shfl_sync(kFull, zk, 0);
    if (base > 0 && lane == 31) deltas[row + base - 1] = z_first - z_prev_last;
    if (live) {
      z_out[row + k] = zk;
      if (k == S - 1) {
        deltas[row + k] = last_delta;
      } else if (lane < 31) {
        deltas[row + k] = z_next - zk;
      }
      mask[row + k] = (any_occ && ((occ >> interval) & 1ull)) ? 1 : 0;
    }
    z_prev_last = zk;
    float x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      x[a] = clamp_nan(__fadd_rn(o[a], __fmul_rn(d[a], zk)), -bound, bound);
    store3(xyzs + 3 * (row + base), 3 * n, lane, x);
  }
}

}  // namespace

// rays_o, rays_d [R, 3] fp32 with element strides (row, column): the
// origins of a view may be a broadcast row; near/far are the cube's
// (bound, min_near).  grid [cascade, G, G, G] bytes, edges [P + 1], P <= 64,
// u [R, S] fp32 non-decreasing draws with row stride u_sr (0: one row for
// every ray); unused when mode_mask (S == P).  Writes z, deltas [R, S], mask
// [R, S] bytes (a torch.bool tensor) and the clamped positions [R, S, 3].
extern "C" int march_rays(const float* rays_o, int64_t o_sr, int64_t o_sc,
                          const float* rays_d, int64_t d_sr, int64_t d_sc,
                          float min_near, const uint8_t* grid, int cascade,
                          int G, float bound, const float* edges, int P,
                          const float* u, int64_t u_sr, int S, int R,
                          int mode_mask, float* z, float* deltas,
                          uint8_t* mask, float* xyzs, void* stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if (R > 0 && S > 0) {
    march_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                   (cudaStream_t)stream>>>(
        rays_o, o_sr, o_sc, rays_d, d_sr, d_sc, min_near, grid, cascade, G,
        bound, edges, P, u, u_sr, S, R, mode_mask, z, deltas, mask, xyzs);
  }
  return (int)cudaGetLastError();
}
