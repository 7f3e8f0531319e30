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

// ---------------------------------------------------------------------------
// K2's vanilla region: render_vanilla's sampling in two launches.
//
// Replaces dreamfusion_tpu/models/renderer.py::render_vanilla's sampling
// (:186-238): core/sampling.py::near_far_from_bound (kind "sphere"),
// stratified_zs and sample_pdf, the coarse weights' cumprod, the merge's
// jnp.sort, ops/composite.py::compute_deltas and _shade_and_composite's
// clamped positions.  The TPU version ranks the draws against the CDF with a
// dense [R, n, T] compare-and-sum and one-hot einsums, and sorts the merged
// z with XLA's sort.
//
//   vanilla_coarse:   |o| -+ bound, z_i = near + (far - near) lin_i
//                     (+ (u_i - 0.5) (far - near) / S when perturbed), the
//                     coarse deltas (optional) and positions clamp(o + d z).
//   vanilla_resample: from the coarse z and sigma [R, S]: alpha, the
//                     cumprod weights, the CDF over the S - 2 interior
//                     weights (+1e-5) on the S - 1 midpoints, n inverse-CDF
//                     draws, the S + n merged z sorted, the deltas (the last
//                     (far - near) / S) and the clamped positions.
//
// Bound on the card: memory at 4096 rays (every array read or written once;
// the serial chains are ~3S dependent operations a ray).  Design: a warp a
// ray, 8 rays a block, each warp on its own shared-memory rows (no block
// barrier).  Lanes stride the samples; lane 0 runs the ray's serial chains
// (the cumprod, the total and the CDF) in the plain version's order, as the
// march kernel's CDF does; lane k places draw k by a binary search of the
// CDF; the S + n merged values are placed by rank (the count of smaller
// values, ties by index: NaN last, as torch.sort), which needs no sorted
// input; the [S, 3] positions go out as the warp's contiguous floats.
// Products and sums are rounded one by one (no fused multiply-add), and exp
// is the library's expf, as torch's eager ops on the card compute them: z,
// the deltas and the positions equal the plain version's bit for bit.

namespace {

constexpr int kMaxS = 66;                  // coarse samples a ray
constexpr int kMaxN = 64;                  // importance draws a ray
constexpr int kMaxM = kMaxS + kMaxN;

__device__ __forceinline__ void sphere_near_far(const float o[3],
                                                float bound, float* near,
                                                float* far) {
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(o[0], o[0]),
                                       __fmul_rn(o[1], o[1])),
                             __fmul_rn(o[2], o[2]));
  const float radius = __fsqrt_rn(r2);
  *near = __fsub_rn(radius, bound);
  *far = __fadd_rn(radius, bound);
}

__device__ __forceinline__ void load_ray(const float* __restrict__ rays_o,
                                         int64_t o_sr, int64_t o_sc,
                                         const float* __restrict__ rays_d,
                                         int64_t d_sr, int64_t d_sc, int r,
                                         float o[3], float d[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[r * o_sr + a * o_sc];
    d[a] = rays_d[r * d_sr + a * d_sc];
  }
}

// The warp's clamped positions clamp(o + d z_i) of z_i = z[i], i < n.
__device__ __forceinline__ void store_positions(float* __restrict__ xyzs,
                                                const float* z, int n,
                                                int lane, const float o[3],
                                                const float d[3],
                                                float bound) {
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const float zi = i < n ? z[i] : 0.f;
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[a] = clamp_nan(__fadd_rn(o[a], __fmul_rn(d[a], zi)), -bound, bound);
    store3(xyzs + 3 * base, 3 * min(32, n - base), lane, p);
  }
}

// (far - near) / S as torch divides a tensor by a number on the card: by
// the number's reciprocal (exact for S a power of two)
__device__ __forceinline__ float per_step(float span, int S) {
  return __fmul_rn(span, __fdiv_rn(1.f, (float)S));
}

// torch.sort's order: NaN after every number
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (a == a && b != b);
}
__device__ __forceinline__ bool same(float a, float b) {
  return a == b || (a != a && b != b);
}

__global__ void __launch_bounds__(kThreads)
vanilla_coarse_kernel(const float* __restrict__ rays_o, int64_t o_sr,
                      int64_t o_sc, const float* __restrict__ rays_d,
                      int64_t d_sr, int64_t d_sc, float bound,
                      const float* __restrict__ lin,
                      const float* __restrict__ u, int64_t u_sr, int S, int R,
                      float* __restrict__ z_out, float* __restrict__ deltas,
                      float* __restrict__ xyzs) {
  __shared__ float s_z[kWarps][kMaxS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + w;
  if (r >= R) return;                       // the whole warp
  const int64_t row = (int64_t)r * S;
  float o[3], d[3], near, far;
  load_ray(rays_o, o_sr, o_sc, rays_d, d_sr, d_sc, r, o, d);
  sphere_near_far(o, bound, &near, &far);
  const float span = __fsub_rn(far, near);
  const float step = per_step(span, S);
  float* z = s_z[w];
  for (int i = lane; i < S; i += 32) {
    float zi = __fadd_rn(near, __fmul_rn(span, lin[i]));
    if (u != nullptr)
      zi = __fadd_rn(zi, __fmul_rn(__fsub_rn(u[r * u_sr + i], 0.5f), step));
    z[i] = zi;
    z_out[row + i] = zi;
  }
  __syncwarp();
  if (deltas != nullptr)
    for (int i = lane; i < S; i += 32)
      deltas[row + i] = i < S - 1 ? __fsub_rn(z[i + 1], z[i]) : step;
  store_positions(xyzs + 3 * row, z, S, lane, o, d, bound);
}

__global__ void __launch_bounds__(kThreads)
vanilla_resample_kernel(const float* __restrict__ rays_o, int64_t o_sr,
                        int64_t o_sc, const float* __restrict__ rays_d,
                        int64_t d_sr, int64_t d_sc, float bound,
                        const float* __restrict__ z_c,
                        const float* __restrict__ sigma,
                        const float* __restrict__ u, int64_t u_sr, int S,
                        int n, int R, float* __restrict__ z_out,
                        float* __restrict__ deltas,
                        float* __restrict__ xyzs) {
  __shared__ float s_w[kWarps][kMaxS];      // alpha, then the weights
  __shared__ float s_bin[kWarps][kMaxS];    // the midpoints: the bins
  __shared__ float s_cdf[kWarps][kMaxS];
  __shared__ float s_all[kWarps][kMaxM];    // coarse z, then the draws
  __shared__ float s_out[kWarps][kMaxM];    // sorted
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + w;
  if (r >= R) return;                       // the whole warp
  const int M = S + n, T = S - 1;           // merged samples, bins
  float o[3], d[3], near, far;
  load_ray(rays_o, o_sr, o_sc, rays_d, d_sr, d_sc, r, o, d);
  sphere_near_far(o, bound, &near, &far);
  const float step = per_step(__fsub_rn(far, near), S);
  float *wt = s_w[w], *bin = s_bin[w], *cdf = s_cdf[w], *all = s_all[w];
  for (int i = lane; i < S; i += 32) all[i] = z_c[(int64_t)r * S + i];
  __syncwarp();
  // alpha = 1 - exp(-delta sigma), the midpoints z + delta / 2
  for (int i = lane; i < S; i += 32) {
    const float di = i < S - 1 ? __fsub_rn(all[i + 1], all[i]) : step;
    const float sdt = __fmul_rn(di, sigma[(int64_t)r * S + i]);
    wt[i] = __fsub_rn(1.f, expf(-sdt));
    if (i < T) bin[i] = __fadd_rn(all[i], __fmul_rn(0.5f, di));
  }
  __syncwarp();
  if (lane == 0) {
    // weights = alpha * cumprod(1 - alpha + 1e-15), exclusive
    float trans = 1.f;
    for (int i = 0; i < S; ++i) {
      const float a = wt[i];
      wt[i] = __fmul_rn(a, trans);
      trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a), 1e-15f));
    }
    // the PDF of the interior weights (+1e-5) and its CDF, serial sums
    float total = 0.f;
    for (int j = 0; j < T - 1; ++j)
      total = __fadd_rn(total, __fadd_rn(wt[j + 1], 1e-5f));
    float c = 0.f;
    cdf[0] = 0.f;
    for (int j = 0; j < T - 1; ++j) {
      c = __fadd_rn(c, __fdiv_rn(__fadd_rn(wt[j + 1], 1e-5f), total));
      cdf[j + 1] = c;
    }
  }
  __syncwarp();
  // draw k: below = #(cdf <= u) - 1, above = min(below + 1, T - 1)
  for (int k = lane; k < n; k += 32) {
    const float uk = u[r * u_sr + k];
    const int below = max(count_le_sorted(cdf, T, uk) - 1, 0);
    const int above = min(below + 1, T - 1);
    float denom = __fsub_rn(cdf[above], cdf[below]);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(uk, cdf[below]), denom);
    const float lo = bin[below], hi = bin[above];
    all[S + k] = __fadd_rn(lo, __fmul_rn(t, __fsub_rn(hi, lo)));
  }
  __syncwarp();
  // the merge: each value to its rank
  float* out = s_out[w];
  for (int i = lane; i < M; i += 32) {
    const float v = all[i];
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const float a = all[j];
      rank += before(a, v) || (same(a, v) && j < i);
    }
    out[rank] = v;
  }
  __syncwarp();
  const int64_t row = (int64_t)r * M;
  for (int i = lane; i < M; i += 32) {
    z_out[row + i] = out[i];
    deltas[row + i] = i < M - 1 ? __fsub_rn(out[i + 1], out[i]) : step;
  }
  store_positions(xyzs + 3 * row, out, M, lane, o, d, bound);
}

}  // namespace

// rays_o, rays_d [R, 3] fp32 with element strides (row, column); lin [S]
// the coarse fractions (jnp.linspace(0, 1, S)); u [R, S] fp32 unit jitter
// draws with row stride u_sr, or null (no jitter).  Writes z [R, S], the
// deltas [R, S] where deltas is not null, and the positions [R, S, 3].
extern "C" int vanilla_coarse(const float* rays_o, int64_t o_sr, int64_t o_sc,
                              const float* rays_d, int64_t d_sr, int64_t d_sc,
                              float bound, const float* lin, const float* u,
                              int64_t u_sr, int S, int R, float* z,
                              float* deltas, float* xyzs, void* stream) {
  if (S < 2 || S > kMaxS) return (int)cudaErrorInvalidValue;
  if (R > 0)
    vanilla_coarse_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                            (cudaStream_t)stream>>>(
        rays_o, o_sr, o_sc, rays_d, d_sr, d_sc, bound, lin, u, u_sr, S, R, z,
        deltas, xyzs);
  return (int)cudaGetLastError();
}

// z_c, sigma [R, S] the coarse pass's; u [R, n] fp32 non-decreasing draws
// in [0, 1) with row stride u_sr (0: one row for every ray).  Writes z and
// deltas [R, S + n] and the positions [R, S + n, 3].
extern "C" int vanilla_resample(const float* rays_o, int64_t o_sr,
                                int64_t o_sc, const float* rays_d,
                                int64_t d_sr, int64_t d_sc, float bound,
                                const float* z_c, const float* sigma,
                                const float* u, int64_t u_sr, int S, int n,
                                int R, float* z, float* deltas, float* xyzs,
                                void* stream) {
  if (S < 3 || S > kMaxS || n < 1 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (R > 0)
    vanilla_resample_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                              (cudaStream_t)stream>>>(
        rays_o, o_sr, o_sc, rays_d, d_sr, d_sc, bound, z_c, sigma, u, u_sr,
        S, n, R, z, deltas, xyzs);
  return (int)cudaGetLastError();
}
