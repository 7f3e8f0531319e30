// K6: multiresolution hash-grid encode, forward (features + spatial
// jacobian) and backward (scatter-add into the table), and the table's
// total-variation and weight-decay regularizers, forward and backward.
//
// Replaces dreamfusion_tpu/ops/hashgrid.py::hash_encode (:201, with
// _level_index :114 and _level_geom :176), ::hashgrid_tv_loss (:322) and
// ::hashgrid_wd_loss (:358).  The TPU version packs each cell's 8 corner rows
// into one gathered row (_corner_pack, the affine rolls) because TPU gathers
// are priced per row; on the card the 8 corners are read directly.
//
// Bound on the card: memory latency of the row gathers.  At the flagship
// spec (L4C8, 2^19 rows per hashed level) the table is 1,576,960 x 8 fp32 =
// 50.5 MB, about the H100's 50 MB L2, so most of a step's 8 x L random
// 32-byte corner rows per sample come from L2, some from HBM.  The byte bound
// (each input read once, each output written once) is far below what the
// random reads cost.  Design: one thread per (sample, level) walks the 8
// corners, reads each row as 16-byte loads (C = 8 fp32: two float4) and
// accumulates the features and the three jacobian columns in fp32 registers;
// consecutive threads hold consecutive levels of a sample, so the outputs
// ([N, L*C], written as 16-byte stores where C*sizeof(T) allows) are written
// contiguously.  The backward repeats the walk with a warp per (level, 32
// consecutive samples), reads the cotangents in their own dtype (bf16 or
// fp32), skips lanes whose cotangents are all zero, merges the folded
// coefficients w*g_feat + sum_d dw/dx_d * g_j_d of neighbouring lanes in the
// same cell (the coarse levels, where a ray's samples or a row's pixels
// meet; csrc/field.cuh) and adds each corner row with float4 (C = 2:
// float2) reductions.  hashgrid_bwd_dx gives, in the same walk, dL/dx =
// sum g_feat * dfeat/dx from the corner rows it reads (the DMTet albedo
// query's positions) and, with cotangents on the jacobian, sum_d g_j_d *
// dj_d/dx (jax.grad through jax.jvp of hash_encode): per corner, the
// weights' mixed terms t_f * (+-ds_d dpos_d) * (+-ds_e dpos_e) and, under
// smoothstep, the pure one t_e t_f * (+-s''(f_d) dpos_d^2), s'' = 6 - 12 f;
// the levels' partials are summed in shared memory.
//
// Rules kept from hash_encode: pos = clip(x*res - 0.5, 0, res - 1) (x*res
// and the subtraction rounded separately, as the plain version and XLA do);
// d pos / d x = res strictly inside (0, res - 1), res/2 at its two ends (the
// JAX clip's tie rule) and 0 outside; dense levels (res^3 <= size) index the
// corner clamped to res - 1 per axis; hashed levels index (sum_d c_d P_d)
// mod 2^32 mod size of the unclamped corner (affine) or (xor_d c_d P_d) mod
// size of the clamped one (xor); a sample with a coordinate outside [0,1]
// gives zeros on every output and no gradient; levels >= n_active are zero.
//
// tv: one thread per (sampled cell, level), a block reduction and one atomic
// per block into the scalar loss; its backward scatters +-2 g diff / (S D L)
// into both rows of every pair.  wd: per-level block reductions of the
// squared table (one atomic per block), backward one elementwise pass; both
// are bound by reading the 50 MB table once.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 512;   // 32 x L x groups, L <= 16
constexpr unsigned kP1 = 2654435761u, kP2 = 805459861u;

struct Level {
  int res, size, offset, dense;
};

__device__ __forceinline__ Level load_level(const int* levels, int l) {
  const int4 v = reinterpret_cast<const int4*>(levels)[l];
  return {v.x, v.y, v.z, v.w};
}

// row of level lp for lattice coords c (already clamped where the rule says)
__device__ __forceinline__ unsigned lattice_index(const unsigned c[3],
                                                  const Level& lp,
                                                  bool xor_hash) {
  if (lp.dense) {
    const unsigned r = (unsigned)lp.res;
    return c[0] + c[1] * r + c[2] * (r * r);
  }
  const unsigned h = xor_hash ? (c[0] ^ (c[1] * kP1) ^ (c[2] * kP2))
                              : (c[0] + c[1] * kP1 + c[2] * kP2);
  return h % (unsigned)lp.size;
}

struct Geom {
  unsigned base[3];
  float t[3][2];      // per axis: the factor of corner bit 0 (1-s), bit 1 (s)
  float dt[3];        // d s / d x_d, d pos / d x included
  float ddt[3];       // d2 s / d x_d2 (d pos / d x twice; 0 when linear)
};

__device__ __forceinline__ void level_geom(const float xs[3], int res,
                                           bool smooth, Geom& g) {
  const float fres = (float)res, hi = (float)(res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float raw = __fsub_rn(__fmul_rn(xs[d], fres), 0.5f);
    const float pos = fminf(fmaxf(raw, 0.f), hi);
    const float fl = floorf(pos);
    const float f = __fsub_rn(pos, fl);
    float s, ds, d2s;
    if (smooth) {
      s = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.f, __fmul_rn(2.f, f)));
      ds = __fmul_rn(__fmul_rn(6.f, f), __fsub_rn(1.f, f));
      d2s = __fsub_rn(6.f, __fmul_rn(12.f, f));
    } else {
      s = f;
      ds = 1.f;
      d2s = 0.f;
    }
    const float dpos = (raw > 0.f && raw < hi) ? fres
                       : (raw == 0.f || raw == hi) ? 0.5f * fres : 0.f;
    g.base[d] = (unsigned)fl;
    g.t[d][0] = __fsub_rn(1.f, s);
    g.t[d][1] = s;
    g.dt[d] = __fmul_rn(ds, dpos);
    g.ddt[d] = __fmul_rn(__fmul_rn(d2s, dpos), dpos);
  }
}

// corner k (bit d = axis d): weight, its x/y/z derivatives and its row
struct Corner {
  float w, dw[3];
  unsigned row;
};

__device__ __forceinline__ Corner corner(const Geom& g, int k, const Level& lp,
                                         bool xor_hash) {
  const int b0 = k & 1, b1 = (k >> 1) & 1, b2 = (k >> 2) & 1;
  const float t0 = g.t[0][b0], t1 = g.t[1][b1], t2 = g.t[2][b2];
  Corner c;
  c.w = __fmul_rn(__fmul_rn(t0, t1), t2);
  c.dw[0] = __fmul_rn(__fmul_rn(t1, t2), b0 ? g.dt[0] : -g.dt[0]);
  c.dw[1] = __fmul_rn(__fmul_rn(t0, t2), b1 ? g.dt[1] : -g.dt[1]);
  c.dw[2] = __fmul_rn(__fmul_rn(t0, t1), b2 ? g.dt[2] : -g.dt[2]);
  unsigned cc[3] = {g.base[0] + b0, g.base[1] + b1, g.base[2] + b2};
  if (lp.dense || xor_hash) {
    const unsigned top = (unsigned)(lp.res - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) cc[d] = min(cc[d], top);
  }
  c.row = (unsigned)lp.offset + lattice_index(cc, lp, xor_hash);
  return c;
}

__device__ __forceinline__ bool load_x(const float* x, int64_t n,
                                       float xs[3]) {
  xs[0] = x[3 * n];
  xs[1] = x[3 * n + 1];
  xs[2] = x[3 * n + 2];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) oob |= xs[d] < 0.f || xs[d] > 1.f;
  return oob;
}

template <typename T, int C>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ levels, int N, int L,
                                int n_active, int smooth, int xor_hash,
                                T* __restrict__ feat, T* __restrict__ jx,
                                T* __restrict__ jy, T* __restrict__ jz) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)N * L) return;
  const int l = (int)(idx % L);
  const int64_t n = idx / L;
  const bool jac = jx != nullptr;
  float f[C], j0[C], j1[C], j2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) f[c] = j0[c] = j1[c] = j2[c] = 0.f;
  float xs[3];
  const bool oob = load_x(x, n, xs);
  if (!oob && l < n_active) {
    const Level lp = load_level(levels, l);
    Geom g;
    level_geom(xs, lp.res, smooth != 0, g);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const Corner q = corner(g, k, lp, xor_hash != 0);
      float row[C];
      field::load_f32<C>(table + (int64_t)q.row * C, row);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        f[c] += q.w * row[c];
        if (jac) {
          j0[c] += q.dw[0] * row[c];
          j1[c] += q.dw[1] * row[c];
          j2[c] += q.dw[2] * row[c];
        }
      }
    }
  }
  const int64_t out = idx * C;      // = n * L * C + l * C
  field::store_row<T, C>(feat + out, f);
  if (jac) {
    field::store_row<T, C>(jx + out, j0);
    field::store_row<T, C>(jy + out, j1);
    field::store_row<T, C>(jz + out, j2);
  }
}

// The table's gradient for cotangents on feat and on jx, jy, jz (any may be
// null), and with DX the positions' gradient dx [N, 3] from all of them
// (g_feat through the first derivative, the jacobians' through the
// second).  A warp per (level, 32 consecutive
// samples); a block holds the L levels of G such groups (blockDim.x =
// 32 L G), and sums their dx partials in shared memory.  Lanes whose
// cotangents are all zero, or whose sample is outside or level inactive,
// take no part.
template <typename G, int C, bool DX>
__global__ void __launch_bounds__(kBwdThreads)
    hash_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ table,
                    const int* __restrict__ levels, int N, int L, int n_active,
                    int smooth, int xor_hash, const G* __restrict__ g_feat,
                    const G* __restrict__ g_jx, const G* __restrict__ g_jy,
                    const G* __restrict__ g_jz, float* __restrict__ dtable,
                    float* __restrict__ dx) {
  extern __shared__ float part[];          // DX: [group][level][lane][3]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = warp % L, grp = warp / L;
  const int groups = blockDim.x / (32 * L);
  const int64_t n = ((int64_t)blockIdx.x * groups + grp) * 32 + lane;
  float xs[3] = {0.f, 0.f, 0.f};
  bool active = n < N && l < n_active && !load_x(x, n, xs);
  const int64_t at = (n * L + l) * C;
  float gf[C], g0[C], g1[C], g2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gf[c] = g0[c] = g1[c] = g2[c] = 0.f;
  if (active) {
    if (g_feat) field::load_cot<C>(g_feat + at, gf);
    if (g_jx) field::load_cot<C>(g_jx + at, g0);
    if (g_jy) field::load_cot<C>(g_jy + at, g1);
    if (g_jz) field::load_cot<C>(g_jz + at, g2);
    active = field::any_nonzero(gf) || field::any_nonzero(g0) ||
             field::any_nonzero(g1) || field::any_nonzero(g2);
  }
  float d[3] = {0.f, 0.f, 0.f};            // this level's share of dx
  const bool hess = DX && (g_jx || g_jy || g_jz);
  if (__any_sync(field::kFull, active)) {
    const Level lp = load_level(levels, l);
    Geom g;
    level_geom(xs, lp.res, smooth != 0, g);
    const field::Run run = field::lane_runs(g.base, active);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const Corner q = corner(g, k, lp, xor_hash != 0);
      if (DX && active) {
        float row[C];
        field::load_f32<C>(table + (int64_t)q.row * C, row);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) s += gf[c] * row[c];
#pragma unroll
        for (int e = 0; e < 3; ++e) d[e] += q.dw[e] * s;
        if (hess) {
          // sum_d (g_j_d . row) * d dw_d / d x_e (untouched, bit for bit,
          // where the jacobian's cotangents are null)
          float sj[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < C; ++c) {
            sj[0] += g0[c] * row[c];
            sj[1] += g1[c] * row[c];
            sj[2] += g2[c] * row[c];
          }
          const int bits[3] = {k & 1, (k >> 1) & 1, (k >> 2) & 1};
          float tk[3], sg[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            tk[a] = g.t[a][bits[a]];
            sg[a] = bits[a] ? g.dt[a] : -g.dt[a];
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const int b = (a + 1) % 3, f = (a + 2) % 3;
            // pure: t_b t_f (+-ddt_a); mixed (a, b): t_f sg_a sg_b
            d[a] += sj[a] * tk[b] * tk[f] *
                    (bits[a] ? g.ddt[a] : -g.ddt[a]);
            const float m = tk[f] * sg[a] * sg[b];
            d[b] += sj[a] * m;
            d[a] += sj[b] * m;
          }
        }
      }
      float coef[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        coef[c] = active ? q.w * gf[c] + q.dw[0] * g0[c] + q.dw[1] * g1[c] +
                               q.dw[2] * g2[c]
                         : 0.f;
      field::merge_runs<C>(coef, run);
      if (active && run.head)
        field::red_add<C>(dtable + (int64_t)q.row * C, coef);
    }
  }
  if constexpr (DX) {
    float* mine = part + ((grp * L + l) * 32 + lane) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) mine[e] = d[e];
    __syncthreads();
    if (l == 0 && n < N) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float sum = 0.f;
        for (int ll = 0; ll < L; ++ll)
          sum += part[((grp * L + ll) * 32 + lane) * 3 + e];
        dx[3 * n + e] = sum;
      }
    }
  }
}

// sum of v over the block, valid in thread 0; every thread must call it
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_sums[w] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
  if (w == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// rows of cell s of level l and of its +x, +y, +z neighbours
__device__ __forceinline__ void tv_rows(const int* cells, int64_t S, int l,
                                        int64_t s, const Level& lp,
                                        bool xor_hash, unsigned& r0,
                                        unsigned r1[3]) {
  const int* p = cells + ((int64_t)l * S + s) * 3;
  const unsigned c[3] = {(unsigned)p[0], (unsigned)p[1], (unsigned)p[2]};
  r0 = (unsigned)lp.offset + lattice_index(c, lp, xor_hash);
  const unsigned top = (unsigned)(lp.res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    unsigned nb[3] = {c[0], c[1], c[2]};
    nb[d] = min(nb[d] + 1, top);
    r1[d] = (unsigned)lp.offset + lattice_index(nb, lp, xor_hash);
  }
}

// grid (ceil(S / kThreads), L)
__global__ void hash_tv_fwd_kernel(const float* __restrict__ table,
                                   const int* __restrict__ levels,
                                   const int* __restrict__ cells, int S, int C,
                                   int xor_hash, float scale,
                                   float* __restrict__ out) {
  const int l = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float part = 0.f;
  if (s < S) {
    const Level lp = load_level(levels, l);
    unsigned r0, r1[3];
    tv_rows(cells, S, l, s, lp, xor_hash != 0, r0, r1);
    for (int d = 0; d < 3; ++d) {
      for (int c = 0; c < C; ++c) {
        const float diff = table[(int64_t)r1[d] * C + c] -
                           table[(int64_t)r0 * C + c];
        part += diff * diff;
      }
    }
  }
  part = block_sum(part);
  if (threadIdx.x == 0) atomicAdd(out, part * scale);
}

__global__ void hash_tv_bwd_kernel(const float* __restrict__ table,
                                   const int* __restrict__ levels,
                                   const int* __restrict__ cells, int S, int C,
                                   int xor_hash, float scale,
                                   const float* __restrict__ g,
                                   float* __restrict__ dtable) {
  const int l = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const Level lp = load_level(levels, l);
  unsigned r0, r1[3];
  tv_rows(cells, S, l, s, lp, xor_hash != 0, r0, r1);
  const float k = 2.f * g[0] * scale;
  for (int d = 0; d < 3; ++d) {
    for (int c = 0; c < C; ++c) {
      const float v = k * (table[(int64_t)r1[d] * C + c] -
                           table[(int64_t)r0 * C + c]);
      atomicAdd(dtable + (int64_t)r1[d] * C + c, v);
      atomicAdd(dtable + (int64_t)r0 * C + c, -v);
    }
  }
}

// grid (blocks, L): a grid-stride pass over level l's size * C values
__global__ void hash_wd_fwd_kernel(const float* __restrict__ table,
                                   const int* __restrict__ levels, int L,
                                   int C, float* __restrict__ out) {
  const int l = blockIdx.y;
  const Level lp = load_level(levels, l);
  const int64_t n = (int64_t)lp.size * C, base = (int64_t)lp.offset * C;
  float part = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float v = table[base + i];
    part += v * v;
  }
  part = block_sum(part);
  if (threadIdx.x == 0)
    atomicAdd(out, part * (0.5f / ((float)lp.size * (float)L)));
}

__global__ void hash_wd_bwd_kernel(const float* __restrict__ table,
                                   const int* __restrict__ levels, int L,
                                   int C, const float* __restrict__ g,
                                   float* __restrict__ dtable) {
  const int l = blockIdx.y;
  const Level lp = load_level(levels, l);
  const int64_t n = (int64_t)lp.size * C, base = (int64_t)lp.offset * C;
  const float k = g[0] / ((float)lp.size * (float)L);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dtable[base + i] = k * table[base + i];
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// blocks per level for the wd passes: enough to fill the card, each thread
// looping over a few values
inline unsigned wd_blocks(int max_size, int C) {
  const int64_t b = ((int64_t)max_size * C + kThreads * 8 - 1) /
                    ((int64_t)kThreads * 8);
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

template <typename T>
cudaError_t fwd_dispatch(int C, unsigned blocks, cudaStream_t s,
                         const float* x, const float* table, const int* levels,
                         int N, int L, int n_active, int smooth, int xor_hash,
                         void* feat, void* jx, void* jy, void* jz) {
#define HG_FWD(CC)                                                            \
  hash_fwd_kernel<T, CC><<<blocks, kThreads, 0, s>>>(                         \
      x, table, levels, N, L, n_active, smooth, xor_hash, (T*)feat, (T*)jx,   \
      (T*)jy, (T*)jz)
  switch (C) {
    case 2: HG_FWD(2); break;
    case 4: HG_FWD(4); break;
    case 8: HG_FWD(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef HG_FWD
  return cudaSuccess;
}

// a block of G groups of 32 samples x L levels (G = 8 / L, at least 1)
template <typename G, bool DX>
cudaError_t bwd_dispatch(int C, cudaStream_t s, const float* x,
                         const float* table, const int* levels, int N, int L,
                         int n_active, int smooth, int xor_hash,
                         const void* g_feat, const void* g_jx,
                         const void* g_jy, const void* g_jz, float* dtable,
                         float* dx) {
  if (N == 0) return cudaSuccess;
  if (L < 1 || 32 * L > kBwdThreads) return cudaErrorInvalidValue;
  const int groups = L >= 8 ? 1 : 8 / L;
  const unsigned blocks = (unsigned)((N + 32 * groups - 1) / (32 * groups));
  const size_t smem = DX ? (size_t)groups * L * 32 * 3 * sizeof(float) : 0;
#define HG_BWD(CC)                                                            \
  hash_bwd_kernel<G, CC, DX><<<blocks, 32 * L * groups, smem, s>>>(           \
      x, table, levels, N, L, n_active, smooth, xor_hash, (const G*)g_feat,   \
      (const G*)g_jx, (const G*)g_jy, (const G*)g_jz, dtable, dx)
  switch (C) {
    case 2: HG_BWD(2); break;
    case 4: HG_BWD(4); break;
    case 8: HG_BWD(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef HG_BWD
  return cudaSuccess;
}

}  // namespace

extern "C" int hashgrid_fwd(const float* x, const float* table,
                            const int* levels, int N, int L, int C,
                            int n_active, int smooth, int xor_hash, void* feat,
                            void* jx, void* jy, void* jz, int out_bf16,
                            void* stream) {
  const int64_t total = (int64_t)N * L;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      out_bf16 ? fwd_dispatch<__nv_bfloat16>(C, blocks_for(total), s, x, table,
                                             levels, N, L, n_active, smooth,
                                             xor_hash, feat, jx, jy, jz)
               : fwd_dispatch<float>(C, blocks_for(total), s, x, table, levels,
                                     N, L, n_active, smooth, xor_hash, feat,
                                     jx, jy, jz);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int hashgrid_bwd(const float* x, const int* levels, int N, int L,
                            int C, int n_active, int smooth, int xor_hash,
                            const void* g_feat, const void* g_jx,
                            const void* g_jy, const void* g_jz, int g_bf16,
                            float* dtable, void* stream) {
  const cudaError_t e =
      g_bf16 ? bwd_dispatch<__nv_bfloat16, false>(
                   C, (cudaStream_t)stream, x, nullptr, levels, N, L,
                   n_active, smooth, xor_hash, g_feat, g_jx, g_jy, g_jz,
                   dtable, nullptr)
             : bwd_dispatch<float, false>(
                   C, (cudaStream_t)stream, x, nullptr, levels, N, L,
                   n_active, smooth, xor_hash, g_feat, g_jx, g_jy, g_jz,
                   dtable, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dtable and dx for cotangents on feat and on jx, jy, jz (any may be null;
// with the three jacobian ones null, the first derivative alone)
extern "C" int hashgrid_bwd_dx(const float* x, const float* table,
                               const int* levels, int N, int L, int C,
                               int n_active, int smooth, int xor_hash,
                               const void* g_feat, const void* g_jx,
                               const void* g_jy, const void* g_jz, int g_bf16,
                               float* dtable, float* dx, void* stream) {
  const cudaError_t e =
      g_bf16 ? bwd_dispatch<__nv_bfloat16, true>(
                   C, (cudaStream_t)stream, x, table, levels, N, L, n_active,
                   smooth, xor_hash, g_feat, g_jx, g_jy, g_jz, dtable, dx)
             : bwd_dispatch<float, true>(
                   C, (cudaStream_t)stream, x, table, levels, N, L, n_active,
                   smooth, xor_hash, g_feat, g_jx, g_jy, g_jz, dtable, dx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int hashgrid_tv_fwd(const float* table, const int* levels,
                               const int* cells, int S, int L, int C,
                               int xor_hash, float scale, float* out,
                               void* stream) {
  if (S > 0 && L > 0) {
    hash_tv_fwd_kernel<<<dim3(blocks_for(S), L), kThreads, 0,
                         (cudaStream_t)stream>>>(table, levels, cells, S, C,
                                                 xor_hash, scale, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int hashgrid_tv_bwd(const float* table, const int* levels,
                               const int* cells, int S, int L, int C,
                               int xor_hash, float scale, const float* g,
                               float* dtable, void* stream) {
  if (S > 0 && L > 0) {
    hash_tv_bwd_kernel<<<dim3(blocks_for(S), L), kThreads, 0,
                         (cudaStream_t)stream>>>(table, levels, cells, S, C,
                                                 xor_hash, scale, g, dtable);
  }
  return (int)cudaGetLastError();
}

extern "C" int hashgrid_wd_fwd(const float* table, const int* levels, int L,
                               int C, int max_size, float* out, void* stream) {
  if (L > 0) {
    hash_wd_fwd_kernel<<<dim3(wd_blocks(max_size, C), L), kThreads, 0,
                         (cudaStream_t)stream>>>(table, levels, L, C, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int hashgrid_wd_bwd(const float* table, const int* levels, int L,
                               int C, int max_size, const float* g,
                               float* dtable, void* stream) {
  if (L > 0) {
    hash_wd_bwd_kernel<<<dim3(wd_blocks(max_size, C), L), kThreads, 0,
                         (cudaStream_t)stream>>>(table, levels, L, C, g,
                                                 dtable);
  }
  return (int)cudaGetLastError();
}
