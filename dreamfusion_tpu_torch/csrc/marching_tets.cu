// K8: marching tetrahedra at fixed slots and the DMTet mesh regularizers
// (vertex normals, uniform Laplacian, normal consistency), forward and
// backward.
//
// Replaces dreamfusion_tpu/ops/marching_tets.py::marching_tets,
// ::vertex_normals, ::laplacian_smooth_loss and ::normal_consistency_loss.
// On the TPU the valid triangles are compacted with top_k over a [2F] mask,
// the scatters are segment sums and shared edges are found by a
// lexicographic sort of (lo, hi) edge keys.  Here every entry point is one
// launch call (one kernel; two for the regularizers' backwards), with no
// zero fill, and only the marching-tets backward scatters with atomics:
//   * marching tets forward: one launch whose blocks are, in order, the
//     tets' (count, a block scan, a decoupled look-back over the earlier
//     tet blocks for the block's offset, then the triangles written at
//     their compacted slots: the TPU top_k's order, valid slots first in
//     slot order), the edges' (crossing test, interpolated vertex) and a
//     few tail blocks that wait for the last tet block's total and zero the
//     slots past it (faces, mask, face_info); the first of them writes the
//     total, the surface's true face count before the max_tris cut.  Beside the faces it records
//     each tet triangle's slot (tri_slot, -1 when a tet has one triangle or
//     the slot fell past max_tris) and each slot's (tet, triangle, tet
//     index) (face_info), which the regularizers use.  The look-back flags
//     and the block counter reset themselves (the last block to finish
//     clears them), so the launch needs no zero fill and replays in a CUDA
//     graph;
//   * marching tets backward: one cooperative launch zeroes d vert_pos and
//     d sdf, then (after a grid barrier) every edge with a non-zero
//     cotangent adds into its two grid vertices;
//   * vertex normals and the Laplacian: a thread per edge slot (surface
//     vertex) walks the static ring of tets around its edge, takes those
//     tets' triangles that hold the vertex (tri_slot) and gathers the face
//     terms, writing its row whole (zero off the surface); the backwards
//     (normal consistency's too) first compute each face's three vertex
//     terms once (*_face_kernel), then gather them the same way
//     (mt_gather_kernel);
//   * normal consistency: a thread per face slot finds the partner of each
//     of its edges from the static tet adjacency: an edge between two
//     opposite tet edges is the diagonal of the tet's quad (partner: the
//     tet's other triangle); any other edge lies on the tet face holding
//     both tet edges, and its partner is the triangle of the tet across
//     that face that holds both (none at the grid's boundary, or when that
//     triangle fell past max_tris): exactly the pairs of equal keys of the
//     TPU's sort;
//   * each loss's mean is finished on the card: every block writes its
//     partial sums, and the last block to finish adds them in block order
//     and writes the loss and its denominator (deterministic).
//
// Bound on the card: memory.  At tet_grid_size 128 the forward reads the
// 1.57M tets' occupancy through the sdf and their edge ids (38 MB), the
// 1.9M unique edges (15 MB) and writes the surface vertices (23 MB); the
// regularizers read and write the E edge slots' rows (23 MB each), of which
// only the ~1-5% on the surface do any work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__constant__ int kTriTable[16][6] = {
    {-1, -1, -1, -1, -1, -1}, {1, 0, 2, -1, -1, -1}, {4, 0, 3, -1, -1, -1},
    {1, 4, 2, 1, 3, 4},       {3, 1, 5, -1, -1, -1}, {2, 3, 0, 2, 5, 3},
    {1, 4, 0, 1, 5, 4},       {4, 2, 5, -1, -1, -1}, {4, 5, 2, -1, -1, -1},
    {4, 1, 0, 4, 5, 1},       {3, 2, 0, 3, 5, 2},    {1, 3, 5, -1, -1, -1},
    {4, 1, 2, 4, 3, 1},       {3, 0, 4, -1, -1, -1}, {2, 0, 1, -1, -1, -1},
    {-1, -1, -1, -1, -1, -1}};
__constant__ int kNumTri[16] = {0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0};
// tet edges (01, 02, 03, 12, 13, 23): for two edges that share a vertex, the
// tet vertex on neither (the one opposite the face holding both); -1 for
// opposite edges (local ids summing to 5) and on the diagonal
__constant__ int kOppVert[6][6] = {
    {-1, 3, 2, 3, 2, -1}, {3, -1, 1, 3, -1, 1}, {2, 1, -1, -1, 2, 1},
    {3, 3, -1, -1, 0, 0}, {2, -1, 2, 0, -1, 0}, {-1, 1, 1, 0, 0, -1}};

constexpr int kBlock = 1024;      // tets or edges per marching-tets block
constexpr int kTail = 16;         // blocks zeroing the slots past the total
constexpr int kThreads = 256;
constexpr int kLossBlocks = 1024;  // a loss kernel's grid-stride blocks (of
                                   // kThreads): at most this many partials
constexpr unsigned long long kAgg = 1ull << 62;   // look-back: aggregate
constexpr unsigned long long kIncl = 2ull << 62;  // look-back: prefix
constexpr unsigned long long kValue = (1ull << 62) - 1;

struct F3 {
  float x, y, z;
};
__device__ __forceinline__ F3 ld3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void st3(float* p, int64_t i, F3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ F3 sub(F3 a, F3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ F3 add(F3 a, F3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ F3 scale(F3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(F3 a, F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ void atomic3(float* p, int64_t i, F3 v) {
  atomicAdd(p + 3 * i, v.x);
  atomicAdd(p + 3 * i + 1, v.y);
  atomicAdd(p + 3 * i + 2, v.z);
}

// ---- marching tets ---------------------------------------------------------

__device__ __forceinline__ int tet_index(const float* sdf, const int* tets,
                                         int f) {
  int idx = 0;
  for (int k = 0; k < 4; ++k) idx |= (sdf[tets[4 * f + k]] > 0.f) << k;
  return idx;
}

// block-wide exclusive scan of one int per thread (blockDim.x == kBlock)
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += u;
    }
    s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return s_warp[warp] + incl - v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The block's look-back is over (or it never needed one): count it, and the
// last of the tet and tail blocks clears the flags and the counter for the
// next launch.  Every thread of the block calls it.
__device__ void finish_lookback(unsigned long long* status, unsigned* done,
                                int n_flags, unsigned n_blocks, int* s_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = atomicAdd(done, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  for (int i = threadIdx.x; i < n_flags; i += blockDim.x) status[i] = 0ull;
  if (threadIdx.x == 0) *done = 0u;
}

// The exclusive prefix of tet block b's triangle count (warp 0 of the block,
// CUB's decoupled look-back): publish the block's total, then read the
// flags of the 32 blocks before it at once, adding aggregates until the
// nearest inclusive prefix; publish the block's own prefix.
__device__ int lookback(unsigned long long* status, int b, int total) {
  const int lane = threadIdx.x & 31;
  if (b == 0) {
    if (lane == 0) atomicExch(status, kIncl | (unsigned long long)total);
    return 0;
  }
  if (lane == 0) atomicExch(status + b, kAgg | (unsigned long long)total);
  int prefix = 0;
  for (int j = b - 1;; j -= 32) {
    const int i = j - lane;                  // lane 0: the nearest block
    unsigned long long w;
    do {
      w = i >= 0 ? peek(status + i) : kIncl;  // before block 0: prefix 0
    } while (__any_sync(0xffffffffu, w == 0ull));
    const unsigned incl = __ballot_sync(0xffffffffu, (w & kIncl) != 0ull);
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? (int)(w & kValue) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    prefix += v;
    if (incl) break;
  }
  if (lane == 0)
    atomicExch(status + b, kIncl | (unsigned long long)(prefix + total));
  return prefix;
}

__global__ void __launch_bounds__(kBlock) mt_fwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ sdf,
    const int* __restrict__ tets, const int* __restrict__ tet_edges,
    const int* __restrict__ ue, int F, int E, int max_tris, int nbT,
    int nbE, unsigned long long* status, unsigned* done,
    float* __restrict__ verts, uint8_t* __restrict__ crossing,
    int* __restrict__ faces, uint8_t* __restrict__ mask,
    int* __restrict__ tri_slot, int* __restrict__ face_info,
    int* __restrict__ n_faces) {
  __shared__ int s_warp[32];
  __shared__ int s_total, s_prefix, s_last;
  const int tid = threadIdx.x;
  const unsigned n_sync = (unsigned)(nbT + kTail);
  // blocks alternate tet, edge, tet, ... (the look-back's waits overlap the
  // edges' memory traffic), then the rest of either, then the tail; tet
  // blocks keep their order
  const int b = blockIdx.x, n2 = 2 * min(nbT, nbE);
  int tb = -1, eb = -1;
  if (b < n2) {
    (b & 1 ? eb : tb) = b >> 1;
  } else if (b < nbT + nbE) {
    (nbT > nbE ? tb : eb) = (n2 >> 1) + b - n2;
  }
  if (tb >= 0) {                                   // ---- tets
    const int f = tb * kBlock + tid;
    const int idx = f < F ? tet_index(sdf, tets, f) : 0;
    const int n = kNumTri[idx];
    const int excl = block_exclusive_scan(n, s_warp, &s_total);
    if (tid < 32) {
      const int prefix = lookback(status, tb, s_total);
      if (tid == 0) s_prefix = prefix;
    }
    __syncthreads();
    if (f < F) {
      const int off = s_prefix + excl;
      for (int k = 0; k < n; ++k) {
        const int slot = off + k;
        int keep = -1;
        if (slot < max_tris) {
          for (int j = 0; j < 3; ++j)
            faces[3 * slot + j] = tet_edges[6 * f + kTriTable[idx][3 * k + j]];
          mask[slot] = 1;
          face_info[slot] = (f << 5) | (k << 4) | idx;
          keep = slot;
        }
        tri_slot[2 * (int64_t)f + k] = keep;
      }
      if (n == 1) tri_slot[2 * (int64_t)f + 1] = -1;
    }
    finish_lookback(status, done, nbT, n_sync, &s_last);
  } else if (eb >= 0) {                            // ---- edges
    const int e = eb * kBlock + tid;
    if (e >= E) return;
    const int a = ue[2 * e], c = ue[2 * e + 1];
    const float sa = sdf[a], sb = sdf[c];
    crossing[e] = (sa > 0.f) != (sb > 0.f);
    float d = sa - sb;
    if (fabsf(d) < 1e-10f) d = d < 0.f ? -1e-10f : 1e-10f;
    const float t = fminf(fmaxf(sa / d, 0.f), 1.f);
    const F3 pa = ld3(pos, a), pb = ld3(pos, c);
    st3(verts, e, {pa.x + (pb.x - pa.x) * t, pa.y + (pb.y - pa.y) * t,
                   pa.z + (pb.z - pa.z) * t});
  } else {                                         // ---- tail: zero slots
    if (tid == 0) {
      unsigned long long w = kIncl;
      if (nbT > 0) {
        do {
          w = peek(status + nbT - 1);
        } while (!(w & kIncl));
      }
      const unsigned long long total = w & kValue;
      s_total = total < (unsigned long long)max_tris ? (int)total : max_tris;
      if (b == nbT + nbE) *n_faces = (int)total;
    }
    __syncthreads();
    const int z = b - nbT - nbE;
    for (int slot = s_total + z * kBlock + tid; slot < max_tris;
         slot += kTail * kBlock) {
      faces[3 * slot] = faces[3 * slot + 1] = faces[3 * slot + 2] = 0;
      mask[slot] = 0;
      face_info[slot] = 0;
    }
    finish_lookback(status, done, nbT, n_sync, &s_last);
  }
}

// One cooperative launch: the grid zeroes d vert_pos and d sdf, waits at a
// grid barrier, then each edge with a non-zero cotangent adds its
// interpolated vertex's gradient into its two grid vertices (the DMTet
// path's cotangents are zero off the surface: ~2% of the edges).
__global__ void __launch_bounds__(kThreads) mt_bwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ sdf,
    const int* __restrict__ ue, int V, int E,
    const float* __restrict__ g_verts, float* __restrict__ g_pos,
    float* __restrict__ g_sdf) {
  cg::grid_group grid = cg::this_grid();
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = i0; i < 3 * (int64_t)V; i += stride) g_pos[i] = 0.f;
  for (int64_t i = i0; i < V; i += stride) g_sdf[i] = 0.f;
  grid.sync();
  for (int64_t e = i0; e < E; e += stride) {
    const F3 g = ld3(g_verts, e);
    if (g.x == 0.f && g.y == 0.f && g.z == 0.f) continue;
    const int a = ue[2 * e], b = ue[2 * e + 1];
    const float sa = sdf[a], sb = sdf[b];
    const float d0 = sa - sb;
    const bool guarded = fabsf(d0) < 1e-10f;
    const float d = guarded ? (d0 < 0.f ? -1e-10f : 1e-10f) : d0;
    const float x = sa / d;
    const float t = fminf(fmaxf(x, 0.f), 1.f);
    atomic3(g_pos, a, scale(g, 1.f - t));
    atomic3(g_pos, b, scale(g, t));
    // t = min(max(x, 0), 1): a tie with a bound passes half the gradient
    const float y = fmaxf(x, 0.f);
    const float pass = (x > 0.f ? 1.f : x == 0.f ? 0.5f : 0.f) *
                       (y < 1.f ? 1.f : y == 1.f ? 0.5f : 0.f);
    if (pass > 0.f) {
      const float gt = pass * dot(g, sub(ld3(pos, b), ld3(pos, a)));
      // x = sa / d with d = sa - sb (a constant when guarded)
      const float dxa = guarded ? 1.f / d : -sb / (d * d);
      const float dxb = guarded ? 0.f : sa / (d * d);
      atomicAdd(g_sdf + a, gt * dxa);
      atomicAdd(g_sdf + b, gt * dxb);
    }
  }
}

// ---- the ring of faces around a surface vertex ------------------------------

// Calls fn(slot, k) for every face that holds edge slot e, k its position in
// the face: the triangles of the tets around edge e (e's ring) whose
// vertices include e.  The ring's triangle slots, kRing tets at a time, are
// loaded together into the thread's row of shared memory (blocks of
// kThreads), so the walk waits on one load for them, not one per tet; the
// faces are visited four at a time for the same reason.
constexpr int kRing = 8;

template <typename Fn>
__device__ __forceinline__ void for_ring_faces(int e,
                                               const int* __restrict__ et_off,
                                               const int* __restrict__ et,
                                               const int* __restrict__ tri_slot,
                                               const int* __restrict__ faces,
                                               Fn fn) {
  __shared__ int s_ring[2 * kRing][kThreads];
  int* ring = &s_ring[0][threadIdx.x];       // stride kThreads: no conflicts
  const int r1 = et_off[e + 1];
  for (int r0 = et_off[e]; r0 < r1; r0 += kRing) {
#pragma unroll
    for (int q = 0; q < kRing; ++q) {
      const int64_t g = r0 + q < r1 ? et[r0 + q] : -1;
      ring[2 * q * kThreads] = g >= 0 ? tri_slot[2 * g] : -1;
      ring[(2 * q + 1) * kThreads] = g >= 0 ? tri_slot[2 * g + 1] : -1;
    }
#pragma unroll 4
    for (int q = 0; q < 2 * kRing; ++q) {
      const int s = ring[q * kThreads];
      if (s < 0) continue;
      const int* f = faces + 3 * s;
      const int k = f[0] == e ? 0 : f[1] == e ? 1 : f[2] == e ? 2 : -1;
      if (k >= 0) fn(s, k);
    }
  }
}

__device__ __forceinline__ F3 face_cross(const float* verts, const int* f) {
  const F3 v0 = ld3(verts, f[0]);
  return cross(sub(ld3(verts, f[1]), v0), sub(ld3(verts, f[2]), v0));
}

// the gradients of vertices 0, 1, 2 of fn = (v1 - v0) x (v2 - v0) for the
// cotangent g of fn → out[0..2] (x, y, z, 0)
__device__ __forceinline__ void cross_bwd3(const float* verts, const int* f,
                                           F3 g, float4* out) {
  const F3 v0 = ld3(verts, f[0]);
  const F3 a = sub(ld3(verts, f[1]), v0), b = sub(ld3(verts, f[2]), v0);
  const F3 da = cross(b, g), db = cross(g, a);
  const F3 d0 = scale(add(da, db), -1.f);
  out[0] = make_float4(d0.x, d0.y, d0.z, 0.f);
  out[1] = make_float4(da.x, da.y, da.z, 0.f);
  out[2] = make_float4(db.x, db.y, db.z, 0.f);
}

// ---- last-block reduction of a loss -----------------------------------------

// Sums (a, b) over the grid: every block writes its partial, and the last
// block to finish adds the partials in block order and writes
// loss = A / max(B, 1) and den = max(B, 1).  Every thread calls it.
__device__ void mean_of_grid(float a, float b, float2* __restrict__ partials,
                             unsigned* done, float* __restrict__ loss,
                             float* __restrict__ den) {
  __shared__ float s_a[32], s_b[32];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, d);
    b += __shfl_down_sync(0xffffffffu, b, d);
  }
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float A = 0.f, B = 0.f;
    for (int w = 0; w < nw; ++w) {
      A += s_a[w];
      B += s_b[w];
    }
    partials[blockIdx.x] = make_float2(A, B);
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  a = b = 0.f;
#pragma unroll 8
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    const float2 p = __ldcg(partials + i);     // past L1: other blocks
    a += p.x;
    b += p.y;
  }
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, d);
    b += __shfl_down_sync(0xffffffffu, b, d);
  }
  __syncthreads();
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float A = 0.f, B = 0.f;
    for (int w = 0; w < nw; ++w) {
      A += s_a[w];
      B += s_b[w];
    }
    const float d = fmaxf(B, 1.f);
    *loss = A / d;
    *den = d;
    *done = 0u;
  }
}

// ---- vertex normals ----------------------------------------------------------

__global__ void vn_fwd_kernel(const float* __restrict__ verts,
                              const int* __restrict__ faces,
                              const uint8_t* __restrict__ crossing,
                              const int* __restrict__ tri_slot,
                              const int* __restrict__ et_off,
                              const int* __restrict__ et, int E,
                              float* __restrict__ out,
                              float* __restrict__ rs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  F3 acc = {0.f, 0.f, 0.f};
  if (crossing[e]) {
    for_ring_faces(e, et_off, et, tri_slot, faces, [&](int s, int) {
      acc = add(acc, face_cross(verts, faces + 3 * s));
    });
  }
  const float n2 = dot(acc, acc);
  F3 n = {0.f, 1.f, 0.f};
  float r = 0.f;
  if (n2 > 1e-20f) {
    r = rsqrtf(n2);
    n = scale(acc, r);
  }
  st3(out, e, n);
  if (crossing[e]) rs[e] = r;
}

// g_acc of vertex u: d normalize(acc) for the cotangent g_n (0 when acc ~ 0)
__device__ __forceinline__ F3 vn_gacc(const float* n, const float* rs,
                                      const float* g_n, int u) {
  const float r = rs[u];
  if (r == 0.f) return {0.f, 0.f, 0.f};
  const F3 nn = ld3(n, u), g = ld3(g_n, u);
  const float p = dot(nn, g);
  return scale(sub(g, scale(nn, p)), r);
}

__global__ void vn_face_kernel(const float* __restrict__ verts,
                               const int* __restrict__ faces,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ n,
                               const float* __restrict__ rs,
                               const float* __restrict__ g_n, int T,
                               float4* __restrict__ term) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= T || !mask[s]) return;
  const int* f = faces + 3 * s;
  const F3 g = add(add(vn_gacc(n, rs, g_n, f[0]), vn_gacc(n, rs, g_n, f[1])),
                   vn_gacc(n, rs, g_n, f[2]));
  cross_bwd3(verts, f, g, term + 3 * (int64_t)s);
}

// ---- Laplacian ---------------------------------------------------------------

// aux[e] = (mean of the neighbours - v, count of directed face edges) for a
// vertex on a face
__global__ void lap_fwd_kernel(const float* __restrict__ verts,
                               const int* __restrict__ faces,
                               const uint8_t* __restrict__ crossing,
                               const int* __restrict__ tri_slot,
                               const int* __restrict__ et_off,
                               const int* __restrict__ et, int E,
                               float4* __restrict__ aux,
                               float2* __restrict__ partials, unsigned* done,
                               float* __restrict__ loss,
                               float* __restrict__ den) {
  float d2 = 0.f, active = 0.f;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
    if (!crossing[e]) continue;
    F3 s = {0.f, 0.f, 0.f};
    float c = 0.f;
    // each vertex receives both others: the face's 6 directed edges
    for_ring_faces(e, et_off, et, tri_slot, faces, [&](int sl, int k) {
      const int* f = faces + 3 * sl;
      s = add(s, add(ld3(verts, f[(k + 1) % 3]), ld3(verts, f[(k + 2) % 3])));
      c += 2.f;
    });
    if (c > 0.f) {
      const F3 v = ld3(verts, e);
      const F3 dm = {s.x / c - v.x, s.y / c - v.y, s.z / c - v.z};
      d2 += dot(dm, dm);
      active += 1.f;
      aux[e] = make_float4(dm.x, dm.y, dm.z, c);
    }
  }
  mean_of_grid(d2, active, partials, done, loss, den);
}

// face s's term of vertex k: v_k fed the neighbour sums of both others
__global__ void lap_face_kernel(const int* __restrict__ faces,
                                const uint8_t* __restrict__ mask,
                                const float4* __restrict__ aux,
                                const float* __restrict__ g,
                                const float* __restrict__ den, int T,
                                float4* __restrict__ term) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= T || !mask[s]) return;
  const float kk = 2.f * (g[0] / den[0]);
  const int* f = faces + 3 * s;
  float4 q[3];
  for (int k = 0; k < 3; ++k) q[k] = aux[f[k]];
  for (int k = 0; k < 3; ++k) {
    const float4 a = q[(k + 1) % 3], b = q[(k + 2) % 3];
    term[3 * (int64_t)s + k] = make_float4(
        kk * a.x / a.w + kk * b.x / b.w, kk * a.y / a.w + kk * b.y / b.w,
        kk * a.z / a.w + kk * b.z / b.w, 0.f);
  }
}

// ---- normal consistency ------------------------------------------------------

__device__ __forceinline__ bool holds(const int* f, int a, int b) {
  const bool ha = f[0] == a || f[1] == a || f[2] == a;
  const bool hb = f[0] == b || f[1] == b || f[2] == b;
  return ha && hb;
}

// unit normal fn * rsqrt(max(|fn|², 1e-20)) and |fn|²
__device__ __forceinline__ F3 unit_normal(const float* verts, const int* f,
                                          float* n2) {
  const F3 fn = face_cross(verts, f);
  *n2 = dot(fn, fn);
  return scale(fn, rsqrtf(fmaxf(*n2, 1e-20f)));
}

__global__ void nc_fwd_kernel(const float* __restrict__ verts,
                              const int* __restrict__ faces,
                              const uint8_t* __restrict__ mask,
                              const int* __restrict__ face_info,
                              const int* __restrict__ tri_slot,
                              const int* __restrict__ tet_nbr, int T,
                              float4* __restrict__ nrm,
                              int* __restrict__ partner,
                              float2* __restrict__ partials, unsigned* done,
                              float* __restrict__ loss,
                              float* __restrict__ den) {
  float term = 0.f, pairs = 0.f;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < T;
       s += gridDim.x * blockDim.x) {
    int p3[3] = {-1, -1, -1};
    if (mask[s]) {
      const int info = face_info[s];
      const int64_t f = info >> 5;
      const int j = (info >> 4) & 1, idx = info & 15;
      const int* fv = faces + 3 * s;
      float n2;
      const F3 ns = unit_normal(verts, fv, &n2);
      nrm[s] = make_float4(ns.x, ns.y, ns.z, n2);
      for (int k = 0; k < 3; ++k) {
        const int la = kTriTable[idx][3 * j + k];
        const int lb = kTriTable[idx][3 * j + (k + 1) % 3];
        int p = -1;
        if (la + lb == 5) {          // the quad's diagonal
          p = tri_slot[2 * f + 1 - j];
        } else {                     // across the tet face holding both
          const int g = tet_nbr[4 * f + kOppVert[la][lb]];
          if (g >= 0) {
            for (int jj = 0; jj < 2; ++jj) {
              const int s2 = tri_slot[2 * (int64_t)g + jj];
              if (s2 >= 0 && holds(faces + 3 * s2, fv[k], fv[(k + 1) % 3]))
                p = s2;
            }
          }
        }
        p3[k] = p;
        if (p > s) {                 // each pair once
          float m2;
          term += 1.f - dot(ns, unit_normal(verts, faces + 3 * p, &m2));
          pairs += 1.f;
        }
      }
    }
    for (int k = 0; k < 3; ++k) partner[3 * s + k] = p3[k];
  }
  mean_of_grid(term, pairs, partials, done, loss, den);
}

__global__ void nc_face_kernel(const float* __restrict__ verts,
                               const int* __restrict__ faces,
                               const uint8_t* __restrict__ mask,
                               const float4* __restrict__ nrm,
                               const int* __restrict__ partner,
                               const float* __restrict__ g,
                               const float* __restrict__ den, int T,
                               float4* __restrict__ term) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= T || !mask[s]) return;
  // d(1 - n_s . n_p) / d n_s over the face's pairs
  F3 gn = {0.f, 0.f, 0.f};
  for (int q = 0; q < 3; ++q) {
    const int p = partner[3 * s + q];
    if (p >= 0) {
      const float4 m = nrm[p];
      gn = add(gn, {m.x, m.y, m.z});
    }
  }
  gn = scale(gn, -(g[0] / den[0]));
  const float4 m = nrm[s];
  F3 gf;
  if (m.w > 1e-20f) {            // d(fn / |fn|)
    const F3 ns = {m.x, m.y, m.z};
    gf = scale(sub(gn, scale(ns, dot(ns, gn))), rsqrtf(m.w));
  } else {                       // fn · rsqrt(1e-20): linear
    gf = scale(gn, 1e10f);
  }
  cross_bwd3(verts, faces + 3 * s, gf, term + 3 * (int64_t)s);
}

// ---- per-face terms gathered per vertex ---------------------------------------

// A thread per edge slot: the sum of the terms (term [T][3], by the vertex's
// position in the face) of the faces that hold it, plus, for the Laplacian,
// the vertex's own -kk (mean - v); rows off the surface are 0.  The faces'
// terms are computed once each by the *_face kernels before it.
template <bool kLapOwn>
__global__ void mt_gather_kernel(const int* __restrict__ faces,
                                    const uint8_t* __restrict__ crossing,
                                    const int* __restrict__ tri_slot,
                                    const int* __restrict__ et_off,
                                    const int* __restrict__ et,
                                    const float4* __restrict__ term,
                                    const float4* __restrict__ aux,
                                    const float* __restrict__ g,
                                    const float* __restrict__ den, int E,
                                    float* __restrict__ g_verts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  F3 gv = {0.f, 0.f, 0.f};
  if (crossing[e]) {
    bool on_face = false;
    for_ring_faces(e, et_off, et, tri_slot, faces, [&](int s, int k) {
      const float4 t = term[3 * (int64_t)s + k];
      gv = add(gv, {t.x, t.y, t.z});
      on_face = true;
    });
    if (kLapOwn && on_face) {
      const float kk = 2.f * (g[0] / den[0]);
      const float4 a = aux[e];
      gv = add(gv, {-kk * a.x, -kk * a.y, -kk * a.z});
    }
  }
  st3(g_verts, e, gv);
}

inline unsigned blocks(int64_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

// a loss kernel's grid over n threads' work (at least one block)
inline unsigned loss_blocks(int64_t n) {
  const unsigned b = blocks(n > 0 ? n : 1, kThreads);
  return b < (unsigned)kLossBlocks ? b : (unsigned)kLossBlocks;
}

}  // namespace

// status [>= nbT] uint64 and done [1]: zero before the first launch; the
// kernel leaves them zero.  n_faces [1]: the surface's face count, the
// slots past max_tris included
extern "C" int marching_tets_fwd(const float* pos, const float* sdf,
                                 const int* tets, const int* tet_edges,
                                 const int* unique_edges, int F, int E,
                                 int max_tris, unsigned long long* status,
                                 unsigned* done, float* verts,
                                 uint8_t* crossing, int* faces, uint8_t* mask,
                                 int* tri_slot, int* face_info, int* n_faces,
                                 void* stream) {
  const int nbT = (int)blocks(F, kBlock), nbE = (int)blocks(E, kBlock);
  mt_fwd_kernel<<<nbT + nbE + kTail, kBlock, 0, (cudaStream_t)stream>>>(
      pos, sdf, tets, tet_edges, unique_edges, F, E, max_tris, nbT, nbE,
      status, done, verts, crossing, faces, mask, tri_slot, face_info,
      n_faces);
  return (int)cudaGetLastError();
}

// a cooperative launch of `ctas` blocks (at most those the card holds at
// once: 2 a multiprocessor)
extern "C" int marching_tets_bwd(const float* pos, const float* sdf,
                                 const int* unique_edges, int V, int E,
                                 const float* g_verts, float* g_pos,
                                 float* g_sdf, int ctas, void* stream) {
  void* args[] = {(void*)&pos,     (void*)&sdf,   (void*)&unique_edges,
                  (void*)&V,       (void*)&E,     (void*)&g_verts,
                  (void*)&g_pos,   (void*)&g_sdf};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)mt_bwd_kernel, dim3((unsigned)ctas), dim3(kThreads), args,
      0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int vertex_normals_fwd(const float* verts, const int* faces,
                                  const uint8_t* crossing,
                                  const int* tri_slot, const int* et_off,
                                  const int* et, int E, float* out, float* rs,
                                  void* stream) {
  if (E > 0)
    vn_fwd_kernel<<<blocks(E, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        verts, faces, crossing, tri_slot, et_off, et, E, out, rs);
  return (int)cudaGetLastError();
}

// term [T][3] float4: scratch (the faces' terms, then the gather)
extern "C" int vertex_normals_bwd(const float* verts, const int* faces,
                                  const uint8_t* mask, const uint8_t* crossing,
                                  const int* tri_slot, const int* et_off,
                                  const int* et, const float* n,
                                  const float* rs, const float* g_n, int E,
                                  int T, float* term, float* g_verts,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 0)
    vn_face_kernel<<<blocks(T, kThreads), kThreads, 0, st>>>(
        verts, faces, mask, n, rs, g_n, T, (float4*)term);
  if (E > 0)
    mt_gather_kernel<false><<<blocks(E, kThreads), kThreads, 0, st>>>(
        faces, crossing, tri_slot, et_off, et, (const float4*)term, nullptr,
        nullptr, nullptr, E, g_verts);
  return (int)cudaGetLastError();
}

// partials [1024] float2, done [1] zero before the first launch
extern "C" int laplacian_fwd(const float* verts, const int* faces,
                             const uint8_t* crossing, const int* tri_slot,
                             const int* et_off, const int* et, int E,
                             float* aux, float* partials, unsigned* done,
                             float* loss, float* den, void* stream) {
  lap_fwd_kernel<<<loss_blocks(E), kThreads, 0, (cudaStream_t)stream>>>(
      verts, faces, crossing, tri_slot, et_off, et, E, (float4*)aux,
      (float2*)partials, done, loss, den);
  return (int)cudaGetLastError();
}

extern "C" int laplacian_bwd(const int* faces, const uint8_t* mask,
                             const uint8_t* crossing, const int* tri_slot,
                             const int* et_off, const int* et,
                             const float* aux, const float* g,
                             const float* den, int E, int T, float* term,
                             float* g_verts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 0)
    lap_face_kernel<<<blocks(T, kThreads), kThreads, 0, st>>>(
        faces, mask, (const float4*)aux, g, den, T, (float4*)term);
  if (E > 0)
    mt_gather_kernel<true><<<blocks(E, kThreads), kThreads, 0, st>>>(
        faces, crossing, tri_slot, et_off, et, (const float4*)term,
        (const float4*)aux, g, den, E, g_verts);
  return (int)cudaGetLastError();
}

// partials [1024] float2, done [1] zero before the first launch
extern "C" int normal_consistency_fwd(const float* verts, const int* faces,
                                      const uint8_t* mask,
                                      const int* face_info,
                                      const int* tri_slot, const int* tet_nbr,
                                      int T, float* nrm, int* partner,
                                      float* partials, unsigned* done,
                                      float* loss, float* den, void* stream) {
  nc_fwd_kernel<<<loss_blocks(T), kThreads, 0, (cudaStream_t)stream>>>(
      verts, faces, mask, face_info, tri_slot, tet_nbr, T, (float4*)nrm,
      partner, (float2*)partials, done, loss, den);
  return (int)cudaGetLastError();
}

extern "C" int normal_consistency_bwd(const float* verts, const int* faces,
                                      const uint8_t* mask,
                                      const uint8_t* crossing,
                                      const int* tri_slot, const int* et_off,
                                      const int* et, const float* nrm,
                                      const int* partner, const float* g,
                                      const float* den, int E, int T,
                                      float* term, float* g_verts,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 0)
    nc_face_kernel<<<blocks(T, kThreads), kThreads, 0, st>>>(
        verts, faces, mask, (const float4*)nrm, partner, g, den, T,
        (float4*)term);
  if (E > 0)
    mt_gather_kernel<false><<<blocks(E, kThreads), kThreads, 0, st>>>(
        faces, crossing, tri_slot, et_off, et, (const float4*)term, nullptr,
        nullptr, nullptr, E, g_verts);
  return (int)cudaGetLastError();
}
