// K8: marching tetrahedra at fixed slots and the DMTet mesh regularizers
// (vertex normals, uniform Laplacian, normal consistency), forward and
// backward.
//
// Replaces dreamfusion_tpu/ops/marching_tets.py::marching_tets,
// ::vertex_normals, ::laplacian_smooth_loss and ::normal_consistency_loss.
// On the TPU the valid triangles are compacted with top_k over a [2F] mask,
// the scatters are segment sums and shared edges are found by a
// lexicographic sort of (lo, hi) edge keys.  Here:
//   * marching tets: a per-edge kernel (crossing test, interpolated
//     vertex), a per-tet kernel that counts each block's triangles, a
//     one-block scan of the block counts and a per-tet kernel that scans
//     inside its block and writes the triangles at their compacted slots:
//     the order is the TPU top_k's (valid slots first, in slot order);
//     the backward atomically adds d verts into d vert_pos and d sdf;
//   * vertex normals and the Laplacian: atomic scatters over faces, then
//     a per-vertex pass; backward, a per-vertex pass and a per-face pass
//     that gathers the per-vertex cotangents and scatters into the verts;
//   * normal consistency: faces that share an undirected edge meet in an
//     open-addressing hash table on the 64-bit key (lo << 32 | hi), claimed
//     with atomicCAS; every later face on an edge pairs with the edge's
//     first (with two faces per edge, the only case the mesh makes, that is
//     the one pair); the loss terms are 1 - cos per pair.
// The regularizers' final sums and divisions are torch.
//
// Bound on the card: memory.  At tet_grid_size 128 the forward reads the
// 1.57M tets' occupancy through the sdf and their edge ids (38 MB), the
// 1.9M unique edges (15 MB) and writes the surface vertices (23 MB); the
// regularizers move a few MB.  Every kernel is one thread per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kTriTable[16][6] = {
    {-1, -1, -1, -1, -1, -1}, {1, 0, 2, -1, -1, -1}, {4, 0, 3, -1, -1, -1},
    {1, 4, 2, 1, 3, 4},       {3, 1, 5, -1, -1, -1}, {2, 3, 0, 2, 5, 3},
    {1, 4, 0, 1, 5, 4},       {4, 2, 5, -1, -1, -1}, {4, 5, 2, -1, -1, -1},
    {4, 1, 0, 4, 5, 1},       {3, 2, 0, 3, 5, 2},    {1, 3, 5, -1, -1, -1},
    {4, 1, 2, 4, 3, 1},       {3, 0, 4, -1, -1, -1}, {2, 0, 1, -1, -1, -1},
    {-1, -1, -1, -1, -1, -1}};
__constant__ int kNumTri[16] = {0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0};

constexpr int kBlock = 1024;      // tets per compaction block
constexpr int kThreads = 256;

struct F3 {
  float x, y, z;
};
__device__ __forceinline__ F3 ld3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ F3 sub(F3 a, F3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ F3 add(F3 a, F3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
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

__global__ void mt_edge_kernel(const float* __restrict__ pos,
                               const float* __restrict__ sdf,
                               const int* __restrict__ ue, int E,
                               float* __restrict__ verts,
                               uint8_t* __restrict__ crossing) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int a = ue[2 * e], b = ue[2 * e + 1];
  const float sa = sdf[a], sb = sdf[b];
  crossing[e] = (sa > 0.f) != (sb > 0.f);
  float d = sa - sb;
  if (fabsf(d) < 1e-10f) d = d < 0.f ? -1e-10f : 1e-10f;
  const float t = fminf(fmaxf(sa / d, 0.f), 1.f);
  const F3 pa = ld3(pos, a), pb = ld3(pos, b);
  verts[3 * (int64_t)e] = pa.x + (pb.x - pa.x) * t;
  verts[3 * (int64_t)e + 1] = pa.y + (pb.y - pa.y) * t;
  verts[3 * (int64_t)e + 2] = pa.z + (pb.z - pa.z) * t;
}

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

__global__ void __launch_bounds__(kBlock)
mt_count_kernel(const float* __restrict__ sdf, const int* __restrict__ tets,
                int F, int* __restrict__ block_sums) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const int f = blockIdx.x * kBlock + threadIdx.x;
  const int n = f < F ? kNumTri[tet_index(sdf, tets, f)] : 0;
  block_exclusive_scan(n, s_warp, &s_total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = s_total;
}

// exclusive scan of nb block sums in place (one block); block_sums[nb] =
// the total
__global__ void __launch_bounds__(kBlock)
mt_scan_kernel(int* __restrict__ block_sums, int nb) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  int carry = 0;
  for (int base = 0; base < nb; base += kBlock) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? block_sums[i] : 0;
    const int ex = block_exclusive_scan(v, s_warp, &s_total);
    if (i < nb) block_sums[i] = carry + ex;
    carry += s_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) block_sums[nb] = carry;
}

__global__ void __launch_bounds__(kBlock)
mt_emit_kernel(const float* __restrict__ sdf, const int* __restrict__ tets,
               const int* __restrict__ tet_edges, int F, int max_tris,
               const int* __restrict__ block_offsets, int* __restrict__ faces,
               uint8_t* __restrict__ mask) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const int f = blockIdx.x * kBlock + threadIdx.x;
  const int idx = f < F ? tet_index(sdf, tets, f) : 0;
  const int n = f < F ? kNumTri[idx] : 0;
  const int off = block_offsets[blockIdx.x] +
                  block_exclusive_scan(n, s_warp, &s_total);
  for (int k = 0; k < n; ++k) {
    const int slot = off + k;
    if (slot >= max_tris) break;
    for (int j = 0; j < 3; ++j)
      faces[3 * slot + j] = tet_edges[6 * f + kTriTable[idx][3 * k + j]];
    mask[slot] = 1;
  }
}

__global__ void mt_bwd_kernel(const float* __restrict__ pos,
                              const float* __restrict__ sdf,
                              const int* __restrict__ ue, int E,
                              const float* __restrict__ g_verts,
                              float* __restrict__ g_pos,
                              float* __restrict__ g_sdf) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const F3 g = ld3(g_verts, e);
  if (g.x == 0.f && g.y == 0.f && g.z == 0.f) return;
  const int a = ue[2 * e], b = ue[2 * e + 1];
  const float sa = sdf[a], sb = sdf[b];
  const float d0 = sa - sb;
  const bool guarded = fabsf(d0) < 1e-10f;
  const float d = guarded ? (d0 < 0.f ? -1e-10f : 1e-10f) : d0;
  const float x = sa / d;
  const float t = fminf(fmaxf(x, 0.f), 1.f);
  atomic3(g_pos, a, {g.x * (1.f - t), g.y * (1.f - t), g.z * (1.f - t)});
  atomic3(g_pos, b, {g.x * t, g.y * t, g.z * t});
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

// ---- vertex normals ----------------------------------------------------------

__device__ __forceinline__ void face_verts(const float* verts, const int* faces,
                                           int t, int f[3], F3 v[3]) {
  for (int k = 0; k < 3; ++k) {
    f[k] = faces[3 * t + k];
    v[k] = ld3(verts, f[k]);
  }
}

__global__ void vn_scatter_kernel(const float* __restrict__ verts,
                                  const int* __restrict__ faces,
                                  const uint8_t* __restrict__ mask, int T,
                                  float* __restrict__ acc) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !mask[t]) return;
  int f[3];
  F3 v[3];
  face_verts(verts, faces, t, f, v);
  const F3 fn = cross(sub(v[1], v[0]), sub(v[2], v[0]));
  for (int k = 0; k < 3; ++k) atomic3(acc, f[k], fn);
}

__global__ void vn_normalize_kernel(const float* __restrict__ acc, int E,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const F3 a = ld3(acc, i);
  const float n2 = dot(a, a);
  F3 n = {0.f, 1.f, 0.f};
  if (n2 > 1e-20f) {
    const float r = rsqrtf(n2);
    n = {a.x * r, a.y * r, a.z * r};
  }
  out[3 * (int64_t)i] = n.x;
  out[3 * (int64_t)i + 1] = n.y;
  out[3 * (int64_t)i + 2] = n.z;
}

__global__ void vn_bwd_vertex_kernel(const float* __restrict__ acc,
                                     const float* __restrict__ n,
                                     const float* __restrict__ g_n, int E,
                                     float* __restrict__ g_acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const F3 a = ld3(acc, i), nn = ld3(n, i), g = ld3(g_n, i);
  const float n2 = dot(a, a);
  F3 r = {0.f, 0.f, 0.f};
  if (n2 > 1e-20f) {
    const float s = rsqrtf(n2), p = dot(nn, g);
    r = {(g.x - nn.x * p) * s, (g.y - nn.y * p) * s, (g.z - nn.z * p) * s};
  }
  g_acc[3 * (int64_t)i] = r.x;
  g_acc[3 * (int64_t)i + 1] = r.y;
  g_acc[3 * (int64_t)i + 2] = r.z;
}

// d verts of fn = (v1 - v0) x (v2 - v0) for the cotangent g of fn
__device__ __forceinline__ void cross_bwd(float* g_verts, const int f[3],
                                          const F3 v[3], F3 g) {
  const F3 a = sub(v[1], v[0]), b = sub(v[2], v[0]);
  const F3 da = cross(b, g), db = cross(g, a);
  atomic3(g_verts, f[1], da);
  atomic3(g_verts, f[2], db);
  const F3 s = add(da, db);
  atomic3(g_verts, f[0], {-s.x, -s.y, -s.z});
}

__global__ void vn_bwd_face_kernel(const float* __restrict__ verts,
                                   const int* __restrict__ faces,
                                   const uint8_t* __restrict__ mask, int T,
                                   const float* __restrict__ g_acc,
                                   float* __restrict__ g_verts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !mask[t]) return;
  int f[3];
  F3 v[3];
  face_verts(verts, faces, t, f, v);
  const F3 g = add(add(ld3(g_acc, f[0]), ld3(g_acc, f[1])), ld3(g_acc, f[2]));
  cross_bwd(g_verts, f, v, g);
}

// ---- Laplacian ---------------------------------------------------------------

__global__ void lap_scatter_kernel(const float* __restrict__ verts,
                                   const int* __restrict__ faces,
                                   const uint8_t* __restrict__ mask, int T,
                                   float* __restrict__ nb_sum,
                                   float* __restrict__ nb_cnt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !mask[t]) return;
  int f[3];
  F3 v[3];
  face_verts(verts, faces, t, f, v);
  // each vertex receives both others: the 6 directed edges of the face
  for (int k = 0; k < 3; ++k) {
    atomic3(nb_sum, f[k], add(v[(k + 1) % 3], v[(k + 2) % 3]));
    atomicAdd(nb_cnt + f[k], 2.f);
  }
}

__global__ void lap_vertex_kernel(const float* __restrict__ verts,
                                  const float* __restrict__ nb_sum,
                                  const float* __restrict__ nb_cnt, int E,
                                  float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const float c = nb_cnt[i];
  float r = 0.f;
  if (c > 0.f) {
    const F3 s = ld3(nb_sum, i), v = ld3(verts, i);
    const F3 dm = {s.x / c - v.x, s.y / c - v.y, s.z / c - v.z};
    r = dot(dm, dm);
  }
  d2[i] = r;
}

__global__ void lap_bwd_vertex_kernel(const float* __restrict__ verts,
                                      const float* __restrict__ nb_sum,
                                      const float* __restrict__ nb_cnt,
                                      const float* __restrict__ gs, int E,
                                      float* __restrict__ g_sum,
                                      float* __restrict__ g_verts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const float c = nb_cnt[i];
  F3 gm = {0.f, 0.f, 0.f}, gv = {0.f, 0.f, 0.f};
  if (c > 0.f) {
    const F3 s = ld3(nb_sum, i), v = ld3(verts, i);
    const float k = 2.f * gs[0];
    const F3 dm = {s.x / c - v.x, s.y / c - v.y, s.z / c - v.z};
    gm = {k * dm.x / c, k * dm.y / c, k * dm.z / c};
    gv = {-k * dm.x, -k * dm.y, -k * dm.z};
  }
  g_sum[3 * (int64_t)i] = gm.x;
  g_sum[3 * (int64_t)i + 1] = gm.y;
  g_sum[3 * (int64_t)i + 2] = gm.z;
  g_verts[3 * (int64_t)i] = gv.x;
  g_verts[3 * (int64_t)i + 1] = gv.y;
  g_verts[3 * (int64_t)i + 2] = gv.z;
}

__global__ void lap_bwd_face_kernel(const int* __restrict__ faces,
                                    const uint8_t* __restrict__ mask, int T,
                                    const float* __restrict__ g_sum,
                                    float* __restrict__ g_verts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !mask[t]) return;
  const int f[3] = {faces[3 * t], faces[3 * t + 1], faces[3 * t + 2]};
  // v_k fed the neighbour sums of both other vertices
  for (int k = 0; k < 3; ++k)
    atomic3(g_verts, f[k],
            add(ld3(g_sum, f[(k + 1) % 3]), ld3(g_sum, f[(k + 2) % 3])));
}

// ---- normal consistency ------------------------------------------------------

constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return x;
}

__global__ void nc_normals_kernel(const float* __restrict__ verts,
                                  const int* __restrict__ faces, int T,
                                  float* __restrict__ nrm) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int f[3];
  F3 v[3];
  face_verts(verts, faces, t, f, v);
  const F3 fn = cross(sub(v[1], v[0]), sub(v[2], v[0]));
  const float r = rsqrtf(fmaxf(dot(fn, fn), 1e-20f));
  nrm[3 * (int64_t)t] = fn.x * r;
  nrm[3 * (int64_t)t + 1] = fn.y * r;
  nrm[3 * (int64_t)t + 2] = fn.z * r;
}

__global__ void nc_insert_kernel(const int* __restrict__ faces,
                                 const uint8_t* __restrict__ mask, int T,
                                 unsigned long long size,
                                 unsigned long long* __restrict__ keys,
                                 int* __restrict__ cnt, int* __restrict__ slot,
                                 int* __restrict__ pos) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;     // e = k * T + t
  if (e >= 3 * T) return;
  const int t = e % T, k = e / T;
  if (!mask[t]) {
    slot[e] = -1;
    return;
  }
  const int a = faces[3 * t + k], b = faces[3 * t + (k + 1) % 3];
  const unsigned long long key =
      ((unsigned long long)(unsigned)min(a, b) << 32) | (unsigned)max(a, b);
  unsigned long long h = mix64(key) & (size - 1);
  while (true) {
    const unsigned long long old = atomicCAS(keys + h, kEmpty, key);
    if (old == kEmpty || old == key) break;
    h = (h + 1) & (size - 1);
  }
  slot[e] = (int)h;
  pos[e] = atomicAdd(cnt + h, 1);
}

__global__ void nc_first_kernel(const int* __restrict__ slot,
                                const int* __restrict__ pos, int T,
                                int* __restrict__ first) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * T) return;
  if (slot[e] >= 0 && pos[e] == 0) first[slot[e]] = e % T;
}

__global__ void nc_pair_kernel(const int* __restrict__ slot,
                               const int* __restrict__ pos,
                               const int* __restrict__ first,
                               const float* __restrict__ nrm, int T,
                               int* __restrict__ partner,
                               float* __restrict__ terms) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * T) return;
  int p = -1;
  float term = 0.f;
  if (slot[e] >= 0 && pos[e] >= 1) {
    p = first[slot[e]];
    term = 1.f - dot(ld3(nrm, e % T), ld3(nrm, p));
  }
  partner[e] = p;
  terms[e] = term;
}

__global__ void nc_bwd_pair_kernel(const int* __restrict__ partner,
                                   const float* __restrict__ nrm,
                                   const float* __restrict__ gs, int T,
                                   float* __restrict__ g_nrm) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * T) return;
  const int p = partner[e];
  if (p < 0) return;
  const int t = e % T;
  const float g = -gs[0];
  const F3 a = ld3(nrm, t), b = ld3(nrm, p);
  atomic3(g_nrm, t, {g * b.x, g * b.y, g * b.z});
  atomic3(g_nrm, p, {g * a.x, g * a.y, g * a.z});
}

__global__ void nc_bwd_face_kernel(const float* __restrict__ verts,
                                   const int* __restrict__ faces,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ nrm, int T,
                                   const float* __restrict__ g_nrm,
                                   float* __restrict__ g_verts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !mask[t]) return;
  const F3 g = ld3(g_nrm, t);
  if (g.x == 0.f && g.y == 0.f && g.z == 0.f) return;
  int f[3];
  F3 v[3];
  face_verts(verts, faces, t, f, v);
  const F3 fn = cross(sub(v[1], v[0]), sub(v[2], v[0]));
  const float n2 = dot(fn, fn);
  F3 gf;
  if (n2 > 1e-20f) {     // d(fn / |fn|)
    const float r = rsqrtf(n2);
    const F3 n = ld3(nrm, t);
    const float p = dot(n, g);
    gf = {(g.x - n.x * p) * r, (g.y - n.y * p) * r, (g.z - n.z * p) * r};
  } else {               // fn · rsqrt(1e-20): linear
    gf = {g.x * 1e10f, g.y * 1e10f, g.z * 1e10f};
  }
  cross_bwd(g_verts, f, v, gf);
}

inline unsigned blocks(int64_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

}  // namespace

extern "C" int marching_tets_fwd(const float* pos, const float* sdf,
                                 const int* tets, const int* tet_edges,
                                 const int* unique_edges, int V, int F, int E,
                                 int max_tris, int* block_sums, float* verts,
                                 uint8_t* crossing, int* faces, uint8_t* mask,
                                 void* stream) {
  (void)V;
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0)
    mt_edge_kernel<<<blocks(E, kThreads), kThreads, 0, s>>>(
        pos, sdf, unique_edges, E, verts, crossing);
  const int nb = (int)blocks(F, kBlock);
  if (nb > 0) {
    mt_count_kernel<<<nb, kBlock, 0, s>>>(sdf, tets, F, block_sums);
    mt_scan_kernel<<<1, kBlock, 0, s>>>(block_sums, nb);
    mt_emit_kernel<<<nb, kBlock, 0, s>>>(sdf, tets, tet_edges, F, max_tris,
                                         block_sums, faces, mask);
  }
  return (int)cudaGetLastError();
}

extern "C" int marching_tets_bwd(const float* pos, const float* sdf,
                                 const int* unique_edges, int E,
                                 const float* g_verts, float* g_pos,
                                 float* g_sdf, void* stream) {
  if (E > 0)
    mt_bwd_kernel<<<blocks(E, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        pos, sdf, unique_edges, E, g_verts, g_pos, g_sdf);
  return (int)cudaGetLastError();
}

extern "C" int vertex_normals_fwd(const float* verts, const int* faces,
                                  const uint8_t* mask, int E, int T,
                                  float* acc, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0)
    vn_scatter_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(verts, faces,
                                                               mask, T, acc);
  if (E > 0)
    vn_normalize_kernel<<<blocks(E, kThreads), kThreads, 0, s>>>(acc, E, out);
  return (int)cudaGetLastError();
}

extern "C" int vertex_normals_bwd(const float* verts, const int* faces,
                                  const uint8_t* mask, const float* acc,
                                  const float* n, const float* g_n, int E,
                                  int T, float* g_acc, float* g_verts,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0)
    vn_bwd_vertex_kernel<<<blocks(E, kThreads), kThreads, 0, s>>>(acc, n, g_n,
                                                                  E, g_acc);
  if (T > 0)
    vn_bwd_face_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(
        verts, faces, mask, T, g_acc, g_verts);
  return (int)cudaGetLastError();
}

extern "C" int laplacian_fwd(const float* verts, const int* faces,
                             const uint8_t* mask, int E, int T, float* nb_sum,
                             float* nb_cnt, float* d2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0)
    lap_scatter_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(
        verts, faces, mask, T, nb_sum, nb_cnt);
  if (E > 0)
    lap_vertex_kernel<<<blocks(E, kThreads), kThreads, 0, s>>>(
        verts, nb_sum, nb_cnt, E, d2);
  return (int)cudaGetLastError();
}

extern "C" int laplacian_bwd(const float* verts, const int* faces,
                             const uint8_t* mask, const float* nb_sum,
                             const float* nb_cnt, const float* gs, int E,
                             int T, float* g_sum, float* g_verts,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0)
    lap_bwd_vertex_kernel<<<blocks(E, kThreads), kThreads, 0, s>>>(
        verts, nb_sum, nb_cnt, gs, E, g_sum, g_verts);
  if (T > 0)
    lap_bwd_face_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(
        faces, mask, T, g_sum, g_verts);
  return (int)cudaGetLastError();
}

extern "C" int normal_consistency_fwd(const float* verts, const int* faces,
                                      const uint8_t* mask, int T, int size,
                                      unsigned long long* keys, int* cnt,
                                      int* first, int* slot, int* pos,
                                      float* nrm, int* partner, float* terms,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0) {
    nc_normals_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(verts, faces,
                                                               T, nrm);
    const unsigned nb = blocks(3 * (int64_t)T, kThreads);
    nc_insert_kernel<<<nb, kThreads, 0, s>>>(faces, mask, T,
                                             (unsigned long long)size, keys,
                                             cnt, slot, pos);
    nc_first_kernel<<<nb, kThreads, 0, s>>>(slot, pos, T, first);
    nc_pair_kernel<<<nb, kThreads, 0, s>>>(slot, pos, first, nrm, T, partner,
                                           terms);
  }
  return (int)cudaGetLastError();
}

extern "C" int normal_consistency_bwd(const float* verts, const int* faces,
                                      const uint8_t* mask, const float* nrm,
                                      const int* partner, const float* gs,
                                      int T, float* g_nrm, float* g_verts,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0) {
    nc_bwd_pair_kernel<<<blocks(3 * (int64_t)T, kThreads), kThreads, 0, s>>>(
        partner, nrm, gs, T, g_nrm);
    nc_bwd_face_kernel<<<blocks(T, kThreads), kThreads, 0, s>>>(
        verts, faces, mask, nrm, T, g_nrm, g_verts);
  }
  return (int)cudaGetLastError();
}
