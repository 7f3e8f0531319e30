// K7: tile-binned triangle rasterizer and attribute interpolation, forward
// and closed-form backward.
//
// Replaces dreamfusion_tpu/ops/raster.py::rasterize and ::interpolate.  On
// the TPU the triangles are binned per 32x32 tile with top_k over a
// [tiles, T] score and every (pixel, listed triangle) pair is one einsum
// per tile, with gradients from autodiff.  Here the forward is four kernels
// in one launch call:
//   * raster_setup_kernel, a thread per triangle and 256 triangles a block:
//     the coefficient rows of bu, bv and z as a*px + b*py + c, sqrt|den|,
//     the padded tile range (empty for a dropped triangle) and the block's
//     histogram of tiles touched, counted in shared memory;
//   * raster_scan_kernel, a warp per tile: the histograms' exclusive prefix
//     over the blocks (in place) and the tile's count;
//   * raster_bin_kernel: each triangle written once into the lists of the
//     tiles its box touches, at its rank among the tile's triangles by
//     index (the block's prefix + earlier warps' counts + the earlier lanes
//     of its warp whose boxes hold the tile), so each list is in index
//     order and only the first tile_cap are kept: the TPU top_k's "first
//     tile_cap by index";
//   * raster_tile_kernel, four blocks per tile (a quarter of its pixel rows
//     each, so that the crowded tiles, cap triangles x 1024 pixels, spread
//     over four SMs) and a thread per pixel: the
//     listed coefficient rows staged through shared memory by cp.async,
//     double-buffered; each pixel keeps the nearest covering triangle
//     (strict <: ties to the lowest index) and the largest soft-edge
//     margin, and stores both winners' slots in the list for the backward.
// The backward (raster_bwd_kernel) takes the same tile parts: each pixel's
// closed-form derivatives of (bu, bv, z) of its winner and of the margin of
// its margin winner are summed in shared memory per listed triangle ((x, y,
// z, -) for each of its vertices), and each triangle with a non-zero sum
// adds them to its vertices' rows with one float4 reduction each; pixels whose
// cotangents are zero take no part.  A list longer than kWindow is summed in
// windows of kWindow slots (the pixel's terms kept in registers), so the
// shared memory does not grow with tile_cap.  interpolate_bwd does the same for the
// attributes' gradient and writes d bary per pixel.  A null cotangent
// reads as zero (no zero-filled plane).
//
// Bound on the card: operations.  The sweep does ~20 fp32 operations per
// (pixel, listed triangle); binning touches each (triangle, tile) pair once;
// the bytes are the per-vertex screen coordinates, the faces and the output
// planes.  Arithmetic that decides a selection uses explicit round-to-nearest
// intrinsics in the plain version's order (no FMA contraction), so the
// kernel selects the same triangles as ops/raster.py::raster_plain on the
// same inputs; the backward's den, bu and bv (the margin's edge, and the
// scale of a thin triangle's gradients) are the plain version's too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// slots are 16 bits, 0xffff for none
constexpr int kMaxCap = 65535;
// listed triangles whose gradient sums a backward pass holds in shared
// memory: a longer list is reduced in windows
constexpr int kWindow = 1024;
constexpr int kMaxTiles = 4096;
constexpr int kStage = 256;      // listed triangles staged per pass
constexpr int kCoef = 12;        // cu[3] cv[3] cz[3] scale pad pad
constexpr int kBinThreads = 256;  // triangles a binning block
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kTileParts = 4;      // blocks per tile: rows of its pixels
constexpr unsigned kNoSlot = 0xffffu;

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}

// the tile rectangle clamped to the grid (x0 > x1 when empty)
__device__ __forceinline__ int4 clamp_rect(int4 r, int ntx, int nty) {
  return make_int4(max(r.x, 0), min(r.y, ntx - 1), max(r.z, 0),
                   min(r.w, nty - 1));
}

__global__ void __launch_bounds__(kBinThreads) raster_setup_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ faces,
    const uint8_t* __restrict__ valid, int T, int tile, float pad, int ntx,
    int nty, int nb, float* __restrict__ coef, int4* __restrict__ range,
    int* __restrict__ hist) {
  extern __shared__ int s_hist[];
  const int G = ntx * nty;
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int t = blockIdx.x * kBinThreads + threadIdx.x;
  if (t < T) {
    const int a = faces[3 * t], b = faces[3 * t + 1], c = faces[3 * t + 2];
    const float x0 = sx[a], y0 = sy[a], x1 = sx[b], y1 = sy[b], x2 = sx[c],
                y2 = sy[c];
    const float z0 = sz[a], z1 = sz[b], z2 = sz[c];
    const float e0x = fsub(x1, x0), e0y = fsub(y1, y0);
    const float e1x = fsub(x2, x0), e1y = fsub(y2, y0);
    float den = fsub(fmul(e0x, e1y), fmul(e0y, e1x));
    if (fabsf(den) < 1e-9f) den = 1e-9f;
    const float inv = __fdiv_rn(1.f, den);
    const float cu[3] = {fmul(e1y, inv), fmul(-e1x, inv),
                         fmul(fsub(fmul(y0, e1x), fmul(x0, e1y)), inv)};
    const float cv[3] = {fmul(-e0y, inv), fmul(e0x, inv),
                         fmul(fsub(fmul(x0, e0y), fmul(y0, e0x)), inv)};
    const float dz1 = fsub(z1, z0), dz2 = fsub(z2, z0);
    float o[kCoef];
    for (int k = 0; k < 3; ++k) {
      o[k] = cu[k];
      o[3 + k] = cv[k];
      o[6 + k] = fadd(fmul(cu[k], dz1), fmul(cv[k], dz2));
    }
    o[8] = fadd(o[8], z0);
    o[9] = __fsqrt_rn(fabsf(den));
    o[10] = 0.f;
    o[11] = 0.f;
    float4* row = reinterpret_cast<float4*>(coef + (int64_t)t * kCoef);
    row[0] = make_float4(o[0], o[1], o[2], o[3]);
    row[1] = make_float4(o[4], o[5], o[6], o[7]);
    row[2] = make_float4(o[8], o[9], o[10], o[11]);
    int4 r = make_int4(1, 0, 1, 0);             // empty: dropped triangle
    if (valid[t]) {
      const float bx0 = fminf(fminf(x0, x1), x2),
                  bx1 = fmaxf(fmaxf(x0, x1), x2);
      const float by0 = fminf(fminf(y0, y1), y2),
                  by1 = fmaxf(fmaxf(y0, y1), y2);
      const float ft = (float)tile;
      r = make_int4((int)floorf(__fdiv_rn(fsub(bx0, pad), ft)),
                    (int)floorf(__fdiv_rn(fadd(bx1, pad), ft)),
                    (int)floorf(__fdiv_rn(fsub(by0, pad), ft)),
                    (int)floorf(__fdiv_rn(fadd(by1, pad), ft)));
    }
    range[t] = r;
    const int4 q = clamp_rect(r, ntx, nty);
    for (int ty = q.z; ty <= q.w; ++ty)
      for (int tx = q.x; tx <= q.y; ++tx) atomicAdd(&s_hist[ty * ntx + tx], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    hist[(int64_t)i * nb + blockIdx.x] = s_hist[i];
}

// a warp per tile: exclusive prefix of its row of block counts, in place
__global__ void raster_scan_kernel(int* __restrict__ hist, int G, int nb,
                                   int* __restrict__ counts) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= G) return;
  int* h = hist + (int64_t)g * nb;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int b = b0 + lane;
    const int v = b < nb ? h[b] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (b < nb) h[b] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) counts[g] = carry;
}

__global__ void __launch_bounds__(kBinThreads) raster_bin_kernel(
    const int4* __restrict__ range, const int* __restrict__ hist, int T,
    int ntx, int nty, int nb, int cap, int* __restrict__ lists) {
  extern __shared__ int smem[];
  __shared__ int4 s_rect[kBinThreads];
  const int G = ntx * nty;
  int* s_base = smem;              // [G] listed before this round
  int* s_warp = smem + G;          // [kBinWarps][G] this round, per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < G; i += kBinThreads) {
    s_base[i] = hist[(int64_t)i * nb + blockIdx.x];
    for (int w = 0; w < kBinWarps; ++w) s_warp[w * G + i] = 0;
  }
  const int t = blockIdx.x * kBinThreads + tid;
  const int4 q = t < T ? clamp_rect(range[t], ntx, nty)
                       : make_int4(1, 0, 1, 0);
  s_rect[tid] = q;
  __syncthreads();
  for (int ty = q.z; ty <= q.w; ++ty)
    for (int tx = q.x; tx <= q.y; ++tx)
      atomicAdd(&s_warp[warp * G + ty * ntx + tx], 1);
  __syncthreads();
  const int4* wr = s_rect + warp * 32;
  for (int ty = q.z; ty <= q.w; ++ty) {
    for (int tx = q.x; tx <= q.y; ++tx) {
      const int g = ty * ntx + tx;
      int rank = s_base[g];
      for (int w = 0; w < warp; ++w) rank += s_warp[w * G + g];
      for (int j = 0; j < lane; ++j) {
        const int4 o = wr[j];
        rank += o.x <= tx && tx <= o.y && o.z <= ty && ty <= o.w;
      }
      if (rank < cap) lists[(int64_t)g * cap + rank] = t;
    }
  }
}

// stage the coefficient rows of list[s0 : s0 + m) into `dst` (cp.async)
__device__ __forceinline__ void stage_rows(float* dst, const float* coef,
                                           const int* list, int s0, int m) {
  for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) {
    const int k = j / 3, q = j - 3 * k;
    dft::cp_async16(dst + 4 * j, coef + (int64_t)list[s0 + k] * kCoef + 4 * q,
                    true);
  }
  dft::cp_async_commit();
}

__global__ void __launch_bounds__(256, 4) raster_tile_kernel(
    const float* __restrict__ coef, const int* __restrict__ lists,
    const int* __restrict__ counts, int H, int W, int tile, int cap,
    float soft, float* __restrict__ bary, int* __restrict__ tri_id,
    float* __restrict__ depth, float* __restrict__ alpha,
    unsigned* __restrict__ slots) {
  __shared__ __align__(16) float s_coef[2][kStage * kCoef];

  const int tid = threadIdx.x;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int g = ty * gridDim.x + tx;
  const int count = counts[g];
  const int n = count < cap ? count : cap;
  const int* list = lists + (int64_t)g * cap;

  const int pix = blockIdx.z * blockDim.x + tid;   // this part's pixels
  const int lx = pix % tile, ly = pix / tile;
  const float px = fadd((float)lx + 0.5f, (float)(tx * tile));
  const float py = fadd((float)ly + 0.5f, (float)(ty * tile));
  float best_z = INFINITY, bu_b = 0.f, bv_b = 0.f;
  int best = -1;
  float best_m = count < cap ? -1e9f : -INFINITY;  // an unlisted slot: -1e9
  int marg = -1;
  if (n > 0) stage_rows(s_coef[0], coef, list, 0, n < kStage ? n : kStage);
  for (int s0 = 0, it = 0; s0 < n; s0 += kStage, ++it) {
    const int m = n - s0 < kStage ? n - s0 : kStage;
    if (s0 + kStage < n) {
      const int m2 = n - s0 - kStage < kStage ? n - s0 - kStage : kStage;
      stage_rows(s_coef[(it + 1) & 1], coef, list, s0 + kStage, m2);
      dft::cp_async_wait<1>();
    } else {
      dft::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* c4 = reinterpret_cast<const float4*>(s_coef[it & 1]);
    for (int j = 0; j < m; ++j) {
      const float4 a = c4[3 * j], b = c4[3 * j + 1], c = c4[3 * j + 2];
      // cu = (a.x, a.y, a.z), cv = (a.w, b.x, b.y), cz = (b.z, b.w, c.x),
      // scale = c.y; each a*px + b*py + c as ops/raster.py::_eval
      const float bu = fadd(fadd(fmul(a.x, px), fmul(a.y, py)), a.z);
      const float bv = fadd(fadd(fmul(a.w, px), fmul(b.x, py)), b.y);
      const float bw = fsub(fsub(1.f, bu), bv);
      if (bu >= 0.f && bv >= 0.f && bw >= 0.f) {
        const float z = fadd(fadd(fmul(b.z, px), fmul(b.w, py)), c.x);
        if (z < best_z) {
          best_z = z;
          best = s0 + j;
          bu_b = bu;
          bv_b = bv;
        }
      }
      if (soft > 0.f) {
        const float mg = fmul(fminf(fminf(bu, bv), bw), c.y);
        if (mg > best_m) {
          best_m = mg;
          marg = s0 + j;
        }
      }
    }
    __syncthreads();
  }
  const int x = tx * tile + lx, y = ty * tile + ly;
  if (x >= W || y >= H) return;
  const int64_t p = (int64_t)y * W + x;
  tri_id[p] = best >= 0 ? list[best] : -1;
  slots[p] = (best >= 0 ? (unsigned)best : kNoSlot) |
             ((marg >= 0 ? (unsigned)marg : kNoSlot) << 16);
  if (best >= 0) {
    bary[3 * p] = fsub(fsub(1.f, bu_b), bv_b);
    bary[3 * p + 1] = bu_b;
    bary[3 * p + 2] = bv_b;
    depth[p] = best_z;
  } else {
    bary[3 * p] = bary[3 * p + 1] = bary[3 * p + 2] = 0.f;
    depth[p] = 1.f;
  }
  if (soft > 0.f) {
    const float mm = marg >= 0 ? best_m : -1e9f;
    alpha[p] = 1.f / (1.f + expf(-fmul(__fdiv_rn(mm, soft), 4.f)));
  } else {
    alpha[p] = best >= 0 ? 1.f : 0.f;
  }
}

struct Tri {
  float x[3], y[3], den, inv, bu, bv;
  bool guarded;
};

// screen-space triangle at pixel (px, py): den, its guard, bu and bv in
// ops/raster.py::_edge_form's operations, each rounded to nearest (no
// contraction, bu and bv divided by den): a thin triangle's gradients grow
// as 1/den, so a contracted den (an FMA keeps a product's low bits, which
// the difference of two near-equal products is made of) moved them by far
// more than the sums' rounding; and bu, bv and bw choose the margin's edge
__device__ Tri load_tri(const float* sx, const float* sy, const int* f,
                        float px, float py) {
  Tri t;
  for (int k = 0; k < 3; ++k) {
    t.x[k] = sx[f[k]];
    t.y[k] = sy[f[k]];
  }
  const float e0x = fsub(t.x[1], t.x[0]), e0y = fsub(t.y[1], t.y[0]);
  const float e1x = fsub(t.x[2], t.x[0]), e1y = fsub(t.y[2], t.y[0]);
  float den = fsub(fmul(e0x, e1y), fmul(e0y, e1x));
  t.guarded = fabsf(den) < 1e-9f;
  if (t.guarded) den = 1e-9f;
  t.den = den;
  t.inv = 1.f / den;
  const float dx = fsub(px, t.x[0]), dy = fsub(py, t.y[0]);
  t.bu = __fdiv_rn(fsub(fmul(dx, e1y), fmul(dy, e1x)), den);
  t.bv = __fdiv_rn(fsub(fmul(dy, e0x), fmul(dx, e0y)), den);
  return t;
}

// d bu / d(x_k, y_k) and d bv / d(x_k, y_k), k = 0..2 (index 2k: x, 2k+1: y)
__device__ void bary_grads(const Tri& t, float px, float py, float dbu[6],
                           float dbv[6]) {
  const float e0x = t.x[1] - t.x[0], e0y = t.y[1] - t.y[0];
  const float e1x = t.x[2] - t.x[0], e1y = t.y[2] - t.y[0];
  const float dx = px - t.x[0], dy = py - t.y[0];
  const float dNu[6] = {dy - e1y, e1x - dx, 0.f, 0.f, -dy, dx};
  const float dNv[6] = {e0y - dy, dx - e0x, dy, -dx, 0.f, 0.f};
  float dden[6] = {e0y - e1y, e1x - e0x, e1y, -e1x, -e0y, e0x};
  if (t.guarded) {
    for (int i = 0; i < 6; ++i) dden[i] = 0.f;
  }
  for (int i = 0; i < 6; ++i) {
    dbu[i] = (dNu[i] - t.bu * dden[i]) * t.inv;
    dbv[i] = (dNv[i] - t.bv * dden[i]) * t.inv;
  }
}

// the per-slot sums of a tile → one float4 reduction per vertex of each
// listed triangle with a non-zero sum; rows are (x, y, z, -) or C channels
// padded to CP
__device__ __forceinline__ void flush_slots(const float* s_acc, int n,
                                            int per_vertex,
                                            const int* __restrict__ list,
                                            const int* __restrict__ faces,
                                            float* __restrict__ out) {
  const int per = 3 * per_vertex;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* a = s_acc + j * per;
    bool nz = false;
    for (int i = 0; i < per; ++i) nz |= a[i] != 0.f;
    if (!nz) continue;
    const int* f = faces + 3 * list[j];
    for (int k = 0; k < 3; ++k) {
      float4* dst = reinterpret_cast<float4*>(out + (int64_t)f[k] *
                                              per_vertex);
      for (int q = 0; q < per_vertex / 4; ++q) {
        const float* v = a + k * per_vertex + 4 * q;
        if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)
          atomicAdd(dst + q, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
}

__global__ void __launch_bounds__(256, 4) raster_bwd_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ faces,
    const int* __restrict__ tri_id, const unsigned* __restrict__ slots,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ alpha, const float* __restrict__ g_bary,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    int H, int W, int tile, int cap, float soft, float* __restrict__ gs) {
  extern __shared__ float s_acc[];  // [kWindow][3 vertices][x, y, z, -]
  const int tid = threadIdx.x;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int g = ty * gridDim.x + tx;
  const int count = counts[g];
  const int n = count < cap ? count : cap;
  const int* list = lists + (int64_t)g * cap;

  // this pixel's terms: its winner's (x, y, z of each vertex, at list slot
  // ws) and its margin winner's (x, y of each vertex, at slot ms)
  float tw[9], tm[6];
  int ws = -1, ms = -1;
  const int pix = blockIdx.z * blockDim.x + tid;   // this part's pixels
  const int x = tx * tile + pix % tile, y = ty * tile + pix / tile;
  if (x < W && y < H) {
    const int64_t p = (int64_t)y * W + x;
    const float px = (float)x + 0.5f, py = (float)y + 0.5f;
    const int t = tri_id[p];
    const unsigned sl = slots[p];
    if (t >= 0) {
      const float gw = g_bary ? g_bary[3 * p] : 0.f;
      const float gu = g_bary ? g_bary[3 * p + 1] : 0.f;
      const float gv = g_bary ? g_bary[3 * p + 2] : 0.f;
      const float gd = g_depth ? g_depth[p] : 0.f;
      if (gw != 0.f || gu != 0.f || gv != 0.f || gd != 0.f) {
        const int* f = faces + 3 * t;
        const Tri tr = load_tri(sx, sy, f, px, py);
        const float z0 = sz[f[0]], z1 = sz[f[1]], z2 = sz[f[2]];
        const float Gu = gu - gw + gd * (z1 - z0);
        const float Gv = gv - gw + gd * (z2 - z0);
        for (int i = 0; i < 9; ++i) tw[i] = 0.f;
        if (Gu != 0.f || Gv != 0.f) {
          float dbu[6], dbv[6];
          bary_grads(tr, px, py, dbu, dbv);
          for (int k = 0; k < 3; ++k) {
            tw[3 * k] = Gu * dbu[2 * k] + Gv * dbv[2 * k];
            tw[3 * k + 1] = Gu * dbu[2 * k + 1] + Gv * dbv[2 * k + 1];
          }
        }
        if (gd != 0.f) {
          tw[2] = gd * (1.f - tr.bu - tr.bv);
          tw[5] = gd * tr.bu;
          tw[8] = gd * tr.bv;
        }
        ws = (int)(sl & kNoSlot);
      }
    }
    const unsigned msl = sl >> 16;
    if (soft > 0.f && msl != kNoSlot && g_alpha) {
      const float al = alpha[p];
      const float Gm = g_alpha[p] * al * (1.f - al) * 4.f / soft;
      if (Gm != 0.f) {
        const int* f = faces + 3 * list[msl];
        const Tri tr = load_tri(sx, sy, f, px, py);
        const float bw = fsub(fsub(1.f, tr.bu), tr.bv);
        // min(min(bu, bv), bw) and the weights its gradient gives bu, bv
        // and bw: torch.minimum's, which halves it at a tie
        const float m1 = fminf(tr.bu, tr.bv), bmin = fminf(m1, bw);
        const float au = tr.bu < tr.bv ? 1.f : tr.bu > tr.bv ? 0.f : 0.5f;
        const float o1 = m1 < bw ? 1.f : m1 > bw ? 0.f : 0.5f;
        const float ww = 1.f - o1;     // d bw = -d bu - d bv
        const float wu = au * o1 - ww, wv = (1.f - au) * o1 - ww;
        float dbu[6], dbv[6];
        bary_grads(tr, px, py, dbu, dbv);
        const float scale = sqrtf(fabsf(tr.den));
        // d scale / d den = sign(den) / (2 scale), none when guarded
        const float ds = tr.guarded ? 0.f
                                    : (tr.den > 0.f ? 0.5f : -0.5f) / scale;
        const float e0x = tr.x[1] - tr.x[0], e0y = tr.y[1] - tr.y[0];
        const float e1x = tr.x[2] - tr.x[0], e1y = tr.y[2] - tr.y[0];
        const float dden[6] = {e0y - e1y, e1x - e0x, e1y, -e1x, -e0y, e0x};
        for (int i = 0; i < 6; ++i) {
          const float db = wu * dbu[i] + wv * dbv[i];
          tm[i] = Gm * (scale * db + bmin * ds * dden[i]);
        }
        ms = (int)msl;
      }
    }
  }
  // the list's sums, kWindow slots at a time
  for (int w0 = 0; w0 < n; w0 += kWindow) {
    const int m = n - w0 < kWindow ? n - w0 : kWindow;
    for (int i = tid; i < 12 * m; i += blockDim.x) s_acc[i] = 0.f;
    __syncthreads();
    if (ws >= w0 && ws < w0 + m) {
      float* a = s_acc + 12 * (ws - w0);
      for (int k = 0; k < 3; ++k)
        for (int c = 0; c < 3; ++c) atomicAdd(a + 4 * k + c, tw[3 * k + c]);
    }
    if (ms >= w0 && ms < w0 + m) {
      float* a = s_acc + 12 * (ms - w0);
      for (int i = 0; i < 6; ++i) atomicAdd(a + 4 * (i >> 1) + (i & 1), tm[i]);
    }
    __syncthreads();
    flush_slots(s_acc, m, 4, list + w0, faces, gs);
    __syncthreads();
  }
}

__global__ void interpolate_fwd_kernel(
    const float* __restrict__ attrs, const float* __restrict__ bary,
    const int* __restrict__ tri_id, const int* __restrict__ faces, int P,
    int C, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)P * C) return;
  const int64_t p = i / C;
  const int c = (int)(i % C);
  const int t = tri_id[p];
  float v = 0.f;
  if (t >= 0) {
    const int* f = faces + 3 * t;
    v = bary[3 * p] * attrs[(int64_t)f[0] * C + c] +
        bary[3 * p + 1] * attrs[(int64_t)f[1] * C + c] +
        bary[3 * p + 2] * attrs[(int64_t)f[2] * C + c];
  }
  out[i] = v;
}

__global__ void __launch_bounds__(256, 4) interpolate_bwd_kernel(
    const float* __restrict__ attrs, const float* __restrict__ bary,
    const int* __restrict__ tri_id, const unsigned* __restrict__ slots,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const int* __restrict__ faces, const float* __restrict__ g_out, int H,
    int W, int tile, int cap, int C, int CP, float* __restrict__ g_attrs,
    float* __restrict__ g_bary) {
  extern __shared__ float s_acc[];        // [kWindow][3 vertices][CP]
  const int tid = threadIdx.x;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int g = ty * gridDim.x + tx;
  const int count = counts[g];
  const int n = count < cap ? count : cap;
  const int* list = lists + (int64_t)g * cap;
  const int pix = blockIdx.z * blockDim.x + tid;   // this part's pixels
  const int x = tx * tile + pix % tile, y = ty * tile + pix / tile;
  int64_t p = 0;
  int ws = -1;                             // the winner's list slot
  float b[3] = {0.f, 0.f, 0.f};
  if (x < W && y < H) {
    p = (int64_t)y * W + x;
    const int t = tri_id[p];
    float gb[3] = {0.f, 0.f, 0.f};
    if (t >= 0) {
      const int* f = faces + 3 * t;
      for (int k = 0; k < 3; ++k) b[k] = bary[3 * p + k];
      for (int c = 0; c < C; ++c) {
        const float gc = g_out[p * C + c];
        for (int k = 0; k < 3; ++k) gb[k] += gc * attrs[(int64_t)f[k] * C + c];
      }
      ws = (int)(slots[p] & kNoSlot);
    }
    for (int k = 0; k < 3; ++k) g_bary[3 * p + k] = gb[k];
  }
  // the list's sums, kWindow slots at a time
  for (int w0 = 0; w0 < n; w0 += kWindow) {
    const int m = n - w0 < kWindow ? n - w0 : kWindow;
    for (int i = tid; i < 3 * CP * m; i += blockDim.x) s_acc[i] = 0.f;
    __syncthreads();
    if (ws >= w0 && ws < w0 + m) {
      float* a = s_acc + 3 * CP * (ws - w0);
      for (int c = 0; c < C; ++c) {
        const float gc = g_out[p * C + c];
        if (gc != 0.f) {
          for (int k = 0; k < 3; ++k) atomicAdd(a + k * CP + c, gc * b[k]);
        }
      }
    }
    __syncthreads();
    flush_slots(s_acc, m, CP, list + w0, faces, g_attrs);
    __syncthreads();
  }
}

inline unsigned blocks(int64_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

// dynamic shared memory above the default 48 KB needs the kernel's opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// coef [T, 12], range [T, 4] int, hist [G, nb] int, counts [G], lists
// [G, cap]: the forward's scratch (lists, counts and slots are kept for the
// backwards)
extern "C" int raster_fwd(const float* sx, const float* sy, const float* sz,
                          const int* faces, const uint8_t* valid, int T,
                          int H, int W, int tile, int cap, float soft,
                          float* coef, int* range, int* hist, int* counts,
                          int* lists, float* bary, int* tri_id, float* depth,
                          float* alpha, unsigned* slots, void* stream) {
  const int ntx = (W + tile - 1) / tile, nty = (H + tile - 1) / tile;
  const int G = ntx * nty;
  if (cap > kMaxCap || tile > 32 || (tile * tile) % (32 * kTileParts) != 0 ||
      G > kMaxTiles)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = T > 0 ? (int)blocks(T, kBinThreads) : 1;
  const size_t bin_smem = (size_t)(1 + kBinWarps) * G * sizeof(int);
  cudaError_t e = allow_smem(raster_bin_kernel, bin_smem);
  if (e != cudaSuccess) return (int)e;
  raster_setup_kernel<<<nb, kBinThreads, G * sizeof(int), s>>>(
      sx, sy, sz, faces, valid, T, tile, soft + 1.f, ntx, nty, nb, coef,
      (int4*)range, hist);
  raster_scan_kernel<<<blocks((int64_t)G * 32, 256), 256, 0, s>>>(hist, G, nb,
                                                                   counts);
  if (T > 0)
    raster_bin_kernel<<<nb, kBinThreads, bin_smem, s>>>(
        (const int4*)range, hist, T, ntx, nty, nb, cap, lists);
  // a tile's pixels in kTileParts blocks, so that the most crowded tiles
  // (cap triangles each) spread over as many SMs
  raster_tile_kernel<<<dim3(ntx, nty, kTileParts), tile * tile / kTileParts,
                       0, s>>>(
      coef, lists, counts, H, W, tile, cap, soft, bary, tri_id, depth, alpha,
      slots);
  return (int)cudaGetLastError();
}

// gs [V, 4] (x, y, z, -), zero on entry; null cotangents read as 0
extern "C" int raster_bwd(const float* sx, const float* sy, const float* sz,
                          const int* faces, const int* tri_id,
                          const unsigned* slots, const int* lists,
                          const int* counts, const float* alpha,
                          const float* g_bary, const float* g_depth,
                          const float* g_alpha, int H, int W, int tile,
                          int cap, float soft, float* gs, void* stream) {
  const int ntx = (W + tile - 1) / tile, nty = (H + tile - 1) / tile;
  const int win = cap < kWindow ? cap : kWindow;
  const size_t smem = (size_t)12 * win * sizeof(float);
  cudaError_t e = allow_smem(raster_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (ntx > 0 && nty > 0)
    raster_bwd_kernel<<<dim3(ntx, nty, kTileParts), tile * tile / kTileParts,
                        smem, (cudaStream_t)stream>>>(
        sx, sy, sz, faces, tri_id, slots, lists, counts, alpha, g_bary,
        g_depth, g_alpha, H, W, tile, cap, soft, gs);
  return (int)cudaGetLastError();
}

extern "C" int interpolate_fwd(const float* attrs, const float* bary,
                               const int* tri_id, const int* faces, int P,
                               int C, float* out, void* stream) {
  const int64_t n = (int64_t)P * C;
  if (n > 0)
    interpolate_fwd_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        attrs, bary, tri_id, faces, P, C, out);
  return (int)cudaGetLastError();
}

// g_attrs [V, CP] (C channels padded to CP, a multiple of 4), zero on entry
extern "C" int interpolate_bwd(const float* attrs, const float* bary,
                               const int* tri_id, const unsigned* slots,
                               const int* lists, const int* counts,
                               const int* faces, const float* g_out, int H,
                               int W, int tile, int cap, int C, int CP,
                               float* g_attrs, float* g_bary, void* stream) {
  const int ntx = (W + tile - 1) / tile, nty = (H + tile - 1) / tile;
  if (CP % 4 != 0 || CP < C) return -1;
  const int win = cap < kWindow ? cap : kWindow;
  const size_t smem = (size_t)3 * CP * win * sizeof(float);
  cudaError_t e = allow_smem(interpolate_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (ntx > 0 && nty > 0)
    interpolate_bwd_kernel<<<dim3(ntx, nty, kTileParts),
                             tile * tile / kTileParts, smem,
                             (cudaStream_t)stream>>>(
        attrs, bary, tri_id, slots, lists, counts, faces, g_out, H, W, tile,
        cap, C, CP, g_attrs, g_bary);
  return (int)cudaGetLastError();
}
