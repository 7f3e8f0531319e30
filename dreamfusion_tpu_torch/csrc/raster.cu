// K7: tile-binned triangle rasterizer and attribute interpolation, forward
// and closed-form backward.
//
// Replaces dreamfusion_tpu/ops/raster.py::rasterize and ::interpolate.  On
// the TPU the triangles are binned per 32x32 tile with top_k over a
// [tiles, T] score and every (pixel, listed triangle) pair is one einsum
// per tile, with gradients from autodiff.  Here:
//   * raster_setup_kernel, one thread per triangle: the coefficient rows of
//     bu, bv and z as a*px + b*py + c, sqrt|den| and the padded tile range
//     (empty for a dropped triangle);
//   * raster_tile_kernel, one block per tile and one thread per pixel: the
//     block scans the triangles' tile ranges in index order, compacts the
//     overlapping ones into a shared list with ballot / popc prefixes and
//     stops at tile_cap (the "first tile_cap by index" of the TPU top_k);
//     then each thread walks the list (staged through shared memory) and
//     keeps the nearest covering triangle (strict <, so ties go to the
//     lowest index) and the largest soft-edge margin.  Both winners' ids
//     are stored for the backward;
//   * raster_bwd_kernel, one thread per pixel: recomputes the closed-form
//     derivatives of (bu, bv, z) of the winner and of the margin of the
//     margin winner and atomically adds them into per-vertex screen-space
//     gradients (the clip -> NDC -> screen map stays in torch autograd).
//   * interpolate: a per-pixel gather and 3-term weighted sum; backward
//     atomically adds into the attributes and writes d bary.
//
// Bound on the card: operations.  The sweep does ~20 fp32 operations per
// pixel and listed triangle (512 per tile at the DMTet shape); the bytes are
// the per-vertex screen coordinates, the faces and 4 output planes.
// Arithmetic that decides a selection uses explicit round-to-nearest
// intrinsics in the plain version's order (no FMA contraction), so the
// kernel selects the same triangles as ops/raster.py::raster_plain on the
// same inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCap = 1024;
constexpr int kStage = 256;     // listed triangles staged per pass
constexpr int kCoef = 12;       // cu[3] cv[3] cz[3] scale pad pad

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
// a*px + b*py + c, as ops/raster.py::_eval
__device__ __forceinline__ float lin(const float* c, float px, float py) {
  return fadd(fadd(fmul(c[0], px), fmul(c[1], py)), c[2]);
}

__global__ void raster_setup_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ faces,
    const uint8_t* __restrict__ valid, int T, int tile, float pad,
    float* __restrict__ coef, int4* __restrict__ range) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int a = faces[3 * t], b = faces[3 * t + 1], c = faces[3 * t + 2];
  const float x0 = sx[a], y0 = sy[a], x1 = sx[b], y1 = sy[b], x2 = sx[c],
              y2 = sy[c];
  const float z0 = sz[a], z1 = sz[b], z2 = sz[c];
  const float e0x = fsub(x1, x0), e0y = fsub(y1, y0);
  const float e1x = fsub(x2, x0), e1y = fsub(y2, y0);
  float den = fsub(fmul(e0x, e1y), fmul(e0y, e1x));
  if (fabsf(den) < 1e-9f) den = 1e-9f;
  const float inv = __fdiv_rn(1.f, den);
  float* o = coef + (int64_t)t * kCoef;
  const float cu[3] = {fmul(e1y, inv), fmul(-e1x, inv),
                       fmul(fsub(fmul(y0, e1x), fmul(x0, e1y)), inv)};
  const float cv[3] = {fmul(-e0y, inv), fmul(e0x, inv),
                       fmul(fsub(fmul(x0, e0y), fmul(y0, e0x)), inv)};
  const float dz1 = fsub(z1, z0), dz2 = fsub(z2, z0);
  for (int k = 0; k < 3; ++k) {
    o[k] = cu[k];
    o[3 + k] = cv[k];
    o[6 + k] = fadd(fmul(cu[k], dz1), fmul(cv[k], dz2));
  }
  o[8] = fadd(o[8], z0);
  o[9] = __fsqrt_rn(fabsf(den));
  o[10] = 0.f;
  o[11] = 0.f;
  int4 r = make_int4(1, 0, 1, 0);             // empty: dropped triangle
  if (valid[t]) {
    const float bx0 = fminf(fminf(x0, x1), x2), bx1 = fmaxf(fmaxf(x0, x1), x2);
    const float by0 = fminf(fminf(y0, y1), y2), by1 = fmaxf(fmaxf(y0, y1), y2);
    const float ft = (float)tile;
    r = make_int4((int)floorf(__fdiv_rn(fsub(bx0, pad), ft)),
                  (int)floorf(__fdiv_rn(fadd(bx1, pad), ft)),
                  (int)floorf(__fdiv_rn(fsub(by0, pad), ft)),
                  (int)floorf(__fdiv_rn(fadd(by1, pad), ft)));
  }
  range[t] = r;
}

__global__ void __launch_bounds__(1024) raster_tile_kernel(
    const float* __restrict__ coef, const int4* __restrict__ range, int T,
    int H, int W, int tile, int cap, float soft, float* __restrict__ bary,
    int* __restrict__ tri_id, float* __restrict__ depth,
    float* __restrict__ alpha, int* __restrict__ marg_id) {
  __shared__ int s_list[kMaxCap];
  __shared__ int s_warp[32];
  __shared__ int s_total;
  __shared__ float s_coef[kStage * 10];
  __shared__ int s_id[kStage];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int tx = blockIdx.x, ty = blockIdx.y;

  // ---- list the first `cap` overlapping triangles in index order -------
  int count = 0;
  for (int base = 0; base < T && count < cap; base += nthreads) {
    const int i = base + tid;
    bool ov = false;
    if (i < T) {
      const int4 r = range[i];
      ov = r.x <= tx && r.y >= tx && r.z <= ty && r.w >= ty;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ov);
    const int before = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? s_warp[lane] : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (lane < nwarps) s_warp[lane] = incl - v;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    const int pos = count + s_warp[warp] + before;
    if (ov && pos < cap) s_list[pos] = i;
    count += s_total;
    __syncthreads();
  }
  const int n = count < cap ? count : cap;

  // ---- per pixel: nearest covering triangle, largest margin -------------
  const int lx = tid % tile, ly = tid / tile;
  const float px = fadd((float)lx + 0.5f, (float)(tx * tile));
  const float py = fadd((float)ly + 0.5f, (float)(ty * tile));
  float best_z = INFINITY, bu_b = 0.f, bv_b = 0.f;
  int best = -1;
  float best_m = count < cap ? -1e9f : -INFINITY;  // an unlisted slot: -1e9
  int marg = -1;
  for (int s0 = 0; s0 < n; s0 += kStage) {
    const int m = n - s0 < kStage ? n - s0 : kStage;
    for (int j = tid; j < m * 10; j += nthreads) {
      const int f = s_list[s0 + j / 10];
      s_coef[j] = coef[(int64_t)f * kCoef + j % 10];
    }
    for (int j = tid; j < m; j += nthreads) s_id[j] = s_list[s0 + j];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float* c = s_coef + j * 10;
      const float bu = lin(c, px, py), bv = lin(c + 3, px, py);
      const float bw = fsub(fsub(1.f, bu), bv);
      if (bu >= 0.f && bv >= 0.f && bw >= 0.f) {
        const float z = lin(c + 6, px, py);
        if (z < best_z) {
          best_z = z;
          best = s_id[j];
          bu_b = bu;
          bv_b = bv;
        }
      }
      if (soft > 0.f) {
        const float mg = fmul(fminf(fminf(bu, bv), bw), c[9]);
        if (mg > best_m) {
          best_m = mg;
          marg = s_id[j];
        }
      }
    }
    __syncthreads();
  }
  const int x = tx * tile + lx, y = ty * tile + ly;
  if (x >= W || y >= H) return;
  const int64_t p = (int64_t)y * W + x;
  tri_id[p] = best;
  marg_id[p] = marg;
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

// screen-space triangle at pixel (px, py): den, its guard, bu and bv
__device__ Tri load_tri(const float* sx, const float* sy, const int* f,
                        float px, float py) {
  Tri t;
  for (int k = 0; k < 3; ++k) {
    t.x[k] = sx[f[k]];
    t.y[k] = sy[f[k]];
  }
  const float e0x = t.x[1] - t.x[0], e0y = t.y[1] - t.y[0];
  const float e1x = t.x[2] - t.x[0], e1y = t.y[2] - t.y[0];
  float den = e0x * e1y - e0y * e1x;
  t.guarded = fabsf(den) < 1e-9f;
  if (t.guarded) den = 1e-9f;
  t.den = den;
  t.inv = 1.f / den;
  const float dx = px - t.x[0], dy = py - t.y[0];
  t.bu = (dx * e1y - dy * e1x) * t.inv;
  t.bv = (dy * e0x - dx * e0y) * t.inv;
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

__global__ void raster_bwd_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ faces,
    const int* __restrict__ tri_id, const int* __restrict__ marg_id,
    const float* __restrict__ alpha, const float* __restrict__ g_bary,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    int H, int W, float soft, float* __restrict__ gx, float* __restrict__ gy,
    float* __restrict__ gz) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)H * W) return;
  const float px = (float)(p % W) + 0.5f, py = (float)(p / W) + 0.5f;
  const int t = tri_id[p];
  if (t >= 0) {
    const int* f = faces + 3 * t;
    const Tri tr = load_tri(sx, sy, f, px, py);
    const float z0 = sz[f[0]], z1 = sz[f[1]], z2 = sz[f[2]];
    const float gw = g_bary[3 * p], gu = g_bary[3 * p + 1],
                gv = g_bary[3 * p + 2], gd = g_depth[p];
    const float Gu = gu - gw + gd * (z1 - z0);
    const float Gv = gv - gw + gd * (z2 - z0);
    if (Gu != 0.f || Gv != 0.f) {
      float dbu[6], dbv[6];
      bary_grads(tr, px, py, dbu, dbv);
      for (int k = 0; k < 3; ++k) {
        atomicAdd(gx + f[k], Gu * dbu[2 * k] + Gv * dbv[2 * k]);
        atomicAdd(gy + f[k], Gu * dbu[2 * k + 1] + Gv * dbv[2 * k + 1]);
      }
    }
    if (gd != 0.f) {
      atomicAdd(gz + f[0], gd * (1.f - tr.bu - tr.bv));
      atomicAdd(gz + f[1], gd * tr.bu);
      atomicAdd(gz + f[2], gd * tr.bv);
    }
  }
  const int m = marg_id[p];
  if (soft > 0.f && m >= 0) {
    const float a = alpha[p];
    const float Gm = g_alpha[p] * a * (1.f - a) * 4.f / soft;
    if (Gm == 0.f) return;
    const int* f = faces + 3 * m;
    const Tri tr = load_tri(sx, sy, f, px, py);
    const float bw = 1.f - tr.bu - tr.bv;
    // min(min(bu, bv), bw): the first of a tie, as fminf picks
    int k = 0;
    float bmin = tr.bu;
    if (tr.bv < bmin) { bmin = tr.bv; k = 1; }
    if (bw < bmin) { bmin = bw; k = 2; }
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
      const float db = k == 0 ? dbu[i] : k == 1 ? dbv[i] : -dbu[i] - dbv[i];
      const float d = Gm * (scale * db + bmin * ds * dden[i]);
      atomicAdd((i & 1 ? gy : gx) + f[i >> 1], d);
    }
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

__global__ void interpolate_bwd_kernel(
    const float* __restrict__ attrs, const float* __restrict__ bary,
    const int* __restrict__ tri_id, const int* __restrict__ faces,
    const float* __restrict__ g_out, int P, int C,
    float* __restrict__ g_attrs, float* __restrict__ g_bary) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int t = tri_id[p];
  float gb[3] = {0.f, 0.f, 0.f};
  if (t >= 0) {
    const int* f = faces + 3 * t;
    for (int c = 0; c < C; ++c) {
      const float g = g_out[p * C + c];
      for (int k = 0; k < 3; ++k) {
        gb[k] += g * attrs[(int64_t)f[k] * C + c];
        atomicAdd(g_attrs + (int64_t)f[k] * C + c, g * bary[3 * p + k]);
      }
    }
  }
  for (int k = 0; k < 3; ++k) g_bary[3 * p + k] = gb[k];
}

}  // namespace

extern "C" int raster_fwd(const float* sx, const float* sy, const float* sz,
                          const int* faces, const uint8_t* valid, int V, int T,
                          int H, int W, int tile, int cap, float soft,
                          float* coef, int* range, float* bary, int* tri_id,
                          float* depth, float* alpha, int* marg_id,
                          void* stream) {
  (void)V;
  if (cap > kMaxCap || tile > 32 || (tile * tile) % 32 != 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0) {
    raster_setup_kernel<<<(T + 255) / 256, 256, 0, s>>>(
        sx, sy, sz, faces, valid, T, tile, soft + 1.f, coef, (int4*)range);
  }
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  raster_tile_kernel<<<grid, tile * tile, 0, s>>>(
      coef, (const int4*)range, T, H, W, tile, cap, soft, bary, tri_id, depth,
      alpha, marg_id);
  return (int)cudaGetLastError();
}

extern "C" int raster_bwd(const float* sx, const float* sy, const float* sz,
                          const int* faces, const int* tri_id,
                          const int* marg_id, const float* alpha,
                          const float* g_bary, const float* g_depth,
                          const float* g_alpha, int H, int W, float soft,
                          float* gx, float* gy, float* gz, void* stream) {
  const int64_t P = (int64_t)H * W;
  if (P > 0) {
    raster_bwd_kernel<<<(unsigned)((P + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        sx, sy, sz, faces, tri_id, marg_id, alpha, g_bary, g_depth, g_alpha,
        H, W, soft, gx, gy, gz);
  }
  return (int)cudaGetLastError();
}

extern "C" int interpolate_fwd(const float* attrs, const float* bary,
                               const int* tri_id, const int* faces, int P,
                               int C, float* out, void* stream) {
  const int64_t n = (int64_t)P * C;
  if (n > 0) {
    interpolate_fwd_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(attrs, bary, tri_id,
                                                     faces, P, C, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int interpolate_bwd(const float* attrs, const float* bary,
                               const int* tri_id, const int* faces,
                               const float* g_out, int P, int C,
                               float* g_attrs, float* g_bary, void* stream) {
  if (P > 0) {
    interpolate_bwd_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        attrs, bary, tri_id, faces, g_out, P, C, g_attrs, g_bary);
  }
  return (int)cudaGetLastError();
}
