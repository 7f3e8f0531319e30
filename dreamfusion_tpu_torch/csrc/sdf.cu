// K9: signed distance of points to a triangle mesh, for DMTet's mesh-file
// init (--dmtet --init_with mesh.obj|.ply).
//
// Replaces dreamfusion_tpu/mesh/sdf.py::signed_distance (with
// _point_tri_dist2 and _winding), which on the TPU is a dense chunked
// point x triangle sweep: [1024, T] tiles of closest-point distances and
// solid angles reduced by min and sum.  Here each thread owns one point and
// walks every triangle; the triangles' 9 coordinates are staged through
// shared memory kTile at a time (one broadcast read per thread per
// triangle), and the running min of d² and the running sum of winding terms
// stay in registers, so nothing of the [P, T] product reaches memory.
//
// Bound on the card: operations.  Each (point, triangle) pair costs about
// 170 fp32 operations (the six dot products and the region tests of the
// distance, the one candidate of the point's region, the solid angle's
// three norms, triple product and atan2), against 12 bytes per point and 36
// per triangle.  The region is decided first and only its candidate point
// is formed; the candidate's formula is JAX's, so the result is the same.
//
// Arithmetic kept from the JAX version, products and sums rounded one by
// one as there (no fma contraction), guards included (the decimated
// stage-1 export has slivers and degenerate triangles, where a dropped
// guard turns into NaN): the face candidate with denominator
// max(va + vb + vc, 1e-30) and v, w clipped to [0, 1]; the edge parameters
// d / where(d == 0, 1e-30, d) clipped to [0, 1]; JAX's precedence of the
// regions (vertex c over b over a over edge bc over ac over ab over the
// face); the winding term atan2(det, den) / 2π.  The winding sum runs in
// fp64 (one add per pair), so its order matters less than JAX's fp32 sum;
// a point is inside (negative) where the sum exceeds 0.5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;        // triangles per shared-memory tile

// Separately rounded products and sums: nvcc would contract a*b + c into
// one fma, and on a sliver triangle the region tests cancel catastrophically
// (d5·d2 − d1·d6 and the like), so a contracted sum picks another region
// and another candidate than the JAX and plain versions, whose products
// and sums round one by one (a 5e-4 difference on a 1e-7-wide sliver).
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}
__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}
__device__ __forceinline__ float guard(float x) {
  return x == 0.f ? 1e-30f : x;
}

__global__ void signed_distance_kernel(const float* __restrict__ points,
                                       const float* __restrict__ tris, int P,
                                       int T, float* __restrict__ sd,
                                       float* __restrict__ winding) {
  __shared__ float s[kTile * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < P;
  const float px = active ? points[3 * (int64_t)i] : 0.f;
  const float py = active ? points[3 * (int64_t)i + 1] : 0.f;
  const float pz = active ? points[3 * (int64_t)i + 2] : 0.f;
  float best = __int_as_float(0x7f800000);          // +inf
  double wsum = 0.0;
  const float inv_2pi = 0.15915494309189535f;       // 1 / (2π)

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < n * 9; k += blockDim.x)
      s[k] = tris[(int64_t)t0 * 9 + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float* t = s + 9 * j;
      const float ax = t[0], ay = t[1], az = t[2];
      const float bx = t[3], by = t[4], bz = t[5];
      const float cx = t[6], cy = t[7], cz = t[8];

      // ---- squared distance (_point_tri_dist2) ----
      const float abx = bx - ax, aby = by - ay, abz = bz - az;
      const float acx = cx - ax, acy = cy - ay, acz = cz - az;
      const float apx = px - ax, apy = py - ay, apz = pz - az;
      const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
      const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
      const float d1 = dot3(abx, aby, abz, apx, apy, apz);
      const float d2 = dot3(acx, acy, acz, apx, apy, apz);
      const float d3 = dot3(abx, aby, abz, bpx, bpy, bpz);
      const float d4 = dot3(acx, acy, acz, bpx, bpy, bpz);
      const float d5 = dot3(abx, aby, abz, cpx, cpy, cpz);
      const float d6 = dot3(acx, acy, acz, cpx, cpy, cpz);
      const float va = sub(mul(d3, d6), mul(d5, d4));
      const float vb = sub(mul(d5, d2), mul(d1, d6));
      const float vc = sub(mul(d1, d4), mul(d3, d2));

      const bool vert_a = (d1 <= 0.f) && (d2 <= 0.f);
      const bool vert_b = (d3 >= 0.f) && (d4 <= d3);
      const bool vert_c = (d6 >= 0.f) && (d5 <= d6);
      const bool edge_ab = !vert_a && !vert_b && (d1 >= 0.f) &&
                           (d3 <= 0.f) && (vc <= 0.f);
      const bool edge_ac = !vert_a && !vert_c && (d2 >= 0.f) &&
                           (d6 <= 0.f) && (vb <= 0.f);
      const bool edge_bc = !vert_b && !vert_c && (d4 - d3 >= 0.f) &&
                           (d5 - d6 >= 0.f) && (va <= 0.f);
      // the region's one candidate, JAX's precedence
      float qx, qy, qz;
      if (vert_c) {
        qx = cx; qy = cy; qz = cz;
      } else if (vert_b) {
        qx = bx; qy = by; qz = bz;
      } else if (vert_a) {
        qx = ax; qy = ay; qz = az;
      } else if (edge_bc) {
        const float e = d4 - d3, f = d5 - d6;
        const float tt = clip01(e / guard(e + f));
        qx = add(bx, mul(tt, cx - bx));
        qy = add(by, mul(tt, cy - by));
        qz = add(bz, mul(tt, cz - bz));
      } else if (edge_ac) {
        const float tt = clip01(d2 / guard(d2 - d6));
        qx = add(ax, mul(tt, acx));
        qy = add(ay, mul(tt, acy));
        qz = add(az, mul(tt, acz));
      } else if (edge_ab) {
        const float tt = clip01(d1 / guard(d1 - d3));
        qx = add(ax, mul(tt, abx));
        qy = add(ay, mul(tt, aby));
        qz = add(az, mul(tt, abz));
      } else {
        const float denom = fmaxf(add(add(va, vb), vc), 1e-30f);
        const float v = clip01(vb / denom), w = clip01(vc / denom);
        qx = add(add(ax, mul(v, abx)), mul(w, acx));
        qy = add(add(ay, mul(v, aby)), mul(w, acy));
        qz = add(add(az, mul(v, abz)), mul(w, acz));
      }
      const float ex = px - qx, ey = py - qy, ez = pz - qz;
      best = fminf(best, dot3(ex, ey, ez, ex, ey, ez));

      // ---- winding term (_winding): r = vertex − p ----
      const float rax = -apx, ray = -apy, raz = -apz;
      const float rbx = -bpx, rby = -bpy, rbz = -bpz;
      const float rcx = -cpx, rcy = -cpy, rcz = -cpz;
      const float la = sqrtf(dot3(rax, ray, raz, rax, ray, raz));
      const float lb = sqrtf(dot3(rbx, rby, rbz, rbx, rby, rbz));
      const float lc = sqrtf(dot3(rcx, rcy, rcz, rcx, rcy, rcz));
      const float det = dot3(rax, ray, raz,
                             sub(mul(rby, rcz), mul(rbz, rcy)),
                             sub(mul(rbz, rcx), mul(rbx, rcz)),
                             sub(mul(rbx, rcy), mul(rby, rcx)));
      const float den =
          add(add(add(mul(mul(la, lb), lc),
                      mul(dot3(rax, ray, raz, rbx, rby, rbz), lc)),
                  mul(dot3(rbx, rby, rbz, rcx, rcy, rcz), la)),
              mul(dot3(rcx, rcy, rcz, rax, ray, raz), lb));
      wsum += (double)mul(atan2f(det, den), inv_2pi);
    }
  }
  if (!active) return;
  const float dist = sqrtf(best);
  const float wn = (float)wsum;
  sd[i] = wn > 0.5f ? -dist : dist;
  if (winding != nullptr) winding[i] = wn;
}

}  // namespace

// points [P, 3], tris [T, 9] (each triangle's a, b, c) → sd [P] and, when
// winding is not NULL, the generalized winding number [P].
extern "C" int signed_distance(const float* points, const float* tris, int P,
                               int T, float* sd, float* winding,
                               void* stream) {
  if (P > 0) {
    signed_distance_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(points, tris, P, T, sd,
                                                     winding);
  }
  return (int)cudaGetLastError();
}
