// K9: signed distance of points to a triangle mesh, for DMTet's mesh-file
// init (--dmtet --init_with mesh.obj|.ply).
//
// Replaces dreamfusion_tpu/mesh/sdf.py::signed_distance (with
// _point_tri_dist2 and _winding), which on the TPU is a dense chunked
// point x triangle sweep: [1024, T] tiles of closest-point distances and
// solid angles reduced by min and sum.  Nothing of the [P, T] product
// reaches memory here: a first kernel writes one record per triangle, the
// second walks every triangle for each point, the records staged through
// shared memory kTile at a time (broadcast reads), the running min of d²
// and the running sum of winding terms in registers.
//
// Bound on the card: operations.  About 180 fp32 operations per (point,
// triangle) pair in JAX's formulation: the six dot products, the region
// tests and the candidate of the distance (~100), the solid angle's three
// norms, triple product and atan2 (~80).  Two things cut the work without
// changing a bit of the result:
//  * the record holds what depends on the triangle alone: a, b, c, the
//    differences ab = b - a, ac = c - a, cb = c - b (rounded as the per-pair
//    subtractions round them) and a bounding sphere;
//  * exact culling of the distance part: every candidate the region logic
//    can form is a + s·ab + t·ac with s, t in [0, 1] (vertices, edges, the
//    face with its clipped weights) or b + t·cb, so it lies in the ball
//    that holds those corners, widened by 2^-10 of its radius plus 2^-16 of
//    the largest coordinate (far above the candidate's rounding).  Where
//    even that ball's nearest point is further than the running minimum,
//    (|p - centre|·(1 - 2^-10))² > ((√best)(1 + 2^-10) + radius)², the
//    candidate's d² exceeds best and fminf would drop it: the region tests
//    are skipped and the minimum is the same, bit for bit;
// The winding term stays whole: every pair, the same arithmetic, the same
// fp64 sum in triangle order (its order decides the sign at 0.5).
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

constexpr int kThreads = 128;
constexpr int kTile = 256;        // triangles per shared-memory tile
constexpr int kRec = 6;           // float4s a triangle record: a, ab, ac,
                                  // b, c, cb, centre, radius, 2 pad
constexpr float kGrow = 1.0009765625f;    // 1 + 2^-10
constexpr float kShrink = 0.9990234375f;  // 1 - 2^-10

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

// One record per triangle: rec[6t .. 6t+5] = (a, ab.x), (ab.yz, ac.xy),
// (ac.z, b), (c, cb.x), (cb.yz, centre.xy), (centre.z, radius, 0, 0).
__global__ void triangle_records_kernel(const float* __restrict__ verts,
                                        const int* __restrict__ tris, int T,
                                        float4* __restrict__ rec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float v[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t i = tris[3 * (int64_t)t + k];
#pragma unroll
    for (int a = 0; a < 3; ++a) v[k][a] = verts[3 * i + a];
  }
  float ab[3], ac[3], cb[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ab[a] = sub(v[1][a], v[0][a]);
    ac[a] = sub(v[2][a], v[0][a]);
    cb[a] = sub(v[2][a], v[1][a]);
  }
  // the corners of every candidate: a, a + ab, a + ac, a + ab + ac, b, c,
  // b + cb (in double: exact or nearly so for float inputs)
  double k[7][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double A = v[0][a];
    k[0][a] = A;
    k[1][a] = A + ab[a];
    k[2][a] = A + ac[a];
    k[3][a] = A + (double)ab[a] + (double)ac[a];
    k[4][a] = v[1][a];
    k[5][a] = v[2][a];
    k[6][a] = (double)v[1][a] + cb[a];
  }
  float centre[3];
  double big = 0.0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    double lo = k[0][a], hi = k[0][a];
#pragma unroll
    for (int j = 1; j < 7; ++j) {
      lo = fmin(lo, k[j][a]);
      hi = fmax(hi, k[j][a]);
    }
    centre[a] = (float)(0.5 * (lo + hi));
    big = fmax(big, fmax(fabs(lo), fabs(hi)));
  }
  double r2 = 0.0;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    double s = 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double e = k[j][a] - (double)centre[a];
      s += e * e;
    }
    r2 = fmax(r2, s);
  }
  // NaN or inf corners give a NaN or inf radius: such a triangle is never
  // culled
  const float radius = __double2float_ru(sqrt(r2) * (1.0 + 0x1p-10) +
                                         big * 0x1p-16);
  float4* out = rec + (int64_t)kRec * t;
  out[0] = make_float4(v[0][0], v[0][1], v[0][2], ab[0]);
  out[1] = make_float4(ab[1], ab[2], ac[0], ac[1]);
  out[2] = make_float4(ac[2], v[1][0], v[1][1], v[1][2]);
  out[3] = make_float4(v[2][0], v[2][1], v[2][2], cb[0]);
  out[4] = make_float4(cb[1], cb[2], centre[0], centre[1]);
  out[5] = make_float4(centre[2], radius, 0.f, 0.f);
}

struct Tri {
  float ax, ay, az, abx, aby, abz, acx, acy, acz;
  float bx, by, bz, cx, cy, cz, cbx, cby, cbz;
  float ox, oy, oz, rad;
};

__device__ __forceinline__ Tri load_tri(const float4* s) {
  const float4 r0 = s[0], r1 = s[1], r2 = s[2], r3 = s[3], r4 = s[4],
               r5 = s[5];
  return Tri{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x,
             r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w, r4.x, r4.y,
             r4.z, r4.w, r5.x, r5.y};
}

// One (point, triangle) pair: the distance part unless culled, the winding
// term always.
template <bool kCull>
__device__ __forceinline__ void pair(const Tri& t, float px, float py,
                                     float pz, float& best, float& reach,
                                     double& wsum, unsigned& n_dist) {
  const float apx = px - t.ax, apy = py - t.ay, apz = pz - t.az;
  const float bpx = px - t.bx, bpy = py - t.by, bpz = pz - t.bz;
  const float cpx = px - t.cx, cpy = py - t.cy, cpz = pz - t.cz;
  bool keep = true;
  if (kCull) {
    const float qx = sub(px, t.ox), qy = sub(py, t.oy), qz = sub(pz, t.oz);
    const float lim = add(reach, t.rad);
    keep = !(mul(dot3(qx, qy, qz, qx, qy, qz), kShrink) > mul(lim, lim));
  }
  if (keep) {
    ++n_dist;
    // ---- squared distance (_point_tri_dist2) ----
    const float d1 = dot3(t.abx, t.aby, t.abz, apx, apy, apz);
    const float d2 = dot3(t.acx, t.acy, t.acz, apx, apy, apz);
    const float d3 = dot3(t.abx, t.aby, t.abz, bpx, bpy, bpz);
    const float d4 = dot3(t.acx, t.acy, t.acz, bpx, bpy, bpz);
    const float d5 = dot3(t.abx, t.aby, t.abz, cpx, cpy, cpz);
    const float d6 = dot3(t.acx, t.acy, t.acz, cpx, cpy, cpz);
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
      qx = t.cx; qy = t.cy; qz = t.cz;
    } else if (vert_b) {
      qx = t.bx; qy = t.by; qz = t.bz;
    } else if (vert_a) {
      qx = t.ax; qy = t.ay; qz = t.az;
    } else if (edge_bc) {
      const float e = d4 - d3, f = d5 - d6;
      const float tt = clip01(e / guard(e + f));
      qx = add(t.bx, mul(tt, t.cbx));
      qy = add(t.by, mul(tt, t.cby));
      qz = add(t.bz, mul(tt, t.cbz));
    } else if (edge_ac) {
      const float tt = clip01(d2 / guard(d2 - d6));
      qx = add(t.ax, mul(tt, t.acx));
      qy = add(t.ay, mul(tt, t.acy));
      qz = add(t.az, mul(tt, t.acz));
    } else if (edge_ab) {
      const float tt = clip01(d1 / guard(d1 - d3));
      qx = add(t.ax, mul(tt, t.abx));
      qy = add(t.ay, mul(tt, t.aby));
      qz = add(t.az, mul(tt, t.abz));
    } else {
      const float denom = fmaxf(add(add(va, vb), vc), 1e-30f);
      const float v = clip01(vb / denom), w = clip01(vc / denom);
      qx = add(add(t.ax, mul(v, t.abx)), mul(w, t.acx));
      qy = add(add(t.ay, mul(v, t.aby)), mul(w, t.acy));
      qz = add(add(t.az, mul(v, t.abz)), mul(w, t.acz));
    }
    const float ex = px - qx, ey = py - qy, ez = pz - qz;
    const float dd = dot3(ex, ey, ez, ex, ey, ez);
    if (dd < best) {                 // fminf(best, dd); a NaN never wins
      best = dd;
      reach = mul(sqrtf(dd), kGrow);
    }
  }

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
  const float inv_2pi = 0.15915494309189535f;       // 1 / (2π)
  wsum += (double)mul(atan2f(det, den), inv_2pi);
}

// A point a thread.  Each block sweeps every triangle, so a second wave of
// a few blocks would cost as much as a full one: at most 56 registers keep
// 9 blocks on an SM (the 274,625 points of tet grid 128 in 1.8 waves).
// Two points a thread, each record read serving two pairs, measured slower
// (108 against 90 ms at 274,625 x 50,000 on the H100: 44 bytes of spills
// at the 56-register cap, which one wave of 1,073 blocks needs).
template <bool kCull>
__global__ void __launch_bounds__(kThreads, 9)
signed_distance_kernel(const float* __restrict__ points,
                       const float4* __restrict__ rec, int P, int T,
                       float* __restrict__ sd, float* __restrict__ winding,
                       unsigned long long* __restrict__ n_dist_out) {
  __shared__ float4 s[kTile * kRec];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < P;
  const float px = active ? points[3 * (int64_t)i] : 0.f;
  const float py = active ? points[3 * (int64_t)i + 1] : 0.f;
  const float pz = active ? points[3 * (int64_t)i + 2] : 0.f;
  float best = __int_as_float(0x7f800000);          // +inf
  float reach = best;
  double wsum = 0.0;
  unsigned n_dist = 0;

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kRec; k += kThreads)
      s[k] = rec[(int64_t)t0 * kRec + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j)
      pair<kCull>(load_tri(s + kRec * j), px, py, pz, best, reach, wsum,
                  n_dist);
  }
  if (!active) return;
  const float dist = sqrtf(best);
  const float wn = (float)wsum;
  sd[i] = wn > 0.5f ? -dist : dist;
  if (winding != nullptr) winding[i] = wn;
  if (n_dist_out != nullptr) atomicAdd(n_dist_out, (unsigned long long)n_dist);
}

}  // namespace

// points [P, 3], verts [V, 3] fp32 and tris [T, 3] int32 → sd [P] and, when
// winding is not NULL, the generalized winding number [P].  rec: a
// workspace of T·24 floats, 16-byte aligned (the triangle records).  cull 0
// takes the region tests for every pair (the same result: the culling is
// exact); n_dist, when not NULL, gets the number of pairs whose distance
// part ran added to it.
extern "C" int signed_distance(const float* points, const float* verts,
                               const int* tris, int P, int T, float* rec,
                               int cull, float* sd, float* winding,
                               unsigned long long* n_dist, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (P > 0 && T > 0) {
    float4* r4 = reinterpret_cast<float4*>(rec);
    triangle_records_kernel<<<(T + 255) / 256, 256, 0, s>>>(verts, tris, T,
                                                            r4);
    const int blocks = (P + kThreads - 1) / kThreads;
    if (cull) {
      signed_distance_kernel<true><<<blocks, kThreads, 0, s>>>(
          points, r4, P, T, sd, winding, n_dist);
    } else {
      signed_distance_kernel<false><<<blocks, kThreads, 0, s>>>(
          points, r4, P, T, sd, winding, n_dist);
    }
  }
  return (int)cudaGetLastError();
}
