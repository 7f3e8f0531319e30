// K4: the field head, alone, with the normals and the shading folded in,
// or with given normals and the select, forward and backward.
//
// Replaces dreamfusion_tpu/ops/activation.py::trunc_exp (a custom_vjp) and
// biased_softplus with the epilogue of NeRFField.common, density_blob and,
// for field_shade_* and field_select_*, the tail of
// NeRFField.common_with_normal and __call__'s shading select
// (dreamfusion_tpu/models/nerf.py:189-197, :244-252, :332-344).  Per sample
// n, for h [N, 4] (the MLP's output, bf16 or fp32), x [N, 3] world
// positions and the MLP's tangents t [3, N, 4] (column 0 read):
//
//   pre    = h0 + blob(x)                   (no gradient)
//   sigma  = act(pre)
//   albedo = sigmoid(h1:4)
//   dsig   = act'(pre)                      its own gradient act''(pre)
//   g      = t0 * dsig / (2 bound)          (∇σ's closed form)
//   normal = nan_to_num(-g * rsqrt(max(|g|², 1e-20)))
//   lam    = ratio + (1 - ratio) * max(<normal, l>, 0)  (gradient 1/2 at 0,
//            as JAX's maximum), l the light direction of n's ray (n / S)
//   color  = albedo | lam | (normal + 1) / 2 | albedo * lam by the shading
//            id (0 albedo, 2 textureless, 3 normal, else lambertian)
//
// act 0 is trunc_exp: exp(pre), gradient exp(min(pre, 15)), the blob
// density * exp(-|x|² / (2 r²)); act 1 is softplus(pre + 1), gradient
// sigmoid(pre + 1), the blob density * (1 - |x| / r).  field_select takes
// the normals as given (the finite-difference ones) and returns sigma and
// colour; its backward writes g_h and g_normal.
//
// ratio and the shading id are read on the device where they are tensors
// (no host read), or taken as values.  The backward follows the plain
// twin's autograd rules exactly: the activation's gradient rule, dsig's own
// gradient, clamp's zero gradient below eps (at or above it, the
// normalization's gradient passes), nan_to_num's zero gradient at
// non-finite inputs, the select.  It writes g_h [N, 4] and g_t [3, N, 4]
// (zeros in columns 1-3) in the inputs' dtype, in the same launch: no fill,
// no slice backward, no cast.  A null cotangent reads as 0.
//
// Bound on the card: memory.  A thread per sample, no reuse; h's and t's
// rows are single 8-byte (bf16) or 16-byte (fp32) loads.  Forward ~72 bytes
// a sample in bf16 (h 8, t 24, x 12 in; sigma 4, colour 12, normal 12 out),
// backward ~112.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kClamp = 15.f;
constexpr float kEps = 1e-20f;

__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          float a, float b, float c,
                                          float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p,
                                          float a, float b, float c,
                                          float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

struct Blob {
  int act;                          // 0 trunc_exp, 1 softplus(x + 1)
  float density, denom;             // density, 2 r² (act 0) or r (act 1)
};

__device__ __forceinline__ float pre_act(float h0, const float* __restrict__ x,
                                         int64_t n, Blob b) {
  const float x0 = x[3 * n], x1 = x[3 * n + 1], x2 = x[3 * n + 2];
  const float d = x0 * x0 + x1 * x1 + x2 * x2;
  return h0 + (b.act == 0 ? b.density * expf(-d / b.denom)
                          : b.density * (1.f - sqrtf(d) / b.denom));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// act(pre), as jax.nn.softplus forms softplus: max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float act_of(float pre, int act) {
  if (act == 0) return expf(pre);
  const float v = pre + 1.f;
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// act's gradient (trunc_exp's clamped rule): dsig
__device__ __forceinline__ float dact_of(float pre, int act) {
  return act == 0 ? expf(fminf(pre, kClamp)) : sigmoid(pre + 1.f);
}

// dsig's own gradient
__device__ __forceinline__ float ddact_of(float pre, int act) {
  if (act == 0) return pre < kClamp ? expf(pre) : 0.f;
  const float s = sigmoid(pre + 1.f);
  return s * (1.f - s);
}

// What the shading needs of its inputs: the light direction of sample n,
// the ambient ratio and the shading id.
struct Shading {
  const float* light;       // [3], or [R, 3] when per_ray > 0; or nullptr
  int per_ray;              // samples a ray (0: one direction for all)
  const float* ratio_p;     // [] on the device, or nullptr: ``ratio``
  float ratio;
  const int64_t* id_p;      // [] on the device, or nullptr: ``id``
  int id;
};

// The normal of sample n and what its gradient needs: the tangents' column
// 0, m = -g before the normalization, |m|², the scale, and which components
// were finite.
struct Normal {
  float t0[3], m[3], n2, inv, n[3];
  bool finite[3];
};

template <typename T>
__device__ __forceinline__ Normal normal_of(const T* __restrict__ t,
                                            int64_t N, int64_t n, float dsig,
                                            float two_b) {
  Normal o;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float row[4];
    load_row(t + 4 * (k * N + n), row);
    o.t0[k] = row[0];
    o.m[k] = -(row[0] * dsig / two_b);
  }
  o.n2 = o.m[0] * o.m[0] + o.m[1] * o.m[1] + o.m[2] * o.m[2];
  o.inv = rsqrtf(fmaxf(o.n2, kEps));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = o.m[k] * o.inv;
    o.finite[k] = isfinite(v);
    // nan_to_num: NaN -> 0, ±inf -> ±the largest float
    o.n[k] = isnan(v) ? 0.f : (isinf(v) ? copysignf(3.402823466e38f, v) : v);
  }
  return o;
}

__device__ __forceinline__ void light_of(const Shading& s, int64_t n,
                                         float l[3]) {
  if (s.light == nullptr) {
    l[0] = l[1] = l[2] = 0.f;
    return;
  }
  const float* p = s.light + (s.per_ray > 0 ? 3 * (n / s.per_ray) : 0);
  l[0] = p[0];
  l[1] = p[1];
  l[2] = p[2];
}

// ---- the head alone ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) field_head_fwd_kernel(
    const T* __restrict__ h, const float* __restrict__ x, int64_t N, Blob b,
    float* __restrict__ sigma, float* __restrict__ albedo) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4];
  load_row(h + 4 * n, hv);
  sigma[n] = act_of(pre_act(hv[0], x, n, b), b.act);
#pragma unroll
  for (int c = 0; c < 3; ++c) albedo[3 * n + c] = sigmoid(hv[c + 1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) field_head_bwd_kernel(
    const T* __restrict__ h, const float* __restrict__ x, int64_t N, Blob b,
    const float* __restrict__ g_sigma, const float* __restrict__ g_albedo,
    T* __restrict__ g_h) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4], g[4];
  load_row(h + 4 * n, hv);
  g[0] = g_sigma ? g_sigma[n] * dact_of(pre_act(hv[0], x, n, b), b.act)
                 : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = sigmoid(hv[c + 1]);
    g[c + 1] = g_albedo ? g_albedo[3 * n + c] * (s * (1.f - s)) : 0.f;
  }
  store_row(g_h + 4 * n, g[0], g[1], g[2], g[3]);
}

// ---- the shading select ----------------------------------------------------

struct Select {
  float l[3], ratio, dot, lam;
  int id;
};

__device__ __forceinline__ Select select_of(const Shading& sh, int64_t n,
                                            const float nv[3]) {
  Select s;
  light_of(sh, n, s.l);
  s.ratio = sh.ratio_p ? *sh.ratio_p : sh.ratio;
  s.id = sh.id_p ? (int)*sh.id_p : sh.id;
  s.dot = nv[0] * s.l[0] + nv[1] * s.l[1] + nv[2] * s.l[2];
  s.lam = s.ratio + (1.f - s.ratio) * fmaxf(s.dot, 0.f);
  return s;
}

__device__ __forceinline__ float color_of(const Select& s, float a,
                                          float nv) {
  return s.id == 0 ? a : s.id == 2 ? s.lam : s.id == 3 ? (nv + 1.f) / 2.f
                                                        : a * s.lam;
}

// The select's backward: the colour's cotangent gc → the albedo's ga and
// the normal's gn (added to gn).
__device__ __forceinline__ void select_bwd(const Select& s, const float a[3],
                                           const float gc[3], float ga[3],
                                           float gn[3]) {
  float glam = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ga[c] = 0.f;
    if (s.id == 0) {
      ga[c] = gc[c];
    } else if (s.id == 2) {
      glam += gc[c];
    } else if (s.id == 3) {
      gn[c] += gc[c] / 2.f;
    } else {
      ga[c] = gc[c] * s.lam;
      glam += gc[c] * a[c];
    }
  }
  // lam: max(dot, 0) passes 1 above 0 and 1/2 at it
  const float gdot = glam * (1.f - s.ratio) *
                     (s.dot > 0.f ? 1.f : (s.dot == 0.f ? 0.5f : 0.f));
#pragma unroll
  for (int c = 0; c < 3; ++c) gn[c] += gdot * s.l[c];
}

// ---- the head with the normals and the shading ------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) field_shade_fwd_kernel(
    const T* __restrict__ h, const T* __restrict__ t,
    const float* __restrict__ x, int64_t N, Shading sh, Blob b, float two_b,
    float* __restrict__ sigma, float* __restrict__ color,
    float* __restrict__ normal) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4];
  load_row(h + 4 * n, hv);
  const float pre = pre_act(hv[0], x, n, b);
  const float dsig = dact_of(pre, b.act);
  sigma[n] = act_of(pre, b.act);
  const Normal nm = normal_of(t, N, n, dsig, two_b);
  const Select s = select_of(sh, n, nm.n);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    normal[3 * n + c] = nm.n[c];
    color[3 * n + c] = color_of(s, sigmoid(hv[c + 1]), nm.n[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) field_shade_bwd_kernel(
    const T* __restrict__ h, const T* __restrict__ t,
    const float* __restrict__ x, int64_t N, Shading sh, Blob b, float two_b,
    const float* __restrict__ g_sigma, const float* __restrict__ g_color,
    const float* __restrict__ g_normal, T* __restrict__ g_h,
    T* __restrict__ g_t) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4], a[3], gc[3], gn[3], ga[3];
  load_row(h + 4 * n, hv);
  const float pre = pre_act(hv[0], x, n, b);
  const float dsig = dact_of(pre, b.act);
  const Normal nm = normal_of(t, N, n, dsig, two_b);
  const Select s = select_of(sh, n, nm.n);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = sigmoid(hv[c + 1]);
    gc[c] = g_color ? g_color[3 * n + c] : 0.f;
    gn[c] = g_normal ? g_normal[3 * n + c] : 0.f;
  }
  select_bwd(s, a, gc, ga, gn);
  float g_inv = 0.f, gm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!nm.finite[c]) gn[c] = 0.f;             // nan_to_num
    g_inv += gn[c] * nm.m[c];
  }
  // normal = m * rsqrt(max(|m|², eps)): the clamp passes at or above eps
  const float k = nm.n2 >= kEps ? g_inv * nm.inv * nm.inv * nm.inv : 0.f;
  float g_dsig = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gm[c] = gn[c] * nm.inv - k * nm.m[c];
    // m = -(t0 * dsig / 2b)
    const float gg = -gm[c];
    g_dsig += gg * nm.t0[c] / two_b;
    store_row(g_t + 4 * (c * N + n), gg * dsig / two_b, 0.f, 0.f, 0.f);
  }
  float g0 = g_dsig * ddact_of(pre, b.act);
  if (g_sigma) g0 += g_sigma[n] * dsig;
  float gh[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gh[c] = ga[c] * (a[c] * (1.f - a[c]));
  store_row(g_h + 4 * n, g0, gh[0], gh[1], gh[2]);
}

// ---- the head with given normals and the select ----------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) field_select_fwd_kernel(
    const T* __restrict__ h, const float* __restrict__ normal,
    const float* __restrict__ x, int64_t N, Shading sh, Blob b,
    float* __restrict__ sigma, float* __restrict__ color) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4], nv[3];
  load_row(h + 4 * n, hv);
#pragma unroll
  for (int c = 0; c < 3; ++c) nv[c] = normal[3 * n + c];
  sigma[n] = act_of(pre_act(hv[0], x, n, b), b.act);
  const Select s = select_of(sh, n, nv);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    color[3 * n + c] = color_of(s, sigmoid(hv[c + 1]), nv[c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) field_select_bwd_kernel(
    const T* __restrict__ h, const float* __restrict__ normal,
    const float* __restrict__ x, int64_t N, Shading sh, Blob b,
    const float* __restrict__ g_sigma, const float* __restrict__ g_color,
    T* __restrict__ g_h, float* __restrict__ g_normal) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float hv[4], nv[3], a[3], gc[3], ga[3], gn[3] = {0.f, 0.f, 0.f};
  load_row(h + 4 * n, hv);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nv[c] = normal[3 * n + c];
    a[c] = sigmoid(hv[c + 1]);
    gc[c] = g_color ? g_color[3 * n + c] : 0.f;
  }
  const Select s = select_of(sh, n, nv);
  select_bwd(s, a, gc, ga, gn);
  const float g0 =
      g_sigma ? g_sigma[n] * dact_of(pre_act(hv[0], x, n, b), b.act) : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) g_normal[3 * n + c] = gn[c];
  store_row(g_h + 4 * n, g0, ga[0] * (a[0] * (1.f - a[0])),
            ga[1] * (a[1] * (1.f - a[1])), ga[2] * (a[2] * (1.f - a[2])));
}

int blocks(int64_t N) { return (int)((N + kThreads - 1) / kThreads); }

Shading make_shading(const float* light, int per_ray, const float* ratio_p,
                     float ratio, const int64_t* id_p, int id) {
  Shading s;
  s.light = light;
  s.per_ray = per_ray;
  s.ratio_p = ratio_p;
  s.ratio = ratio;
  s.id_p = id_p;
  s.id = id;
  return s;
}

}  // namespace

// Every entry point: h [N, 4] bf16 (bf16 = 1) or fp32, act 0 (trunc_exp) or
// 1 (softplus(x + 1)), the blob's density and scale (2 r² or r).

extern "C" int field_head_fwd(const void* h, const float* x, int N, int bf16,
                              int act, float density, float denom,
                              float* sigma, float* albedo, void* stream) {
  const Blob b{act, density, denom};
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_head_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, x, N, b, sigma, albedo);
    else
      field_head_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, x, N, b, sigma, albedo);
  }
  return (int)cudaGetLastError();
}

extern "C" int field_head_bwd(const void* h, const float* x, int N, int bf16,
                              int act, float density, float denom,
                              const float* g_sigma, const float* g_albedo,
                              void* g_h, void* stream) {
  const Blob b{act, density, denom};
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_head_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, x, N, b, g_sigma, g_albedo,
          (__nv_bfloat16*)g_h);
    else
      field_head_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, x, N, b, g_sigma, g_albedo, (float*)g_h);
  }
  return (int)cudaGetLastError();
}

extern "C" int field_shade_fwd(const void* h, const void* t, const float* x,
                               int N, int bf16, int act, const float* light,
                               int per_ray, const float* ratio_p, float ratio,
                               const int64_t* id_p, int id, float density,
                               float denom, float two_b, float* sigma,
                               float* color, float* normal, void* stream) {
  const Blob b{act, density, denom};
  const Shading s = make_shading(light, per_ray, ratio_p, ratio, id_p, id);
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_shade_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, (const __nv_bfloat16*)t, x, N, s, b, two_b,
          sigma, color, normal);
    else
      field_shade_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, (const float*)t, x, N, s, b, two_b, sigma, color,
          normal);
  }
  return (int)cudaGetLastError();
}

extern "C" int field_shade_bwd(const void* h, const void* t, const float* x,
                               int N, int bf16, int act, const float* light,
                               int per_ray, const float* ratio_p, float ratio,
                               const int64_t* id_p, int id, float density,
                               float denom, float two_b, const float* g_sigma,
                               const float* g_color, const float* g_normal,
                               void* g_h, void* g_t, void* stream) {
  const Blob b{act, density, denom};
  const Shading s = make_shading(light, per_ray, ratio_p, ratio, id_p, id);
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_shade_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, (const __nv_bfloat16*)t, x, N, s, b, two_b,
          g_sigma, g_color, g_normal, (__nv_bfloat16*)g_h,
          (__nv_bfloat16*)g_t);
    else
      field_shade_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, (const float*)t, x, N, s, b, two_b, g_sigma,
          g_color, g_normal, (float*)g_h, (float*)g_t);
  }
  return (int)cudaGetLastError();
}

extern "C" int field_select_fwd(const void* h, const float* normal,
                                const float* x, int N, int bf16, int act,
                                const float* light, int per_ray,
                                const float* ratio_p, float ratio,
                                const int64_t* id_p, int id, float density,
                                float denom, float* sigma, float* color,
                                void* stream) {
  const Blob b{act, density, denom};
  const Shading s = make_shading(light, per_ray, ratio_p, ratio, id_p, id);
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_select_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, normal, x, N, s, b, sigma, color);
    else
      field_select_fwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, normal, x, N, s, b, sigma, color);
  }
  return (int)cudaGetLastError();
}

extern "C" int field_select_bwd(const void* h, const float* normal,
                                const float* x, int N, int bf16, int act,
                                const float* light, int per_ray,
                                const float* ratio_p, float ratio,
                                const int64_t* id_p, int id, float density,
                                float denom, const float* g_sigma,
                                const float* g_color, void* g_h,
                                float* g_normal, void* stream) {
  const Blob b{act, density, denom};
  const Shading s = make_shading(light, per_ray, ratio_p, ratio, id_p, id);
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (bf16)
      field_select_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const __nv_bfloat16*)h, normal, x, N, s, b, g_sigma, g_color,
          (__nv_bfloat16*)g_h, g_normal);
    else
      field_select_bwd_kernel<<<blocks(N), kThreads, 0, st>>>(
          (const float*)h, normal, x, N, s, b, g_sigma, g_color, (float*)g_h,
          g_normal);
  }
  return (int)cudaGetLastError();
}
