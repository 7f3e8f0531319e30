// K5: the backward of the gradient clamp (--grad_clip_rgb).
//
// Replaces dreamfusion_tpu/core/math.py::clip_grad (:39; its custom_vjp's
// backward, :45-55, is jnp.clip of the cotangent entering the rendered
// rgb).  out = clamp(g, -limit, limit) elementwise with jnp.clip's rules:
// NaN stays NaN, and a limit of 0 gives zeros; fp32 or bf16 in and out,
// clamped in fp32 (exact for both) and rounded back to the input's type.
//
// Bound on the card: bytes and, at the image path's sizes (48 KB to 3 MB),
// the launch.  One pass with no reuse, so shared memory, tensor cores and
// TMA have nothing to offer: 16-byte loads and stores (4 fp32 or 8 bf16 a
// thread), a scalar tail for the last n % vec values.  It is launched
// through ctypes like every CUDA kernel of the port, so its host cost is a
// C call, not a Python launcher's (the Triton kernel it replaces lost to
// torch.clamp on that alone).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clip(float x, float limit) {
  const float c = fminf(fmaxf(x, -limit), limit);
  return x != x ? x : c;          // fminf/fmaxf drop a NaN: keep it
}

__global__ void clip_f32_kernel(const float* __restrict__ g,
                                float* __restrict__ out, int64_t n,
                                float limit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t vecs = n / 4;
  if (i < vecs) {
    float4 v = reinterpret_cast<const float4*>(g)[i];
    v.x = clip(v.x, limit);
    v.y = clip(v.y, limit);
    v.z = clip(v.z, limit);
    v.w = clip(v.w, limit);
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (i - vecs < n - vecs * 4) {
    const int64_t j = vecs * 4 + (i - vecs);
    out[j] = clip(g[j], limit);
  }
}

__global__ void clip_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                 __nv_bfloat16* __restrict__ out, int64_t n,
                                 float limit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t vecs = n / 8;
  if (i < vecs) {
    uint4 v = reinterpret_cast<const uint4*>(g)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      h[k] = __floats2bfloat162_rn(clip(f.x, limit), clip(f.y, limit));
    }
    reinterpret_cast<uint4*>(out)[i] = v;
  } else if (i - vecs < n - vecs * 8) {
    const int64_t j = vecs * 8 + (i - vecs);
    out[j] = __float2bfloat16_rn(clip(__bfloat162float(g[j]), limit));
  }
}

}  // namespace

// out[n] = clamp(g[n], -limit, limit); g and out fp32 (is_bf16 = 0) or
// bf16, 16-byte aligned.  One thread per 16 bytes, then one per value of
// the tail.
extern "C" int clip_grad_bwd(const void* g, void* out, int64_t n, float limit,
                             int is_bf16, cudaStream_t stream) {
  if (n < 0 || !(limit >= 0.f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int vec = is_bf16 ? 8 : 4;
  const int64_t threads = n / vec + n % vec;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (is_bf16)
    clip_bf16_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(out),
        n, limit);
  else
    clip_f32_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(g), static_cast<float*>(out), n, limit);
  return (int)cudaGetLastError();
}
