// Pieces shared by the field encoders' kernels, K1 (csrc/triplane.cu) and K6
// (csrc/hashgrid.cu): row loads and stores as 16-byte (or 8-, 4-byte)
// vectors, cotangent reads in their own dtype (fp32 or bf16), and the
// backward's reduction into a table: the lanes of a warp that hit the same
// lattice cell in an unbroken run merge their contributions with shuffles,
// and the run's first lane adds the sum with vector reductions (sm_90's
// atomicAdd on float4 / float2 in global memory), skipping chunks that are
// exactly zero.
//
// The backwards lay a warp over 32 consecutive samples of one plane (K1) or
// level (K6), so the lanes that meet at a cell are neighbours: consecutive
// samples of a ray in the NeRF step, consecutive pixels of a row in the DMTet
// albedo query.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace field {

constexpr unsigned kFull = 0xffffffffu;

// N fp32 values from an address aligned to 4*N bytes (N = 1, 2 or 4k)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    static_assert(N == 1, "N is 1, 2 or a multiple of 4");
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// N cotangents from an address aligned to N * sizeof(element) bytes
template <int N>
__device__ __forceinline__ void load_cot(const float* p, float (&v)[N]) {
  load_f32<N>(p, v);
}
template <int N>
__device__ __forceinline__ void load_cot(const __nv_bfloat16* p,
                                         float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {       // little-endian: element 2j low
        v[8 * i + 2 * j] = bf16_lo(w[j]);
        v[8 * i + 2 * j + 1] = bf16_hi(w[j]);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(q.x);
    v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y);
    v[3] = bf16_hi(q.y);
  } else if constexpr (N == 2) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = bf16_lo(q);
    v[1] = bf16_hi(q);
  } else {
    static_assert(N == 1, "N is 1, 2, 4 or a multiple of 8");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int N>
__device__ __forceinline__ bool any_nonzero(const float (&v)[N]) {
  bool nz = false;
#pragma unroll
  for (int i = 0; i < N; ++i) nz |= v[i] != 0.f;
  return nz;
}

__device__ __forceinline__ unsigned out_bits(float v, float) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned out_bits(float v, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// N values to an address aligned to N * sizeof(T) bytes, in 16-, 8-, 4- or
// 2-byte stores
template <typename T, int N>
__device__ __forceinline__ void store_row(T* dst, const float (&v)[N]) {
  if constexpr (N * sizeof(T) < 4) {
    *dst = __float2bfloat16(v[0]);          // one bf16
  } else {
    constexpr int kWords = N * (int)sizeof(T) / 4;
    unsigned w[kWords];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int c = 0; c < N; ++c) w[c] = out_bits(v[c], T());
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i)     // little-endian: element 2i low
        w[i] = out_bits(v[2 * i], T()) | (out_bits(v[2 * i + 1], T()) << 16);
    }
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(dst)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      static_assert(kWords == 1, "a row of 2, 4, 8 or 16k bytes");
      *reinterpret_cast<unsigned*>(dst) = w[0];
    }
  }
}

// dst[0:N] += v, as float4 (or float2) reductions; a chunk that is exactly
// zero is skipped (the table starts at +0, so the sum is unchanged)
template <int N>
__device__ __forceinline__ void red_add(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                   v[4 * i + 3]);
      if (q.x != 0.f || q.y != 0.f || q.z != 0.f || q.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(dst) + i, q);
    }
  } else if constexpr (N == 2) {
    if (v[0] != 0.f || v[1] != 0.f)
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    static_assert(N == 1, "N is 1, 2 or a multiple of 4");
    if (v[0] != 0.f) atomicAdd(dst, v[0]);
  }
}

// The runs of a warp: lane i joins lane i-1's run when both are active and
// hold the same key.  `end` is one past the run's last lane; `merge` is
// false (for the whole warp) when every run is one lane long.
struct Run {
  int end;
  bool head;
  bool merge;
};

template <int K>
__device__ __forceinline__ Run lane_runs(const unsigned (&key)[K],
                                         bool active) {
  const unsigned lane = threadIdx.x & 31;
  bool same = __shfl_up_sync(kFull, (int)active, 1) != 0;
  same &= active && lane > 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
    same &= __shfl_up_sync(kFull, key[i], 1) == key[i];
  const unsigned heads = __ballot_sync(kFull, !same);
  const unsigned above = heads & ~((2u << lane) - 1u);   // heads after lane
  Run r;
  r.head = !same;
  r.end = above ? __ffs(above) - 1 : 32;
  r.merge = heads != kFull;
  return r;
}

// Segmented suffix sums over the runs: afterwards each run's head holds the
// sum of its lanes' v.  Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void merge_runs(float (&v)[N], const Run& r) {
  if (!r.merge) return;                     // the same in every lane
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int off = 1; off < 32; off <<= 1) {
    const bool more = lane + off < r.end;
    if (!__any_sync(kFull, more)) break;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = __shfl_down_sync(kFull, v[i], off);
      if (more) v[i] += t;
    }
  }
}

}  // namespace field
