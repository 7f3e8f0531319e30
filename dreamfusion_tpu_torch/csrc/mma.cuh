// Tensor-core building blocks shared by conv.cu (K12) and attention.cu (K10):
// cp.async copies into shared memory, ldmatrix fragment loads and the
// m16n8k16 bf16 mma.sync with fp32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16):
//   A (16x16, row-major): a0 = (row g, k 2q..2q+1), a1 = (row g+8, same k),
//                         a2 = (row g, k 8+2q..), a3 = (row g+8, k 8+2q..)
//   B (16x8, "col"):      b0 = (k 2q..2q+1, col g), b1 = (k 8+2q.., col g)
//   C (16x8 fp32):        c0,c1 = (row g, col 2q, 2q+1), c2,c3 = row g+8
// with g = lane / 4 and q = lane % 4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dft {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when `pred` is false the 16 bytes are zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

// 4-byte async copy (through L1: .cg takes 16 bytes only), zero-filled
// when `pred` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8x8 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16x16 tile stored row-major (k contiguous) with a row
// stride of `ld` elements.
__device__ __forceinline__ void load_a_frag(uint32_t* a,
                                            const __nv_bfloat16* tile, int ld,
                                            int lane) {
  ldsm_x4(a, tile + (lane % 16) * ld + (lane / 16) * 8);
}

// The same A fragment from a tile stored as [k][m] (m contiguous).
__device__ __forceinline__ void load_a_frag_km(uint32_t* a,
                                               const __nv_bfloat16* tile,
                                               int ld, int lane) {
  ldsm_x4_trans(a, tile + ((lane % 8) + (lane / 16) * 8) * ld +
                       ((lane / 8) % 2) * 8);
}

// B fragments of two adjacent n8 tiles (16 columns) x k16 from a tile stored
// as [n][k] (k contiguous): b[0..1] for columns 0-7, b[2..3] for 8-15.
__device__ __forceinline__ void load_b_frag_nk(uint32_t* b,
                                               const __nv_bfloat16* tile,
                                               int ld, int lane) {
  ldsm_x4(b, tile + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8);
}

// One n8 tile x k16 from a tile stored as [n][k].
__device__ __forceinline__ void load_b_frag_nk_x2(uint32_t* b,
                                                  const __nv_bfloat16* tile,
                                                  int ld, int lane) {
  ldsm_x2(b, tile + (lane % 8) * ld + ((lane / 8) % 2) * 8);
}

// The same from a tile stored as [k][n] (n contiguous).
__device__ __forceinline__ void load_b_frag_kn(uint32_t* b,
                                               const __nv_bfloat16* tile,
                                               int ld, int lane) {
  ldsm_x4_trans(b, tile + ((lane % 8) + ((lane / 8) % 2) * 8) * ld +
                       (lane / 16) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace dft
