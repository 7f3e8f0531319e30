// K10: softmax(q k^T * scale) v with fp32 statistics, forward and backward.
//
// Replaces dreamfusion_tpu/ops/attention.py (chunked_attention :27, an
// online-softmax lax.scan over KV chunks, and dense_attention :72, einsums
// with an fp32 softmax; `attention` :88 picks one by the logits' size).
// Layout as in JAX: q [B, N, h, d], k and v [B, M, h, d], bf16; out
// [B, N, h, d] bf16 and the log-sum-exp [B, h, N] fp32 for the backward.
//
// Bound on the card: operations for the UNet's self-attention (N = M = 4096,
// d = 64: 2*2*N*M*d*B*h = 43 GFLOP against 21 MB of q, k, v, o) and the VAE
// mid-block (d = 512); memory only for the 77-token cross-attention.  So the
// forward is flash-style: nothing of size N x M touches device memory.  A
// block takes BR query rows of one (b, h) and walks the KV tiles of BC rows,
// with the running max, sum and correction in fp32 and P rounded to bf16
// before P V as in the JAX versions; KV rows past M (M = 77) are zero-filled
// and their logits set to -inf.  Two layouts:
//  - d = 64 (the UNet; attention_fwd_wgmma): FlashAttention-3's on Hopper.
//    The FlashAttention-2 layout on mma.sync it replaces ran at ~150
//    TFLOP/s, half of SDPA's, waiting on cp.async and __syncthreads before
//    every KV tile.  Here Q, K and V come by TMA from 4-D maps over
//    [B, tokens, h, 64] (d = 64 bf16 is one 128-byte swizzled row; rows
//    past N or M are zero-filled), K and V through a 3-stage ring with
//    full/empty mbarriers fed by one producer thread.  BR = BC = 128: two
//    consumer warpgroups (setmaxnreg gives them the producer's registers)
//    each own 64 query rows: S = Q K^T by wgmma m64n128k16 from shared
//    memory, the online softmax on the accumulator fragments in fp32
//    (base-2, the scale folded into one FFMA), P rounded to bf16 in
//    registers as wgmma's register A operand for O += P V (m64n64k16, V
//    read as a transposed, MN-major B operand).  At d = 64 the softmax's
//    exponentials cost as much as the products, so they overlap: the two
//    warpgroups take turns to issue products (pingpong), and each issues
//    the next tile's S with this tile's P V before its next softmax.
//  - d = 512 (the VAE mid-block): a warp's 16 rows x 512 fp32 accumulator
//    would take 256 registers a thread, so the warps split instead: the BC
//    columns for S (which goes through shared memory for the softmax, one
//    group of threads per row) and d for P V, keeping the accumulator at
//    64 registers (BR = 32, 8 warps, ~176 KB of dynamic shared memory).
//
// Backward (the VAE mid-block, d = 512, N = M = 4096): D = rowsum(dO o O);
// a scores kernel recomputes S and dP = dO V^T tile by tile on mma.sync,
// forms P = exp(S - lse) and dS = P o (dP - D) in fp32 and stores P^T and
// dS^T in bf16 (2 x 33.5 MB at the VAE's shape); three GEMMs on mma.sync
// then give dV = P^T dO, dK = scale * dS^T Q and dQ = scale * dS K, the last
// reading dS^T through transposed fragment loads.  Materialising P and dS
// costs ~0.13 GB of traffic (~40 us at 3.35 TB/s) against 86 GFLOP of
// products, and keeps each kernel a plain tiled GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dft::cp_async16;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, int BR, int BC, int NW>
struct FwdCfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int LDH = D + 8;    // Q, K, V row stride (bf16)
  static constexpr int LDS = BC + 4;   // S row stride (fp32)
  static constexpr int LDP = BC + 8;   // P row stride (bf16)
  static constexpr int CW = BC / NW;   // S columns per warp
  static constexpr int DW = D / NW;    // output columns per warp
  static constexpr int TPR = kThreads / BR;   // softmax threads per row
  static constexpr size_t kSmem =
      sizeof(bf16) * ((size_t)BR * LDH + 2 * (size_t)BC * LDH +
                      (size_t)BR * LDP) +
      sizeof(float) * ((size_t)BR * LDS + 3 * BR);
  static_assert(CW % 8 == 0 && (CW == 8 || CW % 16 == 0), "S split");
  static_assert(DW % 16 == 0, "d split");
  static_assert(BR % 16 == 0 && BC % 16 == 0, "tiles");
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "rows");
};

template <int D, int BR, int BC, int NW>
__global__ void __launch_bounds__(NW * 32)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int B, int N, int M, int H,
                float scale) {
  using C = FwdCfg<D, BR, BC, NW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BR * C::LDH;
  bf16* sV = sK + BC * C::LDH;
  bf16* sP = sV + BC * C::LDH;
  float* sS = reinterpret_cast<float*>(sP + BR * C::LDP);
  float* sM = sS + BR * C::LDS;
  float* sL = sM + BR;
  float* sCorr = sL + BR;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int z = blockIdx.y, b = z / H, hh = z % H;
  const int i0 = blockIdx.x * BR;
  const int64_t rs = (int64_t)H * D;   // token stride
  const bf16* qb = q + ((int64_t)b * N * H + hh) * D;
  const bf16* kb = k + ((int64_t)b * M * H + hh) * D;
  const bf16* vb = v + ((int64_t)b * M * H + hh) * D;

  constexpr int VPR = D / 8;   // 16-byte vectors per row
  for (int e = tid; e < BR * VPR; e += C::kThreads) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const bool ok = i0 + r < N;
    cp_async16(sQ + r * C::LDH + c, ok ? qb + (i0 + r) * rs + c : qb, ok);
  }
  for (int r = tid; r < BR; r += C::kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  constexpr int MT = BR / 16;        // m16 tiles (all rows, every warp)
  constexpr int NT_S = C::CW / 8;    // n8 tiles of S per warp
  constexpr int NT_O = C::DW / 8;    // n8 tiles of O per warp
  float oacc[MT][NT_O][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT_O; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[a][c][e] = 0.f;

  const int n_tiles = (M + BC - 1) / BC;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * BC;
    for (int e = tid; e < BC * VPR; e += C::kThreads) {
      const int r = e / VPR, c = (e % VPR) * 8;
      const bool ok = j0 + r < M;
      cp_async16(sK + r * C::LDH + c, ok ? kb + (j0 + r) * rs + c : kb, ok);
      cp_async16(sV + r * C::LDH + c, ok ? vb + (j0 + r) * rs + c : vb, ok);
    }
    dft::cp_async_commit();
    dft::cp_async_wait<0>();
    __syncthreads();

    // ---- S = Q K^T for this warp's CW columns ----
    float sacc[MT][NT_S][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < NT_S; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[a][c][e] = 0.f;
    const int col0 = warp * C::CW;
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
        dft::load_a_frag(af[a], sQ + a * 16 * C::LDH + ks * 16, C::LDH, lane);
      if constexpr (NT_S == 1) {
        uint32_t bfr[2];
        dft::load_b_frag_nk_x2(bfr, sK + col0 * C::LDH + ks * 16, C::LDH,
                               lane);
#pragma unroll
        for (int a = 0; a < MT; ++a) dft::mma_bf16(sacc[a][0], af[a], bfr);
      } else {
#pragma unroll
        for (int c = 0; c < NT_S; c += 2) {
          uint32_t bfr[4];
          dft::load_b_frag_nk(bfr, sK + (col0 + c * 8) * C::LDH + ks * 16,
                              C::LDH, lane);
#pragma unroll
          for (int a = 0; a < MT; ++a) {
            dft::mma_bf16(sacc[a][c], af[a], bfr);
            dft::mma_bf16(sacc[a][c + 1], af[a], bfr + 2);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < NT_S; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = a * 16 + g + 8 * (e / 2);
          const int col = col0 + c * 8 + 2 * qd + (e % 2);
          sS[r * C::LDS + col] =
              j0 + col < M ? sacc[a][c][e] * scale : -INFINITY;
        }
    __syncthreads();

    // ---- online softmax, TPR threads per row ----
    {
      const int r = tid / C::TPR, part = tid % C::TPR;
      constexpr int CPT = BC / C::TPR;
      const float* srow = sS + r * C::LDS + part * CPT;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      bf16* prow = sP + r * C::LDP + part * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = __expf(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float corr = __expf(m_old - m_new);
        sCorr[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // ---- O = O * corr + P V for this warp's DW columns ----
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      const float c0 = sCorr[a * 16 + g], c1 = sCorr[a * 16 + g + 8];
#pragma unroll
      for (int c = 0; c < NT_O; ++c) {
        oacc[a][c][0] *= c0;
        oacc[a][c][1] *= c0;
        oacc[a][c][2] *= c1;
        oacc[a][c][3] *= c1;
      }
    }
    const int d0 = warp * C::DW;
#pragma unroll
    for (int ks = 0; ks < BC / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
        dft::load_a_frag(af[a], sP + a * 16 * C::LDP + ks * 16, C::LDP, lane);
#pragma unroll
      for (int c = 0; c < NT_O; c += 2) {
        uint32_t bfr[4];
        dft::load_b_frag_kn(bfr, sV + ks * 16 * C::LDH + d0 + c * 8, C::LDH,
                            lane);
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          dft::mma_bf16(oacc[a][c], af[a], bfr);
          dft::mma_bf16(oacc[a][c + 1], af[a], bfr + 2);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: O / l, log-sum-exp ----
  const int d0 = warp * C::DW;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = a * 16 + g + 8 * h2;
      if (i0 + r >= N) continue;
      const float inv = 1.f / sL[r];
      bf16* orow = o + (((int64_t)b * N + i0 + r) * H + hh) * D + d0;
#pragma unroll
      for (int c = 0; c < NT_O; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + 2 * qd) =
            __floats2bfloat162_rn(oacc[a][c][2 * h2] * inv,
                                  oacc[a][c][2 * h2 + 1] * inv);
      }
    }
  }
  for (int r = tid; r < BR; r += C::kThreads)
    if (i0 + r < N) lse[(int64_t)z * N + i0 + r] = sM[r] + logf(sL[r]);
}

template <int D, int BR, int BC, int NW>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
               float* lse, int B, int N, int M, int H, float scale,
               cudaStream_t stream) {
  using C = FwdCfg<D, BR, BC, NW>;
  auto kern = attn_fwd_kernel<D, BR, BC, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BR - 1) / BR, B * H);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(q, k, v, o, lse, B, N, M, H,
                                                scale);
  return (int)cudaGetLastError();
}

// d = 64 (every UNet attention): FlashAttention-3's layout on wgmma (see the
// note above).
namespace fa {
constexpr int BR = 128, BC = 128, D = 64, STAGES = 3, kThreads = 384;
constexpr int TILE = 128 * D * 2;              // Q, K or V tile: 16 KB
constexpr size_t kSmem = 1024 + (size_t)(1 + 2 * STAGES) * TILE +
                         (1 + 2 * STAGES) * sizeof(uint64_t);
}  // namespace fa

__global__ void __launch_bounds__(fa::kThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      bf16* __restrict__ o, float* __restrict__ lse, int N,
                      int M, int H, float scale) {
  using namespace fa;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = sQ + BR * D;                  // [STAGES][BC][D]
  bf16* sV = sK + STAGES * BC * D;         // [STAGES][BC][D]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * BC * D);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    hop::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);   // every consumer thread arrives
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int z = blockIdx.y, b = z / H, hh = z % H;
  const int i0 = blockIdx.x * BR;
  const int n_tiles = (M + BC - 1) / BC;

  if (grp == 0) {
    // ---- producer: Q once, then K and V tiles through the ring ----
    hop::regs_dec<40>();
    if (tid == 0) {
      hop::mbar_expect_tx(qbar, TILE);
      hop::tma_load_4d(sQ, &qmap, qbar, 0, hh, i0, b);
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int s = jt % STAGES;
        hop::mbar_wait(&empty[s], ((jt / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], 2 * TILE);
        hop::tma_load_4d(sK + s * BC * D, &kmap, &full[s], 0, hh, jt * BC, b);
        hop::tma_load_4d(sV + s * BC * D, &vmap, &full[s], 0, hh, jt * BC, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows 64cw..64cw+63 ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2, FlashAttention-3's pingpong), so that one's softmax runs while
  // the tensor cores work on the other's products; warpgroup 0 goes first.
  auto my_turn = [&]() { hop::bar_sync(1 + cw, 256); };
  auto pass_turn = [&]() { hop::bar_arrive(2 - cw, 256); };
  if (cw == 1) pass_turn();
  hop::mbar_wait(qbar, 0);
  const uint64_t dq = hop::desc_sw128(sQ + cw * 64 * D);
  // logits in log2 units: exp(s * scale - m) = 2^(s * sl2 - m * log2 e)
  const float sl2 = scale * 1.4426950408889634f;

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float sc[64];              // S of the tile being softmaxed
  uint32_t pa[8][4], pb[8][4];   // P, double-buffered: one is in flight
  uint64_t dqs[D / 16];      // Q's descriptor per k16 step
#pragma unroll
  for (int k = 0; k < D / 16; ++k) dqs[k] = dq + 2 * k;   // +32 bytes

  // Every descriptor of a stage is formed before the stage opens, and the
  // accumulators are zeroed and fenced there: nothing but wgmmas runs
  // between a stage's wgmma.fence and its wait (ptxas would serialize).
  // S of tile jt: Q K^T (64 x 128 per warpgroup) into sc.
  auto s_descs = [&](int jt, uint64_t* d) {
    const uint64_t dk = hop::desc_sw128(sK + (jt % STAGES) * BC * D);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) d[k] = dk + 2 * k;
  };
  auto mma_s = [&](const uint64_t* d) {
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hop::wgmma_m64n128k16_ss(sc, dqs[k], d[k]);
    hop::wgmma_commit();
  };
  // P V of tile jt into oacc: V [keys][d] is the transposed (MN-major) B
  // operand, 16 keys (2048 bytes) per k16 step.
  auto v_descs = [&](int jt, uint64_t* d) {
    const bf16* tV = sV + (jt % STAGES) * BC * D;
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      d[kk] = hop::desc_sw128(tV + kk * 16 * D);
  };
  auto mma_pv = [&](const uint64_t* d, uint32_t (&p)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      hop::wgmma_m64n64k16_rs_tb(oacc, p[kk], d[kk]);
    hop::wgmma_commit();
  };
  auto zero_s = [&](int jt) {
    hop::mbar_wait(&full[jt % STAGES], (jt / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    hop::fence_regs<64>(sc);
  };
  // online softmax of tile jt's S on rows g (e = 0, 1) and g + 8 (e = 2, 3)
  // of the warp's 16 (a row's 128 values over the 4 lanes of a quad):
  // the new maxima, the correction of the old sums into corr, P into pn
  auto softmax = [&](int jt, float* corr, uint32_t (*pn)[4]) {
    const int j0 = jt * BC;
    if (j0 + BC > M) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * j + 2 * qd + (e % 2) >= M) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    float msc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * sl2);   // scale > 0
      corr[r] = hop::exp2_approx(m_r[r] - m_new);
      m_r[r] = m_new;
      msc[r] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = hop::exp2_approx(fmaf(sc[4 * j + e], sl2, msc[e / 2]));
        rsum[e / 2] += pv[e];
      }
      pn[j / 2][(j % 2) * 2] = dft::pack_bf16(pv[0], pv[1]);
      pn[j / 2][(j % 2) * 2 + 1] = dft::pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_r[r] = l_r[r] * corr[r] + rsum[r];
    }
  };
  auto rescale = [&](const float* corr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[4 * j] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
  };

  // Tile 0, then per tile: S of the next tile and P V of this one go to the
  // tensor cores together, and the next softmax runs while they work.  P
  // alternates between two buffers (the loop is unrolled by two) and the
  // last tile is peeled off, so that neither a copy nor a branch makes the
  // compiler touch the registers of a wgmma in flight.
  float corr[2];
  uint64_t ds[D / 16], dv[BC / 16];
  s_descs(0, ds);
  zero_s(0);
  my_turn();
  hop::wgmma_fence();
  mma_s(ds);
  pass_turn();
  hop::wgmma_wait<0>();
  hop::fence_regs<64>(sc);
  softmax(0, corr, pa);
  auto step = [&](int jt, uint32_t (&pc)[8][4], uint32_t (&pn)[8][4]) {
    s_descs(jt + 1, ds);
    v_descs(jt, dv);
    zero_s(jt + 1);
    hop::fence_regs<32>(oacc);
    hop::fence_regs<32>(&pc[0][0]);
    my_turn();
    hop::wgmma_fence();
    mma_s(ds);
    mma_pv(dv, pc);
    pass_turn();
    hop::wgmma_wait<1>();            // S of tile jt + 1 (P V still running)
    hop::fence_regs<64>(sc);
    softmax(jt + 1, corr, pn);
    hop::wgmma_wait<0>();            // P V of tile jt: its stage is free
    hop::fence_regs<32>(oacc);
    hop::fence_regs<32>(&pc[0][0]);
    hop::mbar_arrive(&empty[jt % STAGES]);
    rescale(corr);
  };
  auto last = [&](uint32_t (&pc)[8][4]) {
    v_descs(n_tiles - 1, dv);
    hop::fence_regs<32>(oacc);
    hop::fence_regs<32>(&pc[0][0]);
    my_turn();
    hop::wgmma_fence();
    mma_pv(dv, pc);
    pass_turn();
    hop::wgmma_wait<0>();
    hop::fence_regs<32>(oacc);
    hop::mbar_arrive(&empty[(n_tiles - 1) % STAGES]);
  };
  int jt = 0;
  for (; jt + 2 < n_tiles; jt += 2) {
    step(jt, pa, pb);
    step(jt + 1, pb, pa);
  }
  if (jt + 1 < n_tiles) {
    step(jt, pa, pb);
    last(pb);
  } else {
    last(pa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + cw * 64 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l_r[r];
    bf16* orow = o + (((int64_t)b * N + row) * H + hh) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * qd) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv,
                                oacc[4 * j + 2 * r + 1] * inv);
    if (qd == 0)
      lse[(int64_t)z * N + row] = m_r[r] * 0.6931471805599453f + logf(l_r[r]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Dv[z, i] = sum_c dO[b, i, h, c] * O[b, i, h, c]; one warp per row.
__global__ void attn_bwd_dot_kernel(const bf16* __restrict__ dout,
                                    const bf16* __restrict__ out,
                                    float* __restrict__ dv, int B, int N,
                                    int H, int D) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * H * N) return;
  const int i = row % N;
  const int64_t z = row / N;
  const int b = z / H, hh = z % H;
  const int64_t base = (((int64_t)b * N + i) * H + hh) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s += __bfloat162float(dout[base + c]) * __bfloat162float(out[base + c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dv[row] = s;
}

constexpr int SB = 64, SBK = 32, SLD = SBK + 8;

// One 64 x 64 (query, key) tile: S and dP on mma.sync over d, then
// P = exp(S*scale - lse) and dS = P (dP - Dv), stored as bf16 P^T and dS^T,
// both [z][Mp][Np] (zero past N and M).
__global__ void __launch_bounds__(128)
attn_bwd_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec, bf16* __restrict__ pT,
                       bf16* __restrict__ dsT, int B, int N, int M, int H,
                       int D, int Np, int Mp, float scale) {
  __shared__ __align__(16) bf16 sQ[SB * SLD], sK[SB * SLD], sO[SB * SLD],
      sV[SB * SLD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int z = blockIdx.z, b = z / H, hh = z % H;
  const int i0 = blockIdx.x * SB, j0 = blockIdx.y * SB;
  const int64_t rs = (int64_t)H * D;
  const bf16* qb = q + ((int64_t)b * N * H + hh) * D;
  const bf16* ob = dout + ((int64_t)b * N * H + hh) * D;
  const bf16* kb = k + ((int64_t)b * M * H + hh) * D;
  const bf16* vb = v + ((int64_t)b * M * H + hh) * D;
  const int wm = warp / 2, wn = warp % 2;   // 2 x 2 warps, 32 x 32 each

  float sacc[2][4][4], pacc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[a][c][e] = pacc[a][c][e] = 0.f;

  for (int kc = 0; kc < D; kc += SBK) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int e = tid + 128 * t;
      const int r = e / 4, c = (e % 4) * 8;
      const bool kok = kc + c < D;
      const bool iok = kok && i0 + r < N, jok = kok && j0 + r < M;
      cp_async16(sQ + r * SLD + c, iok ? qb + (i0 + r) * rs + kc + c : qb,
                 iok);
      cp_async16(sO + r * SLD + c, iok ? ob + (i0 + r) * rs + kc + c : ob,
                 iok);
      cp_async16(sK + r * SLD + c, jok ? kb + (j0 + r) * rs + kc + c : kb,
                 jok);
      cp_async16(sV + r * SLD + c, jok ? vb + (j0 + r) * rs + kc + c : vb,
                 jok);
    }
    dft::cp_async_commit();
    dft::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < SBK / 16; ++ks) {
      uint32_t aq[2][4], ao[2][4], bk[2][4], bv[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        dft::load_a_frag(aq[a], sQ + (wm * 32 + a * 16) * SLD + ks * 16, SLD,
                         lane);
        dft::load_a_frag(ao[a], sO + (wm * 32 + a * 16) * SLD + ks * 16, SLD,
                         lane);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dft::load_b_frag_nk(bk[c], sK + (wn * 32 + c * 16) * SLD + ks * 16,
                            SLD, lane);
        dft::load_b_frag_nk(bv[c], sV + (wn * 32 + c * 16) * SLD + ks * 16,
                            SLD, lane);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dft::mma_bf16(sacc[a][c], aq[a], &bk[c / 2][(c % 2) * 2]);
          dft::mma_bf16(pacc[a][c], ao[a], &bv[c / 2][(c % 2) * 2]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wm * 32 + a * 16 + g + 8 * (e / 2);
      if (i >= Np) continue;
      const bool iok = i < N;
      const float l = iok ? lse[(int64_t)z * N + i] : 0.f;
      const float dd = iok ? dvec[(int64_t)z * N + i] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + wn * 32 + c * 8 + 2 * qd + (e % 2);
        if (j >= Mp) continue;
        float p = 0.f, dsv = 0.f;
        if (iok && j < M) {
          p = __expf(sacc[a][c][e] * scale - l);
          dsv = p * (pacc[a][c][e] - dd);
        }
        const int64_t t_idx = ((int64_t)z * Mp + j) * Np + i;
        pT[t_idx] = __float2bfloat16(p);
        dsT[t_idx] = __float2bfloat16(dsv);
      }
    }
}

constexpr int GB = 64, GK = 32, GLA = GK + 8, GLB = GB + 8, GLT = GB + 8;

// out[b, m, h, :] = alpha * sum_k A[z, m, k] * Bm[b, k, h, :] for m < Mrows;
// A is [z][Arows][Kp] (zero past the true K), or with A_KM its transpose
// [z][Kp][Arows] (zero past Mrows); Bm holds Krows tokens of width D.
template <bool A_KM>
__global__ void __launch_bounds__(128)
attn_bwd_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                     bf16* __restrict__ out, int H, int D, int Mrows,
                     int Arows, int Kp, int Krows, float alpha) {
  // a stage holds 64 m x 32 k ([m][k]) or 32 k x 64 m ([k][m])
  __shared__ __align__(16) bf16 sA[2][GB * GLA > GK * GLT ? GB * GLA
                                                           : GK * GLT];
  __shared__ __align__(16) bf16 sB[2][GK * GLB];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int z = blockIdx.z, b = z / H, hh = z % H;
  const int m0 = blockIdx.x * GB, n0 = blockIdx.y * GB;
  const int64_t rs = (int64_t)H * D;
  const bf16* ab = A + (int64_t)z * Arows * Kp;
  const bf16* bb = Bm + ((int64_t)b * Krows * H + hh) * D;
  const int wm = warp / 2, wn = warp % 2;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * GK;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int e = tid + 128 * t;
      if constexpr (A_KM) {
        const int kr = e / 8, mc = (e % 8) * 8;   // A^T: 32 rows x 64
        const bool aok = k0 + kr < Kp && m0 + mc < Arows;
        cp_async16(&sA[stage][kr * GLT + mc],
                   aok ? ab + (int64_t)(k0 + kr) * Arows + m0 + mc : ab, aok);
      } else {
        const int r = e / 4, c = (e % 4) * 8;     // A: 64 rows x 32
        const bool aok = m0 + r < Mrows && k0 + c < Kp;
        cp_async16(&sA[stage][r * GLA + c],
                   aok ? ab + (int64_t)(m0 + r) * Kp + k0 + c : ab, aok);
      }
      const int kr = e / 8, nc = (e % 8) * 8;     // B: 32 rows x 64
      const bool bok = k0 + kr < Krows && n0 + nc < D;
      cp_async16(&sB[stage][kr * GLB + nc],
                 bok ? bb + (k0 + kr) * rs + n0 + nc : bb, bok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;

  const int KT = (Kp + GK - 1) / GK;
  load(0, 0);
  dft::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) & 1, kt + 1);
    dft::cp_async_commit();
    dft::cp_async_wait<1>();
    __syncthreads();
    const bf16* tA = sA[kt & 1];
    const bf16* tB = sB[kt & 1];
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if constexpr (A_KM)
          dft::load_a_frag_km(af[a], tA + ks * 16 * GLT + wm * 32 + a * 16,
                              GLT, lane);
        else
          dft::load_a_frag(af[a], tA + (wm * 32 + a * 16) * GLA + ks * 16,
                           GLA, lane);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        dft::load_b_frag_kn(bfr[c], tB + ks * 16 * GLB + wn * 32 + c * 16,
                            GLB, lane);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dft::mma_bf16(acc[a][c], af[a], &bfr[c / 2][(c % 2) * 2]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = m0 + wm * 32 + a * 16 + g + 8 * h2;
      if (m >= Mrows) continue;
      bf16* orow = out + (((int64_t)b * Mrows + m) * H + hh) * D;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + wn * 32 + c * 8 + 2 * qd;
        if (n >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(
            alpha * acc[a][c][2 * h2], alpha * acc[a][c][2 * h2 + 1]);
      }
    }
}

}  // namespace

// o, lse = attention(q, k, v) at d = 512 (the split-d mma.sync kernel);
// all bf16 contiguous.
extern "C" int attention_fwd_mma(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int N, int M,
                                 int H, int D, float scale,
                                 cudaStream_t stream) {
  if (D != 512) return (int)cudaErrorInvalidValue;
  return launch_fwd<512, 32, 64, 8>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, N, M, H,
      scale, stream);
}

// The same at d = 64 on wgmma, q [B, N, h, 64], k and v [B, M, h, 64],
// each read through a TMA map over [B, tokens, h, 64].
extern "C" int attention_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int N, int M, int H, float scale,
                                   cudaStream_t stream) {
  using namespace fa;
  if (N == 0 || B * H == 0) return (int)cudaGetLastError();
  if (M == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t tokens = i == 0 ? N : M;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, tokens,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                   tokens * H * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)D, 1, 128, 1};
    if (!hop::encode_bf16_map(&maps[i], ptrs[i], 4, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(attn_fwd_wgmma_kernel, (int)kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BR - 1) / BR, B * H);
  attn_fwd_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, N, M, H, scale);
  return (int)cudaGetLastError();
}

// dq, dk, dv from q, k, v, o, do and lse; d % 8 == 0.  Scratch: dvec [B*H*N]
// fp32, pT and dsT [B*H][Mp][Np] bf16 (Np, Mp = N, M rounded up to 8).
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, void* dq, void* dk, void* dv,
                             float* dvec, void* pT, void* dsT, int B, int N,
                             int M, int H, int D, float scale,
                             cudaStream_t stream) {
  if (D % 8) return (int)cudaErrorInvalidValue;
  const int Np = (N + 7) / 8 * 8, Mp = (M + 7) / 8 * 8;
  const int Z = B * H;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* dO = static_cast<const bf16*>(dout);
  bf16* PT = static_cast<bf16*>(pT);
  bf16* DST = static_cast<bf16*>(dsT);

  const int64_t rows = (int64_t)Z * N;
  attn_bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      dO, static_cast<const bf16*>(o), dvec, B, N, H, D);
  dim3 sgrid((Np + SB - 1) / SB, (Mp + SB - 1) / SB, Z);
  attn_bwd_scores_kernel<<<sgrid, 128, 0, stream>>>(
      Q, K, V, dO, lse, dvec, PT, DST, B, N, M, H, D, Np, Mp, scale);
  dim3 gk((M + GB - 1) / GB, (D + GB - 1) / GB, Z);
  // dV = P^T dO and dK = scale * dS^T Q: [M, Np] x [N tokens, D]
  attn_bwd_gemm_kernel<false><<<gk, 128, 0, stream>>>(
      PT, dO, static_cast<bf16*>(dv), H, D, M, Mp, Np, N, 1.f);
  attn_bwd_gemm_kernel<false><<<gk, 128, 0, stream>>>(
      DST, Q, static_cast<bf16*>(dk), H, D, M, Mp, Np, N, scale);
  // dQ = scale * dS K: [N, Mp] x [M tokens, D], dS read from dS^T
  dim3 gq((N + GB - 1) / GB, (D + GB - 1) / GB, Z);
  attn_bwd_gemm_kernel<true><<<gq, 128, 0, stream>>>(
      DST, K, static_cast<bf16*>(dq), H, D, N, Np, Mp, M, scale);
  return (int)cudaGetLastError();
}
