// K10: softmax(q k^T * scale) v with fp32 statistics, forward and backward.
//
// Replaces dreamfusion_tpu/ops/attention.py (chunked_attention :27, an
// online-softmax lax.scan over KV chunks, and dense_attention :72, einsums
// with an fp32 softmax; `attention` :88 picks one by the logits' size),
// as the UNet's transformers and the VAE mid-block (models/vae.py:78) call
// it.
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
//  - d = 512 (the VAE mid-block; attention_fwd_wgmma_d512).  The mma.sync
//    layout it replaces ran at ~82 TFLOP/s (8% of peak): 32-row blocks, S
//    through shared memory.  Here a block owns BR = 64 query rows; its
//    O (64 x 512 fp32 = 128 KB) is split by columns over two consumer
//    warpgroups, 128 registers a thread each.  Both compute the same S =
//    Q K^T (64 x 64 keys, wgmma m64n64k16 over K = 512: the duplicate S
//    costs half again the products but no exchange of P or of row
//    statistics between warpgroups), run the online softmax in registers
//    as at d = 64, and each issues O[:, its 256] += P V with P as the
//    register A operand (m64n256k16, V MN-major: its 64-column chunks 8 KB
//    apart, the descriptor's leading byte offset).  Q (64 KB) stays; K
//    streams in 8 KB chunks (64 keys x 64 columns, one 128-byte swizzled
//    row each) through a 12-chunk ring, V a whole 64-key tile (64 KB) at a
//    time, both by TMA from the d = 64 maps' shape.  4096 queries are only
//    64 blocks for 132 SMs, so the KV range is split (kv_splits: 2 at the
//    VAE's shape) and attn_fwd_combine_kernel merges the splits' fp32
//    partial O and log-sum-exp in split order (deterministic, no atomics)
//    into o and lse.  Bound by the tiles' traffic out of L2 (64 query rows
//    per 128 KB of K and V) more than by the products.
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

// d = 512 (the VAE mid-block; see the note above).  Q, K and V come by TMA
// in chunks of 64 rows x 64 columns (8 KB, one 128-byte swizzled row a
// row) from the same 4-D maps as d = 64's.
namespace f5 {
constexpr int D = 512, BR = 64, BC = 64, CH = D / 64, kThreads = 384;
constexpr int CHUNK = 64 * 64 * 2;     // 64 rows x 64 columns
constexpr int KSLOTS = 12;             // the K ring, in chunks
constexpr size_t kSmem = 1024 + (size_t)(2 * CH + KSLOTS) * CHUNK +
                         (3 + 2 * KSLOTS) * sizeof(uint64_t);
}  // namespace f5

// Block (query tile, KV split) of (b, h): rows i0..i0+63, KV tiles
// [jt0, jt1).  With one split it writes o and lse; with more, the split's
// normalised O in fp32 and its log-sum-exp into ows / lws (row r of (b, h)
// = z at (split * Z + z) * N + r), which attn_fwd_combine_kernel merges.
__global__ void __launch_bounds__(f5::kThreads, 1)
attn_fwd_d512_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     bf16* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ ows, float* __restrict__ lws,
                     int N, int M, int H, int Z, int splits, float scale) {
  using namespace f5;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;                 // [CH][64 rows][64]
  unsigned char* sK = sQ + CH * CHUNK;      // [KSLOTS][64 keys][64]
  unsigned char* sV = sK + KSLOTS * CHUNK;  // [CH][64 keys][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + CH * CHUNK);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + KSLOTS;
  uint64_t* vfull = kempty + KSLOTS;
  uint64_t* vempty = vfull + 1;

  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    hop::mbar_init(qbar, 1);
    for (int s = 0; s < KSLOTS; ++s) {
      hop::mbar_init(&kfull[s], 1);
      hop::mbar_init(&kempty[s], 256);   // both warpgroups read every K chunk
    }
    hop::mbar_init(vfull, 1);
    hop::mbar_init(vempty, 256);
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int z = blockIdx.y, b = z / H, hh = z % H;
  const int split = blockIdx.x % splits;
  const int i0 = blockIdx.x / splits * BR;
  const int n_tiles = (M + BC - 1) / BC;
  const int jt0 = n_tiles * split / splits;
  const int jt1 = n_tiles * (split + 1) / splits;

  if (grp == 0) {
    // ---- producer: Q once, then per KV tile its 8 K chunks, then V ----
    hop::regs_dec<40>();
    if (tid == 0) {
      hop::mbar_expect_tx(qbar, CH * CHUNK);
      for (int c = 0; c < CH; ++c)
        hop::tma_load_4d(sQ + c * CHUNK, &qmap, qbar, 64 * c, hh, i0, b);
      int kit = 0;
      for (int jt = jt0, vt = 0; jt < jt1; ++jt, ++vt) {
        for (int c = 0; c < CH; ++c, ++kit) {
          const int s = kit % KSLOTS;
          hop::mbar_wait(&kempty[s], ((kit / KSLOTS) & 1) ^ 1);
          hop::mbar_expect_tx(&kfull[s], CHUNK);
          hop::tma_load_4d(sK + s * CHUNK, &kmap, &kfull[s], 64 * c, hh,
                           jt * BC, b);
        }
        hop::mbar_wait(vempty, (vt & 1) ^ 1);
        hop::mbar_expect_tx(vfull, CH * CHUNK);
        for (int c = 0; c < CH; ++c)
          hop::tma_load_4d(sV + c * CHUNK, &vmap, vfull, 64 * c, hh, jt * BC,
                           b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns output columns 256cw..256cw+255 ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  // logits in log2 units: exp(s * scale - m) = 2^(s * sl2 - m * log2 e)
  const float sl2 = scale * 1.4426950408889634f;
  float oacc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float sc[32];             // S of the tile: 64 rows x 64 keys
  uint32_t pf[4][4];        // P in bf16, wgmma's register A per k16 step
  // this warpgroup's half of V: chunks 4cw..4cw+3, 8 KB apart (LBO)
  const uint64_t dv = hop::desc_sw128(sV + 4 * cw * CHUNK, CHUNK);
  hop::mbar_wait(qbar, 0);

  int kit = 0;
  for (int jt = jt0, vt = 0; jt < jt1; ++jt, ++vt) {
    // ---- S = Q K^T (both warpgroups: all 64 rows), 8 chunks of K ----
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hop::fence_regs<32>(sc);
    int prev = -1;
#pragma unroll 1
    for (int c = 0; c < CH; ++c, ++kit) {
      const int s = kit % KSLOTS;
      const uint64_t dq = hop::desc_sw128(sQ + c * CHUNK);
      const uint64_t dk = hop::desc_sw128(sK + s * CHUNK);
      hop::mbar_wait(&kfull[s], (kit / KSLOTS) & 1);
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)      // +32 bytes per k16 step
        hop::wgmma_m64n64k16_ss(sc, dq + 2 * k, dk + 2 * k);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();            // the previous chunk's products
      if (prev >= 0) hop::mbar_arrive(&kempty[prev]);
      prev = s;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs<32>(sc);
    hop::mbar_arrive(&kempty[prev]);

    // ---- online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3) ----
    const int j0 = jt * BC;
    if (j0 + BC > M) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * j + 2 * qd + (e % 2) >= M) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, corr[2], msc[2];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
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
    for (int j = 0; j < 8; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = hop::exp2_approx(fmaf(sc[4 * j + e], sl2, msc[e / 2]));
        rsum[e / 2] += pv[e];
      }
      pf[j / 2][(j % 2) * 2] = dft::pack_bf16(pv[0], pv[1]);
      pf[j / 2][(j % 2) * 2 + 1] = dft::pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_r[r] = l_r[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      oacc[4 * j] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }

    // ---- O += P V on this warpgroup's 256 columns (V MN-major) ----
    hop::mbar_wait(vfull, vt & 1);
    hop::fence_regs<128>(oacc);
    hop::fence_regs<16>(&pf[0][0]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)     // +16 keys = +2048 bytes
      hop::wgmma_m64n256k16_rs_tb(oacc, pf[kk], dv + 128 * kk);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<128>(oacc);
    hop::fence_regs<16>(&pf[0][0]);
    hop::mbar_arrive(vempty);
  }

  // ---- epilogue: O / l and the log-sum-exp, or the split's partials ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l_r[r];
    const float lv = m_r[r] * 0.6931471805599453f + logf(l_r[r]);
    if (splits == 1) {
      bf16* orow = o + (((int64_t)b * N + row) * H + hh) * D + 256 * cw;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * qd) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv,
                                  oacc[4 * j + 2 * r + 1] * inv);
      if (cw == 0 && qd == 0) lse[(int64_t)z * N + row] = lv;
    } else {
      const int64_t prow = ((int64_t)split * Z + z) * N + row;
      float* orow = ows + prow * D + 256 * cw;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * qd) =
            make_float2(oacc[4 * j + 2 * r] * inv,
                        oacc[4 * j + 2 * r + 1] * inv);
      if (cw == 0 && qd == 0) lws[prow] = lv;
    }
  }
}

// Merges the KV splits of d = 512 in split order (no atomics): per row,
// lse = log sum_s exp(lse_s) and o = sum_s exp(lse_s - lse) o_s; one
// thread per 4 columns of a row.
__global__ void attn_fwd_combine_kernel(const float* __restrict__ ows,
                                        const float* __restrict__ lws,
                                        bf16* __restrict__ o,
                                        float* __restrict__ lse, int Z,
                                        int N, int H, int splits) {
  constexpr int D = f5::D;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t rows = (int64_t)Z * N;
  const int64_t R = idx / (D / 4);
  const int d0 = (int)(idx % (D / 4)) * 4;
  if (R >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, lws[s * rows + R]);
  float wsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = expf(lws[s * rows + R] - m);
    const float4 v =
        *reinterpret_cast<const float4*>(ows + (s * rows + R) * D + d0);
    wsum += w;
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  const float inv = 1.f / wsum;
  const int z = (int)(R / N), i = (int)(R % N), b = z / H, hh = z % H;
  bf16* out = o + (((int64_t)b * N + i) * H + hh) * D + d0;
  *reinterpret_cast<__nv_bfloat162*>(out) =
      __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(out + 2) =
      __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  if (d0 == 0) lse[R] = m + logf(wsum);
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

// The same at d = 512 on wgmma (the VAE mid-block), the KV range cut into
// `splits` (1 <= splits <= the KV tiles of 64): with splits > 1, ows fp32
// [splits * B*h*N * 512] and lws fp32 [splits * B*h*N] hold the partials.
extern "C" int attention_fwd_wgmma_d512(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int N, int M, int H,
                                        int splits, float* ows, float* lws,
                                        float scale, cudaStream_t stream) {
  using namespace f5;
  if (N == 0 || B * H == 0) return (int)cudaGetLastError();
  const int n_tiles = (M + BC - 1) / BC;
  if (M == 0 || splits < 1 || splits > n_tiles ||
      (splits > 1 && (ows == nullptr || lws == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t tokens = i == 0 ? N : M;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, tokens,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                   tokens * H * D * 2};
    const cuuint32_t box[4] = {64, 1, 64, 1};
    if (!hop::encode_bf16_map(&maps[i], ptrs[i], 4, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(attn_fwd_d512_kernel, (int)kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int Z = B * H;
  dim3 grid((N + BR - 1) / BR * splits, Z);
  attn_fwd_d512_kernel<<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, ows, lws, N, M,
      H, Z, splits, scale);
  if (splits > 1) {
    const int64_t threads = (int64_t)Z * N * (D / 4);
    attn_fwd_combine_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                              stream>>>(ows, lws, static_cast<bf16*>(o), lse,
                                        Z, N, H, splits);
  }
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
