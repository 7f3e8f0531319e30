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
// mid-block (d = 512); the softmax's exponentials (B*h*N*M of them, 16 per
// SM per clock) for SD 1.5's d = 40 (268M: >= 0.069 ms against the
// products' 0.043); memory only for the 77-token cross-attention.  So the
// forward is flash-style: nothing of size N x M touches device memory.  A
// block takes BR query rows of one (b, h) and walks the KV tiles of BC rows,
// with the running max, sum and correction in fp32 and P rounded to bf16
// before P V as in the JAX versions; KV rows past M (M = 77) are zero-filled
// and their logits set to -inf.  Two layouts:
//  - the UNet's head dims, d = 64 (SD 2.x; attention_fwd_wgmma) and 40, 80,
//    160 (SD 1.x's 8 heads over 320, 640 and 1280 channels;
//    attention_fwd_wgmma_d40, _d80, _d160): FlashAttention-3's layout on
//    Hopper, one kernel parametrised on d.  The FlashAttention-2 layout on
//    mma.sync it replaces ran at ~150 TFLOP/s, half of SDPA's, waiting on
//    cp.async and __syncthreads before every KV tile.  Here Q, K and V come
//    by TMA from 4-D maps over [B, tokens, h, d] in 64-column chunks (one
//    128-byte swizzled row each; columns past d and rows past N or M are
//    zero-filled), K and V through a 3-stage ring with full/empty mbarriers
//    fed by one producer thread.  BR = 128: two consumer warpgroups
//    (setmaxnreg gives them the producer's registers) each own 64 query
//    rows: S = Q K^T by wgmma m64nBCk16 from shared memory over ceil(d / 16)
//    k-steps (48 columns at d = 40, the last 8 zero), the online softmax on
//    the accumulator fragments in fp32 (base-2, the scale folded into one
//    FFMA), P rounded to bf16 in registers as wgmma's register A operand
//    for O += P V (m64ndk16, V read as a transposed, MN-major B operand
//    whose 64-column chunks are the descriptor's LBO apart).  BC = 128 keys
//    a tile at d <= 64, 64 above (O is d / 2 fp32 registers a thread).  The
//    softmax's exponentials cost as much as the products at d = 64, more at
//    d = 40, so they overlap: the two warpgroups take turns to issue
//    products (pingpong), and each issues the next tile's S with this
//    tile's P V before its next softmax.  Where JAX takes its chunked
//    branch with a scale that is not a power of two (d = 40's 64²
//    self-attention), the logits are bf16(q * scale) k^T as in
//    chunked_attention :42: the consumers round the resident Q tile once in
//    shared memory before the first S.
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
// Backward.  D = rowsum(dO o O) per query row; the logits are recomputed
// as the forward formed them.  Where the forward took JAX's chunked branch
// with a scale that is not a power of two (SD 1.5's [2, 4096, 8, 40]
// self-attention), they were bf16(q * scale) k^T (chunked_attention :42,
// whose derivative passes straight through the rounding):
// attn_bwd_prescale_kernel first writes qs = bf16(q * scale) to scratch,
// S = qs K^T with scale 1, dK = dS^T qs and dQ = scale * dS K.  Two forms:
//  - the UNet's head dims, d = 40, 64, 80, 160 (attention_bwd_flash and
//    its _d40, _d80, _d160 entry points; one template on d): flash-style,
//    nothing of size N x M in device memory.  The four-kernel form it
//    replaces stored P and dS in bf16 (2 x 537 MB at SD 1.5's [2, 4096, 8,
//    40]) and read them back for three GEMM launches: ~2.7 GB of traffic,
//    most of its 1.35 ms against a bound of 0.11 ms (the exponentials).
//    Here attn_bwd_rows_kernel writes each row's lse (log2 units) and D,
//    padded to 128 rows (+inf and 0: P = 0 there); then one launch holds
//    two passes side by side (attn_bwd_flash_kernel), each block two
//    consumer warpgroups fed by one TMA producer thread.  The dK/dV pass:
//    a block per (b, h, 128 keys) keeps K and V in shared memory and walks
//    the query tiles (64 queries, 32 at d = 160) through a ring: Sᵀ = K Qᵀ
//    and dPᵀ = V dOᵀ by wgmma, P = exp(S - lse) and dS = P (dP - D) on the
//    accumulators in fp32, rounded to bf16 in registers as the register A
//    operand of dV += P dO and dK += dS Q (dO, Q MN-major), dK and dV
//    accumulated in registers over the tiles (where few key tiles leave
//    SMs idle, the query range splits and a reduce kernel sums the fp32
//    partials in split order).  The dQ pass: a block per (b, h, 128
//    queries), the forward's layout, recomputes S and dP against each
//    64-key tile for dQ += dS K, rather than adding into dQ with fp32
//    atomics: two launches agree bit for bit.  Rows past N and M are TMA's
//    zero fill; keys past M get P = 0 in the dQ pass (77 text keys,
//    zero123's one) and are not stored by the dK/dV pass.
//  - d = 512 (the VAE mid-block, N = M = 4096: P and dS are 2 x 33.5 MB;
//    attention_bwd_wgmma): the row dots (attn_bwd_dot_kernel); a scores
//    pass recomputes S = Q K^T and dP = dO V^T for each 128 x 128 (query,
//    key) tile in wgmma accumulators (two consumer warpgroups of 64 query
//    rows, Q, dO, K and V by TMA through a 3-stage ring over d in steps of
//    64 columns), forms P = exp(S - lse) and dS = P o (dP - D) in fp32 and
//    stores both in bf16, row-major [z][N][Mp], by TMA from swizzled
//    staging; one wgmma GEMM kernel then gives dV = P^T dO and dK = scale *
//    dS^T Q in one launch (A read MN-major through the descriptor's
//    transpose bit, B = dO or Q MN-major) and dQ = scale * dS K in a
//    second (A K-major), 128 x 128 tiles over a 4-stage ring.  Bound by
//    operations (86 GFLOP against ~0.2 GB of traffic); the mma.sync
//    backward it replaced (64 x 64 tiles, plain loads, 5 launches) ran
//    0.64 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The UNet's head dims (64 in SD 2.x; 40, 80 and 160 in SD 1.x):
// FlashAttention-3's layout on wgmma (see the note above), one kernel
// parametrised on D.  A row of Q, K or V is ceil(D / 64) chunks of 64
// columns (one 128-byte swizzled row each, TMA's zero fill past D), so
// every operand has the d = 64 kernel's descriptor form: S = Q K^T takes
// ceil(D / 16) k16 steps (the zero columns add nothing), and O += P V has
// N = D, V's chunks BC * 128 bytes apart (the descriptor's LBO).
namespace fa {
template <int D_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int CH = (D + 63) / 64;     // 64-column chunks of a row
  static constexpr int KS = (D + 15) / 16;     // k16 steps of S = Q K^T
  // keys per KV tile: 128 at D <= 64; 64 above, which keeps O (D / 2
  // registers a thread), S and the two P buffers within the consumers'
  // registers
  static constexpr int BR = 128, BC = D <= 64 ? 128 : 64, STAGES = 3;
  static constexpr int kThreads = 384;
  static constexpr int QCH = BR * 128, KCH = BC * 128;   // bytes of a chunk
  static constexpr size_t kSmem =
      1024 + (size_t)CH * (QCH + 2 * STAGES * KCH) +
      (1 + 2 * STAGES) * sizeof(uint64_t);
};
}  // namespace fa

// With `prescale` (JAX's chunked branch, chunked_attention :42), each
// consumer warpgroup first rounds its rows of the resident Q to
// bf16(q * scale) in shared memory, and the logits take no further scale.
template <int D>
__global__ void __launch_bounds__(fa::Cfg<D>::kThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      bf16* __restrict__ o, float* __restrict__ lse, int N,
                      int M, int H, float scale, int prescale) {
  using C = fa::Cfg<D>;
  constexpr int BR = C::BR, BC = C::BC, CH = C::CH, KS = C::KS;
  constexpr int STAGES = C::STAGES, QCH = C::QCH, KCH = C::KCH;
  constexpr int NS = BC / 2, NP = BC / 16, NO = D / 2;   // S, P, O registers
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;                      // [CH][BR rows][64]
  unsigned char* sK = sQ + CH * QCH;             // [STAGES][CH][BC keys][64]
  unsigned char* sV = sK + STAGES * CH * KCH;    // [STAGES][CH][BC keys][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * CH * KCH);
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
      hop::mbar_expect_tx(qbar, CH * QCH);
      for (int c = 0; c < CH; ++c)
        hop::tma_load_4d(sQ + c * QCH, &qmap, qbar, 64 * c, hh, i0, b);
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int s = jt % STAGES;
        hop::mbar_wait(&empty[s], ((jt / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], 2 * CH * KCH);
        for (int c = 0; c < CH; ++c) {
          hop::tma_load_4d(sK + (s * CH + c) * KCH, &kmap, &full[s], 64 * c,
                           hh, jt * BC, b);
          hop::tma_load_4d(sV + (s * CH + c) * KCH, &vmap, &full[s], 64 * c,
                           hh, jt * BC, b);
        }
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
  if (prescale) {
    // q * scale in fp32, rounded to bf16 (zero-filled columns stay 0);
    // the generic proxy's writes, fenced, before wgmma reads them
    for (int c = 0; c < CH; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(sQ + c * QCH + cw * 64 * 128);
      for (int i = tid % 128; i < 64 * 128 / 16; i += 128) {
        uint4 u = rows[i];
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          h2[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        rows[i] = u;
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(3 + cw, 128);
  }
  // logits in log2 units: exp(s * scale - m) = 2^(s * sl2 - m * log2 e)
  const float sl2 = (prescale ? 1.f : scale) * 1.4426950408889634f;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float sc[NS];               // S of the tile being softmaxed
  uint32_t pa[NP][4], pb[NP][4];   // P, double-buffered: one is in flight
  uint64_t dqs[KS];           // Q's descriptor per k16 step: +32 bytes
#pragma unroll
  for (int k = 0; k < KS; ++k)
    dqs[k] = hop::desc_sw128(sQ + (k / 4) * QCH + cw * 64 * 128) +
             2 * (k % 4);

  // Every descriptor of a stage is formed before the stage opens, and the
  // accumulators are zeroed and fenced there: nothing but wgmmas runs
  // between a stage's wgmma.fence and its wait (ptxas would serialize).
  // S of tile jt: Q K^T (64 x BC per warpgroup) into sc.
  auto s_descs = [&](int jt, uint64_t* d) {
    const unsigned char* tK = sK + (jt % STAGES) * CH * KCH;
#pragma unroll
    for (int k = 0; k < KS; ++k)
      d[k] = hop::desc_sw128(tK + (k / 4) * KCH) + 2 * (k % 4);
  };
  auto mma_s = [&](const uint64_t* d) {
#pragma unroll
    for (int k = 0; k < KS; ++k) hop::wgmma_ss<BC>(sc, dqs[k], d[k]);
    hop::wgmma_commit();
  };
  // P V of tile jt into oacc: V [keys][d] is the transposed (MN-major) B
  // operand, 16 keys (2048 bytes) per k16 step, its 64-column chunks KCH
  // bytes apart.
  auto v_descs = [&](int jt, uint64_t* d) {
    const unsigned char* tV = sV + (jt % STAGES) * CH * KCH;
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      d[kk] = hop::desc_sw128(tV + kk * 2048, CH > 1 ? KCH : 16);
  };
  auto mma_pv = [&](const uint64_t* d, uint32_t (&p)[NP][4]) {
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) hop::wgmma_rs_tb<D>(oacc, p[kk], d[kk]);
    hop::wgmma_commit();
  };
  auto zero_s = [&](int jt) {
    hop::mbar_wait(&full[jt % STAGES], (jt / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    hop::fence_regs<NS>(sc);
  };
  // online softmax of tile jt's S on rows g (e = 0, 1) and g + 8 (e = 2, 3)
  // of the warp's 16 (a row's BC values over the 4 lanes of a quad):
  // the new maxima, the correction of the old sums into corr, P into pn
  auto softmax = [&](int jt, float* corr, uint32_t (*pn)[4]) {
    const int j0 = jt * BC;
    if (j0 + BC > M) {
#pragma unroll
      for (int j = 0; j < BC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * j + 2 * qd + (e % 2) >= M) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
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
    for (int j = 0; j < BC / 8; ++j) {
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
    for (int j = 0; j < D / 8; ++j) {
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
  uint64_t ds[KS], dv[NP];
  s_descs(0, ds);
  zero_s(0);
  my_turn();
  hop::wgmma_fence();
  mma_s(ds);
  pass_turn();
  hop::wgmma_wait<0>();
  hop::fence_regs<NS>(sc);
  softmax(0, corr, pa);
  auto step = [&](int jt, uint32_t (&pc)[NP][4], uint32_t (&pn)[NP][4]) {
    s_descs(jt + 1, ds);
    v_descs(jt, dv);
    zero_s(jt + 1);
    hop::fence_regs<NO>(oacc);
    hop::fence_regs<4 * NP>(&pc[0][0]);
    my_turn();
    hop::wgmma_fence();
    mma_s(ds);
    mma_pv(dv, pc);
    pass_turn();
    hop::wgmma_wait<1>();            // S of tile jt + 1 (P V still running)
    hop::fence_regs<NS>(sc);
    softmax(jt + 1, corr, pn);
    hop::wgmma_wait<0>();            // P V of tile jt: its stage is free
    hop::fence_regs<NO>(oacc);
    hop::fence_regs<4 * NP>(&pc[0][0]);
    hop::mbar_arrive(&empty[jt % STAGES]);
    rescale(corr);
  };
  auto last = [&](uint32_t (&pc)[NP][4]) {
    v_descs(n_tiles - 1, dv);
    hop::fence_regs<NO>(oacc);
    hop::fence_regs<4 * NP>(&pc[0][0]);
    my_turn();
    hop::wgmma_fence();
    mma_pv(dv, pc);
    pass_turn();
    hop::wgmma_wait<0>();
    hop::fence_regs<NO>(oacc);
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
    for (int j = 0; j < D / 8; ++j)
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

// qs = bf16(q * scale), 8 values a thread (n % 8 == 0: d * 2 bytes is a
// multiple of 16 at every head dim)
__global__ void attn_bwd_prescale_kernel(const uint4* __restrict__ q,
                                         uint4* __restrict__ qs, int64_t n8,
                                         float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 v = q[i];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
  qs[i] = v;
}

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

// ---- the scores pass --------------------------------------------------------

// One 128 x 128 (query, key) tile of (b, h) = z: S = Q K^T and dP = dO V^T
// in wgmma accumulators over d, k steps of 64 columns, then P = exp(S scale
// - lse) and dS = P (dP - Dv), both stored bf16 row-major [z][N][Mp] by TMA
// (rows past N and columns past M clipped).
namespace bs {
constexpr int BR = 128, BC = 128, STAGES = 3, kThreads = 384;
constexpr int TILE = 128 * 64 * 2;            // 128 rows x 64 columns: 16 KB
constexpr int STAGE = 4 * TILE;               // Q, dO, K, V
constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE +
                         2 * STAGES * sizeof(uint64_t);
}  // namespace bs

// (row, col) of a [64 rows][64 columns] bf16 box written for a 128-byte
// swizzled TMA store: chunk col / 8 of row r sits at chunk (col / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t* swz64(unsigned char* box, int r,
                                           int col) {
  return reinterpret_cast<uint32_t*>(box + r * 128 +
                                     (((col >> 3) ^ (r & 7)) << 4) +
                                     (col & 7) * 2);
}

__global__ void __launch_bounds__(bs::kThreads, 1)
attn_bwd_scores_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap pmap,
                       const __grid_constant__ CUtensorMap smap,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec, int N, int M, int H,
                       int D, float scale) {
  using namespace bs;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int z = blockIdx.z, b = z / H, hh = z % H;
  const int i0 = blockIdx.x * BR, j0 = blockIdx.y * BC;
  const int nk = D / 64;

  if (grp == 0) {
    // ---- producer: per k step, Q and dO rows i0.., K and V rows j0.. ----
    hop::regs_dec<40>();
    if (tid == 0) {
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        unsigned char* st = base + s * STAGE;
        hop::mbar_wait(&empty[s], ((kc / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], STAGE);
        hop::tma_load_4d(st, &qmap, &full[s], 64 * kc, hh, i0, b);
        hop::tma_load_4d(st + TILE, &omap, &full[s], 64 * kc, hh, i0, b);
        hop::tma_load_4d(st + 2 * TILE, &kmap, &full[s], 64 * kc, hh, j0, b);
        hop::tma_load_4d(st + 3 * TILE, &vmap, &full[s], 64 * kc, hh, j0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows 64cw..64cw+63 ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  float sacc[64], pacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = pacc[i] = 0.f;
  hop::fence_regs<64>(sacc);
  hop::fence_regs<64>(pacc);
  int prev = -1;
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    unsigned char* st = base + s * STAGE;
    // K-major operands, +32 bytes per k16 step
    const uint64_t dq = hop::desc_sw128(st + cw * 64 * 128);
    const uint64_t ddo = hop::desc_sw128(st + TILE + cw * 64 * 128);
    const uint64_t dk = hop::desc_sw128(st + 2 * TILE);
    const uint64_t dv = hop::desc_sw128(st + 3 * TILE);
    hop::mbar_wait(&full[s], (kc / STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::wgmma_m64n128k16_ss(sacc, dq + 2 * k, dk + 2 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::wgmma_m64n128k16_ss(pacc, ddo + 2 * k, dv + 2 * k);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();              // the previous k step's products
    if (prev >= 0) hop::mbar_arrive(&empty[prev]);
    prev = s;
  }
  hop::wgmma_wait<0>();
  hop::fence_regs<64>(sacc);
  hop::fence_regs<64>(pacc);
  hop::mbar_arrive(&empty[prev]);

  // ---- P and dS: rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp ----
  const float sl2 = scale * 1.4426950408889634f;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + cw * 64 + warp * 16 + g + 8 * r;
    const bool ok = row < N;
    l2[r] = ok ? lse[(int64_t)z * N + row] * 1.4426950408889634f : 0.f;
    dd[r] = ok ? dvec[(int64_t)z * N + row] : 0.f;
  }
  // both warpgroups are past their last products: the ring is free
  hop::bar_sync(1, 256);
  unsigned char* sP = base + cw * 4 * 8192;      // [2 boxes][64][64]
  unsigned char* sS = sP + 2 * 8192;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = (j % 8) * 8 + 2 * qd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = warp * 16 + g + 8 * r;
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        pv[e] = hop::exp2_approx(fmaf(sacc[i], sl2, -l2[r]));
        dsv[e] = pv[e] * (pacc[i] - dd[r]);
      }
      *swz64(sP + (j / 8) * 8192, rl, col) = dft::pack_bf16(pv[0], pv[1]);
      *swz64(sS + (j / 8) * 8192, rl, col) = dft::pack_bf16(dsv[0], dsv[1]);
    }
  }
  hop::fence_proxy_async();
  hop::bar_sync(2 + cw, 128);
  const int r0 = i0 + cw * 64;
  if (tid % 128 == 0 && r0 < N) {       // boxes wholly past N or M: none
    for (int h = 0; h < 2 && j0 + 64 * h < M; ++h) {
      hop::tma_store_4d(&pmap, sP + h * 8192, j0 + 64 * h, r0, z, 0);
      hop::tma_store_4d(&smap, sS + h * 8192, j0 + 64 * h, r0, z, 0);
    }
    hop::bulk_commit();
    hop::bulk_wait();
  }
}

// ---- the three products -------------------------------------------------------

// out[b, m, h, n] = alpha * sum_k A[m, k] B[k, n] per (b, h) = z: A the
// scores pass's P or dS ([z][N][Mp] row-major: MN-major for dV = P^T dO and
// dK = scale dS^T Q, where m is a key; K-major for dQ = scale dS K), B the
// token-major q, k or dO ([B, tokens, h, D], MN-major: n contiguous).  A
// 128 x 128 tile per block, two consumer warpgroups of 64 rows, a 4-stage
// TMA ring over K in 64-deep steps; blockIdx.z / Z picks one of two
// products (dV and dK share A's layout and one launch).  Rows past the
// output's tokens are clipped by the TMA store.
namespace bg {
constexpr int BM = 128, BN = 128, STAGES = 4, kThreads = 384;
constexpr int BOX = 64 * 64 * 2;                 // a 64 x 64 box: 8 KB
constexpr int STAGE = 4 * BOX;                   // A: 2 boxes, B: 2 boxes
constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE + 4 * BOX +
                         2 * STAGES * sizeof(uint64_t);
}  // namespace bg

struct GemmMaps {
  CUtensorMap a[2], b[2], o[2];
};

template <bool A_MN>
__global__ void __launch_bounds__(bg::kThreads, 1)
attn_bwd_gemm_kernel(const __grid_constant__ GemmMaps maps, int Mrows,
                     int Kdim, int H, int D, int Z, float alpha0,
                     float alpha1) {
  using namespace bg;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  unsigned char* epi = base + STAGES * STAGE;      // [2 warpgroups][2][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 4 * BOX);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int prod = blockIdx.z / Z, z = blockIdx.z % Z, b = z / H, hh = z % H;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nks = (Kdim + 63) / 64;
  // a box of A wholly past the output's rows is not loaded: the rows it
  // would feed are not stored
  const int na = m0 + 64 < Mrows ? 2 : 1;
  const CUtensorMap* am = &maps.a[prod];
  const CUtensorMap* bm = &maps.b[prod];

  if (grp == 0) {
    hop::regs_dec<40>();
    if (tid == 0) {
      for (int ks = 0; ks < nks; ++ks) {
        const int s = ks % STAGES, k0 = 64 * ks;
        unsigned char* st = base + s * STAGE;
        hop::mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], (na + 2) * BOX);
        for (int h = 0; h < na; ++h) {
          if (A_MN)        // [64 k rows][64 m]: keys m0 + 64h.. inner
            hop::tma_load_4d(st + h * BOX, am, &full[s], m0 + 64 * h, k0, z,
                             0);
          else             // [64 m rows][64 k]
            hop::tma_load_4d(st + h * BOX, am, &full[s], k0, m0 + 64 * h, z,
                             0);
        }
        for (int h = 0; h < 2; ++h)    // [64 k tokens][64 n]
          hop::tma_load_4d(st + (2 + h) * BOX, bm, &full[s], n0 + 64 * h, hh,
                           k0, b);
      }
    }
    return;
  }

  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hop::fence_regs<64>(acc);
  int prev = -1;
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const int s = ks % STAGES;
    unsigned char* st = base + s * STAGE;
    uint64_t da[4], db[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: MN-major, 16 k rows (2048 bytes) per k16 step; or K-major, +32
      // bytes.  B: MN-major, its two 64-column boxes BOX apart (LBO).
      da[kk] = A_MN ? hop::desc_sw128(st + cw * BOX + kk * 2048)
                    : hop::desc_sw128(st + cw * BOX) + 2 * kk;
      db[kk] = hop::desc_sw128(st + 2 * BOX + kk * 2048, BOX);
    }
    hop::mbar_wait(&full[s], (ks / STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_m64n128k16_ss_t<A_MN ? 1 : 0, 1>(acc, da[kk], db[kk]);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    if (prev >= 0) hop::mbar_arrive(&empty[prev]);
    prev = s;
  }
  hop::wgmma_wait<0>();
  hop::fence_regs<64>(acc);
  hop::mbar_arrive(&empty[prev]);

  // ---- epilogue: alpha * acc in bf16, by TMA ----
  const float alpha = prod ? alpha1 : alpha0;
  unsigned char* sO = epi + cw * 2 * BOX;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *swz64(sO + (j / 8) * BOX, warp * 16 + g + 8 * r, (j % 8) * 8 + 2 * qd) =
          dft::pack_bf16(alpha * acc[4 * j + 2 * r],
                         alpha * acc[4 * j + 2 * r + 1]);
  hop::fence_proxy_async();
  hop::bar_sync(1 + cw, 128);
  if (tid % 128 == 0 && cw < na) {
    for (int h = 0; h < 2; ++h)
      hop::tma_store_4d(&maps.o[prod], sO + h * BOX, n0 + 64 * h, hh,
                        m0 + 64 * cw, b);
    hop::bulk_commit();
    hop::bulk_wait();
  }
}

// ---- the flash-style backward at the UNet's head dims --------------------

// One template on d (40, 64, 80, 160) in two passes, nothing of size N x M
// in device memory (see the note above).  A row of Q, dO, K or V is
// ceil(d / 64) chunks of 64 columns (128-byte swizzled rows, TMA's zero
// fill past d), as the forward's.
namespace fb {
template <int D_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int CH = (D + 63) / 64;     // 64-column chunks of a row
  static constexpr int KS = (D + 15) / 16;     // k16 steps over d
  static constexpr int kThreads = 384;
  // dK/dV pass: BC keys a block (64 a consumer warpgroup), BR queries a
  // step; BR = 32 at d = 160 keeps S, dP and the two d-wide accumulators
  // within a consumer's registers
  static constexpr int BC = 128, BR = D <= 80 ? 64 : 32;
  static constexpr int KCH = BC * 128, QCH = BR * 128;   // bytes of a chunk
  static constexpr int STAGES = D <= 64 ? 4 : 3;
  // a stage: Q and dO chunks, then the tile's lse (log2 units) and D
  static constexpr int STAGE =
      (2 * CH * QCH + 2 * BR * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + (size_t)2 * CH * KCH +
                                  (size_t)STAGES * STAGE +
                                  (1 + 2 * STAGES) * sizeof(uint64_t);
  // dQ pass: QR queries a block (64 a consumer warpgroup), KT keys a step
  static constexpr int QR = 128, KT = 64;
  static constexpr int QCH2 = QR * 128, KCH2 = KT * 128;
  static constexpr int STAGES2 = D <= 80 ? 3 : 2;
  static constexpr size_t kSmem2 = 1024 + (size_t)2 * CH * QCH2 +
                                   (size_t)STAGES2 * 2 * CH * KCH2 +
                                   (1 + 2 * STAGES2) * sizeof(uint64_t);
  static_assert(kSmem <= 232448 && kSmem2 <= 232448, "shared memory");
  // the launch holds either pass's block
  static constexpr size_t kSmemAll = kSmem > kSmem2 ? kSmem : kSmem2;
};
constexpr int ROWS = 128;      // the rows' lse and D padded to a multiple
}  // namespace fb

// lse2[z, i] = lse[z, i] * log2(e) and Dv[z, i] = sum_c dO[b, i, h, c] *
// O[b, i, h, c] for i < N; +inf and 0 for N <= i < Np (their P is 0).
// ROW_LANES lanes a row of [B*H][Np]: lane j reads the row's 16-byte vectors
// j, j + ROW_LANES, ... (D % 8 == 0; a group's reads are contiguous), and
// the lanes' sums meet by a fixed butterfly.  Several lanes a row so that
// the UNets' 256-query rows (4096 rows at B*H = 16) spread over the SMs.
constexpr int ROW_LANES = 8;
__global__ void attn_bwd_rows_kernel(const bf16* __restrict__ dout,
                                     const bf16* __restrict__ out,
                                     const float* __restrict__ lse,
                                     float* __restrict__ lse2,
                                     float* __restrict__ dv, int B, int N,
                                     int H, int D, int Np) {
  const int64_t row =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / ROW_LANES;
  const int j = threadIdx.x % ROW_LANES;
  // a group of lanes returns whole: blockDim is a multiple of ROW_LANES
  if (row >= (int64_t)B * H * Np) return;
  const int i = (int)(row % Np);
  const int64_t z = row / Np;
  if (i >= N) {
    if (j == 0) {
      lse2[row] = INFINITY;
      dv[row] = 0.f;
    }
    return;
  }
  const int b = (int)(z / H), hh = (int)(z % H);
  const int64_t base = (((int64_t)b * N + i) * H + hh) * D / 8;
  const uint4* dov = reinterpret_cast<const uint4*>(dout) + base;
  const uint4* ov = reinterpret_cast<const uint4*>(out) + base;
  float s = 0.f;
  for (int c = j; c < D / 8; c += ROW_LANES) {
    uint4 a = dov[c], o = ov[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(o2[e]);
      s += x.x * y.x;
      s += x.y * y.y;
    }
  }
  const unsigned group = 0xffu << (threadIdx.x % 32 / ROW_LANES * ROW_LANES);
#pragma unroll
  for (int off = ROW_LANES / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(group, s, off, ROW_LANES);
  if (j == 0) {
    dv[row] = s;
    lse2[row] = lse[z * N + i] * 1.4426950408889634f;
  }
}

// The tensor maps of the two passes: the dK/dV pass's Q and dO in BR-row
// boxes, K and V in BC-row boxes; the dQ pass's Q and dO in QR-row boxes,
// K and V in KT-row boxes.
struct FlashMaps {
  CUtensorMap q1, o1, k1, v1, q2, o2, k2, v2;
};

// dK and dV of BC keys (key tile jb) of (b, h) = z, over the query tiles of
// split `split`.  K and V stay in shared memory; per query tile the
// consumer warpgroup cw (keys 64 cw ..) forms Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
// (wgmma m64nBRk16, both operands K-major), then P = exp(S scale - lse)
// and dS = P (dP - D) in fp32 on the accumulator fragments, rounded to
// bf16 in registers as wgmma's register A operand: dV += P dO and dK +=
// dS Q (m64ndk16, dO and Q read MN-major across their chunks).  Queries
// past N have lse +inf (P = 0); keys past M are zero rows whose dK and dV
// are not stored.  One split writes dK (times s_scale) and dV in bf16, more
// write their fp32 partials to ws [2][splits][B*M*H*D] (dK's, then dV's).
template <int D>
__device__ __forceinline__ void flash_dkdv(
    const FlashMaps& maps, unsigned char* base, const float* __restrict__ lse2,
    const float* __restrict__ dvec, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ ws, int jb, int z, int split,
    int splits, int Z, int N, int M, int H, int Np, float s_scale) {
  using C = fb::Cfg<D>;
  constexpr int BR = C::BR, BC = C::BC, CH = C::CH, KS = C::KS;
  constexpr int STAGES = C::STAGES, STAGE = C::STAGE;
  constexpr int QCH = C::QCH, KCH = C::KCH;
  constexpr int NS = BR / 2, NP = BR / 16, NA = D / 2;
  unsigned char* sK = base;                      // [CH][BC keys][64]
  unsigned char* sV = sK + CH * KCH;             // [CH][BC keys][64]
  unsigned char* ring = sV + CH * KCH;           // [STAGES][STAGE]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    hop::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);   // both consumer warpgroups
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int b = z / H, hh = z % H;
  const int j0 = jb * BC;
  const int q_tiles = (N + BR - 1) / BR;
  const int t0 = (int)((int64_t)q_tiles * split / splits);
  const int t1 = (int)((int64_t)q_tiles * (split + 1) / splits);

  if (grp == 0) {
    // ---- producer: K and V once, then the query tiles through the ring --
    hop::regs_dec<40>();
    if (tid == 0) {
      hop::mbar_expect_tx(kvbar, 2 * CH * KCH);
      for (int c = 0; c < CH; ++c) {
        hop::tma_load_4d(sK + c * KCH, &maps.k1, kvbar, 64 * c, hh, j0, b);
        hop::tma_load_4d(sV + c * KCH, &maps.v1, kvbar, 64 * c, hh, j0, b);
      }
      for (int it = t0; it < t1; ++it) {
        const int n = it - t0, s = n % STAGES;
        unsigned char* st = ring + s * STAGE;
        hop::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], 2 * CH * QCH + 2 * BR * 4);
        const int i0 = it * BR;
        for (int c = 0; c < CH; ++c) {
          hop::tma_load_4d(st + c * QCH, &maps.q1, &full[s], 64 * c, hh, i0,
                           b);
          hop::tma_load_4d(st + (CH + c) * QCH, &maps.o1, &full[s], 64 * c,
                           hh, i0, b);
        }
        // the rows' padding keeps i0 + BR <= Np; 128-byte aligned
        const int64_t r0 = (int64_t)z * Np + i0;
        hop::bulk_load(st + 2 * CH * QCH, lse2 + r0, BR * 4, &full[s]);
        hop::bulk_load(st + 2 * CH * QCH + BR * 4, dvec + r0, BR * 4,
                       &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys j0 + 64 cw .. ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  const float sl2 = s_scale * 1.4426950408889634f;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  // Descriptors as a base and constant offsets (a descriptor + n moves
  // its start by 16n bytes), so that few registers hold them beside the
  // two d-wide accumulators.  A: this warpgroup's 64 rows of K and V,
  // K-major: +32 bytes a k16 step within a chunk, chunks KCH apart.
  const uint64_t kd = hop::desc_sw128(sK + cw * 64 * 128);
  const uint64_t vd = hop::desc_sw128(sV + cw * 64 * 128);
  hop::mbar_wait(kvbar, 0);

#pragma unroll 1
  for (int it = t0; it < t1; ++it) {
    const int n = it - t0, s = n % STAGES;
    const unsigned char* st = ring + s * STAGE;
    // B operands: Q and dO K-major for S and dP (as K and V); MN-major (16
    // queries, 2048 bytes, a k16 step; chunks QCH apart) for dK and dV
    const uint64_t qk = hop::desc_sw128(st);
    const uint64_t ok = hop::desc_sw128(st + CH * QCH);
    const uint64_t qm = hop::desc_sw128(st, CH > 1 ? QCH : 16);
    const uint64_t om = hop::desc_sw128(st + CH * QCH, CH > 1 ? QCH : 16);
    float sacc[NS], pacc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = pacc[i] = 0.f;
    hop::fence_regs<NS>(sacc);
    hop::fence_regs<NS>(pacc);
    hop::mbar_wait(&full[s], (n / STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hop::wgmma_ss<BR>(sacc, kd + (k / 4) * (KCH >> 4) + 2 * (k % 4),
                        qk + (k / 4) * (QCH >> 4) + 2 * (k % 4));
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hop::wgmma_ss<BR>(pacc, vd + (k / 4) * (KCH >> 4) + 2 * (k % 4),
                        ok + (k / 4) * (QCH >> 4) + 2 * (k % 4));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<NS>(sacc);
    hop::fence_regs<NS>(pacc);

    // P and dS on rows (keys) g, g + 8 of the warp's 16, columns (queries)
    // 8j + 2qd, + 1, as the register A operand of the next products
    const float* sl = reinterpret_cast<const float*>(st + 2 * CH * QCH);
    const float* sd = sl + BR;
    uint32_t pf[NP][4], df[NP][4];
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * qd + (e % 2);
        pv[e] = hop::exp2_approx(fmaf(sacc[4 * j + e], sl2, -sl[col]));
        dsv[e] = pv[e] * (pacc[4 * j + e] - sd[col]);
      }
      pf[j / 2][(j % 2) * 2] = dft::pack_bf16(pv[0], pv[1]);
      pf[j / 2][(j % 2) * 2 + 1] = dft::pack_bf16(pv[2], pv[3]);
      df[j / 2][(j % 2) * 2] = dft::pack_bf16(dsv[0], dsv[1]);
      df[j / 2][(j % 2) * 2 + 1] = dft::pack_bf16(dsv[2], dsv[3]);
    }
    hop::fence_regs<4 * NP>(&pf[0][0]);
    hop::fence_regs<4 * NP>(&df[0][0]);
    hop::fence_regs<NA>(dva);
    hop::fence_regs<NA>(dka);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      hop::wgmma_rs_tb<D>(dva, pf[kk], om + kk * (2048 >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      hop::wgmma_rs_tb<D>(dka, df[kk], qm + kk * (2048 >> 4));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<NA>(dva);
    hop::fence_regs<NA>(dka);
    hop::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: rows past M are not stored ----
  const int64_t total = (int64_t)Z * M * D;      // B*M*H*D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + cw * 64 + warp * 16 + g + 8 * r;
    if (key >= M) continue;
    const int64_t row = (((int64_t)b * M + key) * H + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t i = row + 8 * j + 2 * qd;
      const float k0 = dka[4 * j + 2 * r], k1 = dka[4 * j + 2 * r + 1];
      const float v0 = dva[4 * j + 2 * r], v1 = dva[4 * j + 2 * r + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(dk + i) =
            dft::pack_bf16(s_scale * k0, s_scale * k1);
        *reinterpret_cast<uint32_t*>(dv + i) = dft::pack_bf16(v0, v1);
      } else {
        *reinterpret_cast<float2*>(ws + split * total + i) =
            make_float2(k0, k1);
        *reinterpret_cast<float2*>(ws + (splits + split) * total + i) =
            make_float2(v0, v1);
      }
    }
  }
}

// dQ of QR queries (query tile ib) of (b, h) = z over every key tile: the
// forward's layout (Q and dO resident, K and V through a ring) with dP =
// dO Vᵀ beside S = Q Kᵀ, P and dS recomputed from lse and D as in the dK/dV
// pass (keys past M masked to P = 0), and dQ += dS K with K read again as
// the MN-major B operand.  dQ = q_scale * the sum, bf16, rows past N not
// stored.
template <int D>
__device__ __forceinline__ void flash_dq(
    const FlashMaps& maps, unsigned char* base, const float* __restrict__ lse2,
    const float* __restrict__ dvec, bf16* __restrict__ dq, int ib, int z,
    int N, int M, int H, int Np, float s_scale, float q_scale) {
  using C = fb::Cfg<D>;
  constexpr int QR = C::QR, KT = C::KT, CH = C::CH, KS = C::KS;
  constexpr int STAGES = C::STAGES2, QCH = C::QCH2, KCH = C::KCH2;
  constexpr int NS = KT / 2, NP = KT / 16, NA = D / 2;
  unsigned char* sQ = base;                      // [CH][QR rows][64]
  unsigned char* sO = sQ + CH * QCH;             // [CH][QR rows][64]
  unsigned char* ring = sO + CH * QCH;           // [STAGES][K, V: CH][KT][64]
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(ring + STAGES * 2 * CH * KCH);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, grp = tid / 128;
  if (tid == 0) {
    hop::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int b = z / H, hh = z % H;
  const int i0 = ib * QR;
  const int n_tiles = (M + KT - 1) / KT;

  if (grp == 0) {
    hop::regs_dec<40>();
    if (tid == 0) {
      hop::mbar_expect_tx(qbar, 2 * CH * QCH);
      for (int c = 0; c < CH; ++c) {
        hop::tma_load_4d(sQ + c * QCH, &maps.q2, qbar, 64 * c, hh, i0, b);
        hop::tma_load_4d(sO + c * QCH, &maps.o2, qbar, 64 * c, hh, i0, b);
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int s = jt % STAGES;
        unsigned char* st = ring + s * 2 * CH * KCH;
        hop::mbar_wait(&empty[s], ((jt / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], 2 * CH * KCH);
        for (int c = 0; c < CH; ++c) {
          hop::tma_load_4d(st + c * KCH, &maps.k2, &full[s], 64 * c, hh,
                           jt * KT, b);
          hop::tma_load_4d(st + (CH + c) * KCH, &maps.v2, &full[s], 64 * c,
                           hh, jt * KT, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows i0 + 64 cw .. ----
  hop::regs_inc<232>();
  const int cw = grp - 1;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int qd = lane % 4, g = lane / 4;
  const float sl2 = s_scale * 1.4426950408889634f;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {      // i0 + 128 <= Np: padded rows
    const int64_t row = (int64_t)z * Np + i0 + cw * 64 + warp * 16 + g +
                        8 * r;
    l2[r] = lse2[row];
    dd[r] = dvec[row];
  }
  float dqa[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dqa[i] = 0.f;
  // descriptors as a base and constant offsets, as in the dK/dV pass
  const uint64_t qk = hop::desc_sw128(sQ + cw * 64 * 128);
  const uint64_t ok = hop::desc_sw128(sO + cw * 64 * 128);
  hop::mbar_wait(qbar, 0);

#pragma unroll 1
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int s = jt % STAGES;
    const unsigned char* st = ring + s * 2 * CH * KCH;
    // K and V K-major for S and dP; K MN-major (16 keys a k16 step) for dQ
    const uint64_t kt = hop::desc_sw128(st);
    const uint64_t vk = hop::desc_sw128(st + CH * KCH);
    const uint64_t km = hop::desc_sw128(st, CH > 1 ? KCH : 16);
    float sacc[NS], pacc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = pacc[i] = 0.f;
    hop::fence_regs<NS>(sacc);
    hop::fence_regs<NS>(pacc);
    hop::mbar_wait(&full[s], (jt / STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hop::wgmma_ss<KT>(sacc, qk + (k / 4) * (QCH >> 4) + 2 * (k % 4),
                        kt + (k / 4) * (KCH >> 4) + 2 * (k % 4));
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hop::wgmma_ss<KT>(pacc, ok + (k / 4) * (QCH >> 4) + 2 * (k % 4),
                        vk + (k / 4) * (KCH >> 4) + 2 * (k % 4));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<NS>(sacc);
    hop::fence_regs<NS>(pacc);

    // dS on rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8j + 2qd, + 1
    const int j0 = jt * KT;
    const bool ragged = j0 + KT > M;
    uint32_t df[NP][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = hop::exp2_approx(fmaf(sacc[4 * j + e], sl2, -l2[e / 2]));
        if (ragged && j0 + 8 * j + 2 * qd + (e % 2) >= M) pv = 0.f;
        dsv[e] = pv * (pacc[4 * j + e] - dd[e / 2]);
      }
      df[j / 2][(j % 2) * 2] = dft::pack_bf16(dsv[0], dsv[1]);
      df[j / 2][(j % 2) * 2 + 1] = dft::pack_bf16(dsv[2], dsv[3]);
    }
    hop::fence_regs<4 * NP>(&df[0][0]);
    hop::fence_regs<NA>(dqa);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      hop::wgmma_rs_tb<D>(dqa, df[kk], km + kk * (2048 >> 4));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<NA>(dqa);
    hop::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + cw * 64 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* qrow = dq + (((int64_t)b * N + row) * H + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(qrow + 8 * j + 2 * qd) = dft::pack_bf16(
          q_scale * dqa[4 * j + 2 * r], q_scale * dqa[4 * j + 2 * r + 1]);
  }
}

// Both passes in one launch, so that they share the card: the first
// ceil(M / BC) * Z * splits blocks are the dK/dV pass's (key tile fastest,
// then (b, h), then the split), the rest the dQ pass's (query tile, then
// (b, h)).  The passes read only the inputs and the rows' lse and D.
template <int D>
__global__ void __launch_bounds__(fb::Cfg<D>::kThreads, 1)
attn_bwd_flash_kernel(const __grid_constant__ FlashMaps maps,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dvec, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      float* __restrict__ ws, int Z, int N, int M, int H,
                      int Np, int splits, float s_scale, float q_scale) {
  using C = fb::Cfg<D>;
  extern __shared__ unsigned char smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_buf) + 1023) & ~uintptr_t(1023));
  const int kt = (M + C::BC - 1) / C::BC, kv_blocks = kt * Z * splits;
  const int x = blockIdx.x;
  if (x < kv_blocks) {
    flash_dkdv<D>(maps, base, lse2, dvec, dk, dv, ws, x % kt, (x / kt) % Z,
                  x / (kt * Z), splits, Z, N, M, H, Np, s_scale);
  } else {
    const int y = x - kv_blocks, qt = (N + C::QR - 1) / C::QR;
    flash_dq<D>(maps, base, lse2, dvec, dq, y % qt, y / qt, N, M, H, Np,
                s_scale, q_scale);
  }
}

// dK = dk_scale * sum_s ws[0][s] and dV = sum_s ws[1][s], in split order
__global__ void attn_bwd_split_reduce_kernel(const float* __restrict__ ws,
                                             bf16* __restrict__ dk,
                                             bf16* __restrict__ dv,
                                             int64_t total, int splits,
                                             float dk_scale) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * total) return;
  const int which = idx >= total;
  const int64_t i = idx - which * total;
  const float* w = ws + (int64_t)which * splits * total + i;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += w[s * total];
  if (which)
    dv[i] = __float2bfloat16(v);
  else
    dk[i] = __float2bfloat16(dk_scale * v);
}

}  // namespace

// The UNet's forward at head dim D on wgmma, q [B, N, h, D], k and v
// [B, M, h, D], each read through a TMA map over [B, tokens, h, D] in
// boxes of 64 columns (D * 2 bytes is a multiple of 16: every D here).
template <int D>
static int attn_fwd_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int N, int M,
                                 int H, int prescale, float scale,
                                 cudaStream_t stream) {
  using C = fa::Cfg<D>;
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
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)(i == 0 ? C::BR : C::BC),
                               1};
    if (!hop::encode_bf16_map(&maps[i], ptrs[i], 4, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(attn_fwd_wgmma_kernel<D>, (int)C::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::BR - 1) / C::BR, B * H);
  attn_fwd_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, N, M, H, scale,
      prescale);
  return (int)cudaGetLastError();
}

// One entry point per head dim (each its own launch counter); prescale:
// logits of bf16(q * scale) (JAX's chunked branch) rather than scale * q k.
#define ATTN_FWD_WGMMA(name, D)                                             \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      float* lse, int B, int N, int M, int H, int prescale, \
                      float scale, cudaStream_t stream) {                   \
    return attn_fwd_wgmma_launch<D>(q, k, v, o, lse, B, N, M, H, prescale,  \
                                    scale, stream);                         \
  }
ATTN_FWD_WGMMA(attention_fwd_wgmma, 64)
ATTN_FWD_WGMMA(attention_fwd_wgmma_d40, 40)
ATTN_FWD_WGMMA(attention_fwd_wgmma_d80, 80)
ATTN_FWD_WGMMA(attention_fwd_wgmma_d160, 160)
#undef ATTN_FWD_WGMMA

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

// A [B, tokens, h, D] bf16 map with boxes of `rows` tokens x 64 columns.
static bool token_map(CUtensorMap* map, const void* p, int B, int tokens,
                      int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)tokens, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)tokens * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hop::encode_bf16_map(map, p, 4, dims, strides, box);
}

// dq, dk, dv from q, k, v, o, do and lse at head dim D = 512; all of them
// 16-byte aligned.  Scratch: dvec [B*H*N]
// fp32, p and ds [B*H][N][Mp] bf16 (Mp = M rounded up to 8), and with
// prescale qs like q.  Four launches (five with prescale): the row dots D,
// the scores pass, dV and dK, dQ.
static int attn_bwd_launch(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           void* dq, void* dk, void* dv, float* dvec, void* p,
                           void* ds, void* qs, int B, int N, int M, int H,
                           int D, int prescale, float scale,
                           cudaStream_t stream) {
  if (N < 1 || M < 1 || B * H < 1 || (prescale && qs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Mp = (M + 7) / 8 * 8, Z = B * H;
  // with prescale the logits are bf16(q * scale) k^T: qs takes q's place in
  // S and in dK, and only dQ keeps the scale
  const void* qq_ptr = prescale ? qs : q;
  const float s_scale = prescale ? 1.f : scale;
  // scores pass: Q, dO, K, V in 128-row boxes; P and dS [z][N][Mp]
  CUtensorMap qm, om, km, vm, pm, sm;
  bool ok = token_map(&qm, qq_ptr, B, N, H, D, 128) &&
            token_map(&om, dout, B, N, H, D, 128) &&
            token_map(&km, k, B, M, H, D, 128) &&
            token_map(&vm, v, B, M, H, D, 128);
  const cuuint64_t sdims[4] = {(cuuint64_t)M, (cuuint64_t)N, (cuuint64_t)Z,
                               1};
  const cuuint64_t sstr[3] = {(cuuint64_t)Mp * 2, (cuuint64_t)N * Mp * 2,
                              (cuuint64_t)Z * N * Mp * 2};
  const cuuint32_t sbox[4] = {64, 64, 1, 1};
  ok = ok && hop::encode_bf16_map(&pm, p, 4, sdims, sstr, sbox) &&
       hop::encode_bf16_map(&sm, ds, 4, sdims, sstr, sbox);
  // products: dV = P^T dO, dK = scale dS^T Q (A MN-major); dQ = scale dS K
  GemmMaps kv, qq;
  kv.a[0] = pm;
  kv.a[1] = sm;
  qq.a[0] = qq.a[1] = sm;
  ok = ok && token_map(&kv.b[0], dout, B, N, H, D, 64) &&
       token_map(&kv.b[1], qq_ptr, B, N, H, D, 64) &&
       token_map(&kv.o[0], dv, B, M, H, D, 64) &&
       token_map(&kv.o[1], dk, B, M, H, D, 64) &&
       token_map(&qq.b[0], k, B, M, H, D, 64) &&
       token_map(&qq.o[0], dq, B, N, H, D, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  qq.b[1] = qq.b[0];
  qq.o[1] = qq.o[0];
  static bool set_s[hop::kMaxDevices] = {}, set_kv[hop::kMaxDevices] = {},
              set_q[hop::kMaxDevices] = {};
  cudaError_t err =
      hop::allow_smem(attn_bwd_scores_kernel, (int)bs::kSmem, set_s);
  if (err == cudaSuccess)
    err = hop::allow_smem(attn_bwd_gemm_kernel<true>, (int)bg::kSmem, set_kv);
  if (err == cudaSuccess)
    err = hop::allow_smem(attn_bwd_gemm_kernel<false>, (int)bg::kSmem, set_q);
  if (err != cudaSuccess) return (int)err;

  if (prescale) {
    const int64_t n8 = (int64_t)B * N * H * D / 8;
    attn_bwd_prescale_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0,
                               stream>>>(static_cast<const uint4*>(q),
                                         static_cast<uint4*>(qs), n8, scale);
  }
  const int64_t rows = (int64_t)Z * N;
  attn_bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o), dvec, B,
      N, H, D);
  dim3 sgrid((N + bs::BR - 1) / bs::BR, (M + bs::BC - 1) / bs::BC, Z);
  attn_bwd_scores_kernel<<<sgrid, bs::kThreads, bs::kSmem, stream>>>(
      qm, om, km, vm, pm, sm, lse, dvec, N, M, H, D, s_scale);
  const int nt = D / bg::BN;
  dim3 gkv((M + bg::BM - 1) / bg::BM, nt, 2 * Z);
  attn_bwd_gemm_kernel<true><<<gkv, bg::kThreads, bg::kSmem, stream>>>(
      kv, M, N, H, D, Z, 1.f, s_scale);
  dim3 gq((N + bg::BM - 1) / bg::BM, nt, Z);
  attn_bwd_gemm_kernel<false><<<gq, bg::kThreads, bg::kSmem, stream>>>(
      qq, N, M, H, D, Z, scale, scale);
  return (int)cudaGetLastError();
}

// The four-kernel backward at d = 512 (the VAE mid-block; the UNet's head
// dims take attention_bwd_flash*).
extern "C" int attention_bwd_wgmma(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* dvec,
                                   void* p, void* ds, void* qs, int B, int N,
                                   int M, int H, int D, int prescale,
                                   float scale, cudaStream_t stream) {
  if (D != 512) return (int)cudaErrorInvalidValue;
  return attn_bwd_launch(q, k, v, o, dout, lse, dq, dk, dv, dvec, p, ds, qs,
                         B, N, M, H, D, prescale, scale, stream);
}

// The flash-style backward at head dim D (40, 64, 80 or 160): dq, dk, dv
// from q, k, v, o, do and lse (all 16-byte aligned).  Scratch: lse2 and
// dvec fp32 [B*H*Np] (Np = N rounded up to 128), qs like q with prescale,
// ws fp32 [2 * splits * B*M*H*D] with splits > 1 (1 <= splits <= the
// query tiles of the dK/dV pass).  Launches: bf16(q * scale) with
// prescale, the rows' lse and D, both passes in one (and with splits, the
// reduce of the dK/dV partials).
template <int D>
static int attn_bwd_flash_launch(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, void* dq, void* dk,
                                 void* dv, float* lse2, float* dvec, void* qs,
                                 float* ws, int B, int N, int M, int H,
                                 int splits, int prescale, float scale,
                                 cudaStream_t stream) {
  using C = fb::Cfg<D>;
  const int Z = B * H;
  if (N < 1 || M < 1 || Z < 1 || splits < 1 ||
      splits > (N + C::BR - 1) / C::BR || (splits > 1 && ws == nullptr) ||
      (prescale && qs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Np = (N + fb::ROWS - 1) / fb::ROWS * fb::ROWS;
  // with prescale the logits are bf16(q * scale) k^T: qs takes q's place in
  // S and in dK, and only dQ keeps the scale
  const void* qq = prescale ? qs : q;
  const float s_scale = prescale ? 1.f : scale;
  FlashMaps maps;
  if (!token_map(&maps.q1, qq, B, N, H, D, C::BR) ||
      !token_map(&maps.o1, dout, B, N, H, D, C::BR) ||
      !token_map(&maps.k1, k, B, M, H, D, C::BC) ||
      !token_map(&maps.v1, v, B, M, H, D, C::BC) ||
      !token_map(&maps.q2, qq, B, N, H, D, C::QR) ||
      !token_map(&maps.o2, dout, B, N, H, D, C::QR) ||
      !token_map(&maps.k2, k, B, M, H, D, C::KT) ||
      !token_map(&maps.v2, v, B, M, H, D, C::KT))
    return (int)cudaErrorInvalidValue;
  static bool set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(attn_bwd_flash_kernel<D>, (int)C::kSmemAll, set);
  if (err != cudaSuccess) return (int)err;
  if (prescale) {
    const int64_t n8 = (int64_t)B * N * H * D / 8;
    attn_bwd_prescale_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0,
                               stream>>>(static_cast<const uint4*>(q),
                                         static_cast<uint4*>(qs), n8, scale);
  }
  const int64_t lanes = (int64_t)Z * Np * ROW_LANES;
  attn_bwd_rows_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o), lse, lse2,
      dvec, B, N, H, D, Np);
  const int blocks = (M + C::BC - 1) / C::BC * Z * splits +
                     (N + C::QR - 1) / C::QR * Z;
  attn_bwd_flash_kernel<D><<<blocks, C::kThreads, C::kSmemAll, stream>>>(
      maps, lse2, dvec, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), ws, Z, N, M, H, Np, splits, s_scale, scale);
  if (splits > 1) {
    const int64_t total = (int64_t)Z * M * D;
    attn_bwd_split_reduce_kernel<<<(unsigned)((2 * total + 255) / 256), 256,
                                   0, stream>>>(
        ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), total, splits,
        s_scale);
  }
  return (int)cudaGetLastError();
}

// One entry point (and launch counter) per head dim, as the forward's.
#define ATTN_BWD_FLASH(name, D)                                               \
  extern "C" int name(const void* q, const void* k, const void* v,            \
                      const void* o, const void* dout, const float* lse,      \
                      void* dq, void* dk, void* dv, float* lse2, float* dvec, \
                      void* qs, float* ws, int B, int N, int M, int H,        \
                      int splits, int prescale, float scale,                  \
                      cudaStream_t stream) {                                  \
    return attn_bwd_flash_launch<D>(q, k, v, o, dout, lse, dq, dk, dv, lse2, \
                                    dvec, qs, ws, B, N, M, H, splits,         \
                                    prescale, scale, stream);                 \
  }
ATTN_BWD_FLASH(attention_bwd_flash, 64)
ATTN_BWD_FLASH(attention_bwd_flash_d40, 40)
ATTN_BWD_FLASH(attention_bwd_flash_d80, 80)
ATTN_BWD_FLASH(attention_bwd_flash_d160, 160)
#undef ATTN_BWD_FLASH

// ---------------------------------------------------------------------------
// fp32 forward (DPT's ViT-B blocks: [1, 577, 12, 64] fp32, JAX's dense
// branch: fp32 logits, softmax, P kept fp32, P V)
// ---------------------------------------------------------------------------
//
// CUDA cores, no tensor cores: TF32 would part from the plain version by
// ~1e-3.  Bound: operations (2 x 2 N M d FMA-flops a head: 1.02 GFLOP a
// DPT attention, 15.3 us at 67 TFLOP/s fp32).  The first design (a block
// per 64 queries, 120 blocks on 132 SMs, scalar synchronous K/V loads, S
// through shared memory with three barriers a tile) ran at 23% of that.
// Here:
//  - a block takes BR = 32 query rows of one (b, h): 19 x 12 = 228 blocks,
//    two resident on each SM (88 KB of shared memory each);
//  - four warps: warp (rh, kg) owns query rows rh*16 .. + 15 and the keys
//    kg*32 .. + 31 of every 64-key tile, with its own online softmax
//    (running max and sum in fp32, exp of s - max as torch's softmax takes
//    it) and its own O; the two key halves merge once at the end, in a
//    fixed order (deterministic);
//  - K and V tiles come by 16-byte cp.async into a double buffer (rows
//    past M zero-filled, their logits -inf; 577 keys leave a last tile of
//    one key), so the next tile's copy runs under this tile's products:
//    one __syncthreads a tile;
//  - a lane is 4 rows x 4 keys of S (float4 reads along d: Q's rows are
//    broadcasts, K's 8 consecutive rows over distinct banks at the padded
//    stride) and 4 rows x 8 columns of O; the row max and sum reduce by
//    shuffles among the 8 lanes of a row, P goes through the warp's own
//    slice of shared memory (__syncwarp only) to be read as float4 along
//    the keys for O += P V.
namespace f32a {
constexpr int D = 64, BR = 32, BC = 64, LD = D + 4, PLD = 40, kThreads = 128;
constexpr int HALF_BC = BC / 2;   // the keys of one warp's half of a tile
constexpr size_t kSmem =
    (size_t)(BR * LD + 4 * BC * LD + 4 * 16 * PLD) * sizeof(float);
}  // namespace f32a

__global__ void __launch_bounds__(f32a::kThreads, 2)
    attn_fwd_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int N, int M, int H,
                         float scale) {
  using namespace f32a;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                        // [BR][LD]
  float* Ks = Qs + BR * LD;              // [2][BC][LD]
  float* Vs = Ks + 2 * BC * LD;          // [2][BC][LD]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rh = warp & 1, kg = warp >> 1;
  const int ty = lane / 8, tx = lane % 8;
  float* Ps = Vs + 2 * BC * LD + warp * 16 * PLD;   // this warp's [16][PLD]
  const int z = blockIdx.y, b = z / H, h = z % H, n0 = blockIdx.x * BR;
  const int64_t row = (int64_t)H * D;    // floats between tokens
  const float* qz = q + (int64_t)b * N * row + (int64_t)h * D;
  const float* kz = k + (int64_t)b * M * row + (int64_t)h * D;
  const float* vz = v + (int64_t)b * M * row + (int64_t)h * D;
  // a thread copies 16-byte chunk tid % 16 of rows tid / 16 + 8 i
  const int cc = (tid % 16) * 4, cr = tid / 16;
  for (int r = cr; r < BR; r += kThreads / 16) {
    const bool in = n0 + r < N;
    dft::cp_async16(Qs + r * LD + cc,
                    in ? qz + (int64_t)(n0 + r) * row + cc : qz, in);
  }
  auto load_kv = [&](int buf, int m0) {
    float* kb = Ks + buf * BC * LD;
    float* vb = Vs + buf * BC * LD;
    for (int r = cr; r < BC; r += kThreads / 16) {
      const bool in = m0 + r < M;
      const int64_t off = in ? (int64_t)(m0 + r) * row + cc : 0;
      dft::cp_async16(kb + r * LD + cc, kz + off, in);
      dft::cp_async16(vb + r * LD + cc, vz + off, in);
    }
  };
  load_kv(0, 0);
  dft::cp_async_commit();

  // this lane's rows (of the warp's 16) i*4 + ty, keys kg*32 + j*8 + tx,
  // O columns tx*4 .. + 3 and 32 + tx*4 .. + 3
  const float* qrow = Qs + (rh * 16 + ty) * LD;
  float m_run[4], l_run[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (M + BC - 1) / BC;
  for (int t = 0; t < tiles; ++t) {
    dft::cp_async_wait<0>();
    __syncthreads();                     // tile t landed; t - 1 is done
    if (t + 1 < tiles) load_kv((t + 1) & 1, (t + 1) * BC);
    dft::cp_async_commit();
    const float* kb = Ks + (t & 1) * BC * LD + (kg * HALF_BC + tx) * LD;
    const float* vb = Vs + (t & 1) * BC * LD + kg * HALF_BC * LD + tx * 4;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qrow + i * 4 * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kb + j * 8 * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    const int key0 = t * BC + kg * HALF_BC + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key0 + j * 8 < M ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      // a half with no key yet (M < 33) keeps its zeros
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - base);
        Ps[(i * 4 + ty) * PLD + j * 8 + tx] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - base);  // 0 before the first key
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncwarp();
    // O += P V over the warp's 32 keys
#pragma unroll 2
    for (int kk = 0; kk < HALF_BC; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (i * 4 + ty) * PLD +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(vb + (kk + u) * LD);
        const float4 v1 =
            *reinterpret_cast<const float4*>(vb + (kk + u) * LD + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

  // merge the key halves: kg = 1 hands (m, l, O) over through the K/V
  // buffers, kg = 0 combines and stores
  dft::cp_async_wait<0>();
  __syncthreads();
  float* xo = Ks + rh * 16 * LD;              // [16][LD]: O, then m, l
  float* xm = Ks + 32 * LD + rh * 32;         // [16] m, [16] l
  if (kg == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* r = xo + (i * 4 + ty) * LD + tx * 4;
      *reinterpret_cast<float4*>(r) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(r + 32) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx == 0) {
        xm[i * 4 + ty] = m_run[i];
        xm[16 + i * 4 + ty] = l_run[i];
      }
    }
  }
  __syncthreads();
  if (kg == 1) return;
  float* oz = o + (int64_t)b * N * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rh * 16 + i * 4 + ty;
    const float m1 = xm[i * 4 + ty], l1 = xm[16 + i * 4 + ty];
    const float mm = fmaxf(m_run[i], m1);     // finite: key 0 is in half 0
    const float a0 = expf(m_run[i] - mm), a1 = expf(m1 - mm);
    const float l = l_run[i] * a0 + l1 * a1;
    if (n0 + r >= N) continue;
    if (tx == 0) lse[(int64_t)z * N + n0 + r] = mm + logf(l);
    const float inv = 1.f / l;
    const float* x1 = xo + (i * 4 + ty) * LD + tx * 4;
    float* dst = oz + (int64_t)(n0 + r) * row + tx * 4;
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const float4 w = *reinterpret_cast<const float4*>(x1 + 32 * hlf);
      const float* a = acc[i] + 4 * hlf;
      *reinterpret_cast<float4*>(dst + 32 * hlf) = make_float4(
          (a[0] * a0 + w.x * a1) * inv, (a[1] * a0 + w.y * a1) * inv,
          (a[2] * a0 + w.z * a1) * inv, (a[3] * a0 + w.w * a1) * inv);
    }
  }
}

extern "C" int attention_fwd_fp32(const float* q, const float* k,
                                  const float* v, float* o, float* lse,
                                  int B, int N, int M, int H, int D,
                                  float scale, cudaStream_t stream) {
  using namespace f32a;
  if (D != f32a::D || M < 1) return (int)cudaErrorInvalidValue;
  if (N == 0 || B * H == 0) return (int)cudaGetLastError();
  static bool smem_set[hop::kMaxDevices] = {};
  const cudaError_t err =
      hop::allow_smem(attn_fwd_fp32_kernel, (int)kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BR - 1) / BR, B * H);
  attn_fwd_fp32_kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, lse, N,
                                                          M, H, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 backward (the DPT's ViT-B blocks: [1, 577, 12, 64] fp32, JAX's dense
// branch differentiated: P and dS kept in fp32)
// ---------------------------------------------------------------------------
//
// CUDA cores, no TF32, as the forward.  Bound: operations, five products of
// 2 N M d a head (S and dP recomputed for dK and dV, again for dQ: the
// kernels do seven) = 2.56 GFLOP a DPT attention, 0.038 ms at 67 TFLOP/s.
// Three kernels in one launch:
//  - attn_bwd_fp32_dot_kernel: D = rowsum(dO o O), [B*h, N];
//  - attn_bwd_fp32_kernel<true>: a block per (b, h, 32 keys) keeps K and V
//    of its keys in shared memory and walks the queries in tiles of 64 (Q,
//    dO, lse and D by cp.async into a double buffer): S^T and dP^T of its
//    keys x the tile, P = exp(S scale - lse) and dS = P o (dP - D) into
//    shared memory, then dV += P^T dO and dK += dS^T Q in registers;
//  - attn_bwd_fp32_kernel<false>: a block per (b, h, 32 queries) keeps Q and
//    dO (and their lse and D) and walks the keys in tiles of 64: the same S,
//    dP, P and dS, then dQ += dS K.
// The two walks share one kernel: a block's resident rows A1, A2 (K, V or Q,
// dO) against the streamed tile's B1, B2 (Q, dO or K, V).  Each lane holds
// 4 resident rows x 4 tile rows of S and dP (float4 reads along d: the
// resident rows are broadcasts, the tile's 16 rows of a half-warp fall on
// distinct banks at the padded stride), then 4 resident rows x 4 columns of
// d of the outputs (float4 reads of P, dS and the tile along its rows).
// Rows past N or M are zero-filled and their P set to 0.  No atomics: the
// sums run in a fixed order (deterministic).
namespace b32 {
constexpr int D = 64, R = 32, T = 64, LD = D + 4, PLD = R + 4, kThreads = 128;
constexpr size_t kSmem =
    (size_t)(2 * R * LD + 2 * 2 * T * LD + 2 * T * PLD + 2 * 2 * T) *
    sizeof(float);
}  // namespace b32

// D[z, n] = sum_d dO[b, n, h, d] O[b, n, h, d]: 16 lanes a row
__global__ void attn_bwd_fp32_dot_kernel(const float* __restrict__ o,
                                         const float* __restrict__ dout,
                                         float* __restrict__ dvec, int N,
                                         int H, int64_t rows) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 16;
  const int c = (threadIdx.x % 16) * 4;
  float s = 0.f;
  if (r < rows) {
    const float4 a = *reinterpret_cast<const float4*>(o + r * b32::D + c);
    const float4 g = *reinterpret_cast<const float4*>(dout + r * b32::D + c);
    s = a.x * g.x + a.y * g.y + a.z * g.z + a.w * g.w;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (r < rows && threadIdx.x % 16 == 0) {
    // row r = (b N + n) H + h → D[(b H + h) N + n]
    const int h = (int)(r % H);
    const int64_t bn = r / H;
    const int64_t b = bn / N, n = bn % N;
    dvec[(b * H + h) * N + n] = s;
  }
}

// KV: resident keys (A1 = K, A2 = V), streamed queries (B1 = Q, B2 = dO);
// else resident queries (A1 = Q, A2 = dO), streamed keys (B1 = K, B2 = V).
template <bool KV>
__global__ void __launch_bounds__(b32::kThreads, 2)
    attn_bwd_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int N, int M, int H,
                         float scale) {
  using namespace b32;
  extern __shared__ __align__(16) float sm[];
  float* A1 = sm;                          // [R][LD]
  float* A2 = A1 + R * LD;                 // [R][LD]
  float* B1 = A2 + R * LD;                 // [2][T][LD]
  float* B2 = B1 + 2 * T * LD;             // [2][T][LD]
  float* Ps = B2 + 2 * T * LD;             // [T][PLD]: P[t][r]
  float* Gs = Ps + T * PLD;                // [T][PLD]: dS[t][r]
  float* Ls = Gs + T * PLD;                // [2][T] lse of streamed queries
  float* Ds = Ls + 2 * T;                  // [2][T] D of streamed queries
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int z = blockIdx.y, b = z / H, h = z % H, r0 = blockIdx.x * R;
  const int nres = KV ? M : N, nstr = KV ? N : M;
  const int64_t row = (int64_t)H * D;
  const float* qz = q + (int64_t)b * N * row + (int64_t)h * D;
  const float* kz = k + (int64_t)b * M * row + (int64_t)h * D;
  const float* vz = v + (int64_t)b * M * row + (int64_t)h * D;
  const float* gz = dout + (int64_t)b * N * row + (int64_t)h * D;
  const float* a1g = KV ? kz : qz;
  const float* a2g = KV ? vz : gz;
  const float* b1g = KV ? qz : kz;
  const float* b2g = KV ? gz : vz;
  const float* lz = lse + (int64_t)z * N;
  const float* dz = dvec + (int64_t)z * N;

  // a thread copies 16-byte chunk tid % 16 of rows tid / 16 + 8 i
  const int cc = (tid % 16) * 4, cr = tid / 16;
  for (int r = cr; r < R; r += kThreads / 16) {
    const bool in = r0 + r < nres;
    const int64_t off = in ? (int64_t)(r0 + r) * row + cc : 0;
    dft::cp_async16(A1 + r * LD + cc, a1g + off, in);
    dft::cp_async16(A2 + r * LD + cc, a2g + off, in);
  }
  auto load_tile = [&](int buf, int t0) {
    float* b1 = B1 + buf * T * LD;
    float* b2 = B2 + buf * T * LD;
    for (int r = cr; r < T; r += kThreads / 16) {
      const bool in = t0 + r < nstr;
      const int64_t off = in ? (int64_t)(t0 + r) * row + cc : 0;
      dft::cp_async16(b1 + r * LD + cc, b1g + off, in);
      dft::cp_async16(b2 + r * LD + cc, b2g + off, in);
    }
    if (KV && tid < T) {
      const bool in = t0 + tid < N;
      dft::cp_async4(Ls + buf * T + tid, in ? lz + t0 + tid : lz, in);
      dft::cp_async4(Ds + buf * T + tid, in ? dz + t0 + tid : dz, in);
    }
  };
  load_tile(0, 0);
  dft::cp_async_commit();

  // phase 1: resident rows tr + 8 j, tile rows tt + 16 i
  const int tr = warp * 2 + lane / 16, tt = lane % 16;
  // phase 2: resident rows pr*4 .. + 3, columns pd*4 .. + 3 of d
  const int pr = tid / 16, pd = tid % 16;
  float lse_r[4], d_r[4];                 // the resident queries' (not KV)
  if (!KV) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = r0 + tr + 8 * j;
      lse_r[j] = n < N ? lz[n] : 0.f;
      d_r[j] = n < N ? dz[n] : 0.f;
    }
  }
  float acc1[4][4], acc2[4][4];           // KV: dV, dK; else dQ in acc2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc1[i][c] = acc2[i][c] = 0.f;

  const int tiles = (nstr + T - 1) / T;
  for (int it = 0; it < tiles; ++it) {
    dft::cp_async_wait<0>();
    __syncthreads();                       // tile it landed; it - 1 is done
    if (it + 1 < tiles) load_tile((it + 1) & 1, (it + 1) * T);
    dft::cp_async_commit();
    const float* b1 = B1 + (it & 1) * T * LD;
    const float* b2 = B2 + (it & 1) * T * LD;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 x1[4], x2[4], y1[4], y2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x1[j] = *reinterpret_cast<const float4*>(A1 + (tr + 8 * j) * LD + d);
        x2[j] = *reinterpret_cast<const float4*>(A2 + (tr + 8 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y1[i] = *reinterpret_cast<const float4*>(b1 + (tt + 16 * i) * LD + d);
        y2[i] = *reinterpret_cast<const float4*>(b2 + (tt + 16 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(x1[j].x, y1[i].x, s[j][i]);
          s[j][i] = fmaf(x1[j].y, y1[i].y, s[j][i]);
          s[j][i] = fmaf(x1[j].z, y1[i].z, s[j][i]);
          s[j][i] = fmaf(x1[j].w, y1[i].w, s[j][i]);
          dp[j][i] = fmaf(x2[j].x, y2[i].x, dp[j][i]);
          dp[j][i] = fmaf(x2[j].y, y2[i].y, dp[j][i]);
          dp[j][i] = fmaf(x2[j].z, y2[i].z, dp[j][i]);
          dp[j][i] = fmaf(x2[j].w, y2[i].w, dp[j][i]);
        }
    }
    const float* lt = Ls + (it & 1) * T;
    const float* dt = Ds + (it & 1) * T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tt + 16 * i;
      const bool in = it * T + t < nstr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float l = KV ? lt[t] : lse_r[j];
        const float dd = KV ? dt[t] : d_r[j];
        const float p = in ? expf(s[j][i] * scale - l) : 0.f;
        Ps[t * PLD + tr + 8 * j] = p;
        Gs[t * PLD + tr + 8 * j] = p * (dp[j][i] - dd);
      }
    }
    __syncthreads();
    // phase 2: KV: dV += P^T dO (acc1), dK += dS^T Q (acc2); else
    // dQ += dS K (acc2)
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const float4 g4 = *reinterpret_cast<const float4*>(Gs + t * PLD +
                                                         pr * 4);
      const float4 y1 = *reinterpret_cast<const float4*>(b1 + t * LD +
                                                         pd * 4);
      const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
      const float yy1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc2[i][c] = fmaf(gg[i], yy1[c], acc2[i][c]);
      if (KV) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + t * PLD +
                                                           pr * 4);
        const float4 y2 = *reinterpret_cast<const float4*>(b2 + t * LD +
                                                           pd * 4);
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
        const float yy2[4] = {y2.x, y2.y, y2.z, y2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc1[i][c] = fmaf(pp[i], yy2[c], acc1[i][c]);
      }
    }
  }
  dft::cp_async_wait<0>();
  float* out2 = KV ? dk : dq;
  const int64_t zb = (int64_t)b * nres * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + pr * 4 + i;
    if (r >= nres) continue;
    const int64_t at = zb + (int64_t)r * row + pd * 4;
    *reinterpret_cast<float4*>(out2 + at) =
        make_float4(acc2[i][0] * scale, acc2[i][1] * scale,
                    acc2[i][2] * scale, acc2[i][3] * scale);
    if (KV)
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
  }
}

// dq, dk, dv [B, N|M, H, 64] fp32 from q, k, v, o, dout (fp32, 16-byte
// aligned, q's layout) and the forward's lse [B, H, N]; dvec [B*H*N] fp32
// scratch for D = rowsum(dO o O).
extern "C" int attention_bwd_fp32(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* dout, const float* lse,
                                  float* dq, float* dk, float* dv,
                                  float* dvec, int B, int N, int M, int H,
                                  int D, float scale, cudaStream_t stream) {
  using namespace b32;
  if (D != b32::D || M < 1) return (int)cudaErrorInvalidValue;
  if (N == 0 || B * H == 0) return (int)cudaGetLastError();
  static bool set_kv[hop::kMaxDevices] = {}, set_q[hop::kMaxDevices] = {};
  cudaError_t err =
      hop::allow_smem(attn_bwd_fp32_kernel<true>, (int)kSmem, set_kv);
  if (err == cudaSuccess)
    err = hop::allow_smem(attn_bwd_fp32_kernel<false>, (int)kSmem, set_q);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * N * H;
  attn_bwd_fp32_dot_kernel<<<(unsigned)((rows * 16 + 255) / 256), 256, 0,
                             stream>>>(o, dout, dvec, N, H, rows);
  attn_bwd_fp32_kernel<true>
      <<<dim3((M + R - 1) / R, B * H), kThreads, kSmem, stream>>>(
          q, k, v, dout, lse, dvec, dq, dk, dv, N, M, H, scale);
  attn_bwd_fp32_kernel<false>
      <<<dim3((N + R - 1) / R, B * H), kThreads, kSmem, stream>>>(
          q, k, v, dout, lse, dvec, dq, dk, dv, N, M, H, scale);
  return (int)cudaGetLastError();
}
