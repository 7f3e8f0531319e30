// K3: volume-rendering compositing with the renderer's epilogue, forward and
// closed-form backward, one launch each way.
//
// Replaces dreamfusion_tpu/ops/composite.py::composite_rays (a parallel
// exclusive cumsum over the padded sample axis, gradients from autodiff) and
// the tail of dreamfusion_tpu/models/renderer.py::_shade_and_composite: the
// background and the orient loss.
//
// Bound on the card: memory, and at the step's 4096 rays the latency of one
// small launch.  Per ray the forward reads S sigmas, deltas, z values, mask
// bytes, 3S colours (and 3S normals under the orient loss) and writes S
// weights plus 5 scalars; the arithmetic is two exps per sample.  Design:
// one warp per ray, lanes over samples, 8 rays a block (4096 rays fill 512
// blocks over the 132 SMs).  A row is read by the warp's lanes side by
// side; the [S, 3] rows (colours, normals) as the warp's 3S contiguous
// floats, handed to their sample's lane by shuffles (``load3``).  The
// exclusive sum of sigma*delta is a shuffle scan; S > 32 takes 32-sample
// chunks with the scan's carry.  The backward is one pass: the suffix sum
// sum_{i>k} g^_i w_i by a reverse shuffle scan (for S > 32 the later
// chunks' total from a first pass over them), T recomputed by the forward
// scan.
//
// Semantics kept from the JAX version: sdt = sigma * delta, zero at masked
// samples; alpha = 1 - exp(-sdt), straight-through binarized (alpha > 0.5)
// when asked, with d alpha / d sdt = exp(-sdt) either way; exclusive
// transmittance T, set to 0 where T < t_thresh (no gradient there); weights
// are zero at masked samples.  The epilogue:
//   image  = sum_k w_k rgb_k + (1 - wsum) * bg,   bg = use ? net : colour
//            (colour a constant, or strided over rays and channels; the
//            choice ``use`` read on the device),
//   orient = mean_r sum_k w_k max(<n_k, d_r>, 0)^2,  d_r = rays_d / |rays_d|
//            (w a constant: no gradient through it), finished on the card
//            by the last block; its counter resets itself, so the launch
//            replays in a CUDA graph.
// Backward, with
//   g^_i = g_w[i] + g_wsum - <g_image, bg> + g_depth * z_i + <g_image, rgb_i>,
//   dL/dsdt_k = g^_k * T_k * exp(-sdt_k) - sum_{i>k} g^_i * w_i,
// dL/dsigma_k = mask_k * delta_k * dL/dsdt_k, dL/drgb_k = w_k * g_image,
// dL/dn_k = g_orient / R * 2 w_k max(<n_k, d>, 0) d and, where the
// background MLP's colour is taken, dL/dnet = g_image * (1 - wsum).  A null
// cotangent reads as 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rays a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Background {
  const float* color;      // nullptr: the constant ``value``
  float value;
  int rs, cs;              // colour strides over rays and channels
  const float* net;        // [R, 3] the background MLP's colour, or nullptr
  const uint8_t* use;      // [] bool: take ``net`` (with net), or nullptr
};

__device__ __forceinline__ bool takes_net(const Background& b) {
  return b.net != nullptr && b.use != nullptr && *b.use != 0;
}

__device__ __forceinline__ float bg_at(const Background& b, bool net,
                                       int64_t r, int c) {
  if (net) return b.net[3 * r + c];
  return b.color ? b.color[r * b.rs + c * b.cs] : b.value;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// sum over lanes <= lane
__device__ __forceinline__ float scan_incl(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// sum over lanes >= lane
__device__ __forceinline__ float scan_suffix(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v += u;
  }
  return v;
}

// Lane k's three floats of the `n` (<= 96) contiguous floats at p: the warp
// reads them side by side, then each lane gathers its sample's row.
__device__ __forceinline__ void load3(const float* __restrict__ p, int n,
                                      int lane, float out[3]) {
  const float r0 = lane < n ? p[lane] : 0.f;
  const float r1 = lane + 32 < n ? p[lane + 32] : 0.f;
  const float r2 = lane + 64 < n ? p[lane + 64] : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int j = 3 * lane + c;
    const float a = __shfl_sync(kFull, r0, j & 31);
    const float b = __shfl_sync(kFull, r1, j & 31);
    const float d = __shfl_sync(kFull, r2, j & 31);
    out[c] = j < 32 ? a : (j < 64 ? b : d);
  }
}

// The inverse of load3: lane k's three floats to p[3k..3k+2], stored by the
// warp side by side (the first `n` floats).
__device__ __forceinline__ void store3(float* __restrict__ p, int n, int lane,
                                       const float v[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = lane + 32 * i;
    const int src = j / 3, c = j - 3 * src;
    const float a = __shfl_sync(kFull, v[0], src);
    const float b = __shfl_sync(kFull, v[1], src);
    const float d = __shfl_sync(kFull, v[2], src);
    if (j < n) p[j] = c == 0 ? a : (c == 1 ? b : d);
  }
}

__device__ __forceinline__ void unit_dir(const float* __restrict__ d,
                                         float out[3]) {
  const float x = d[0], y = d[1], z = d[2];
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  out[0] = x * inv;
  out[1] = y * inv;
  out[2] = z * inv;
}

// One chunk of ray r's samples [c0, c0 + 32): the sample's validity, sdt,
// and thresholded exclusive transmittance; `carry` (the sum of the earlier
// chunks' sdt) advances by this chunk's.
struct Sample {
  bool in, valid;
  int64_t i;
  float sdt, T;
};

__device__ __forceinline__ Sample chunk_sample(
    const float* __restrict__ sigma, const float* __restrict__ deltas,
    const uint8_t* __restrict__ mask, int64_t r, int S, int c0, int lane,
    float t_thresh, float& carry) {
  Sample s;
  s.in = c0 + lane < S;
  s.i = r * S + c0 + lane;
  s.valid = s.in && (mask == nullptr || mask[s.i] != 0);
  s.sdt = s.valid ? sigma[s.i] * deltas[s.i] : 0.f;
  const float incl = scan_incl(s.sdt, lane);
  float excl = __shfl_up_sync(kFull, incl, 1);
  excl = (lane == 0 ? 0.f : excl) + carry;
  carry += __shfl_sync(kFull, incl, 31);
  s.T = expf(-excl);
  if (s.T < t_thresh) s.T = 0.f;
  return s;
}

// The grid's mean of one value per warp: each block writes its partial, and
// the last block to finish adds the partials in block order, writes
// sum / R and resets the counter.  Every thread calls it.
__device__ void grid_mean(float v, int R, float* __restrict__ partials,
                          unsigned* __restrict__ done,
                          float* __restrict__ out) {
  __shared__ float s_v[kWarps];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_v[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += s_v[w];
    partials[blockIdx.x] = a;
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float a = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    a += __ldcg(partials + i);                 // past L1: other blocks
  a = warp_sum(a);
  if (lane == 0) s_v[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_v[w];
    *out = t / (float)R;
    *done = 0u;
  }
}

__global__ void __launch_bounds__(kThreads) composite_fwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb,
    const float* __restrict__ z, const float* __restrict__ deltas,
    const uint8_t* __restrict__ mask, int R, int S, float t_thresh,
    int binarize, Background bg, const float* __restrict__ normals,
    const float* __restrict__ rays_d, float* __restrict__ weights,
    float* __restrict__ wsum, float* __restrict__ depth,
    float* __restrict__ image, float* __restrict__ partials,
    unsigned* __restrict__ done, float* __restrict__ loss) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  float orient = 0.f;
  if (r < R) {
    float dir[3] = {0.f, 0.f, 0.f};
    if (normals) unit_dir(rays_d + 3 * r, dir);
    float carry = 0.f, ws = 0.f, d = 0.f, o = 0.f;
    float im[3] = {0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < S; c0 += 32) {
      const Sample s = chunk_sample(sigma, deltas, mask, r, S, c0, lane,
                                    t_thresh, carry);
      float alpha = 1.f - expf(-s.sdt);
      if (binarize) alpha = alpha > 0.5f ? 1.f : 0.f;
      const float w = s.valid ? alpha * s.T : 0.f;
      if (s.in) {
        weights[s.i] = w;
        d += w * z[s.i];
      }
      ws += w;
      const int n3 = 3 * min(32, S - c0);
      float c[3];
      load3(rgb + 3 * (r * S + c0), n3, lane, c);
      im[0] += w * c[0];
      im[1] += w * c[1];
      im[2] += w * c[2];
      if (normals) {
        float n[3];
        load3(normals + 3 * (r * S + c0), n3, lane, n);
        const float p = fmaxf(n[0] * dir[0] + n[1] * dir[1] + n[2] * dir[2],
                              0.f);
        o += w * p * p;
      }
    }
    ws = warp_sum(ws);
    d = warp_sum(d);
#pragma unroll
    for (int c = 0; c < 3; ++c) im[c] = warp_sum(im[c]);
    orient = warp_sum(o);
    if (lane == 0) {
      const bool net = takes_net(bg);
      wsum[r] = ws;
      depth[r] = d;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        image[3 * r + c] = im[c] + (1.f - ws) * bg_at(bg, net, r, c);
    }
  }
  if (normals) grid_mean(orient, R, partials, done, loss);
}

// g^ w of every sample of ray r, summed over the warp: when S > 32, the
// later chunks' part of the suffix sums is this less the chunks so far.
__device__ float gw_total(const float* __restrict__ rgb,
                          const float* __restrict__ z,
                          const float* __restrict__ weights,
                          const float* __restrict__ g_weights, int64_t r,
                          int S, int lane, float gs, float gd,
                          const float gi[3]) {
  float t = 0.f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const bool in = c0 + lane < S;
    const int64_t i = r * S + c0 + lane;
    float c[3];
    load3(rgb + 3 * (r * S + c0), 3 * min(32, S - c0), lane, c);
    if (in) {
      const float gh = (g_weights ? g_weights[i] : 0.f) + gs + gd * z[i] +
                       gi[0] * c[0] + gi[1] * c[1] + gi[2] * c[2];
      t += gh * weights[i];
    }
  }
  return warp_sum(t);
}

__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb,
    const float* __restrict__ z, const float* __restrict__ deltas,
    const uint8_t* __restrict__ mask, const float* __restrict__ weights,
    const float* __restrict__ wsum, int R, int S, float t_thresh,
    const float* __restrict__ g_image, const float* __restrict__ g_depth,
    const float* __restrict__ g_weights, const float* __restrict__ g_wsum,
    Background bg, const float* __restrict__ normals,
    const float* __restrict__ rays_d, const float* __restrict__ g_loss,
    float* __restrict__ g_sigma, float* __restrict__ g_rgb,
    float* __restrict__ g_normals, float* __restrict__ g_bgnet) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const bool net = takes_net(bg);
  float gi[3], bgv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gi[c] = g_image ? g_image[3 * r + c] : 0.f;
    bgv[c] = bg_at(bg, net, r, c);
  }
  const float gd = g_depth ? g_depth[r] : 0.f;
  // the background's (1 - wsum) term moves wsum's cotangent
  const float gs = (g_wsum ? g_wsum[r] : 0.f) -
                   (gi[0] * bgv[0] + gi[1] * bgv[1] + gi[2] * bgv[2]);
  if (g_bgnet && lane == 0) {
    const float keep = net ? 1.f - wsum[r] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) g_bgnet[3 * r + c] = gi[c] * keep;
  }
  float dir[3] = {0.f, 0.f, 0.f};
  float go = 0.f;                       // d loss / d (w max(<n, d>, 0)^2)
  if (g_normals) {
    unit_dir(rays_d + 3 * r, dir);
    go = *g_loss / (float)R;
  }
  // sum of g^ w over the chunks after the current one (all of them, before
  // the first)
  float rest = S > 32 ? gw_total(rgb, z, weights, g_weights, r, S, lane, gs,
                                 gd, gi)
                      : 0.f;
  float carry = 0.f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const Sample s = chunk_sample(sigma, deltas, mask, r, S, c0, lane,
                                  t_thresh, carry);
    const int n3 = 3 * min(32, S - c0);
    float c[3];
    load3(rgb + 3 * (r * S + c0), n3, lane, c);
    float w = 0.f, gh = 0.f;
    if (s.in) {
      w = weights[s.i];
      gh = (g_weights ? g_weights[s.i] : 0.f) + gs + gd * z[s.i] +
           gi[0] * c[0] + gi[1] * c[1] + gi[2] * c[2];
    }
    const float gw = gh * w;
    const float sfx = scan_suffix(gw, lane);            // lanes >= this
    const float later = __shfl_down_sync(kFull, sfx, 1);
    if (S > 32) rest -= __shfl_sync(kFull, sfx, 0);     // this chunk's total
    const float suffix = (lane == 31 ? 0.f : later) + rest;
    if (s.in)
      g_sigma[s.i] = s.valid
          ? (gh * s.T * expf(-s.sdt) - suffix) * deltas[s.i] : 0.f;
    const float gc[3] = {w * gi[0], w * gi[1], w * gi[2]};
    store3(g_rgb + 3 * (r * S + c0), n3, lane, gc);
    if (g_normals) {
      float n[3];
      load3(normals + 3 * (r * S + c0), n3, lane, n);
      const float p = fmaxf(n[0] * dir[0] + n[1] * dir[1] + n[2] * dir[2],
                            0.f);
      const float k = go * w * 2.f * p;
      const float gn[3] = {k * dir[0], k * dir[1], k * dir[2]};
      store3(g_normals + 3 * (r * S + c0), n3, lane, gn);
    }
  }
}

Background make_bg(const float* color, float value, int rs, int cs,
                   const float* net, const uint8_t* use) {
  Background b;
  b.color = color;
  b.value = value;
  b.rs = rs;
  b.cs = cs;
  b.net = net;
  b.use = use;
  return b;
}

// ops/composite.py sizes the orient mean's partials by the same count
int blocks_for(int R) { return (R + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int composite_fwd(
    const float* sigma, const float* rgb, const float* z, const float* deltas,
    const uint8_t* mask, int R, int S, float t_thresh, int binarize,
    const float* bg_color, float bg_value, int bg_rs, int bg_cs,
    const float* bg_net, const uint8_t* use_bg_net, const float* normals,
    const float* rays_d, float* weights, float* wsum, float* depth,
    float* image, float* partials, unsigned* done, float* loss,
    void* stream) {
  if (R > 0) {
    composite_fwd_kernel<<<blocks_for(R), kThreads, 0,
                           (cudaStream_t)stream>>>(
        sigma, rgb, z, deltas, mask, R, S, t_thresh, binarize,
        make_bg(bg_color, bg_value, bg_rs, bg_cs, bg_net, use_bg_net),
        normals, rays_d, weights, wsum, depth, image, partials, done, loss);
  }
  return (int)cudaGetLastError();
}

extern "C" int composite_bwd(
    const float* sigma, const float* rgb, const float* z, const float* deltas,
    const uint8_t* mask, const float* weights, const float* wsum, int R,
    int S, float t_thresh, const float* g_image, const float* g_depth,
    const float* g_weights, const float* g_wsum, const float* bg_color,
    float bg_value, int bg_rs, int bg_cs, const float* bg_net,
    const uint8_t* use_bg_net, const float* normals, const float* rays_d,
    const float* g_loss, float* g_sigma, float* g_rgb, float* g_normals,
    float* g_bgnet, void* stream) {
  if (R > 0) {
    composite_bwd_kernel<<<blocks_for(R), kThreads, 0,
                           (cudaStream_t)stream>>>(
        sigma, rgb, z, deltas, mask, weights, wsum, R, S, t_thresh, g_image,
        g_depth, g_weights, g_wsum,
        make_bg(bg_color, bg_value, bg_rs, bg_cs, bg_net, use_bg_net),
        normals, rays_d, g_loss, g_sigma, g_rgb, g_normals, g_bgnet);
  }
  return (int)cudaGetLastError();
}
