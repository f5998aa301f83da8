// Per-tile alpha compositing of Gaussian splats, forward and backward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// gslam_tpu_torch/ops/blend.py; each function launches on the stream it is
// given and returns cudaGetLastError().
//
// blend_fwd replaces the Pallas kernel `_fwd_kernel` launched by `_run_fwd`
// (gslam_tpu/ops/blend_pallas.py:104-133, 199-220). blend_bwd replaces
// `_bwd_kernel` launched by `_run_bwd` (blend_pallas.py:136-188, 223-246),
// the custom VJP of `_blend_core`.
//
// Layout (splat-minor rows, as the Pallas kernels take them), F = 5:
//   xy [T,2,M], con [T,3,M] (a, b, c), op [T,1,M], feat [T,F,M]
//   fwd out: out [T,P,F], tf [T,P], touched [T,M] int32
//   bwd in:  g_out [T,P,F], g_tf [T,P]
//   bwd out: dxy [T,2,M], dcon [T,3,M], dop [T,1,M], dfeat [T,F,M]
// Gradients are per (tile, slot): no atomics, so results are deterministic
// and the caller reduces them.
//
// What bounds it: operations, not bytes. One frame's full-resolution
// render is T*P*M = 300*256*512 = 39.3 M (pixel, splat) pairs, each with an
// exp for the Gaussian falloff and, where the splat contributes, a log1p
// and an exp for the transmittance, against ~6.8 MB of inputs. The
// transcendentals run on the SM's special-function units, a quarter of the
// float32 rate. The design keeps every operand on chip: one block per tile,
// one thread per pixel (P = 256), the tile's 11*M splat floats staged once
// in shared memory and read by all 256 threads as broadcasts; a pixel skips
// the transmittance math for splats that do not touch it. No early
// termination: the reference composites every splat of the list.
//
// Backward: one forward sweep gives the log-transmittance at the end of
// every 32-splat chunk (kept in shared memory) and the total; a
// back-to-front sweep then keeps the running suffix S = sum_{j>m} w_j G_j
// and recovers log T_m by subtraction in log space from its chunk's anchor
// (never by dividing by 1 - alpha). Subtracting from the total alone would
// carry an error of eps * |log T_final| into the front splats, which
// dominate the gradient; the anchors keep the forward's accuracy. Per-splat sums over the 256 pixels are warp-shuffle trees,
// then a fixed-order sum of the 8 warp partials in shared memory; a warp
// with no contributing pixel for a splat skips its shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 5;         // blend features: rgb, depth, beta
constexpr int kNC = kF + 6;   // bwd per-splat channels: dfeat[F], dop, dca, dcb, dcc, dx, dy
constexpr int kChunk = 32;    // splats per backward flush of warp partials
constexpr unsigned kFull = 0xffffffffu;

struct Tile {
  const float* x; const float* y;
  const float* ca; const float* cb; const float* cc;
  const float* op; const float* feat;  // feat: F rows of M
};

// Stage one tile's 11*M splat floats into shared memory.
__device__ Tile stage_tile(float* s, const float* xy, const float* con,
                           const float* op, const float* feat, int t, int M) {
  const int n_xy = 2 * M, n_con = 3 * M, n_op = M, n_feat = kF * M;
  const float* g_xy = xy + (size_t)t * n_xy;
  const float* g_con = con + (size_t)t * n_con;
  const float* g_op = op + (size_t)t * n_op;
  const float* g_feat = feat + (size_t)t * n_feat;
  for (int i = threadIdx.x; i < n_xy; i += blockDim.x) s[i] = g_xy[i];
  for (int i = threadIdx.x; i < n_con; i += blockDim.x) s[n_xy + i] = g_con[i];
  for (int i = threadIdx.x; i < n_op; i += blockDim.x) s[n_xy + n_con + i] = g_op[i];
  for (int i = threadIdx.x; i < n_feat; i += blockDim.x)
    s[n_xy + n_con + n_op + i] = g_feat[i];
  Tile tl;
  tl.x = s; tl.y = s + M;
  tl.ca = s + 2 * M; tl.cb = s + 3 * M; tl.cc = s + 4 * M;
  tl.op = s + 5 * M; tl.feat = s + 6 * M;
  return tl;
}

// Effective alpha of splat m at pixel (px, py); returns whether it counts
// (sigma >= 0 and alpha_raw >= alpha_cut) and the raw/clamped alpha.
__device__ __forceinline__ bool splat_alpha(const Tile& tl, int m, float px, float py,
                                            float alpha_cut, float alpha_clamp,
                                            float& dx, float& dy, float& a_raw,
                                            float& alpha) {
  dx = px - tl.x[m];
  dy = py - tl.y[m];
  const float sigma = 0.5f * (tl.ca[m] * dx * dx + tl.cc[m] * dy * dy) + tl.cb[m] * dx * dy;
  a_raw = tl.op[m] * expf(-sigma);
  const bool ok = (sigma >= 0.0f) && (a_raw >= alpha_cut);
  alpha = ok ? fminf(a_raw, alpha_clamp) : 0.0f;
  return ok;
}

__global__ void blend_fwd_kernel(const float* __restrict__ xy, const float* __restrict__ con,
                                 const float* __restrict__ op, const float* __restrict__ feat,
                                 float* __restrict__ out, float* __restrict__ tf,
                                 int* __restrict__ touched, int M, int ts, int tiles_x,
                                 float alpha_cut, float alpha_clamp, float min_t) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  int* s_touched = reinterpret_cast<int*>(smem + (6 + kF) * M);
  const Tile tl = stage_tile(smem, xy, con, op, feat, t, M);
  for (int i = p; i < M; i += P) s_touched[i] = 0;
  __syncthreads();

  const float px = (float)((t % tiles_x) * ts + p % ts);
  const float py = (float)((t / tiles_x) * ts + p / ts);
  float log_t = 0.0f;  // running sum of log1p(-alpha) over splats before m
  float acc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = 0.0f;

  for (int m = 0; m < M; ++m) {
    float dx, dy, a_raw, alpha;
    const bool ok = splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha);
    float T = 0.0f;
    if (ok) {
      T = expf(log_t);
      const float w = alpha * T;
#pragma unroll
      for (int f = 0; f < kF; ++f) acc[f] += w * tl.feat[f * M + m];
      log_t += log1pf(-alpha);
    }
    const unsigned hit = __ballot_sync(kFull, ok && T > min_t);
    if (lane == 0 && hit) atomicAdd(&s_touched[m], __popc(hit));  // integer: order-free
  }

  float* o = out + ((size_t)t * P + p) * kF;
#pragma unroll
  for (int f = 0; f < kF; ++f) o[f] = acc[f];
  tf[(size_t)t * P + p] = expf(log_t);
  __syncthreads();
  for (int i = p; i < M; i += P) touched[(size_t)t * M + i] = s_touched[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void blend_bwd_kernel(const float* __restrict__ xy, const float* __restrict__ con,
                                 const float* __restrict__ op, const float* __restrict__ feat,
                                 const float* __restrict__ g_out, const float* __restrict__ g_tf,
                                 float* __restrict__ dxy, float* __restrict__ dcon,
                                 float* __restrict__ dop, float* __restrict__ dfeat,
                                 int M, int ts, int tiles_x, float alpha_cut,
                                 float alpha_clamp) {
  extern __shared__ float smem[];
  if (M == 0) return;  // no slots: the outputs are empty
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = P >> 5;
  float* s_part = smem + (6 + kF) * M;  // [n_warps][kNC][kChunk]
  float* s_anchor = s_part + n_warps * kNC * kChunk;  // [n_chunks][P]
  const Tile tl = stage_tile(smem, xy, con, op, feat, t, M);
  __syncthreads();

  const float px = (float)((t % tiles_x) * ts + p % ts);
  const float py = (float)((t / tiles_x) * ts + p / ts);
  float g[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) g[f] = g_out[((size_t)t * P + p) * kF + f];
  const float gtf = g_tf[(size_t)t * P + p];

  // sweep 1 (front to back, the forward's order): the inclusive
  // log-transmittance at the end of every chunk, and the total
  float log_total = 0.0f;
  for (int m = 0; m < M; ++m) {
    float dx, dy, a_raw, alpha;
    if (splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha))
      log_total += log1pf(-alpha);
    if ((m + 1) % kChunk == 0 || m == M - 1) s_anchor[(m / kChunk) * P + p] = log_total;
  }
  const float t_final = expf(log_total);
  const float gtf_tf = gtf * t_final;

  // sweep 2 (back to front): running suffix S; inclusive log T restarts
  // from the forward's value at each chunk's end, so it is subtracted over
  // at most kChunk splats and keeps the forward's accuracy where T is large
  float S = 0.0f;
  for (int base = ((M - 1) / kChunk) * kChunk; base >= 0; base -= kChunk) {
    const int top = min(base + kChunk, M);
    float log_incl = s_anchor[(base / kChunk) * P + p];
    for (int m = top - 1; m >= base; --m) {
      float dx, dy, a_raw, alpha;
      const bool ok = splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha);
      float c[kNC];
#pragma unroll
      for (int k = 0; k < kNC; ++k) c[k] = 0.0f;
      if (ok) {
        const float log1m = log1pf(-alpha);
        const float log_excl = log_incl - log1m;
        const float T = expf(log_excl);
        const float w = alpha * T;
        float G = 0.0f;
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const float fv = tl.feat[f * M + m];
          G += g[f] * fv;
          c[f] = g[f] * w;
        }
        const float one_m = 1.0f - alpha;
        float g_alpha = T * G - S / one_m - gtf_tf / one_m;
        if (!(a_raw < alpha_clamp)) g_alpha = 0.0f;
        const float g_sigma = -alpha * g_alpha;
        const float ca = tl.ca[m], cb = tl.cb[m], cc = tl.cc[m];
        c[kF] = g_alpha * alpha;
        c[kF + 1] = 0.5f * dx * dx * g_sigma;
        c[kF + 2] = dx * dy * g_sigma;
        c[kF + 3] = 0.5f * dy * dy * g_sigma;
        c[kF + 4] = -(ca * dx + cb * dy) * g_sigma;
        c[kF + 5] = -(cb * dx + cc * dy) * g_sigma;
        S += w * G;
        log_incl = log_excl;
      }
      float* part = s_part + (size_t)warp * kNC * kChunk + (m - base);
      if (__any_sync(kFull, ok)) {
#pragma unroll
        for (int k = 0; k < kNC; ++k) {
          const float v = warp_sum(c[k]);
          if (lane == 0) part[k * kChunk] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kNC; ++k) part[k * kChunk] = 0.0f;
      }
    }
    __syncthreads();
    // fixed-order sum of the warp partials, then write this chunk's splats
    for (int i = p; i < kNC * kChunk; i += P) {
      const int k = i / kChunk;
      const int j = i % kChunk;
      const int m = base + j;
      if (m >= top) continue;
      float v = 0.0f;
      for (int w = 0; w < n_warps; ++w) v += s_part[((size_t)w * kNC + k) * kChunk + j];
      if (k < kF) {
        dfeat[((size_t)t * kF + k) * M + m] = v;
      } else if (k == kF) {
        dop[(size_t)t * M + m] = v / fmaxf(tl.op[m], 1e-12f);
      } else if (k < kF + 4) {
        dcon[((size_t)t * 3 + (k - kF - 1)) * M + m] = v;
      } else {
        dxy[((size_t)t * 2 + (k - kF - 4)) * M + m] = v;
      }
    }
    __syncthreads();
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

int blend_fwd(const float* xy, const float* con, const float* op, const float* feat,
              float* out, float* tf, int* touched, int T, int M, int ts, int tiles_x,
              float alpha_cut, float alpha_clamp, float min_t, void* stream) {
  const size_t smem = (size_t)(6 + kF) * M * sizeof(float) + (size_t)M * sizeof(int);
  int err = set_smem((const void*)blend_fwd_kernel, smem);
  if (err) return err;
  blend_fwd_kernel<<<T, ts * ts, smem, (cudaStream_t)stream>>>(
      xy, con, op, feat, out, tf, touched, M, ts, tiles_x, alpha_cut, alpha_clamp, min_t);
  return (int)cudaGetLastError();
}

int blend_bwd(const float* xy, const float* con, const float* op, const float* feat,
              const float* g_out, const float* g_tf, float* dxy, float* dcon, float* dop,
              float* dfeat, int T, int M, int ts, int tiles_x, float alpha_cut,
              float alpha_clamp, void* stream) {
  const int n_warps = ts * ts / 32;
  const int n_chunks = (M + kChunk - 1) / kChunk;
  const size_t smem = (size_t)(6 + kF) * M * sizeof(float) +
                      (size_t)n_warps * kNC * kChunk * sizeof(float) +
                      (size_t)n_chunks * ts * ts * sizeof(float);
  int err = set_smem((const void*)blend_bwd_kernel, smem);
  if (err) return err;
  blend_bwd_kernel<<<T, ts * ts, smem, (cudaStream_t)stream>>>(
      xy, con, op, feat, g_out, g_tf, dxy, dcon, dop, dfeat, M, ts, tiles_x, alpha_cut,
      alpha_clamp);
  return (int)cudaGetLastError();
}

}  // extern "C"
