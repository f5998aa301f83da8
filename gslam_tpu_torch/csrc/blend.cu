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
// in shared memory and read by all threads as broadcasts; a pixel skips
// the transmittance math for splats that do not touch it. No early
// termination: the reference composites every splat of the list.
//
// Forward: each pixel walks its splats front to back, one dependent
// log-transmittance update after another. Three things cut that chain:
// - Per-warp culling, as in the backward (below), with warps that cover
//   8x4 pixel blocks (fwd_pixel): a square footprint meets fewer splats
//   than the backward's 16x2 rows. The half of the test that depends on the
//   splat alone (cull_test's box: a log, three divisions, two roots) runs
//   once per block at staging, not once per warp; a lane then compares one
//   box with its warp's rectangle. Culled splats would have added exact
//   zeros, so at S = 1 the outputs are the unculled kernel's, bit for bit.
// - S depth segments per tile (blend_fwd_segments: enough warps for ~32 per
//   SM, at most 1024 threads a block). Segment s composites its contiguous
//   part of the list from T = 1 (pass A); after a barrier it starts from
//   the fixed-order sum `pre` of the earlier segments' log-transmittance,
//   and its accumulators are scaled by exp(pre) and summed in segment
//   order: T_m = exp(pre) * exp(log T within the segment), regrouped.
//   n_touched needs the true T, so segment 0 counts in pass A and a later
//   segment re-walks its splats (pass B) only while some lane's true T is
//   above visibility_min_T. The chain is M / S splats plus pass B.
// - The n_touched ballot runs only while some lane of the warp can count
//   (T never rises), checked at each 32-splat chunk.
//
// Backward: one forward sweep gives the log-transmittance at the end of
// every 32-splat chunk (kept in shared memory) and the total; a
// back-to-front sweep then keeps the running suffix S = sum_{j>m} w_j G_j
// and recovers log T_m by subtraction in log space from its chunk's anchor
// (never by dividing by 1 - alpha). Subtracting from the total alone would
// carry an error of eps * |log T_final| into the front splats, which
// dominate the gradient; the anchors keep the forward's accuracy.
// Two things cut the backward's work:
// - Per-warp culling. At each chunk's start every lane tests one splat of
//   the chunk against the warp's pixel rectangle (cull_keep: a necessary
//   condition for the alpha test, with margins against float32 rounding);
//   a ballot gives the mask and the warp visits only its set bits, in the
//   sweep's order. A culled splat fails the alpha test at every pixel of the
//   warp, so its pairs would have added exact zeros: culling changes no bit
//   of a thread's sums.
// - A reduce-scatter of the 11 per-splat channels (padded to 16): a butterfly
//   of 16 shuffles leaves channel k's warp sum in lanes 2k and 2k+1, where 11
//   shuffle trees took 55. A warp with no contributing pixel for a visited
//   splat skips it; the warps' partials are then summed in a fixed order,
//   skipping those a warp did not write (they are zeros). Deterministic.

#include <algorithm>
#include <cfloat>
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kF = 5;         // blend features: rgb, depth, beta
constexpr int kNC = kF + 6;   // bwd per-splat channels: dfeat[F], dop, dca, dcb, dcc, dx, dy
constexpr int kChunk = 32;    // splats per backward flush of warp partials (one per lane)
constexpr int kNR = 16;       // kNC padded to the reduce-scatter's width
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;        // a block's limit: blend_fwd's P * S
constexpr int kFootW = 8, kFootH = 4;     // blend_fwd's warp footprint (pixels)
constexpr int kWarpsPerSm = 32;           // blend_fwd_segments' aim
// cull_keep's bound on float32 rounding in sigma: |sigma_f - sigma| <=
// kCullGamma * cond(Q) * sigma (a few units of 2^-24 per operation, doubled)
constexpr float kCullGamma = 32.0f / 16777216.0f;

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
// sigma and alpha_raw are rounded op by op in the plain version's order
// (__fmul_rn/__fadd_rn keep nvcc from contracting them into fmas), so the
// kernel keeps exactly the pairs the plain version keeps: contracted, a pair
// within an ulp of alpha_cut could go the other way.
__device__ __forceinline__ bool splat_alpha(const Tile& tl, int m, float px, float py,
                                            float alpha_cut, float alpha_clamp,
                                            float& dx, float& dy, float& a_raw,
                                            float& alpha) {
  dx = px - tl.x[m];
  dy = py - tl.y[m];
  const float sxx = __fmul_rn(__fmul_rn(tl.ca[m], dx), dx);
  const float syy = __fmul_rn(__fmul_rn(tl.cc[m], dy), dy);
  const float sxy = __fmul_rn(__fmul_rn(tl.cb[m], dx), dy);
  const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sxx, syy)), sxy);
  a_raw = __fmul_rn(tl.op[m], expf(-sigma));
  const bool ok = (sigma >= 0.0f) && (a_raw >= alpha_cut);
  alpha = ok ? fminf(a_raw, alpha_clamp) : 0.0f;
  return ok;
}

// The warp's pixel rectangle: min/max of its lanes' coordinates (any tile
// size whose ts*ts is a multiple of 32).
struct Rect { float x0, x1, y0, y1; };

__device__ Rect warp_rect(float px, float py) {
  Rect r{px, px, py, py};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r.x0 = fminf(r.x0, __shfl_xor_sync(kFull, r.x0, off));
    r.x1 = fmaxf(r.x1, __shfl_xor_sync(kFull, r.x1, off));
    r.y0 = fminf(r.y0, __shfl_xor_sync(kFull, r.y0, off));
    r.y1 = fmaxf(r.y1, __shfl_xor_sync(kFull, r.y1, off));
  }
  return r;
}

// Whether rectangle r meets the box of half-extents (ex, ey) around (mx, my).
__device__ __forceinline__ bool box_meets(float mx, float my, float ex, float ey,
                                          const Rect& r) {
  const float gx = fmaxf(fmaxf(r.x0 - mx, mx - r.x1), 0.0f);  // distance to r
  const float gy = fmaxf(fmaxf(r.y0 - my, my - r.y1), 0.0f);
  return gx <= ex && gy <= ey;
}

// Whether splat m can pass the alpha test at some pixel of rectangle r; false
// only where it provably cannot. With Q = [[a, b], [b, c]], sigma(d) =
// d'Qd/2 and L = log(op / alpha_cut), a pass needs sigma <= L; for Q
// positive definite that ellipse lies in |dx| <= sqrt(2 L c / det),
// |dy| <= sqrt(2 L a / det). Margins: L gets 2e-5 + 1e-6 |L| (logf, expf and
// the product op * exp); float32 sigma is within kCullGamma * cond(Q) *
// sigma of the exact one, cond(Q) <= tr^2 / det, so L is divided by
// 1 - q and det is lowered by the same factor (its own rounding is far
// smaller); the extents get a relative 1e-5 (sqrt, division, distance).
// Kept always: a conic that is not positive definite, or q > 1/4. Skipped
// always: L < 0 (op < alpha_cut, including op = 0 and padding).
// warp_cull_plain (ops/blend.py) is the same predicate in torch.
// The test's first half depends on the splat alone: with kBox, cull_test
// writes that half, the box, to box[2] (half-extents around the mean, +inf
// where kept always) instead of testing r, and box_meets is the second half.
// (cull_keep is the kBox = false instance: blend_bwd's code is unchanged.)
template <bool kBox>
__device__ __forceinline__ bool cull_test(const Tile& tl, int m, const Rect& r, float log_cut,
                                          float* box) {
  const float L = logf(tl.op[m]) - log_cut;  // -inf for op = 0, NaN below
  const float Lm = L + 2e-5f + 1e-6f * fabsf(L);
  if (!(Lm >= 0.0f)) return false;
  if (kBox) box[0] = box[1] = INFINITY;
  const float a = tl.ca[m], b = tl.cb[m], c = tl.cc[m];
  const float det = fmaf(a, c, -b * b);
  if (!(a > 0.0f && c > 0.0f && det > 0.0f)) return true;
  const float q = kCullGamma * ((a + c) * (a + c) / det);
  if (!(q <= 0.25f)) return true;
  const float Le = Lm / (1.0f - q);
  const float det_lo = det * (1.0f - q);
  const float ex = sqrtf(2.0f * Le * c / det_lo) * (1.0f + 1e-5f);
  const float ey = sqrtf(2.0f * Le * a / det_lo) * (1.0f + 1e-5f);
  if (kBox) {
    box[0] = ex;
    box[1] = ey;
    return true;
  }
  return box_meets(tl.x[m], tl.y[m], ex, ey, r);
}

__device__ __forceinline__ bool cull_keep(const Tile& tl, int m, const Rect& r,
                                          float log_cut) {
  return cull_test<false>(tl, m, r, log_cut, nullptr);
}

// The chunk's splats [base, base + 32) that the warp must visit: bit j for
// splat base + j. Lane j tests splat base + j, with keep(m) or cull_keep.
template <class Keep>
__device__ __forceinline__ unsigned warp_live(int base, int M, int lane, bool cull,
                                              const Keep& keep) {
  const int m = base + lane;
  return __ballot_sync(kFull, m < M && (!cull || keep(m)));
}

__device__ __forceinline__ unsigned warp_live(const Tile& tl, int base, int M, int lane,
                                              const Rect& r, float log_cut, bool cull) {
  return warp_live(base, M, lane, cull, [&](int m) { return cull_keep(tl, m, r, log_cut); });
}

// Row-major index in the ts x ts tile of blend_fwd's pixel q: warp q / 32
// covers an 8x4 block, blocks in row-major order (ts is a multiple of 8
// whenever ts * ts is a multiple of 32).
__device__ __forceinline__ int fwd_pixel(int q, int ts) {
  const int w = q >> 5, lane = q & 31;
  const int bx = w % (ts / kFootW), by = w / (ts / kFootW);
  return (by * kFootH + lane / kFootW) * ts + bx * kFootW + lane % kFootW;
}

// Threads [s * P, (s + 1) * P) of a block of P * S composite depth segment s,
// splats [s * seg_len, (s + 1) * seg_len) of the tile (seg_len a multiple of
// kChunk). Shared memory: the tile's splats, n_touched [M], each splat's
// cull box half-extents [2][M], each segment's sum of log1p(-alpha) [S][P],
// and segments 1..S-1's scaled accumulators [S-1][P][F].
__global__ void __launch_bounds__(kMaxThreads)
blend_fwd_kernel(const float* __restrict__ xy, const float* __restrict__ con,
                 const float* __restrict__ op, const float* __restrict__ feat,
                 float* __restrict__ out, float* __restrict__ tf, int* __restrict__ touched,
                 int M, int ts, int tiles_x, float alpha_cut, float alpha_clamp, float min_t,
                 int seg_len) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int P = ts * ts;
  const int S = blockDim.x / P;
  const int s = threadIdx.x / P;  // depth segment (warp-uniform: P % 32 == 0)
  const int q = threadIdx.x % P;
  const int lane = q & 31;
  int* s_touched = reinterpret_cast<int*>(smem + (6 + kF) * M);
  float* s_ex = reinterpret_cast<float*>(s_touched + M);  // [M], then s_ey [M]
  float* s_ey = s_ex + M;
  float* s_log = s_ey + M;        // [S][P]
  float* s_acc = s_log + S * P;   // [S-1][P][F]
  const Tile tl = stage_tile(smem, xy, con, op, feat, t, M);
  for (int i = threadIdx.x; i < M; i += blockDim.x) s_touched[i] = 0;
  const bool cull = alpha_cut > 0.0f && alpha_cut <= FLT_MAX;  // else keep every splat
  const float log_cut = logf(alpha_cut);
  __syncthreads();
  // each splat's box, once per block (-1: meets no rectangle)
  for (int i = threadIdx.x; i < M && cull; i += blockDim.x) {
    float box[2];
    if (!cull_test<true>(tl, i, Rect{}, log_cut, box)) box[0] = box[1] = -1.0f;
    s_ex[i] = box[0];
    s_ey[i] = box[1];
  }
  __syncthreads();

  const int pix = fwd_pixel(q, ts);
  const float px = (float)((t % tiles_x) * ts + pix % ts);
  const float py = (float)((t / tiles_x) * ts + pix / ts);
  const Rect rect = warp_rect(px, py);
  const auto keep = [&](int m) { return box_meets(tl.x[m], tl.y[m], s_ex[m], s_ey[m], rect); };
  const int lo = min(s * seg_len, M), hi = min(lo + seg_len, M);

  // pass A: composite the segment from T = 1; segment 0's T is the true one,
  // so it also counts n_touched
  float log_t = 0.0f;  // running sum of log1p(-alpha) over the segment's splats before m
  float acc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = 0.0f;
  for (int base = lo; base < hi; base += kChunk) {
    const bool count = s == 0 && __any_sync(kFull, expf(log_t) > min_t);
    for (unsigned live = warp_live(base, hi, lane, cull, keep); live; live &= live - 1) {
      const int m = base + __ffs(live) - 1;  // lowest set bit first: front to back
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
      if (count) {
        const unsigned hit = __ballot_sync(kFull, ok && T > min_t);
        if (lane == 0 && hit) atomicAdd(&s_touched[m], __popc(hit));  // integer: order-free
      }
    }
  }

  if (S > 1) {
    s_log[s * P + q] = log_t;
    __syncthreads();
    float pre = 0.0f;  // log T at the segment's start: the earlier segments' sums, in order
    for (int r = 0; r < s; ++r) pre += s_log[r * P + q];
    if (s > 0) {
      // pass B: n_touched with the true T = exp(pre + log T within the
      // segment), while some lane's T can still exceed min_t
      float lt = 0.0f;
      for (int base = lo; base < hi && __any_sync(kFull, expf(pre + lt) > min_t);
           base += kChunk) {
        for (unsigned live = warp_live(base, hi, lane, cull, keep); live; live &= live - 1) {
          const int m = base + __ffs(live) - 1;
          float dx, dy, a_raw, alpha;
          const bool ok =
              splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha);
          float T = 0.0f;
          if (ok) {
            T = expf(pre + lt);
            lt += log1pf(-alpha);
          }
          const unsigned hit = __ballot_sync(kFull, ok && T > min_t);
          if (lane == 0 && hit) atomicAdd(&s_touched[m], __popc(hit));
        }
      }
      const float scale = expf(pre);
#pragma unroll
      for (int f = 0; f < kF; ++f) s_acc[((s - 1) * P + q) * kF + f] = acc[f] * scale;
    }
    __syncthreads();
    if (s == 0) {  // the segments' sums, in segment order
      for (int r = 1; r < S; ++r) {
        log_t += s_log[r * P + q];
#pragma unroll
        for (int f = 0; f < kF; ++f) acc[f] += s_acc[((r - 1) * P + q) * kF + f];
      }
    }
  }

  if (s == 0) {
    float* o = out + ((size_t)t * P + pix) * kF;
#pragma unroll
    for (int f = 0; f < kF; ++f) o[f] = acc[f];
    tf[(size_t)t * P + pix] = expf(log_t);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) touched[(size_t)t * M + i] = s_touched[i];
}

// One step of the reduce-scatter: v[0, 2H) -> v[0, H). A lane keeps the
// upper half if bit 2H of its index is set, else the lower, and adds its
// partner's (lane ^ 2H) copy of that half. H is a template constant so that
// every index is one: with H a loop variable the compiler indexed the
// registers at run time, behind a branch on `up` around every shuffle.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kNR], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * H);
  }
}

// Reduce-scatter of 16 per-lane values over the warp: butterfly steps at
// lane offsets 16, 8, 4, 2, then a last exchange at offset 1 completes the
// sum; 8 + 4 + 2 + 1 + 1 = 16 shuffles. Returns the warp sum of value
// lane >> 1 (lanes 2k and 2k+1 both hold value k). Each value's sum pairs
// lanes in the same tree as a shfl_down tree, so it is bit-identical to one.
__device__ __forceinline__ float warp_reduce_scatter16(float (&v)[kNR], int lane) {
  static_assert(kNR == 16, "the steps below halve 16 values four times");
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
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
  unsigned* s_wrote = reinterpret_cast<unsigned*>(s_part + n_warps * kNC * kChunk);  // [n_warps]
  float* s_anchor = reinterpret_cast<float*>(s_wrote + n_warps);  // [n_chunks][P]
  const Tile tl = stage_tile(smem, xy, con, op, feat, t, M);
  __syncthreads();

  const float px = (float)((t % tiles_x) * ts + p % ts);
  const float py = (float)((t / tiles_x) * ts + p / ts);
  const Rect rect = warp_rect(px, py);
  const bool cull = alpha_cut > 0.0f && alpha_cut <= FLT_MAX;  // else keep every splat
  const float log_cut = logf(alpha_cut);
  float g[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) g[f] = g_out[((size_t)t * P + p) * kF + f];
  const float gtf = g_tf[(size_t)t * P + p];

  // sweep 1 (front to back, the forward's order): the inclusive
  // log-transmittance at the end of every chunk, and the total
  float log_total = 0.0f;
  for (int base = 0; base < M; base += kChunk) {
    for (unsigned live = warp_live(tl, base, M, lane, rect, log_cut, cull); live;
         live &= live - 1) {
      const int m = base + __ffs(live) - 1;  // lowest set bit first
      float dx, dy, a_raw, alpha;
      if (splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha))
        log_total += log1pf(-alpha);
    }
    s_anchor[(base / kChunk) * P + p] = log_total;
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
    unsigned wrote = 0;  // splats of the chunk whose partials this warp wrote
    for (unsigned live = warp_live(tl, base, M, lane, rect, log_cut, cull); live;) {
      const int j = 31 - __clz(live);  // highest set bit first
      live &= ~(1u << j);
      const int m = base + j;
      float dx, dy, a_raw, alpha;
      const bool ok = splat_alpha(tl, m, px, py, alpha_cut, alpha_clamp, dx, dy, a_raw, alpha);
      if (!__any_sync(kFull, ok)) continue;
      float c[kNR];
#pragma unroll
      for (int k = 0; k < kNR; ++k) c[k] = 0.0f;
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
      const float v = warp_reduce_scatter16(c, lane);
      const int k = lane >> 1;
      if (!(lane & 1) && k < kNC) s_part[((size_t)warp * kNC + k) * kChunk + j] = v;
      wrote |= 1u << j;
    }
    if (lane == 0) s_wrote[warp] = wrote;
    __syncthreads();
    // fixed-order sum of the warp partials, then write this chunk's splats
    for (int i = p; i < kNC * kChunk; i += P) {
      const int k = i / kChunk;
      const int j = i % kChunk;
      const int m = base + j;
      if (m >= top) continue;
      float v = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        if ((s_wrote[w] >> j) & 1u) v += s_part[((size_t)w * kNC + k) * kChunk + j];
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

size_t fwd_smem_bytes(int M, int ts, int S) {
  const size_t P = (size_t)ts * ts;
  return (size_t)(6 + kF) * M * sizeof(float) +  // the tile's splats
         (size_t)M * sizeof(int) +                // n_touched
         (size_t)2 * M * sizeof(float) +          // cull boxes
         (size_t)S * P * sizeof(float) +          // segment sums of log1p(-alpha)
         (size_t)(S - 1) * P * kF * sizeof(float);  // segments 1..S-1's accumulators
}

// Splats per segment: the tile's 32-splat chunks shared out over S segments.
int fwd_seg_len(int M, int S) {
  const int n_chunks = (M + kChunk - 1) / kChunk;
  return (n_chunks + S - 1) / S * kChunk;
}

size_t bwd_smem_bytes(int M, int ts) {
  const int n_warps = ts * ts / 32;
  const int n_chunks = (M + kChunk - 1) / kChunk;
  return (size_t)(6 + kF) * M * sizeof(float) +               // the tile's splats
         (size_t)n_warps * kNC * kChunk * sizeof(float) +      // warp partials
         (size_t)n_warps * sizeof(unsigned) +                   // which partials were written
         (size_t)n_chunks * ts * ts * sizeof(float);            // chunk anchors
}

}  // namespace

extern "C" {

// blend_fwd's depth segments per tile on the current card: the fewest that
// give ~kWarpsPerSm warps per SM over T tiles, at most 1024 threads a block
// and no more than the tile's 32-splat chunks.
int blend_fwd_segments(int T, int M, int ts, int* S) {
  int dev = 0, n_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long warps = std::max((long)T * (ts * ts / 32), 1L);  // one segment's, over T tiles
  const long want = ((long)kWarpsPerSm * n_sm + warps - 1) / warps;
  const int s_max = std::min(kMaxThreads / (ts * ts), std::max((M + kChunk - 1) / kChunk, 1));
  *S = (int)std::max(1L, std::min(want, (long)s_max));
  return 0;
}

// blend_fwd with S depth segments per tile (1 <= S, ts * ts * S <= 1024).
int blend_fwd_split(const float* xy, const float* con, const float* op, const float* feat,
                    float* out, float* tf, int* touched, int T, int M, int ts, int tiles_x,
                    float alpha_cut, float alpha_clamp, float min_t, int S, void* stream) {
  if (S < 1 || ts * ts * S > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(M, ts, S);
  int err = set_smem((const void*)blend_fwd_kernel, smem);
  if (err) return err;
  blend_fwd_kernel<<<T, ts * ts * S, smem, (cudaStream_t)stream>>>(
      xy, con, op, feat, out, tf, touched, M, ts, tiles_x, alpha_cut, alpha_clamp, min_t,
      fwd_seg_len(M, S));
  return (int)cudaGetLastError();
}

int blend_fwd(const float* xy, const float* con, const float* op, const float* feat,
              float* out, float* tf, int* touched, int T, int M, int ts, int tiles_x,
              float alpha_cut, float alpha_clamp, float min_t, void* stream) {
  int S = 1;
  const int err = blend_fwd_segments(T, M, ts, &S);
  if (err) return err;
  return blend_fwd_split(xy, con, op, feat, out, tf, touched, T, M, ts, tiles_x, alpha_cut,
                         alpha_clamp, min_t, S, stream);
}

int blend_bwd(const float* xy, const float* con, const float* op, const float* feat,
              const float* g_out, const float* g_tf, float* dxy, float* dcon, float* dop,
              float* dfeat, int T, int M, int ts, int tiles_x, float alpha_cut,
              float alpha_clamp, void* stream) {
  const size_t smem = bwd_smem_bytes(M, ts);
  int err = set_smem((const void*)blend_bwd_kernel, smem);
  if (err) return err;
  blend_bwd_kernel<<<T, ts * ts, smem, (cudaStream_t)stream>>>(
      xy, con, op, feat, g_out, g_tf, dxy, dcon, dop, dfeat, M, ts, tiles_x, alpha_cut,
      alpha_clamp);
  return (int)cudaGetLastError();
}

// What a kernel takes on this card at its launch shape (M, ts and, for
// blend_fwd, S segments): kernel 0 is blend_fwd, 1 blend_bwd. out[0]
// registers per thread, out[1] dynamic shared memory per block (bytes),
// out[2] local memory per thread (bytes; spills), out[3] resident blocks
// per SM.
int blend_resources(int kernel, int M, int ts, int S, int* out) {
  if (kernel != 0 && kernel != 1) return (int)cudaErrorInvalidValue;
  const void* fn = kernel == 0 ? (const void*)blend_fwd_kernel : (const void*)blend_bwd_kernel;
  const int threads = kernel == 0 ? ts * ts * S : ts * ts;
  const size_t smem = kernel == 0 ? fwd_smem_bytes(M, ts, S) : bwd_smem_bytes(M, ts);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  err = set_smem(fn, smem);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return err;
}

}  // extern "C"
