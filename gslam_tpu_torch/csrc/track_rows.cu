// Per-(tile, slot) EWA projection of the tracking render and its VJP to the
// viewmat, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// gslam_tpu_torch/ops/track_fused.py; each function launches on the stream it
// is given and returns cudaGetLastError().
//
// It replaces no Pallas kernel: the JAX package projects the tracking rows
// in jnp (gslam_tpu/ops/track_fused.py `tracking_rows`) and XLA fuses them
// under jit. In the port the same expression runs eagerly, ~170 elementwise
// launches forward and ~330 in autograd's backward, each over T*M slots,
// many of them sums of a [T, M] gradient onto one of the viewmat's entries.
// These kernels do the evaluation's projection in one launch and its
// gradient in two.
//
//   track_rows_fwd_kernel  one thread per (tile, slot): the world mean and
//       covariance of the slot at the viewmat's pose, the near/far test, the
//       frustum clamp of x/z and y/z, the camera covariance, the EWA conic
//       and its det > 0 test; writes xy [T,2,M], con [T,3,M], op [T,1,M]
//       and feat [T,5,M] (rgb, camera z, beta). Every operation is rounded
//       as the plain version's torch ops round it, in their order
//       (__fmul_rn/__fadd_rn/__fdiv_rn keep nvcc from contracting them into
//       fmas; reciprocals are IEEE), so the rows equal the plain version's
//       on the card bit for bit.
//   track_rows_bwd_kernel  one thread per (tile, slot): the forward again
//       in float32 for its masks (near/far, the clamp's closed interval,
//       det > 0), then the chain from the row cotangents (xy, con and feat's
//       depth channel; op and the other features do not depend on the pose)
//       in float64, through the conic, the Jacobian, the camera covariance
//       and the camera point, to the 12 entries of dL/dR and dL/dt. Nothing
//       is saved by the forward. The block's 256 slots are summed by warp
//       shuffles and then warp by warp in a fixed order, one partial row of
//       12 doubles a block.
//   track_rows_sum_kernel  one block: entry e of the [4, 4] gradient is the
//       fixed-order sum of the blocks' partial rows (warp e, lanes striding
//       over the blocks, then a shuffle tree); row 3 is zero.
// No atomics: two calls on the same inputs give the same bits.
//
// What bounds it: bytes. At T = 300 tiles of M = 512 slots the forward
// reads 14 floats a slot and writes 11 (15.4 MB, 4.6 us at 3.35 TB/s); the
// backward reads 15 (the means, the covariance, 6 cotangents: 9.2 MB). The
// float64 chain is ~300 operations a slot, 46 M at T*M = 153,600, under 2 us
// at the card's 34 TFLOP/s in float64. Each thread reads the camera's 20
// floats from the same addresses (one L1 line each) and its slot's inputs
// coalesced along M.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block of the per-slot kernels
constexpr int kWarps = kThreads / 32;
constexpr int kG = 12;         // dL/dR row-major (9), then dL/dt (3)
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float R[9], t[3];  // viewmat rows 0-2
  float fx, fy, cx, cy;
};

// Scalars as the plain version's torch ops take them: Python floats cast to
// float32 (near, far, eps2d, and 1.3 * 0.5 * width / height, the
// numerators of the clamp limits).
struct Consts {
  float near, far, lim_x_num, lim_y_num, eps2d;
};

__device__ __forceinline__ Cam load_cam(const float* viewmat, const float* K) {
  Cam c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[3 * i + j] = viewmat[4 * i + j];
    c.t[i] = viewmat[4 * i + 3];
  }
  c.fx = K[0];
  c.fy = K[4];
  c.cx = K[2];
  c.cy = K[5];
  return c;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, lo, hi) with tensor limits: NaN passes, else min(max(...)).
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (isnan(v)) return v;
  return fminf(fmaxf(v, lo), hi);
}

// The camera-frame row r . m + t, summed left to right (_camera_point).
__device__ __forceinline__ float cam_row(const float* r, float t, float mx, float my,
                                         float mz) {
  return add(add(add(mul(r[0], mx), mul(r[1], my)), mul(r[2], mz)), t);
}

// (R Sigma) row for R row r (_rotate_cov's row_sigma); w are the world
// covariance's (c00, c01, c02, c11, c12, c22).
__device__ __forceinline__ void row_sigma(const float* r, const float* w, float* s) {
  s[0] = add(add(mul(r[0], w[0]), mul(r[1], w[1])), mul(r[2], w[2]));
  s[1] = add(add(mul(r[0], w[1]), mul(r[1], w[3])), mul(r[2], w[4]));
  s[2] = add(add(mul(r[0], w[2]), mul(r[1], w[4])), mul(r[2], w[5]));
}

__device__ __forceinline__ float dot_row(const float* s, const float* r) {
  return add(add(mul(s[0], r[0]), mul(s[1], r[1])), mul(s[2], r[2]));
}

// One slot's forward in float32, rounded as tracking_rows_plain's torch ops.
struct Fwd {
  float z, xy0, xy1, con0, con1, con2;
  bool in_depth, in_x, in_y, det_ok;
};

__device__ __forceinline__ Fwd forward32(const Cam& c, const Consts& k, float mx, float my,
                                         float mz, const float* w) {
  Fwd f;
  const float px = cam_row(c.R, c.t[0], mx, my, mz);
  const float py = cam_row(c.R + 3, c.t[1], mx, my, mz);
  f.z = cam_row(c.R + 6, c.t[2], mx, my, mz);
  f.in_depth = (f.z > k.near) && (f.z < k.far);
  const float zs = f.in_depth ? f.z : 1.0f;
  // _clamped_tangent: lim = (1.3 * 0.5 * width) / fx is reciprocal(fx) * num
  const float lim_x = mul(__frcp_rn(c.fx), k.lim_x_num);
  const float lim_y = mul(__frcp_rn(c.fy), k.lim_y_num);
  const float rx = dvd(px, zs), ry = dvd(py, zs);
  f.in_x = rx >= -lim_x && rx <= lim_x;  // where torch.clamp passes the gradient
  f.in_y = ry >= -lim_y && ry <= lim_y;
  const float tx = mul(zs, clamp_t(rx, -lim_x, lim_x));
  const float ty = mul(zs, clamp_t(ry, -lim_y, lim_y));
  // _rotate_cov
  float s0[3], s1[3], s2[3];
  row_sigma(c.R, w, s0);
  row_sigma(c.R + 3, w, s1);
  row_sigma(c.R + 6, w, s2);
  const float c00 = dot_row(s0, c.R), c01 = dot_row(s0, c.R + 3), c02 = dot_row(s0, c.R + 6);
  const float c11 = dot_row(s1, c.R + 3), c12 = dot_row(s1, c.R + 6);
  const float c22 = dot_row(s2, c.R + 6);
  // _ewa_conic; 1.0 / z_safe is reciprocal(z_safe) * 1.0
  const float iz = __frcp_rn(zs);
  const float iz2 = mul(iz, iz);
  const float j00 = mul(c.fx, iz);
  const float j02 = mul(mul(-c.fx, tx), iz2);
  const float j11 = mul(c.fy, iz);
  const float j12 = mul(mul(-c.fy, ty), iz2);
  const float a = add(add(mul(j00, add(mul(j00, c00), mul(j02, c02))),
                          mul(j02, add(mul(j00, c02), mul(j02, c22)))), k.eps2d);
  const float b = add(mul(j00, add(mul(j11, c01), mul(j12, c02))),
                      mul(j02, add(mul(j11, c12), mul(j12, c22))));
  const float cc = add(add(mul(j11, add(mul(j11, c11), mul(j12, c12))),
                           mul(j12, add(mul(j11, c12), mul(j12, c22)))), k.eps2d);
  const float det = sub(mul(a, cc), mul(b, b));
  f.det_ok = det > 0.0f;
  const float ds = f.det_ok ? det : 1.0f;
  f.con0 = dvd(cc, ds);
  f.con1 = dvd(-b, ds);
  f.con2 = dvd(a, ds);
  f.xy0 = add(mul(mul(c.fx, px), iz), c.cx);
  f.xy1 = add(mul(mul(c.fy, py), iz), c.cy);
  return f;
}

__global__ void __launch_bounds__(kThreads) track_rows_fwd_kernel(
    const float* __restrict__ viewmat, const float* __restrict__ K,
    const float* __restrict__ m3d, const float* __restrict__ cov6,
    const float* __restrict__ opac, const float* __restrict__ color,
    const float* __restrict__ beta, float* __restrict__ xy, float* __restrict__ con,
    float* __restrict__ op, float* __restrict__ feat, int T, int M, Consts k) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)T * M) return;
  const size_t t = (size_t)(i / M), m = (size_t)(i % M), Ms = (size_t)M;
  const Cam c = load_cam(viewmat, K);
  float w[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = cov6[(t * 6 + j) * Ms + m];
  const float* mp = m3d + t * 3 * Ms + m;
  const Fwd f = forward32(c, k, mp[0], mp[Ms], mp[2 * Ms], w);
  xy[(t * 2 + 0) * Ms + m] = f.xy0;
  xy[(t * 2 + 1) * Ms + m] = f.xy1;
  con[(t * 3 + 0) * Ms + m] = f.con0;
  con[(t * 3 + 1) * Ms + m] = f.con1;
  con[(t * 3 + 2) * Ms + m] = f.con2;
  op[t * Ms + m] = (f.in_depth && f.det_ok) ? opac[t * Ms + m] : 0.0f;
  float* fp = feat + t * 5 * Ms + m;
  const float* cp = color + t * 3 * Ms + m;
  fp[0] = cp[0];
  fp[Ms] = cp[Ms];
  fp[2 * Ms] = cp[2 * Ms];
  fp[3 * Ms] = f.z;
  fp[4 * Ms] = beta[t * Ms + m];
}

// One slot's gradient: the chain in float64 from the float32 forward's
// masks, added to g (dL/dR row-major, then dL/dt). tracking_rows_vjp_plain
// (ops/track_fused.py) is the same chain in torch.
__device__ __forceinline__ void slot_grad(const Cam& c, const Consts& k, const Fwd& f,
                                          const float* m32, const float* w32, double gu,
                                          double gv, double gc0, double gc1, double gc2,
                                          double gz, double* g) {
  double R[9], w[6];
#pragma unroll
  for (int j = 0; j < 9; ++j) R[j] = c.R[j];
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = w32[j];
  const double mx = m32[0], my = m32[1], mz = m32[2];
  const double fx = c.fx, fy = c.fy;
  const double px = R[0] * mx + R[1] * my + R[2] * mz + (double)c.t[0];
  const double py = R[3] * mx + R[4] * my + R[5] * mz + (double)c.t[1];
  const double z = R[6] * mx + R[7] * my + R[8] * mz + (double)c.t[2];
  const double zs = f.in_depth ? z : 1.0;
  const double iz = 1.0 / zs, iz2 = iz * iz;
  const double rx = px / zs, ry = py / zs;
  const double lx = (double)k.lim_x_num / fx, ly = (double)k.lim_y_num / fy;
  const double rcx = f.in_x ? rx : fmin(fmax(rx, -lx), lx);
  const double rcy = f.in_y ? ry : fmin(fmax(ry, -ly), ly);
  const double tx = zs * rcx, ty = zs * rcy;
  // S = R Sigma and the camera covariance S R^T
  const double Sg[9] = {w[0], w[1], w[2], w[1], w[3], w[4], w[2], w[4], w[5]};
  double S[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      S[3 * i + l] = R[3 * i] * Sg[l] + R[3 * i + 1] * Sg[3 + l] + R[3 * i + 2] * Sg[6 + l];
  auto cdot = [&](int i, int j) {
    return S[3 * i] * R[3 * j] + S[3 * i + 1] * R[3 * j + 1] + S[3 * i + 2] * R[3 * j + 2];
  };
  const double c00 = cdot(0, 0), c01 = cdot(0, 1), c02 = cdot(0, 2);
  const double c11 = cdot(1, 1), c12 = cdot(1, 2), c22 = cdot(2, 2);
  const double j00 = fx * iz, j11 = fy * iz;
  const double j02 = -fx * tx * iz2, j12 = -fy * ty * iz2;
  const double u0 = j00 * c00 + j02 * c02, u1 = j00 * c02 + j02 * c22;
  const double v0 = j11 * c01 + j12 * c02, v1 = j11 * c12 + j12 * c22;
  const double w0 = j11 * c11 + j12 * c12;
  const double eps = k.eps2d;
  const double a = j00 * u0 + j02 * u1 + eps;
  const double b = j00 * v0 + j02 * v1;
  const double cc = j11 * w0 + j12 * v1 + eps;
  const double ds = f.det_ok ? a * cc - b * b : 1.0;
  // con = (cc, -b, a) / det_safe
  const double g_ds = -(gc0 * cc - gc1 * b + gc2 * a) / (ds * ds);
  const double g_det = f.det_ok ? g_ds : 0.0;
  const double g_a = gc2 / ds + g_det * cc;
  const double g_cc = gc0 / ds + g_det * a;
  const double g_b = -gc1 / ds - 2.0 * g_det * b;
  // the Jacobian J = [[j00, 0, j02], [0, j11, j12]] and the camera covariance
  const double g_j00 = 2.0 * g_a * u0 + g_b * v0;
  const double g_j02 = 2.0 * g_a * u1 + g_b * v1;
  const double g_j11 = 2.0 * g_cc * w0 + g_b * (j00 * c01 + j02 * c12);
  const double g_j12 = 2.0 * g_cc * v1 + g_b * u1;
  // dL/dC as a symmetric matrix (off-diagonal entries halved); dL/dR += 2 G S
  const double G00 = g_a * j00 * j00, G11 = g_cc * j11 * j11;
  const double G22 = g_a * j02 * j02 + g_b * j02 * j12 + g_cc * j12 * j12;
  const double G01 = 0.5 * g_b * j00 * j11;
  const double G02 = g_a * j00 * j02 + 0.5 * g_b * j00 * j12;
  const double G12 = 0.5 * g_b * j02 * j11 + g_cc * j11 * j12;
  const double G[9] = {G00, G01, G02, G01, G11, G12, G02, G12, G22};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      g[3 * i + l] += 2.0 * (G[3 * i] * S[l] + G[3 * i + 1] * S[3 + l] + G[3 * i + 2] * S[6 + l]);
  // through 1/z, the clamp and the camera point
  const double g_iz2 = -(g_j02 * fx * tx + g_j12 * fy * ty);
  const double g_tx = -g_j02 * fx * iz2, g_ty = -g_j12 * fy * iz2;
  const double g_iz = g_j00 * fx + g_j11 * fy + 2.0 * iz * g_iz2 + gu * fx * px + gv * fy * py;
  const double g_rx = f.in_x ? g_tx * zs : 0.0, g_ry = f.in_y ? g_ty * zs : 0.0;
  const double g_px = gu * fx * iz + g_rx / zs;
  const double g_py = gv * fy * iz + g_ry / zs;
  const double g_zs = g_tx * rcx + g_ty * rcy - g_iz * iz * iz - (g_rx * rx + g_ry * ry) / zs;
  const double g_z = (f.in_depth ? g_zs : 0.0) + gz;
  const double gp[3] = {g_px, g_py, g_z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[3 * i] += gp[i] * mx;
    g[3 * i + 1] += gp[i] * my;
    g[3 * i + 2] += gp[i] * mz;
    g[9 + i] += gp[i];
  }
}

__global__ void __launch_bounds__(kThreads) track_rows_bwd_kernel(
    const float* __restrict__ viewmat, const float* __restrict__ K,
    const float* __restrict__ m3d, const float* __restrict__ cov6,
    const float* __restrict__ g_xy, const float* __restrict__ g_con,
    const float* __restrict__ g_feat, double* __restrict__ partial, int T, int M, Consts k) {
  __shared__ double warp_sums[kWarps][kG];
  double g[kG];
#pragma unroll
  for (int e = 0; e < kG; ++e) g[e] = 0.0;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < (long long)T * M) {
    const size_t t = (size_t)(i / M), m = (size_t)(i % M), Ms = (size_t)M;
    const Cam c = load_cam(viewmat, K);
    float w[6], mv[3];
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = cov6[(t * 6 + j) * Ms + m];
#pragma unroll
    for (int j = 0; j < 3; ++j) mv[j] = m3d[(t * 3 + j) * Ms + m];
    const Fwd f = forward32(c, k, mv[0], mv[1], mv[2], w);
    slot_grad(c, k, f, mv, w, g_xy[(t * 2) * Ms + m], g_xy[(t * 2 + 1) * Ms + m],
              g_con[(t * 3) * Ms + m], g_con[(t * 3 + 1) * Ms + m],
              g_con[(t * 3 + 2) * Ms + m], g_feat[(t * 5 + 3) * Ms + m], g);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kG; ++e) {
    double v = g[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) warp_sums[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < kG) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) s += warp_sums[j][threadIdx.x];
    partial[(size_t)blockIdx.x * kG + threadIdx.x] = s;
  }
}

// 16 warps: warp e writes entry e of the row-major [4, 4] gradient.
__global__ void __launch_bounds__(512) track_rows_sum_kernel(
    const double* __restrict__ partial, int n_blocks, float* __restrict__ g_viewmat) {
  const int lane = threadIdx.x & 31, e = threadIdx.x >> 5;
  const int row = e / 4, col = e % 4;
  if (row == 3) {
    if (lane == 0) g_viewmat[e] = 0.0f;
    return;
  }
  const int src = col < 3 ? 3 * row + col : 9 + row;
  double v = 0.0;
  for (int b = lane; b < n_blocks; b += 32) v += partial[(size_t)b * kG + src];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) g_viewmat[e] = (float)v;
}

int blocks_for(int T, int M) {
  return (int)(((long long)T * M + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The doubles of scratch track_rows_bwd takes for T tiles of M slots, in *n.
int track_rows_bwd_scratch(int T, int M, long long* n) {
  *n = (long long)blocks_for(T, M) * kG;
  return 0;
}

int track_rows_fwd(const float* viewmat, const float* K, const float* m3d, const float* cov6,
                   const float* opac, const float* color, const float* beta, float* xy,
                   float* con, float* op, float* feat, int T, int M, float near, float far,
                   float lim_x_num, float lim_y_num, float eps2d, void* stream) {
  const Consts k{near, far, lim_x_num, lim_y_num, eps2d};
  track_rows_fwd_kernel<<<blocks_for(T, M), kThreads, 0, (cudaStream_t)stream>>>(
      viewmat, K, m3d, cov6, opac, color, beta, xy, con, op, feat, T, M, k);
  return (int)cudaGetLastError();
}

// scratch: track_rows_bwd_scratch(T, M) doubles; g_viewmat: 16 floats.
int track_rows_bwd(const float* viewmat, const float* K, const float* m3d, const float* cov6,
                   const float* g_xy, const float* g_con, const float* g_feat, double* scratch,
                   float* g_viewmat, int T, int M, float near, float far, float lim_x_num,
                   float lim_y_num, float eps2d, void* stream) {
  const Consts k{near, far, lim_x_num, lim_y_num, eps2d};
  const int n_blocks = blocks_for(T, M);
  track_rows_bwd_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      viewmat, K, m3d, cov6, g_xy, g_con, g_feat, scratch, T, M, k);
  int err = (int)cudaGetLastError();
  if (err) return err;
  track_rows_sum_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(scratch, n_blocks, g_viewmat);
  return (int)cudaGetLastError();
}

}  // extern "C"
