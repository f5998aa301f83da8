// Tile binning of projected splats for every camera of a render at once, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// gslam_tpu_torch/ops/binning.py; each function launches on the stream it is
// given and returns cudaGetLastError() (bin_sort: cub's error).
//
// It replaces no Pallas kernel: the JAX package bins in jnp
// (gslam_tpu/ops/binning.py), and the port's plain version,
// `bin_gaussians`, builds an [N, max_span^2] pair grid, selects from it with
// boolean masks (a host sync each) and sorts 64-bit keys with torch.sort,
// one camera at a time. These kernels give the same tile lists, bit for
// bit, for C cameras of N splats in one pass with no host sync and no
// [N, K] tensor. With P = max_pairs pair slots a camera and T tiles:
//
//   bin_count       [C, N]: each splat's tile rectangle and pair count, the
//                   plain version's arithmetic operation for operation;
//   bin_scan        one cub inclusive sum over the C N counts: camera c's
//                   offsets are its stretch less the sum before it, and the
//                   pairs it wants are its stretch's last offset;
//   bin_emit        [C, P]: slot s < min(wanted, P) finds its splat i by
//                   binary search over the camera's offsets, j = s - excl[i],
//                   dx = j % span_x, dy = j / span_x, and writes the key
//                   (c (T + 1) + tile) << 32 | ordered(depth) and the value i;
//                   every later slot the sentinel (tile T, depth +inf, id 0).
//                   These are the plain version's slots, in its order;
//   bin_sort        one stable cub radix sort of the C P pairs over the key's
//                   low 32 + bits(C (T + 1) - 1) bits: the camera prefix
//                   keeps each camera's P slots together, and stability keeps
//                   the plain version's order among equal keys;
//   bin_tile_lists  [C, T]: each tile's range by binary search over its
//                   camera's sorted keys, its first `capacity` ids (slots
//                   past the count take the camera's first sorted id, as the
//                   plain gather of index 0 does), its mask, its count, and
//                   the camera's wanted pairs as int32.
// bin_temp_bytes sizes the cub scratch that the scan and the sort share.
//
// What bounds it: bytes. At 640x480 (T = 1,200), 10 cameras of 2^20 slots
// and 4 pairs a splat it reads the splats (~17 MB a camera), writes 42 M
// 12-byte pairs, sorts them in 6 passes of 8 bits (~1 GB moved a pass) and
// gathers 3 M list entries: ~7 GB, ~2 ms at 3.35 TB/s. The design keeps
// every pass one streaming read and write: the emit's binary search is
// narrowed per block to the splats between its first and last slot, so its
// reads stay in L1/L2, and the tile lists read only the ranges they copy.
// No atomics: the output is deterministic.

#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kEmitItems = 8;  // slots a thread of bin_emit writes

// floor(v / ts) clamped to [0, hi - 1], as the plain version's tile_of: IEEE
// division (no fast math), then the clamp in float and the conversion.
// Invalid splats may carry NaN; their tiles are never read.
__device__ __forceinline__ int tile_of(float v, int ts, int hi) {
  const float f = floorf(v / (float)ts);
  return (int)fminf(fmaxf(f, 0.0f), (float)(hi - 1));
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// float32 -> 32-bit unsigned whose integer order is the float order.
__device__ __forceinline__ unsigned long long ordered_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (int)u < 0 ? 0xFFFFFFFFull - u : (unsigned long long)u + 0x80000000ull;
}

// First index in [lo, hi) whose offset exceeds q (hi where none does).
__device__ __forceinline__ int first_above(const long long* __restrict__ off, int lo, int hi,
                                           long long q) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (off[mid] > q) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// geom[k] = (tx0, ty0, span_x, span_y), counts[k] = span_x span_y or 0, for
// the C N splats of means2d [C, N, 2], radii [C, N], valid [C, N].
__global__ void bin_count_kernel(const float* __restrict__ means2d,
                                 const float* __restrict__ radii,
                                 const unsigned char* __restrict__ valid, int4* __restrict__ geom,
                                 long long* __restrict__ counts, long long total, int ts,
                                 int tiles_x, int tiles_y, int max_span) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const float x = means2d[2 * k], y = means2d[2 * k + 1];
  const float r = radii[k];
  int tx0 = tile_of(x - r, ts, tiles_x);
  const int tx1 = tile_of(x + r, ts, tiles_x);
  int ty0 = tile_of(y - r, ts, tiles_y);
  const int ty1 = tile_of(y + r, ts, tiles_y);
  int span_x = tx1 - tx0 + 1;
  int span_y = ty1 - ty0 + 1;
  // an oversized footprint becomes a max_span window centred on the splat
  if (span_x > max_span) {
    tx0 = clamp_int(tile_of(x, ts, tiles_x) - max_span / 2, 0, tiles_x - max_span);
    span_x = max_span;
  }
  if (span_y > max_span) {
    ty0 = clamp_int(tile_of(y, ts, tiles_y) - max_span / 2, 0, tiles_y - max_span);
    span_y = max_span;
  }
  geom[k] = make_int4(tx0, ty0, span_x, span_y);
  counts[k] = valid[k] ? span_x * span_y : 0;
}

// The sum of the counts of the cameras before camera c, in the inclusive
// scan over all C N counts: camera c's offsets are its stretch less this.
__device__ __forceinline__ long long camera_base(const long long* __restrict__ incl, int c,
                                                 int N) {
  return c > 0 ? incl[(long long)c * N - 1] : 0;
}

// Grid (ceil(P / (kThreads kEmitItems)), C): a block writes kThreads
// kEmitItems consecutive slots, each thread every kThreads-th of them.
__global__ void bin_emit_kernel(const long long* __restrict__ incl, const int4* __restrict__ geom,
                                const float* __restrict__ depths,
                                unsigned long long* __restrict__ keys, int* __restrict__ vals,
                                int N, long long P, int T, int tiles_x) {
  const int c = blockIdx.y;
  const long long s0 = (long long)blockIdx.x * kThreads * kEmitItems;
  const long long* off = incl + (long long)c * N;
  const long long base = camera_base(incl, c, N);
  const long long live = min(off[N - 1] - base, P);  // slots that hold a pair
  // the splats of the block's first and last live slot bound every search
  __shared__ int bounds[2];
  if (threadIdx.x < 2) {
    const long long q = threadIdx.x == 0 ? s0 : min(s0 + kThreads * kEmitItems, live) - 1;
    bounds[threadIdx.x] = q >= s0 && q < live ? first_above(off, 0, N, base + q) : 0;
  }
  __syncthreads();
  const unsigned long long cam = (unsigned long long)c * (T + 1);
  int i = bounds[0];  // a thread's slots rise, and so do their splats
  for (int item = 0; item < kEmitItems; ++item) {
    const long long s = s0 + (long long)item * kThreads + threadIdx.x;
    if (s >= P) return;
    unsigned long long key;
    int val;
    if (s < live) {
      i = first_above(off, i, bounds[1] + 1, base + s);
      const long long k = (long long)c * N + i;
      const int4 g = geom[k];  // a splat with pairs is valid: its count is span_x span_y
      const int j = (int)(base + s - (off[i] - (long long)g.z * g.w));
      const int tile = (g.y + j / g.z) * tiles_x + g.x + j % g.z;
      key = ((cam + tile) << 32) | ordered_bits(depths[k]);
      val = i;
    } else {
      key = ((cam + T) << 32) | ordered_bits(__int_as_float(0x7f800000));  // +inf
      val = 0;
    }
    keys[c * P + s] = key;
    vals[c * P + s] = val;
  }
}

// Grid (T, C): one block a tile.
__global__ void bin_tile_lists_kernel(const unsigned long long* __restrict__ keys,
                                      const int* __restrict__ vals,
                                      const long long* __restrict__ incl,
                                      int* __restrict__ tile_gauss,
                                      unsigned char* __restrict__ tile_mask,
                                      int* __restrict__ tile_counts, int* __restrict__ n_pairs,
                                      int N, long long P, int T, int capacity) {
  const int t = blockIdx.x, c = blockIdx.y;
  const unsigned long long* k = keys + c * P;
  const int* v = vals + c * P;
  // thread 0: the first sorted slot of tile t; thread 1: of tile t + 1
  __shared__ long long range[2];
  if (threadIdx.x < 2) {
    const unsigned long long want = (unsigned long long)c * (T + 1) + t + threadIdx.x;
    long long lo = 0, hi = P;
    while (lo < hi) {
      const long long mid = lo + (hi - lo) / 2;
      if ((k[mid] >> 32) < want) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    range[threadIdx.x] = lo;
  }
  __syncthreads();
  const long long start = range[0];
  const long long count = range[1] - start;
  const int first = v[0];
  const long long row = ((long long)c * T + t) * capacity;
  for (int m = threadIdx.x; m < capacity; m += blockDim.x) {
    const bool live = m < count;
    tile_gauss[row + m] = live ? v[start + m] : first;
    tile_mask[row + m] = live;
  }
  if (threadIdx.x == 0) {
    tile_counts[(long long)c * T + t] = (int)count;
    if (t == 0) n_pairs[c] = (int)(incl[(long long)c * N + N - 1] - camera_base(incl, c, N));
  }
}

unsigned blocks_for(long long n, int per_block = kThreads) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// The cub scratch (bytes) that bin_scan over n_counts counts and bin_sort
// over n_pairs pairs need: the larger of the two.
int bin_temp_bytes(int n_counts, int n_pairs, int end_bit, size_t* out) {
  size_t scan = 0, sort = 0;
  cudaError_t err = cub::DeviceScan::InclusiveSum(nullptr, scan, (const long long*)nullptr,
                                                  (long long*)nullptr, n_counts);
  if (err != cudaSuccess) return (int)err;
  cub::DoubleBuffer<unsigned long long> k(nullptr, nullptr);
  cub::DoubleBuffer<int> v(nullptr, nullptr);
  err = cub::DeviceRadixSort::SortPairs(nullptr, sort, k, v, n_pairs, 0, end_bit);
  if (err != cudaSuccess) return (int)err;
  *out = scan > sort ? scan : sort;
  return 0;
}

// means2d [C, N, 2] f32, radii [C, N] f32, valid [C, N] bool ->
// geom [C, N, 4] int32, counts [C, N] int64.
int bin_count(const float* means2d, const float* radii, const unsigned char* valid, int* geom,
              long long* counts, long long total, int ts, int tiles_x, int tiles_y, int max_span,
              void* stream) {
  bin_count_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      means2d, radii, valid, (int4*)geom, counts, total, ts, tiles_x, tiles_y,
      max_span);
  return (int)cudaGetLastError();
}

// incl [C * N] = the inclusive sum of counts [C * N] (int64), in temp.
int bin_scan(const long long* counts, long long* incl, int n, void* temp, size_t temp_bytes,
             void* stream) {
  return (int)cub::DeviceScan::InclusiveSum(temp, temp_bytes, counts, incl, n,
                                            (cudaStream_t)stream);
}

// incl [C, N] int64 inclusive sums, geom, depths [C, N] f32 ->
// keys [C, P] uint64, vals [C, P] int32. N >= 1, P >= 1.
int bin_emit(const long long* incl, const int* geom, const float* depths,
             unsigned long long* keys, int* vals, int C, int N, long long P, int T, int tiles_x,
             void* stream) {
  const dim3 grid(blocks_for(P, kThreads * kEmitItems), C);
  bin_emit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(incl, (const int4*)geom, depths,
                                                               keys, vals, N, P, T, tiles_x);
  return (int)cudaGetLastError();
}

// The stable radix sort of n pairs over key bits [0, end_bit), from
// (keys0, vals0) with (keys1, vals1) as the alternate buffers, in temp;
// *selector says which buffers (0 or 1) hold the sorted pairs.
int bin_sort(unsigned long long* keys0, unsigned long long* keys1, int* vals0, int* vals1, int n,
             int end_bit, void* temp, size_t temp_bytes, int* selector, void* stream) {
  cub::DoubleBuffer<unsigned long long> k(keys0, keys1);
  cub::DoubleBuffer<int> v(vals0, vals1);
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, k, v, n, 0, end_bit,
                                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (k.selector != v.selector) return (int)cudaErrorUnknown;
  *selector = k.selector;
  return 0;
}

// sorted keys, vals [C, P], incl [C, N] inclusive sums -> tile_gauss [C, T, capacity]
// int32, tile_mask [C, T, capacity] bool, tile_counts [C, T] int32,
// n_pairs [C] int32.
int bin_tile_lists(const unsigned long long* keys, const int* vals, const long long* incl,
                   int* tile_gauss, unsigned char* tile_mask, int* tile_counts, int* n_pairs,
                   int C, int N, long long P, int T, int capacity, void* stream) {
  const dim3 grid(T, C);
  bin_tile_lists_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys, vals, incl, tile_gauss, tile_mask, tile_counts, n_pairs, N, P, T, capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
