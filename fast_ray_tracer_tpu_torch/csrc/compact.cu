// Stream compaction for the static-bucket wavefront, written for Hopper
// (sm_90a). Two public operations, each a sequence of launches on the
// caller's stream:
//
//   frt_compact_{f32,f64}  replaces fast_ray_tracer_tpu/ops/compact_pallas.py
//                          _compact_kernel (public compact_rows):
//       out[pos(i)] = src[i] for every active lane i with pos(i) < B, where
//       pos(i) is the number of active lanes before i; rows [count, B) get
//       fill_row. Lanes with pos(i) >= B (overflow) are dropped: nothing is
//       ever written out of bounds, and the caller's overflow flag catches
//       the loss.
//   frt_expand_{f32,f64}   replaces compact_pallas.py _expand_kernel (public
//                          expand_rows), the transpose:
//       out[i] = act[i] ? child[min(pos(i), B-1)] : 0.
//
// Both are pure data movement, so they are bound by device-memory bytes:
// level 0 of the 800x400 flagship frame reads about 640,000 x 6 x 4 B and
// writes B x 6 x 4 B, a few MB — at 3.35 TB/s that is microseconds, and
// the launches and their latency (tens of microseconds at most) dominate.
//
// The TPU kernel's design is not carried over: its log-shift lane cumsum
// and 7-round binary search for the j-th active lane exist because Mosaic
// has no scatter, its SMEM carry because the TPU grid runs in order, its
// async-DMA output ring because of VMEM staging. Here blocks run in any
// order, so the natural form is a scan, then a scatter:
//   1. count:   one block per 1024-lane tile counts its active lanes with
//               __ballot_sync + __popc;
//   2. offsets: one block scans the per-tile counts (exclusive) and writes
//               the total to device memory, so no host sync is needed;
//   3. compact / expand: each block recomputes its lanes' positions within
//               the tile (warp ballots, warp sums through shared memory),
//               adds the tile's offset, and moves the rows; neighbouring
//               threads touch neighbouring elements of the tile.
// This three-launch scan is the simple form; a single-pass scan with
// decoupled look-back is later work.
//
// Plain C interface (loaded with ctypes): pointers and the stream come in as
// void*, every launch goes on the given stream, nothing synchronises and
// nothing allocates (the caller passes the scratch buffers). Each entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;              // lanes per block, one per thread
constexpr int kWarps = kTile / 32;       // 32: one warp can scan the warps
constexpr int kMaxC = 32;                // widest row (fill row by value)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct FillRow {
  T v[kMaxC];
};

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive count of active lanes before this thread's lane within the
// block. `warp_off` is kWarps ints of shared memory. All threads call it.
__device__ __forceinline__ int block_exclusive(bool a, int* warp_off) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, a);
  if (lane == 0) warp_off[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_off[lane];
    warp_off[lane] = warp_inclusive_scan(v, lane) - v;
  }
  __syncthreads();
  return warp_off[warp] + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kTile)
count_kernel(const bool* __restrict__ act, int64_t n,
             int* __restrict__ block_count) {
  __shared__ int warp_cnt[kWarps];
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  const bool a = i < n && act[i];
  const unsigned m = __ballot_sync(kFull, a);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    int v = warp_cnt[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) block_count[blockIdx.x] = v;
  }
}

// One block: exclusive scan of the per-tile counts, looping over them in
// chunks of kTile, plus the grand total.
__global__ void __launch_bounds__(kTile)
offsets_kernel(const int* __restrict__ block_count, int nblocks,
               int* __restrict__ block_off, int* __restrict__ total) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblocks; base += kTile) {
    const int b = base + threadIdx.x;
    const int v = b < nblocks ? block_count[b] : 0;
    const int x = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_inclusive_scan(warp_sum[lane], lane);
    __syncthreads();
    const int warp_excl = warp == 0 ? 0 : warp_sum[warp - 1];
    if (b < nblocks) block_off[b] = carry + warp_excl + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kWarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

template <typename T>
__global__ void __launch_bounds__(kTile)
compact_kernel(const T* __restrict__ src, const bool* __restrict__ act,
               const int* __restrict__ block_off,
               const int* __restrict__ total, T* __restrict__ out,
               int64_t n, int c, int64_t b, FillRow<T> fill) {
  __shared__ int warp_off[kWarps];
  __shared__ int dst[kTile];        // output row per lane of the tile, or -1
  __shared__ T sfill[kMaxC];
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int64_t i = row0 + threadIdx.x;
  const bool a = i < n && act[i];
  const int64_t pos =
      (int64_t)block_off[blockIdx.x] + block_exclusive(a, warp_off);
  dst[threadIdx.x] = (a && pos < b) ? (int)pos : -1;
  if (threadIdx.x < kMaxC) sfill[threadIdx.x] = fill.v[threadIdx.x];
  __syncthreads();

  // the tile's rows are contiguous in src: walk its elements e = r*c + k,
  // stepping (r, k) with e instead of dividing
  const int rows = n - row0 < kTile ? (int)(n - row0) : kTile;
  const int elems = rows > 0 ? rows * c : 0;
  const T* s = src + row0 * c;
  const int dr = kTile / c, dk = kTile % c;
  int r = threadIdx.x / c, k = threadIdx.x % c;
  for (int e = threadIdx.x; e < elems; e += kTile) {
    const int d = dst[r];
    if (d >= 0) out[(int64_t)d * c + k] = s[e];
    r += dr;
    k += dk;
    if (k >= c) { k -= c; ++r; }
  }

  // rows [count, b) take the fill row: grid-stride over their elements
  const int64_t t = *total;
  if (t < b) {
    const int64_t fe = (b - t) * c;
    const int64_t stride = (int64_t)gridDim.x * kTile;
    T* f = out + t * c;
    int64_t e = (int64_t)blockIdx.x * kTile + threadIdx.x;
    int fk = (int)(e % c);
    const int fdk = (int)(stride % c);
    for (; e < fe; e += stride) {
      f[e] = sfill[fk];
      fk += fdk;
      if (fk >= c) fk -= c;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile)
expand_kernel(const T* __restrict__ child, const bool* __restrict__ act,
              const int* __restrict__ block_off, T* __restrict__ out,
              int64_t n, int c, int64_t b) {
  __shared__ int warp_off[kWarps];
  __shared__ int srow[kTile];       // child row per lane of the tile, or -1
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int64_t i = row0 + threadIdx.x;
  const bool a = i < n && act[i];
  const int64_t pos =
      (int64_t)block_off[blockIdx.x] + block_exclusive(a, warp_off);
  srow[threadIdx.x] = a ? (int)(pos < b - 1 ? pos : b - 1) : -1;
  __syncthreads();

  const int rows = n - row0 < kTile ? (int)(n - row0) : kTile;
  const int elems = rows > 0 ? rows * c : 0;
  T* o = out + row0 * c;
  const int dr = kTile / c, dk = kTile % c;
  int r = threadIdx.x / c, k = threadIdx.x % c;
  for (int e = threadIdx.x; e < elems; e += kTile) {
    const int sr = srow[r];
    o[e] = sr >= 0 ? child[(int64_t)sr * c + k] : T(0);
    r += dr;
    k += dk;
    if (k >= c) { k -= c; ++r; }
  }
}

int num_tiles(int64_t n) { return n > 0 ? (int)((n + kTile - 1) / kTile) : 1; }

// count + offsets: the scan shared by both operations
void scan(const bool* act, int64_t n, int* block_count, int* block_off,
          int* total, cudaStream_t stream) {
  const int nb = num_tiles(n);
  count_kernel<<<nb, kTile, 0, stream>>>(act, n, block_count);
  offsets_kernel<<<1, kTile, 0, stream>>>(block_count, nb, block_off, total);
}

template <typename T>
int compact(const T* src, const bool* act, T* out, int* block_count,
            int* block_off, int* total, int64_t n, int c, int64_t b,
            const double* fill_host, void* stream_ptr) {
  if (c < 1 || c > kMaxC || b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FillRow<T> fill;
  for (int k = 0; k < kMaxC; ++k) fill.v[k] = k < c ? (T)fill_host[k] : T(0);
  scan(act, n, block_count, block_off, total, stream);
  compact_kernel<T><<<num_tiles(n), kTile, 0, stream>>>(
      src, act, block_off, total, out, n, c, b, fill);
  return (int)cudaGetLastError();
}

template <typename T>
int expand(const T* child, const bool* act, T* out, int* block_count,
           int* block_off, int* total, int64_t n, int c, int64_t b,
           void* stream_ptr) {
  if (c < 1 || b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  scan(act, n, block_count, block_off, total, stream);
  expand_kernel<T><<<num_tiles(n), kTile, 0, stream>>>(
      child, act, block_off, out, n, c, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int frt_tile() { return kTile; }
int frt_max_c() { return kMaxC; }

int frt_compact_f32(const void* src, const void* act, void* out,
                    void* block_count, void* block_off, void* total,
                    int64_t n, int c, int64_t b, const double* fill,
                    void* stream) {
  return compact<float>(static_cast<const float*>(src),
                        static_cast<const bool*>(act),
                        static_cast<float*>(out),
                        static_cast<int*>(block_count),
                        static_cast<int*>(block_off),
                        static_cast<int*>(total), n, c, b, fill, stream);
}

int frt_compact_f64(const void* src, const void* act, void* out,
                    void* block_count, void* block_off, void* total,
                    int64_t n, int c, int64_t b, const double* fill,
                    void* stream) {
  return compact<double>(static_cast<const double*>(src),
                         static_cast<const bool*>(act),
                         static_cast<double*>(out),
                         static_cast<int*>(block_count),
                         static_cast<int*>(block_off),
                         static_cast<int*>(total), n, c, b, fill, stream);
}

int frt_expand_f32(const void* child, const void* act, void* out,
                   void* block_count, void* block_off, void* total,
                   int64_t n, int c, int64_t b, void* stream) {
  return expand<float>(static_cast<const float*>(child),
                       static_cast<const bool*>(act),
                       static_cast<float*>(out),
                       static_cast<int*>(block_count),
                       static_cast<int*>(block_off),
                       static_cast<int*>(total), n, c, b, stream);
}

int frt_expand_f64(const void* child, const void* act, void* out,
                   void* block_count, void* block_off, void* total,
                   int64_t n, int c, int64_t b, void* stream) {
  return expand<double>(static_cast<const double*>(child),
                        static_cast<const bool*>(act),
                        static_cast<double*>(out),
                        static_cast<int*>(block_count),
                        static_cast<int*>(block_off),
                        static_cast<int*>(total), n, c, b, stream);
}

}  // extern "C"
