// Stream compaction for the static-bucket wavefront, written for Hopper
// (sm_90a). Two public operations, each a short sequence of launches on the
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
// level 0 of the 800x400 flagship frame reads 640,000 x 6 x 4 B of rows and
// 640,000 flags and writes B x 6 x 4 B, 27.6 MB in all: 8.2 us at 3.35 TB/s.
//
// The TPU kernel's design is not carried over: its log-shift lane cumsum
// and 7-round binary search for the j-th active lane exist because Mosaic
// has no scatter, its SMEM carry because the TPU grid runs in order, its
// async-DMA output ring because of VMEM staging. Here blocks run in any
// order.
//
// Compaction is one scan-and-move pass (a single-pass scan with decoupled
// look-back, Merrill & Garland 2016), then a small fill launch:
//   - a block takes its tile from an atomic ticket, not from blockIdx.x, so
//     every tile before it has already been scheduled and the look-back
//     cannot wait on a tile that never runs;
//   - it loads its flags, then its tile's rows (a contiguous byte range of
//     src, 16 bytes a load where aligned, eight loads in flight a thread)
//     into shared memory; it counts its active rows, records in shared
//     memory which tile row is the j-th active one, publishes its count,
//     and looks back over its predecessors' status words (one 64-bit word
//     per tile: a flag in the top bits and a count) for its offset, the
//     whole block reading 256 predecessors per round, as all tiles start at
//     once and most have published only their count. (Plain loads measured
//     faster here than cp.async copies left in flight over the look-back.)
//   - because the compaction is stable, the tile's active rows land on the
//     contiguous output range [off, off + cnt): the block writes them as one
//     coalesced run, neighbouring threads on neighbouring elements, cut at
//     B so overflow lanes are dropped in bounds;
//   - the last tile writes the total, and the fill launch writes fill_row
//     into rows [total, B) without a host sync.
// The scratch (ticket, total and the status words) is one buffer per
// stream, zeroed once when the caller makes it; the fill launch, which
// runs after every tile has finished, clears the ticket and the status
// words again, so each call leaves it clean for the next and a call needs
// no memset. A tile holds 256 x R rows, R chosen from C and the element
// size so that its rows take at most 32 KB of shared memory (64 KB at
// C = 32 in float64, R = 1).
//
// Expansion keeps the first design: count (one block per 1024-lane tile,
// __ballot_sync + __popc), a one-block exclusive scan of the counts that
// writes the total to device memory, then the move.
//
// Plain C interface (loaded with ctypes): pointers and the stream come in as
// void*, every launch goes on the given stream, nothing synchronises and
// nothing allocates (the caller passes the scratch buffers). Each entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;              // expand: lanes per block
constexpr int kWarps = kTile / 32;       // 32: one warp can scan the warps
constexpr int kMaxC = 32;                // widest row (fill row by value)
constexpr unsigned kFull = 0xffffffffu;

// compaction: threads per block, rows per thread at most, shared-memory
// budget of a tile's rows, and the shared memory a block may ask for
constexpr int kScanThreads = 256;
constexpr int kMaxRowsPerThread = 8;
constexpr int kTileBytes = 32768;
constexpr int kLoads = 8;                // 16-byte loads in flight a thread
constexpr int kMaxSmem = kScanThreads * kMaxC * 8 + kScanThreads * 4;
// a tile's status word: flag in bits 62-63, count below
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCountMask = (1ull << 62) - 1;
// scratch layout, in 64-bit words: ticket, total, then one status per tile
constexpr int kStatus0 = 2;

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

// rows per thread of a compaction tile: its rows fill at most kTileBytes
// of shared memory, and at least one row per thread
int rows_per_thread(int c, int esize) {
  const int r = kTileBytes / (kScanThreads * c * esize);
  return r < 1 ? 1 : (r > kMaxRowsPerThread ? kMaxRowsPerThread : r);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Decoupled look-back, run by the whole block: the number of active rows
// in the tiles before `tile`. Thread i reads the status of tile base - i,
// so a round covers kScanThreads predecessors (all tiles start at once, so
// most have only published their count yet, and a round is one L2 round
// trip); the round stops at the nearest tile that has published its
// inclusive prefix (a tile before 0 counts as a prefix of 0), else it sums
// every count and slides back. All threads call it and get the sum.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, int tile, long long* warp_sum,
    int* warp_pre) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long excl = 0;
  for (int base = tile - 1;; base -= kScanThreads) {
    const int idx = base - tid;
    unsigned long long s = kPrefix;
    if (idx >= 0) {
      while ((s = load_status(status + idx)) < kAggregate) __nanosleep(32);
    }
    const unsigned pre = __ballot_sync(kFull, s >= kPrefix);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kCountMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) {
      warp_sum[warp] = v;
      warp_pre[warp] = pre != 0;
    }
    __syncthreads();
    bool done = false;
    for (int w = 0; w < kScanThreads / 32 && !done; ++w) {
      excl += warp_sum[w];
      done = warp_pre[w];
    }
    __syncthreads();           // warp_sum is rewritten by the next round
    if (done) return excl;
  }
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
compact_kernel(const T* __restrict__ src, const bool* __restrict__ act,
               T* __restrict__ out, unsigned long long* __restrict__ scratch,
               int ntiles, int64_t n, int c, int64_t b, int rpt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile, s_cnt;
  __shared__ int warp_off[kScanThreads / 32], warp_pre[kScanThreads / 32];
  __shared__ long long warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_per_tile = kScanThreads * rpt;
  T* tile_rows = reinterpret_cast<T*>(smem);           // rows_per_tile x c
  int* src_row = reinterpret_cast<int*>(smem + sizeof(T) * rows_per_tile * c);

  if (tid == 0) s_tile = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int tile = s_tile;
  const int64_t row0 = (int64_t)tile * rows_per_tile;
  const int rows = n - row0 < rows_per_tile ? (int)(n - row0) : rows_per_tile;

  // 1. this thread's flags first, so their loads are not queued behind the
  //    tile's; then the tile's rows, one contiguous byte range, into shared
  //    memory, 16 bytes a load where aligned and kLoads loads in flight
  const int r0 = tid * rpt;
  unsigned flags = 0;
  for (int k = 0; k < rpt; ++k)
    if (r0 + k < rows && act[row0 + r0 + k]) flags |= 1u << k;
  const int elems = rows * c;
  const T* g = src + row0 * c;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // tiles start 16-byte aligned: 256 x R x C x sizeof(T) is a multiple of 16
    constexpr int kPer = 16 / sizeof(T);
    const int nvec = elems / kPer;
    const int4* gv = reinterpret_cast<const int4*>(g);
    int4* sv = reinterpret_cast<int4*>(tile_rows);
    for (int v0 = tid; v0 < nvec; v0 += kScanThreads * kLoads) {
      int4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int v = v0 + u * kScanThreads;
        if (v < nvec) x[u] = __ldg(gv + v);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int v = v0 + u * kScanThreads;
        if (v < nvec) sv[v] = x[u];
      }
    }
    e0 = nvec * kPer;
  }
  for (int e = e0 + tid; e < elems; e += kScanThreads) tile_rows[e] = g[e];

  // 2. this thread's rows [tid * rpt, tid * rpt + rpt): count, scan, and
  //    record which tile row is the j-th active one
  const int mine = __popc(flags);
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_off[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kScanThreads / 32 ? warp_off[lane] : 0;
    int w = v;
#pragma unroll
    for (int o = 1; o < kScanThreads / 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kScanThreads / 32) warp_off[lane] = w - v;
    if (lane == kScanThreads / 32 - 1) s_cnt = w;
  }
  __syncthreads();
  int j = warp_off[warp] + x - mine;
  for (int k = 0; k < rpt; ++k)
    if (flags >> k & 1u) src_row[j++] = r0 + k;

  // 3. publish the count, look back for the offset, publish the prefix
  unsigned long long* status = scratch + kStatus0;
  long long off = 0;
  if (tile > 0) {
    if (tid == 0) store_status(status + tile, kAggregate | s_cnt);
    off = look_back(status, tile, warp_sum, warp_pre);
  }
  if (tid == 0) {
    store_status(status + tile, kPrefix | (unsigned long long)(off + s_cnt));
    if (tile == ntiles - 1) scratch[1] = (unsigned long long)(off + s_cnt);
  }
  __syncthreads();

  // 4. the active rows as one run out[off, off + cnt), cut at b
  const long long room = b - off;
  const int cnt = room < s_cnt ? (room > 0 ? (int)room : 0) : s_cnt;
  T* o = out + off * c;
  const int dr = kScanThreads / c, dk = kScanThreads % c;
  int r = tid / c, k = tid % c;
  for (int e = tid; e < cnt * c; e += kScanThreads) {
    o[e] = tile_rows[src_row[r] * c + k];
    r += dr;
    k += dk;
    if (k >= c) { k -= c; ++r; }
  }
}

// rows [min(total, b), b) take the fill row: grid-stride over their
// elements. It runs after every tile has finished, so it also clears the
// ticket and the status words for the next call on this stream (the total
// is written by every call that has tiles).
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
fill_kernel(unsigned long long* __restrict__ scratch, int ntiles,
            T* __restrict__ out, int c, int64_t b,
            const __grid_constant__ FillRow<T> fill) {
  // __grid_constant__: read in place; a by-value row indexed at run time
  // is copied to a local stack frame by every thread
  __shared__ T sfill[kMaxC];
  if (threadIdx.x < kMaxC) sfill[threadIdx.x] = fill.v[threadIdx.x];
  const int64_t total = ntiles > 0 ? (int64_t)scratch[1] : 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kScanThreads;
  const int64_t first = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (first == 0) scratch[0] = 0;
  for (int64_t i = first; i < ntiles; i += stride) scratch[kStatus0 + i] = 0;
  const int64_t t = total < b ? total : b;
  const int64_t fe = (b - t) * c;
  T* f = out + t * c;
  int fk = (int)(first % c);
  const int fdk = (int)(stride % c);
  for (int64_t e = first; e < fe; e += stride) {
    f[e] = sfill[fk];
    fk += fdk;
    if (fk >= c) fk -= c;
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

// count + offsets: the scan of the expansion
void scan(const bool* act, int64_t n, int* block_count, int* block_off,
          int* total, cudaStream_t stream) {
  const int nb = num_tiles(n);
  count_kernel<<<nb, kTile, 0, stream>>>(act, n, block_count);
  offsets_kernel<<<1, kTile, 0, stream>>>(block_count, nb, block_off, total);
}

// The scratch must be clean (zero ticket and status words) on entry; every
// call leaves it clean for the next call on the same stream.
template <typename T>
int compact(const T* src, const bool* act, T* out, void* scratch_ptr,
            int64_t scratch_words, int64_t n, int c, int64_t b,
            const double* fill_host, int device, void* stream_ptr) {
  if (c < 1 || c > kMaxC || b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int rpt = rows_per_thread(c, (int)sizeof(T));
  const int64_t rows_per_tile = (int64_t)kScanThreads * rpt;
  const int64_t ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  if (scratch_words < kStatus0 + ntiles) return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned long long* scratch = static_cast<unsigned long long*>(scratch_ptr);
  const size_t smem = sizeof(T) * rows_per_tile * c + 4 * rows_per_tile;
  if (smem > 48 * 1024)
    // above the default limit a kernel must ask for its shared memory
    err = cudaFuncSetAttribute(compact_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err == cudaSuccess) {
    FillRow<T> fill;
    for (int k = 0; k < kMaxC; ++k)
      fill.v[k] = k < c ? (T)fill_host[k] : T(0);
    if (ntiles > 0)
      compact_kernel<T><<<(unsigned)ntiles, kScanThreads, smem, stream>>>(
          src, act, out, scratch, (int)ntiles, n, c, b, rpt);
    const int64_t fe = (b * c > ntiles ? b * c : ntiles);
    const int64_t blocks = (fe + kScanThreads - 1) / kScanThreads;
    fill_kernel<T><<<(unsigned)(blocks < 1024 ? blocks : 1024),
                     kScanThreads, 0, stream>>>(scratch, (int)ntiles, out, c,
                                                b, fill);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
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

// rows per compaction tile for rows of c elements of esize bytes
int frt_compact_tile_rows(int c, int esize) {
  return kScanThreads * rows_per_thread(c, esize);
}

// rows per compaction tile: 256 at the least
int frt_compact_min_tile_rows() { return kScanThreads; }

int frt_compact_f32(const void* src, const void* act, void* out,
                    void* scratch, int64_t scratch_words, int64_t n, int c,
                    int64_t b, const double* fill, int device, void* stream) {
  return compact<float>(static_cast<const float*>(src),
                        static_cast<const bool*>(act),
                        static_cast<float*>(out), scratch, scratch_words, n,
                        c, b, fill, device, stream);
}

int frt_compact_f64(const void* src, const void* act, void* out,
                    void* scratch, int64_t scratch_words, int64_t n, int c,
                    int64_t b, const double* fill, int device, void* stream) {
  return compact<double>(static_cast<const double*>(src),
                         static_cast<const bool*>(act),
                         static_cast<double*>(out), scratch, scratch_words, n,
                         c, b, fill, device, stream);
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
