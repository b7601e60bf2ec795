// Stream compaction for the static-bucket wavefront, written for Hopper
// (sm_90a). Two public operations on the caller's stream:
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
// Both are pure data movement, so they are bound by device-memory bytes.
// At level 0 of the 800x400 flagship frame (N = 640,000, B = 483,328) the
// compaction reads N x 6 x 4 B of rows and N flags and writes B x 6 x 4 B,
// 27.6 MB: 8.2 us at 3.35 TB/s; the expansion reads B x 9 x 4 B and N
// flags and writes N x 9 x 4 B, 41.1 MB: 12.3 us.
//
// The TPU kernel's design is not carried over: its log-shift lane cumsum
// and 7-round binary search for the j-th active lane exist because Mosaic
// has no scatter, its SMEM carry because the TPU grid runs in order, its
// async-DMA output ring because of VMEM staging. Here blocks run in any
// order.
//
// Each operation is one pass over the flags, a single-pass scan with
// decoupled look-back (Merrill & Garland 2016) over tiles of 256 x R rows:
//   - a block takes its tile from an atomic ticket, not from blockIdx.x, so
//     every tile before it has already been scheduled and the look-back
//     cannot wait on a tile that never runs;
//   - it counts its active rows, publishes the count, and looks back over
//     its predecessors' status words (one 64-bit word per tile: a flag in
//     the top bits and a count) for its offset, the whole block reading 256
//     predecessors per round, as all tiles start at once and most have
//     published only their count; then it publishes its inclusive prefix.
// R is chosen from C and the element size so that a tile's rows take at
// most 32 KB of shared memory (64 KB at C = 32 in float64, R = 1).
//
// Compaction: the block loads its tile's rows (a contiguous byte range of
// src, 16 bytes a load where aligned, eight loads in flight a thread) into
// shared memory before the look-back (plain loads measured faster here
// than cp.async copies left in flight over it), and records which tile row
// is the j-th active one. Because the compaction is stable, the tile's
// active rows land on the contiguous output range [off, off + cnt): the
// block writes them as one coalesced run, cut at B so overflow lanes are
// dropped in bounds. The last tile writes the total, and a small fill
// launch writes fill_row into rows [total, B) without a host sync.
//
// Expansion, one launch: the tile's j-th active row reads child row
// min(off + j, B - 1), so the whole tile reads the contiguous span of child
// rows [min(off, B - 1), min(off + cnt - 1, B - 1)], as the TPU kernel's
// one DMA a step does. Once the look-back has its offset, the block copies
// that span into shared memory with 16-byte cp.async copies (scalar loads
// where the child is not 16-byte aligned and at the span's ragged end),
// places each tile row's child row, and writes the tile's output, 256 x R
// x C elements contiguous from its first row, with coalesced 16-byte
// stores, zero for inactive rows. Device memory is read once and written
// once, in order.
//
// The scratch (ticket, the compaction's total, the expansion's count of
// tiles done, then the status words) is one buffer per stream, zeroed once
// when the caller makes it, and every call leaves it clean for the next,
// so the two operations alternate on one stream without a memset: the
// compaction's fill launch, which runs after every tile has finished,
// clears the ticket and the status words; in the expansion each tile
// counts itself done once its look-back has read its last status word,
// and the tile that completes the count clears them.
//
// Plain C interface (loaded with ctypes): pointers and the stream come in as
// void*, every launch goes on the given stream, nothing synchronises and
// nothing allocates (the caller passes the scratch buffer). Each entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 32;                // widest row (fill row by value)
constexpr unsigned kFull = 0xffffffffu;

// threads per block, rows per thread at most, shared-memory budget of a
// tile's rows, and the shared memory a block may ask for: the rows at C =
// 32 in float64, the expansion's 16 bytes of alignment slack, one int a row
constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;
constexpr int kMaxRowsPerThread = 8;
constexpr int kTileBytes = 32768;
constexpr int kLoads = 8;                // 16-byte loads in flight a thread
constexpr int kMaxSmem = kScanThreads * kMaxC * 8 + 16 + kScanThreads * 4;
// a tile's status word: flag in bits 62-63, count below
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCountMask = (1ull << 62) - 1;
// scratch layout, in 64-bit words: ticket, total, tiles done, then one
// status per tile
constexpr int kTotal = 1;
constexpr int kDone = 2;
constexpr int kStatus0 = 3;

template <typename T>
struct FillRow {
  T v[kMaxC];
};

// rows per thread of a tile: its rows fill at most kTileBytes of shared
// memory, and at least one row per thread
int rows_per_thread(int c, int esize) {
  const int r = kTileBytes / (kScanThreads * c * esize);
  return r < 1 ? 1 : (r > kMaxRowsPerThread ? kMaxRowsPerThread : r);
}

// Makes `device` current for its scope and restores the caller's device.
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

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

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The block's tile from the ticket; all threads call it.
__device__ __forceinline__ int take_tile(unsigned long long* scratch,
                                         int* s_tile) {
  if (threadIdx.x == 0) *s_tile = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  return *s_tile;
}

// This thread's flags, bit k for tile row r0 + k of the `rows` in the tile.
__device__ __forceinline__ unsigned load_flags(const bool* act, int64_t row0,
                                               int r0, int rows, int rpt) {
  unsigned flags = 0;
  for (int k = 0; k < rpt; ++k)
    if (r0 + k < rows && act[row0 + r0 + k]) flags |= 1u << k;
  return flags;
}

// The number of active rows before this thread's `mine` in the block; the
// block's count goes to *cnt (shared). `warp_off` is kWarps ints of shared
// memory. All threads call it.
__device__ __forceinline__ int block_exclusive(int mine, int* warp_off,
                                               int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_off[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_off[lane] : 0;
    int w = v;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_off[lane] = w - v;
    if (lane == kWarps - 1) *cnt = w;
  }
  __syncthreads();
  return warp_off[warp] + x - mine;
}

// Decoupled look-back, run by the whole block: the number of active rows
// in the tiles before `tile`. Thread i reads the status of tile base - i,
// so a round covers kScanThreads predecessors (all tiles start at once, so
// most have only published their count yet, and a round is one L2 round
// trip); the round stops at the nearest tile that has published its
// inclusive prefix (a tile before 0 counts as a prefix of 0), else it sums
// every count and slides back. All threads call it and get the sum; every
// thread's last status read is done when it returns.
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
    for (int w = 0; w < kWarps && !done; ++w) {
      excl += warp_sum[w];
      done = warp_pre[w];
    }
    __syncthreads();           // warp_sum is rewritten by the next round
    if (done) return excl;
  }
}

// Publish the tile's count `cnt`, look back for its offset, publish its
// inclusive prefix. All threads call it and get the offset.
__device__ __forceinline__ long long tile_offset(
    unsigned long long* status, int tile, int cnt, long long* warp_sum,
    int* warp_pre) {
  long long off = 0;
  if (tile > 0) {
    if (threadIdx.x == 0) store_status(status + tile, kAggregate | cnt);
    off = look_back(status, tile, warp_sum, warp_pre);
  }
  if (threadIdx.x == 0)
    store_status(status + tile, kPrefix | (unsigned long long)(off + cnt));
  return off;
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
compact_kernel(const T* __restrict__ src, const bool* __restrict__ act,
               T* __restrict__ out, unsigned long long* __restrict__ scratch,
               int ntiles, int64_t n, int c, int64_t b, int rpt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile, s_cnt;
  __shared__ int warp_off[kWarps], warp_pre[kWarps];
  __shared__ long long warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int rows_per_tile = kScanThreads * rpt;
  T* tile_rows = reinterpret_cast<T*>(smem);           // rows_per_tile x c
  int* src_row = reinterpret_cast<int*>(smem + sizeof(T) * rows_per_tile * c);

  const int tile = take_tile(scratch, &s_tile);
  const int64_t row0 = (int64_t)tile * rows_per_tile;
  const int rows = n - row0 < rows_per_tile ? (int)(n - row0) : rows_per_tile;

  // 1. this thread's flags first, so their loads are not queued behind the
  //    tile's; then the tile's rows, one contiguous byte range, into shared
  //    memory, 16 bytes a load where aligned and kLoads loads in flight
  const int r0 = tid * rpt;
  const unsigned flags = load_flags(act, row0, r0, rows, rpt);
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
  int j = block_exclusive(mine, warp_off, &s_cnt);
  for (int k = 0; k < rpt; ++k)
    if (flags >> k & 1u) src_row[j++] = r0 + k;

  // 3. publish the count, look back for the offset, publish the prefix
  const long long off = tile_offset(scratch + kStatus0, tile, s_cnt,
                                    warp_sum, warp_pre);
  if (tid == 0 && tile == ntiles - 1)
    scratch[kTotal] = (unsigned long long)(off + s_cnt);
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
  const int64_t total = ntiles > 0 ? (int64_t)scratch[kTotal] : 0;
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
__global__ void __launch_bounds__(kScanThreads)
expand_kernel(const T* __restrict__ child, const bool* __restrict__ act,
              T* __restrict__ out, unsigned long long* __restrict__ scratch,
              int ntiles, int64_t n, int c, int64_t b, int rpt) {
  constexpr int kPer = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile, s_cnt, s_last;
  __shared__ int warp_off[kWarps], warp_pre[kWarps];
  __shared__ long long warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int rows_per_tile = kScanThreads * rpt;
  T* span = reinterpret_cast<T*>(smem);     // rows_per_tile x c + kPer
  int* child_row = reinterpret_cast<int*>(
      smem + sizeof(T) * (rows_per_tile * c + kPer));  // rows_per_tile

  const int tile = take_tile(scratch, &s_tile);
  const int64_t row0 = (int64_t)tile * rows_per_tile;
  const int rows = n - row0 < rows_per_tile ? (int)(n - row0) : rows_per_tile;

  // 1. this thread's rows [tid * rpt, tid * rpt + rpt): count, scan, look
  //    back for the tile's offset
  const int r0 = tid * rpt;
  const unsigned flags = load_flags(act, row0, r0, rows, rpt);
  int j = block_exclusive(__popc(flags), warp_off, &s_cnt);
  const int cnt = s_cnt;
  const long long off = tile_offset(scratch + kStatus0, tile, cnt, warp_sum,
                                    warp_pre);
  // this tile reads no status word any more (nor writes one): count it
  // done; the tile that completes the count clears the scratch (step 4)
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(scratch + kDone, 1ull) ==
             (unsigned long long)(ntiles - 1);
  }

  // 2. active row j reads child row min(off + j, b - 1): the tile reads
  //    child rows [lo, hi], staged in shared memory from element a0 (lo's
  //    first element, rounded down to 16 bytes where the child is aligned)
  const long long lo = off < b - 1 ? off : b - 1;
  const long long last = off + cnt - 1;
  const long long hi = last < b - 1 ? last : b - 1;
  for (int k = 0; k < rpt && r0 + k < rows; ++k) {
    if (flags >> k & 1u) {
      const long long cr = off + j < b - 1 ? off + j : b - 1;
      child_row[r0 + k] = (int)(cr - lo);
      ++j;
    } else {
      child_row[r0 + k] = -1;
    }
  }
  int shift = 0;              // span[shift] is child row lo's first element
  if (cnt > 0) {
    const int64_t e_lo = lo * c, e_end = (hi + 1) * c;
    int64_t a0 = e_lo;
    int copied = 0;
    if ((reinterpret_cast<uintptr_t>(child) & 15) == 0) {
      a0 = e_lo & ~(int64_t)(kPer - 1);
      const int nvec = (int)((e_end - a0) / kPer);
      const unsigned sbase = (unsigned)__cvta_generic_to_shared(span);
      const int4* gv = reinterpret_cast<const int4*>(child + a0);
      for (int v = tid; v < nvec; v += kScanThreads)
        cp_async16(sbase + 16u * v, gv + v);
      copied = nvec * kPer;
    }
    shift = (int)(e_lo - a0);
    const int m = (int)(e_end - a0);
    for (int e = copied + tid; e < m; e += kScanThreads) span[e] = child[a0 + e];
    cp_async_wait_all();
  }
  __syncthreads();

  // 3. the tile's output, rows * c elements contiguous from row0 * c (16-byte
  //    aligned: 256 x R x C x sizeof(T) is a multiple of 16), kPer elements
  //    a store where out is aligned, zero for inactive rows
  const int elems = rows * c;
  T* o = out + row0 * c;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int nvec = elems / kPer;
    constexpr int kStep = kScanThreads * kPer;
    const int dr = kStep / c, dk = kStep % c;
    int r = tid * kPer / c, k = tid * kPer % c;
    for (int v = tid; v < nvec; v += kScanThreads) {
      union {
        int4 q;
        T t[kPer];
      } x;
      int rr = r, kk = k;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int cr = child_row[rr];
        x.t[u] = cr >= 0 ? span[cr * c + kk + shift] : T(0);
        if (++kk == c) { kk = 0; ++rr; }
      }
      reinterpret_cast<int4*>(o)[v] = x.q;
      r += dr;
      k += dk;
      if (k >= c) { k -= c; ++r; }
    }
    e0 = nvec * kPer;
  }
  for (int e = e0 + tid; e < elems; e += kScanThreads) {
    const int cr = child_row[e / c];
    o[e] = cr >= 0 ? span[cr * c + e % c + shift] : T(0);
  }

  // 4. every tile has read its last status word: clear the ticket, the
  //    count of tiles done and the status words for the next call
  if (s_last) {
    __threadfence();
    for (int i = tid; i < ntiles; i += kScanThreads)
      scratch[kStatus0 + i] = 0;
    if (tid == 0) {
      scratch[0] = 0;
      scratch[kDone] = 0;
    }
  }
}

// The scratch must be clean (zero ticket, tiles done and status words) on
// entry; every call leaves it clean for the next call on the same stream.
template <typename T>
int compact(const T* src, const bool* act, T* out, void* scratch_ptr,
            int64_t scratch_words, int64_t n, int c, int64_t b,
            const double* fill_host, int device, void* stream_ptr) {
  if (c < 1 || c > kMaxC || b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int rpt = rows_per_thread(c, (int)sizeof(T));
  const int64_t rows_per_tile = (int64_t)kScanThreads * rpt;
  const int64_t ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  if (scratch_words < kStatus0 + ntiles) return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned long long* scratch = static_cast<unsigned long long*>(scratch_ptr);
  const size_t smem = sizeof(T) * rows_per_tile * c + 4 * rows_per_tile;
  if (smem > 48 * 1024)
    // above the default limit a kernel must ask for its shared memory
    err = cudaFuncSetAttribute(compact_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  FillRow<T> fill;
  for (int k = 0; k < kMaxC; ++k) fill.v[k] = k < c ? (T)fill_host[k] : T(0);
  if (ntiles > 0)
    compact_kernel<T><<<(unsigned)ntiles, kScanThreads, smem, stream>>>(
        src, act, out, scratch, (int)ntiles, n, c, b, rpt);
  const int64_t fe = (b * c > ntiles ? b * c : ntiles);
  const int64_t blocks = (fe + kScanThreads - 1) / kScanThreads;
  fill_kernel<T><<<(unsigned)(blocks < 1024 ? blocks : 1024), kScanThreads,
                   0, stream>>>(scratch, (int)ntiles, out, c, b, fill);
  return (int)cudaGetLastError();
}

// One launch; none for n = 0. The scratch as for compact.
template <typename T>
int expand(const T* child, const bool* act, T* out, void* scratch_ptr,
           int64_t scratch_words, int64_t n, int c, int64_t b, int device,
           void* stream_ptr) {
  if (c < 1 || c > kMaxC || b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int rpt = rows_per_thread(c, (int)sizeof(T));
  const int64_t rows_per_tile = (int64_t)kScanThreads * rpt;
  const int64_t ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  if (scratch_words < kStatus0 + ntiles) return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaSuccess;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(T) * (rows_per_tile * c + 16 / sizeof(T)) +
                      4 * rows_per_tile;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(expand_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<T><<<(unsigned)ntiles, kScanThreads, smem,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      child, act, out, static_cast<unsigned long long*>(scratch_ptr),
      (int)ntiles, n, c, b, rpt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int frt_max_c() { return kMaxC; }

// rows per tile of either kernel for rows of c elements of esize bytes
int frt_tile_rows(int c, int esize) {
  return kScanThreads * rows_per_thread(c, esize);
}

// 64-bit scratch words a call over n rows needs, for either kernel (a tile
// holds at least kScanThreads rows)
int64_t frt_scratch_words(int64_t n) {
  return kStatus0 + (n + kScanThreads - 1) / kScanThreads;
}

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
                   void* scratch, int64_t scratch_words, int64_t n, int c,
                   int64_t b, int device, void* stream) {
  return expand<float>(static_cast<const float*>(child),
                       static_cast<const bool*>(act),
                       static_cast<float*>(out), scratch, scratch_words, n, c,
                       b, device, stream);
}

int frt_expand_f64(const void* child, const void* act, void* out,
                   void* scratch, int64_t scratch_words, int64_t n, int c,
                   int64_t b, int device, void* stream) {
  return expand<double>(static_cast<const double*>(child),
                        static_cast<const bool*>(act),
                        static_cast<double*>(out), scratch, scratch_words, n,
                        c, b, device, stream);
}

}  // extern "C"
