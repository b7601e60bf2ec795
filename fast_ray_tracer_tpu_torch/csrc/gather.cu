// The backward of a row gather from a small table, written for Hopper
// (sm_90a). One public operation on the caller's stream:
//
//   frt_table_grad_{f32,f64}   grad[k, :] = sum of g[i, :] over every lane
//                              i with idx[i] == k (a negative index counts
//                              from the end, as in table[idx]),
//
// for g (N, W) contiguous and idx (N,) int64 at any stride, grad (K, W).
// It is the VJP of ops/gather.take_rows, the wavefront's gathers from the
// material, primitive and pattern tables, which have a few to a few tens
// of rows. It replaces no TPU kernel: the JAX package leaves this
// scatter-add to XLA.
//
// Bound: bytes. It reads N x (W x esize + 8) bytes of cotangent and
// indices and writes K x W x esize of gradient, plus G x K x W x esize of
// per-block partial sums written and read back (G the blocks of the first
// launch, at most a few hundred; K x W x esize at most kMaxTableBytes). It
// does no arithmetic to speak of: one add a cotangent element.
//
// Contention. Hundreds of thousands of lanes fall on a handful of rows, so
// every design that adds into the gradient from many threads at once
// serialises there: ATen's sort-then-walk backward of table[idx] walks each
// row's run of duplicates on one warp (milliseconds a call), and global
// float atomics would queue in one or two L2 lines and give a different
// sum each run. Here no two threads ever add into one address:
//   - pass 1: a block takes a contiguous range of rows. Thread t reads one
//     column, c = t mod Wp (Wp the power of two at or above W; threads of
//     the columns past W only take part in the sums), of the rows
//     t / Wp, t / Wp + T / Wp, ... (T threads a block): a warp reads 32 /
//     Wp whole rows, contiguous. Each thread owns a private copy of its
//     column of the gradient, K elements in shared memory, slot j of
//     thread t at j x T + t, so a warp's 32 threads always touch 32
//     distinct banks, whatever their keys; it adds each element at its
//     row's key. The block then sums its threads' copies: warp w takes
//     the gradient's elements w, w + T/32, ..., each lane summing a fixed
//     set of that column's threads in order, a shuffle butterfly summing
//     the lanes; the block's sums go to partial[b] (to the gradient itself
//     when there is one block);
//   - pass 2: one warp an element sums partial[0..G) the same way.
// Every sum's order is fixed by (N, K, W, the element size, the card's SM
// count), so two calls give bitwise-equal gradients; the cost does not
// depend on how the lanes fall on the rows. A thread's copy takes
// K x esize bytes of shared memory, so T shrinks from 256 only for tables
// of many rows; the table's size is capped (kMaxTableBytes and a row's
// kMaxThreads elements, which ops/gather.MAX_TABLE_BYTES and MAX_ROW
// repeat and chip_smoke.py checks: a larger table keeps ATen's backward,
// where contention is low).
//
// Plain C interface (loaded with ctypes): pointers and the stream come in as
// void*, every launch goes on the given stream, nothing synchronises and
// nothing allocates (the caller passes the partial sums' buffer, sized by
// frt_table_grad_blocks). Each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// the largest table, K x W x esize bytes
constexpr int kMaxTableBytes = 3584;
// shared memory a block of pass 1 may take
constexpr int kBlockBytes = 112 * 1024;
// shared memory of an SM, less the 1 KB the card reserves a block
constexpr int kSmBytes = 227 * 1024;
// blocks of pass 1 an SM: 2 x 256 threads, each with kUnroll elements and
// their indices in flight, keep ~48 KB of loads in flight an SM
constexpr int kBlocksPerSm = 2;
// the fewest cotangent elements a thread of pass 1 is given before the
// pass takes another block (small N: fewer blocks, less to sum)
constexpr int kMinElemsPerThread = 32;
// rows a thread loads before it adds them
constexpr int kUnroll = 16;
constexpr int kMaxDevices = 64;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass 1: block b sums the cotangent of rows [b x rows, (b+1) x rows) into
// dst[b] (K x W elements). wp: the power of two at or above w, at most
// blockDim.x.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) slice_kernel(
    const T* __restrict__ g, const int64_t* __restrict__ idx,
    int64_t istride, int64_t n, int k, int w, int wp, int64_t rows,
    T* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  for (int j = 0; j < k; ++j) buf[j * nt + t] = T(0);

  const int col = t & (wp - 1);
  const int64_t step = nt / wp;          // rows a round of the block
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t nrows = n - row0 < rows ? n - row0 : rows;
  if (col < w) {
    const T* gb = g + row0 * w + col;
    const int64_t* ib = idx + row0 * istride;
    for (int64_t r = t / wp; r < nrows; r += step * kUnroll) {
      int64_t key[kUnroll];
      T v[kUnroll];
      bool in[kUnroll];
      // every load of the batch is issued before any is used: a row past
      // the range reads row 0, which exists, and adds nothing
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = r + u * step;
        in[u] = q < nrows;
        key[u] = ib[(in[u] ? q : 0) * istride];
        v[u] = gb[(in[u] ? q : 0) * w];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t kk = key[u] + (key[u] < 0 ? k : 0);
        // an index outside the table cannot reach here: the forward
        // gather would have failed on it
        if (in[u] && kk >= 0 && kk < k) buf[(int)kk * nt + t] += v[u];
      }
    }
  }
  __syncthreads();

  // the block's sum of each gradient element (key j, column c): a warp an
  // element, each lane over column c's threads c + wp x (lane + 32 i) in
  // order, then a butterfly
  const int lane = t & 31;
  const int nw = nt >> 5;
  const int per_col = nt / wp;
  T* out = dst + (int64_t)blockIdx.x * k * w;
  for (int s = t >> 5; s < k * w; s += nw) {
    const int j = s / w;
    const int c = s - j * w;
    T acc = T(0);
    for (int i = lane; i < per_col; i += 32) acc += buf[j * nt + c + i * wp];
    acc = warp_sum(acc);
    if (lane == 0) out[s] = acc;
  }
}

// Pass 2: out[s] = the sum of partial[b][s] over b < blocks, a warp an
// element.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) sum_kernel(
    const T* __restrict__ partial, int blocks, int kw, T* __restrict__ out) {
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= kw) return;                   // the whole warp
  const int lane = threadIdx.x & 31;
  T acc = T(0);
  for (int b = lane; b < blocks; b += 32) acc += partial[(int64_t)b * kw + s];
  acc = warp_sum(acc);
  if (lane == 0) out[s] = acc;
}

struct Plan {
  int threads = 0;
  int blocks = 0;
  int wp = 0;
  int64_t rows = 0;
  size_t smem = 0;
};

int sm_count(int device) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

// The launch geometry of a call (threads 0: the table is too large). It
// depends on the shapes and the card alone, so the sums' order does too.
Plan plan(int64_t n, int k, int w, int esize, int device) {
  Plan p;
  if (n <= 0 || k <= 0 || w <= 0 ||
      (int64_t)k * w * esize > kMaxTableBytes)
    return p;
  int wp = 1;
  while (wp < w) wp <<= 1;
  // a thread's copy is k x esize <= kMaxTableBytes, so 32 threads always
  // fit kBlockBytes; a row's columns must fit one block
  int t = kMaxThreads;
  while (t > 32 && t > wp && (int64_t)t * k * esize > kBlockBytes) t >>= 1;
  const int sms = sm_count(device);
  if (wp > t || sms <= 0) return p;
  p.threads = t;
  p.wp = wp;
  p.smem = (size_t)t * k * esize;
  int per_sm = (int)(kSmBytes / (p.smem + 1024));
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const int64_t per_block = (int64_t)(t / wp) * kMinElemsPerThread;
  int64_t want = (n + per_block - 1) / per_block;
  const int64_t most = (int64_t)per_sm * sms;
  if (want > most) want = most;
  if (want < 1) want = 1;
  p.rows = (n + want - 1) / want;
  p.blocks = (int)((n + p.rows - 1) / p.rows);
  return p;
}

template <typename T>
int table_grad(const T* g, const int64_t* idx, int64_t istride, int64_t n,
               int k, int w, T* partial, int64_t partial_elems, T* out,
               int device, void* stream_ptr) {
  const Plan p = plan(n, k, w, (int)sizeof(T), device);
  if (p.threads == 0) return (int)cudaErrorInvalidValue;
  const int kw = k * w;
  if (p.blocks > 1 && partial_elems < (int64_t)p.blocks * kw)
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  static bool raised[kMaxDevices];
  if (p.smem > 48 * 1024 && !raised[device]) {
    // above the default limit a kernel must ask for its shared memory
    err = cudaFuncSetAttribute(slice_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBlockBytes);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  slice_kernel<T><<<(unsigned)p.blocks, p.threads, p.smem, stream>>>(
      g, idx, istride, n, k, w, p.wp, p.rows, p.blocks > 1 ? partial : out);
  if (p.blocks > 1) {
    const int warps = kMaxThreads / 32;
    sum_kernel<T><<<(unsigned)((kw + warps - 1) / warps), kMaxThreads, 0,
                    stream>>>(partial, p.blocks, kw, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the first launch of a call (so the caller sizes the partial
// sums, blocks x K x W elements, when it is above 1); 0 when the table
// exceeds kMaxTableBytes or n is 0.
int frt_table_grad_blocks(int64_t n, int k, int w, int esize, int device) {
  return plan(n, k, w, esize, device).blocks;
}

// The largest K x W x esize the kernel takes, and the widest row W.
int frt_table_grad_max_bytes() { return kMaxTableBytes; }
int frt_table_grad_max_row() { return kMaxThreads; }

int frt_table_grad_f32(const void* g, const void* idx, int64_t istride,
                       int64_t n, int k, int w, void* partial,
                       int64_t partial_elems, void* out, int device,
                       void* stream) {
  return table_grad<float>(static_cast<const float*>(g),
                           static_cast<const int64_t*>(idx), istride, n, k,
                           w, static_cast<float*>(partial), partial_elems,
                           static_cast<float*>(out), device, stream);
}

int frt_table_grad_f64(const void* g, const void* idx, int64_t istride,
                       int64_t n, int k, int w, void* partial,
                       int64_t partial_elems, void* out, int device,
                       void* stream) {
  return table_grad<double>(static_cast<const double*>(g),
                            static_cast<const int64_t*>(idx), istride, n, k,
                            w, static_cast<double*>(partial), partial_elems,
                            static_cast<double*>(out), device, stream);
}

}  // extern "C"
