// The photon map's irradiance estimate, written for Hopper (sm_90a). One
// public operation on the caller's stream:
//
//   frt_irradiance_{f32,f64}   for each query (a point and its eye vector)
//                              pm_irradiance_estimate (the reference's
//                              pm.c:91-156) over the photons of the 27
//                              grid cells around it: (irr (R, 3), found
//                              (R,) int64), and r^2 (R,) where the caller
//                              asks for it (the checks),
//
// exactly as render/photon._estimate_block defines it on the card: the
// query's cell from (p - origin) * (1 / cell) (torch's CUDA division by a
// host scalar), floored, clamped to the grid; d^2 = ((dx^2 + dy^2) + dz^2)
// with every product rounded; the strict range test d^2 < max_dist^2;
// found = min(n_in, num); r^2 the num-th smallest in-range d^2 when n_in >=
// num (the bits torch.kthvalue gives), else max_dist^2; every in-range
// photon with d^2 <= r^2 selected, ties included; a selected photon with
// dirs . eyev < 0 summed with the cone weight 1 - sqrt(d^2) * (1 / (k
// max_dist)); the sums times 1 / ((1 - 2 / (3k)) pi r^2), zeroed where
// found < 8. Every scalar is rounded as torch rounds it on the card (the
// wrapper passes them as Python computes them; --fmad=false keeps every
// product rounded). Only the order of the three sums differs.
//
// It replaces no TPU kernel: the JAX package's estimate is jnp code (a
// bisection on counts over a candidate table). The port's torch version
// builds a (queries, candidates) table padded to a power-of-two width class,
// gathers positions and directions into it, runs torch.kthvalue over every
// padded row and sums per slot, with host syncs to group the queries: on
// the benchmark's Cornell frame it took 89% of the frame's device time.
//
// Bound. The least work is one squared distance for each photon a query
// sums (at most num), so the roofline of benchmark/gi_roofline.py is far
// below anything that must find those photons: a query reads every
// candidate of its 27 cells (1-4 thousand on a wall of the Cornell box, up
// to half a million in a caustic's focus) to count the ones in range and
// select the num nearest. The kernel is bound by those position reads
// (12 or 24 bytes a candidate, mostly from L2: a 1M-photon map's positions
// are 12 MB) and, more, by the selection: of the ~440 ms that the
// benchmark's Cornell frame's calls take on an H100, the cells' lookups
// take ~32 ms and the candidates' pass, counting alone, ~100 ms; the
// appends, the buffers' radix selects and the sums take the rest. Dropping
// the cells that lie out of reach (with a margin for the roundings) saved
// about 1%, and was left out.
//
// Design:
//   - the 27 cells are 9 runs of 3 consecutive cell ids (the z neighbours),
//     and the occupied cells are sorted by id, so each run's photons are one
//     contiguous range of the cell-sorted map: 9 ranges a query, each from
//     two binary searches in the occupied-cell keys (lanes 0-8 of a warp);
//   - a team of warps takes a query: one warp when its candidates number
//     at most kLightMax (almost every query), the whole block of kWarps
//     when more (the dense foci of caustics), so a few such queries do not
//     hold one warp for the launch's tail. A block takes kQueriesPerBlock
//     queries: its warps answer the light ones, then the block answers its
//     heavy ones one after another. The route follows the candidate count
//     alone;
//   - one pass over the candidates: each warp of the team reads its share
//     (a warp-wide slice of 32 consecutive photons at a time, coalesced),
//     counts the in-range ones and appends those with d^2 at or below its
//     running threshold tau, as (d^2 bits, photon) pairs in candidate order,
//     to its buffer in shared memory (kCap entries). When the buffer fills,
//     tau becomes the num-th smallest d^2 of the buffer (a radix select) and
//     the buffer keeps only the entries at or below it (stable). Every
//     in-range photon at or below the final r^2 is then in some buffer of
//     the team: r^2 is at most each warp's num-th smallest, so at most each
//     warp's tau;
//   - r^2 is a radix select (8-bit digits from the top, histograms in
//     shared memory with integer atomics) over the union of the team's
//     buffers: positive floats order as their bit patterns, so the result
//     carries the exact bits of the num-th smallest. A query with fewer
//     than num in range has r^2 = max_dist^2 and no select;
//   - the sums read power and direction for the buffer entries at or below
//     r^2 only;
//   - a buffer that cannot make room (num above kCap less a warp, or more
//     than kCap photons tied at the threshold) marks the team: it then
//     selects and sums by passes over the candidates themselves, d^2
//     recomputed each pass (exact, slower).
// Deterministic: no float atomics; each lane sums its entries in buffer
// order, a shuffle butterfly sums a warp, a team sums its warps in order,
// so two runs give the same bits. Which buffer entries exist depends only on
// the query and the map.
//
// Plain C interface (loaded with ctypes): pointers and the stream come in as
// void*, the launch goes on the given stream, nothing synchronises and
// nothing allocates. The entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// blocks an SM holds: 64 registers a thread; a float32 block's 41 KB of
// shared memory fits 5. Four blocks (32 warps) hide more of the reads'
// latency than the three that 76-80 registers allow (8% less time on the
// Cornell cell's calls, measured on an H100)
constexpr int kBlocksPerSm = 4;
// queries a block takes: 4 a warp
constexpr int kQueriesPerBlock = 32;
// the most candidates one warp takes alone; a query with more is the
// whole block's
constexpr long long kLightMax = 16384;
constexpr int kDigit = 8;
constexpr int kBins = 1 << kDigit;
// the 3 x 3 runs of z-neighbour cells
constexpr int kRanges = 9;
// slices of 32 candidates a lane loads before it uses them
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Key = unsigned int;
  // buffer entries a warp: 8 warps x (512 x 8 + 1 KB of histogram) = 40 KB
  static constexpr int kCap = 512;
  __device__ static Key key(float v) { return __float_as_uint(v); }
  __device__ static float val(Key k) { return __uint_as_float(k); }
  __device__ static float floor_(float v) { return floorf(v); }
  __device__ static float sqrt_(float v) { return sqrtf(v); }
};

template <>
struct Num<double> {
  using Key = unsigned long long;
  static constexpr int kCap = 256;
  __device__ static Key key(double v) { return (Key)__double_as_longlong(v); }
  __device__ static double val(Key k) {
    return __longlong_as_double((long long)k);
  }
  __device__ static double floor_(double v) { return floor(v); }
  __device__ static double sqrt_(double v) { return sqrt(v); }
};

template <typename T>
struct Args {
  const T* pts;                  // (R, 3) query points
  const T* eye;                  // (R, 3) eye vectors
  const T* pos;                  // (N, 3) cell-sorted photons
  const T* power;
  const T* dirs;
  const long long* keys;         // (M,) occupied cell ids, ascending
  const long long* row_start;    // (M + 1,)
  T* irr;                        // (R, 3)
  long long* found;              // (R,)
  T* r2;                         // (R,) or null: each query's r^2
  long long n;                   // R
  long long m;                   // M
  long long dims[3];
  T org[3];                      // the grid's origin
  T hi[3];                       // dims - 1
  T inv_cell;                    // 1 / cell, rounded as torch rounds it
  T md2;                         // max_dist^2
  T cone;                        // 1 / (k max_dist)
  T norm_c;                      // (1 - 2 / (3k)) pi
  int num;
};

template <typename T>
struct WarpBuf {
  typename Num<T>::Key key[Num<T>::kCap];
  int idx[Num<T>::kCap];
  unsigned int hist[kBins];
};

template <typename T>
struct Shared {
  WarpBuf<T> w[kWarps];
  T part[kWarps][3];
  long long cnt[kWarps];
  int flag[kWarps];
  unsigned int pick[2];
  int heavy[kQueriesPerBlock];
  int n_heavy;
};

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

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ long long lower_bound(const long long* keys,
                                                 long long lo, long long hi,
                                                 long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Lane r < 9 of a warp: the photon rows [s, e) of run r of the query's 27
// cells (cells (cx + r / 3 - 1, cy + r % 3 - 1, cz - 1 .. cz + 1) within the
// grid); the other lanes get an empty range.
template <typename T>
__device__ void query_ranges(const Args<T>& a, const T p[3], int lane,
                             long long& s, long long& e) {
  using N = Num<T>;
  long long c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // _neighbor_extents: floor((p - org) / cell) on the card, clamped
    // before the integer conversion (parked 1e30 points overflow it)
    const T u = (p[k] - a.org[k]) * a.inv_cell;
    T f = N::floor_(u);
    f = f < T(0) ? T(0) : f;
    f = f < a.hi[k] ? f : a.hi[k];
    c[k] = (long long)f;
  }
  s = e = 0;
  if (lane < kRanges) {
    const long long n0 = c[0] + lane / 3 - 1;
    const long long n1 = c[1] + lane % 3 - 1;
    if (n0 >= 0 && n0 < a.dims[0] && n1 >= 0 && n1 < a.dims[1]) {
      const long long zlo = c[2] > 0 ? c[2] - 1 : 0;
      const long long zhi = c[2] + 1 < a.dims[2] ? c[2] + 1 : a.dims[2] - 1;
      const long long base = (n0 * a.dims[1] + n1) * a.dims[2];
      const long long lo = lower_bound(a.keys, 0, a.m, base + zlo);
      const long long hi = lower_bound(a.keys, lo, a.m, base + zhi + 1);
      s = __ldg(a.row_start + lo);
      e = __ldg(a.row_start + hi);
    }
  }
}

template <typename T>
__device__ __forceinline__ T dist2(const T* __restrict__ pos, long long i,
                                   const T p[3]) {
  const T dx = pos[3 * i] - p[0];
  const T dy = pos[3 * i + 1] - p[1];
  const T dz = pos[3 * i + 2] - p[2];
  return (dx * dx + dy * dy) + dz * dz;
}

// a selected photon's weighted power, if it faces the eye
template <typename T>
__device__ __forceinline__ void add_photon(const Args<T>& a, long long i,
                                           T d2, const T ev[3], T acc[3]) {
  const T* dr = a.dirs + 3 * i;
  if ((dr[0] * ev[0] + dr[1] * ev[1]) + dr[2] * ev[2] < T(0)) {
    const T w = T(1) - Num<T>::sqrt_(d2) * a.cone;
    const T* pw = a.power + 3 * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += w * pw[c];
  }
}

// One warp: the digit whose bin holds the k-th smallest (1-based) entry of
// the histogram, and k within that bin; clears the histogram.
__device__ __forceinline__ void pick_digit(unsigned int* hist,
                                           unsigned int& k, int& digit,
                                           int lane) {
  constexpr int kPer = kBins / 32;
  unsigned int c[kPer];
  unsigned int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = hist[lane * kPer + j];
    s += c[j];
  }
  unsigned int inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  const unsigned int exc = inc - s;
  const unsigned int b = __ballot_sync(kFull, exc < k && k <= inc);
  const int src = b ? __ffs(b) - 1 : 0;
  int d = 0;
  unsigned int kk = k;
  if (lane == src) {
    unsigned int acc = exc;
    bool done = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!done) {
        if (k <= acc + c[j]) {
          d = lane * kPer + j;
          kk = k - acc;
          done = true;
        } else {
          acc += c[j];
        }
      }
    }
  }
  digit = __shfl_sync(kFull, d, src);
  k = __shfl_sync(kFull, kk, src);
#pragma unroll
  for (int j = 0; j < kPer; ++j) hist[lane * kPer + j] = 0;
  __syncwarp();
}

// The k-th smallest key of a team of NW warps (one warp, or the block):
// `fill(hist, prefix, mask, shift)` adds this thread's entries whose key
// matches prefix under mask to the histogram of their digit at shift.
template <typename T, int NW, typename Fill>
__device__ typename Num<T>::Key team_select(Shared<T>& sm, unsigned int k,
                                            int warp, int lane, Fill fill) {
  using Key = typename Num<T>::Key;
  constexpr int kBits = 8 * (int)sizeof(Key);
  unsigned int* hist = sm.w[NW == 1 ? warp : 0].hist;
  Key prefix = 0, mask = 0;
  for (int shift = kBits - kDigit; shift >= 0; shift -= kDigit) {
    fill(hist, prefix, mask, shift);
    int d = 0;
    if constexpr (NW == 1) {
      __syncwarp();
      pick_digit(hist, k, d, lane);
    } else {
      __syncthreads();
      if (warp == 0) {
        pick_digit(hist, k, d, lane);
        if (lane == 0) {
          sm.pick[0] = (unsigned int)d;
          sm.pick[1] = k;
        }
      }
      __syncthreads();
      d = (int)sm.pick[0];
      k = sm.pick[1];
    }
    prefix |= (Key)d << shift;
    mask |= (Key)(kBins - 1) << shift;
  }
  return prefix;
}

template <int NW, typename T>
__device__ long long team_sum(Shared<T>& sm, long long v, int warp,
                              int lane) {
  v = warp_sum(v);
  if constexpr (NW == 1) {
    return v;
  } else {
    if (lane == 0) sm.cnt[warp] = v;
    __syncthreads();
    long long t = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += sm.cnt[w];
    __syncthreads();
    return t;
  }
}

template <int NW, typename T>
__device__ bool team_any(Shared<T>& sm, bool v, int warp, int lane) {
  v = __any_sync(kFull, v);
  if constexpr (NW == 1) {
    return v;
  } else {
    if (lane == 0) sm.flag[warp] = v;
    __syncthreads();
    bool t = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) t = t || sm.flag[w];
    __syncthreads();
    return t;
  }
}

// acc summed over the team, in a fixed order: every lane of a warp holds
// the same butterfly sum; a block adds its warps' sums in warp order.
template <int NW, typename T>
__device__ void team_sum3(Shared<T>& sm, T acc[3], int warp, int lane) {
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = warp_sum(acc[c]);
  if constexpr (NW > 1) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sm.part[warp][c] = acc[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T t = sm.part[0][c];
#pragma unroll
      for (int w = 1; w < NW; ++w) t += sm.part[w][c];
      acc[c] = t;
    }
    __syncthreads();
  }
}

// Keeps the buffer's entries whose key is at most t, in order; returns
// their count. One warp.
template <typename T>
__device__ int compact(WarpBuf<T>& buf, int cnt, typename Num<T>::Key t,
                       int lane) {
  const unsigned int lt = (1u << lane) - 1u;
  int out = 0;
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + lane;
    typename Num<T>::Key k = 0;
    int id = 0;
    if (i < cnt) {
      k = buf.key[i];
      id = buf.idx[i];
    }
    const bool keep = i < cnt && k <= t;
    const unsigned int b = __ballot_sync(kFull, keep);
    // every read of this slice is done before any write: a write goes to
    // a position at or below its read
    __syncwarp();
    if (keep) {
      const int at = out + __popc(b & lt);
      buf.key[at] = k;
      buf.idx[at] = id;
    }
    out += __popc(b);
    __syncwarp();
  }
  return out;
}

// One query by a team of NW warps; this warp is the team's wt-th. (rs, re):
// this lane's range of query_ranges.
template <typename T, int NW>
__device__ void solve(const Args<T>& a, Shared<T>& sm, long long q,
                      const T p[3], long long rs, long long re, int wt,
                      int warp, int lane) {
  using N = Num<T>;
  using Key = typename N::Key;
  constexpr int kCap = N::kCap;
  constexpr long long kStride = 32LL * NW;
  WarpBuf<T>& buf = sm.w[warp];
  const unsigned int lt = (1u << lane) - 1u;
  const unsigned int num = (unsigned int)a.num;
  T ev[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ev[c] = a.eye[3 * q + c];

  // the pass: count the in-range candidates, keep those at or below tau
  int cnt = 0;
  Key tau = ~Key(0);
  bool ovf = false;
  long long n_lane = 0;
  for (int r = 0; r < kRanges; ++r) {
    const long long s = __shfl_sync(kFull, rs, r);
    const long long e = __shfl_sync(kFull, re, r);
    for (long long i0 = s + 32LL * wt; i0 < e; i0 += kStride * kUnroll) {
      T d2[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + kStride * u + lane;
        d2[u] = i < e ? dist2(a.pos, i, p) : a.md2;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = d2[u] < a.md2;
        n_lane += in;
        if (ovf) continue;
        const Key k = N::key(d2[u]);
        bool app = in && k <= tau;
        unsigned int b = __ballot_sync(kFull, app);
        if (!b) continue;
        if (cnt + __popc(b) > kCap) {
          if (cnt >= (int)num) {
            // this warp's buffer alone: the team's other warps go on
            tau = team_select<T, 1>(
                sm, num, warp, lane,
                [&](unsigned int* h, Key pre, Key msk, int sh) {
                  for (int i = lane; i < cnt; i += 32) {
                    const Key kk = buf.key[i];
                    if ((kk & msk) == pre)
                      atomicAdd(h + ((unsigned int)(kk >> sh) & (kBins - 1)),
                                1u);
                  }
                });
            cnt = compact(buf, cnt, tau, lane);
            app = app && k <= tau;
            b = __ballot_sync(kFull, app);
          }
          if (cnt + __popc(b) > kCap) {
            ovf = true;
            continue;
          }
        }
        if (app) {
          const int at = cnt + __popc(b & lt);
          buf.key[at] = k;
          buf.idx[at] = (int)(i0 + kStride * u + lane);
        }
        cnt += __popc(b);
      }
    }
  }
  __syncwarp();
  const long long n_in = team_sum<NW>(sm, n_lane, warp, lane);
  const bool rescan = team_any<NW>(sm, ovf, warp, lane);

  // every in-range candidate of this thread's share, d^2 recomputed
  auto each_in_range = [&](auto&& f) {
    for (int r = 0; r < kRanges; ++r) {
      const long long s = __shfl_sync(kFull, rs, r);
      const long long e = __shfl_sync(kFull, re, r);
      for (long long i = s + 32LL * wt + lane; i < e; i += kStride) {
        const T d = dist2(a.pos, i, p);
        if (d < a.md2) f(i, d);
      }
    }
  };

  T r2 = a.md2;
  Key thr = N::key(a.md2);
  if (n_in >= (long long)num) {
    if (!rescan) {
      thr = team_select<T, NW>(
          sm, num, warp, lane, [&](unsigned int* h, Key pre, Key msk, int sh) {
            for (int i = lane; i < cnt; i += 32) {
              const Key kk = buf.key[i];
              if ((kk & msk) == pre)
                atomicAdd(h + ((unsigned int)(kk >> sh) & (kBins - 1)), 1u);
            }
          });
    } else {
      thr = team_select<T, NW>(
          sm, num, warp, lane, [&](unsigned int* h, Key pre, Key msk, int sh) {
            each_in_range([&](long long, T d) {
              const Key kk = N::key(d);
              if ((kk & msk) == pre)
                atomicAdd(h + ((unsigned int)(kk >> sh) & (kBins - 1)), 1u);
            });
          });
    }
    r2 = N::val(thr);
  }

  // the sums over the selected photons (in range, d^2 <= r^2)
  T acc[3] = {T(0), T(0), T(0)};
  if (!rescan) {
    for (int i = lane; i < cnt; i += 32) {
      const Key kk = buf.key[i];
      if (kk <= thr) add_photon(a, buf.idx[i], N::val(kk), ev, acc);
    }
  } else {
    each_in_range([&](long long i, T d) {
      if (N::key(d) <= thr) add_photon(a, i, d, ev, acc);
    });
  }
  team_sum3<NW>(sm, acc, warp, lane);

  if (wt == 0 && lane == 0) {
    const long long found = n_in < (long long)num ? n_in : (long long)num;
    const T norm = T(1) / (r2 * a.norm_c);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.irr[3 * q + c] = found >= 8 ? acc[c] * norm : T(0);
    a.found[q] = found;
    if (a.r2) a.r2[q] = r2;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
irradiance_kernel(const __grid_constant__ Args<T> a) {
  __shared__ Shared<T> sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < kBins; j += 32) sm.w[warp].hist[j] = 0;
  if (threadIdx.x == 0) sm.n_heavy = 0;
  __syncthreads();

  const long long q0 = (long long)blockIdx.x * kQueriesPerBlock;
  for (int j = warp; j < kQueriesPerBlock; j += kWarps) {
    const long long q = q0 + j;
    if (q >= a.n) break;
    T p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = a.pts[3 * q + c];
    long long s, e;
    query_ranges(a, p, lane, s, e);
    if (warp_sum(e - s) > kLightMax) {
      // the block's, after the light queries
      if (lane == 0) sm.heavy[atomicAdd(&sm.n_heavy, 1)] = j;
      continue;
    }
    solve<T, 1>(a, sm, q, p, s, e, 0, warp, lane);
  }
  __syncthreads();

  const int nh = sm.n_heavy;
  for (int h = 0; h < nh; ++h) {
    const long long q = q0 + sm.heavy[h];
    T p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = a.pts[3 * q + c];
    long long s, e;
    query_ranges(a, p, lane, s, e);
    solve<T, kWarps>(a, sm, q, p, s, e, warp, warp, lane);
    __syncthreads();
  }
}

template <typename T>
int irradiance(const void* pts, const void* eye, int64_t n, const void* pos,
               const void* power, const void* dirs, int64_t n_photons,
               const void* keys, const void* row_start, int64_t m,
               int64_t d0, int64_t d1, int64_t d2, double o0, double o1,
               double o2, double cell, int num, double md2, double cone,
               double norm_c, void* irr, void* found, void* r2, int device,
               void* stream_ptr) {
  if (n < 0 || m < 1 || num < 1 || n_photons < 0 ||
      n_photons > (int64_t)INT32_MAX || d0 < 1 || d1 < 1 || d2 < 1 ||
      (n + kQueriesPerBlock - 1) / kQueriesPerBlock > (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  Args<T> a;
  a.pts = static_cast<const T*>(pts);
  a.eye = static_cast<const T*>(eye);
  a.pos = static_cast<const T*>(pos);
  a.power = static_cast<const T*>(power);
  a.dirs = static_cast<const T*>(dirs);
  a.keys = static_cast<const long long*>(keys);
  a.row_start = static_cast<const long long*>(row_start);
  a.irr = static_cast<T*>(irr);
  a.found = static_cast<long long*>(found);
  a.r2 = static_cast<T*>(r2);
  a.n = n;
  a.m = m;
  a.dims[0] = d0;
  a.dims[1] = d1;
  a.dims[2] = d2;
  a.org[0] = T(o0);
  a.org[1] = T(o1);
  a.org[2] = T(o2);
  a.hi[0] = T(d0 - 1);
  a.hi[1] = T(d1 - 1);
  a.hi[2] = T(d2 - 1);
  // torch's CUDA division by a host scalar multiplies by its reciprocal,
  // taken in the tensor's type
  a.inv_cell = T(1) / T(cell);
  a.md2 = T(md2);
  a.cone = T(cone);
  a.norm_c = T(norm_c);
  a.num = num;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned blocks =
      (unsigned)((n + kQueriesPerBlock - 1) / kQueriesPerBlock);
  irradiance_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Candidates (photons of a query's 27 cells) above which the block, not a
// warp, takes a query.
long long frt_irradiance_light_max() { return kLightMax; }

int frt_irradiance_f32(const void* pts, const void* eye, int64_t n,
                       const void* pos, const void* power, const void* dirs,
                       int64_t n_photons, const void* keys,
                       const void* row_start, int64_t m, int64_t d0,
                       int64_t d1, int64_t d2, double o0, double o1,
                       double o2, double cell, int num, double md2,
                       double cone, double norm_c, void* irr, void* found,
                       void* r2, int device, void* stream) {
  return irradiance<float>(pts, eye, n, pos, power, dirs, n_photons, keys,
                           row_start, m, d0, d1, d2, o0, o1, o2, cell, num,
                           md2, cone, norm_c, irr, found, r2, device, stream);
}

int frt_irradiance_f64(const void* pts, const void* eye, int64_t n,
                       const void* pos, const void* power, const void* dirs,
                       int64_t n_photons, const void* keys,
                       const void* row_start, int64_t m, int64_t d0,
                       int64_t d1, int64_t d2, double o0, double o1,
                       double o2, double cell, int num, double md2,
                       double cone, double norm_c, void* irr, void* found,
                       void* r2, int device, void* stream) {
  return irradiance<double>(pts, eye, n, pos, power, dirs, n_photons, keys,
                            row_start, m, d0, d1, d2, o0, o1, o2, cell, num,
                            md2, cone, norm_c, irr, found, r2, device, stream);
}

}  // extern "C"
