// Clustered-mesh ray queries, written for Hopper (sm_90a). Möller–Trumbore
// over 128-triangle superclusters (two adjacent Morton-ordered clusters of
// 64) behind a per-ray slab test against each supercluster's AABB.
//
//   frt_mesh_closest_{f32,f64}  replaces fast_ray_tracer_tpu/ops/mesh_pallas.py
//                               _closest_kernel and _stream_closest_kernel
//                               (public mesh_pallas.closest):
//       per ray, the minimum positive t over the triangles of the
//       superclusters its slab test passes, and the lowest triangle index
//       among those at that t; (inf, 0) on a miss. An optional keep plane
//       drops triangles from the query.
//   frt_mesh_shadow_{f32,f64}   replaces mesh_pallas.py _shadow_kernel and
//                               _stream_shadow_kernel (public
//                               mesh_pallas.shadow): the reference's early-
//                               exit shadow walk as a rank-lexicographic
//                               monoid — per ray, the minimum shadow-walk
//                               rank among positive hits (INT32_MAX when
//                               none), then the nearest shadow-casting t
//                               among the hits of that rank (inf if none).
//
// The contract is the plain torch versions in ops/mesh.py, bit for bit: the
// same slab test as mesh_pallas._shortlist (the 1e-12 safe inverse,
// tmin <= tmax, tmax > 0) made per ray, and the Möller–Trumbore arithmetic
// of mesh_pallas._mt_core term for term. Build with --fmad=false and IEEE
// division, or products fused into FMAs would move t in the last bits.
// Ties and the visit order: superclusters are visited in index order and a
// triangle replaces the carry only at a strictly smaller t (closest) or
// rank, so the result is the lowest index at the minimum — independent of
// which rays share a block, which keeps the bucketed wavefront bitwise
// equal to the unrolled trace that batches rays differently.
//
// Closest: work that follows the (ray, supercluster) pairs whose slab test
// passes. The first design (one thread per ray, a 128-ray block staging
// every supercluster any of its rays passed) left most threads idle behind
// the block's union and walked all superclusters for dead lanes; the TPU
// kernel never had that problem, as it evaluates a block's rays x 128
// triangles as one vector operation on a shortlist. Here:
//   - a three-level cull: each lane tests its own ray against the root box,
//     then the boxes of groups of kGroup consecutive (Morton-ordered)
//     superclusters, then the superclusters of the groups it passed. Every
//     box above a supercluster is the exact componentwise min/max of its
//     members' boxes (ops/mesh.py pack). With round-to-nearest,
//     fl((x - o) * inv) is monotone in x, so an enclosing box's slab
//     interval contains each member's: a ray that passes a member passes
//     every box above it, and the cull drops no pair the plain version
//     keeps. A group's members are counted, [g * kGroup, min(nsc, ...)),
//     never padded with boxes: the empty-box sentinel (min 1e30, max
//     -1e30) would pass the slab test of every live ray. A warp
//     none of whose rays passes the root box writes (inf, 0) and stops, so
//     the fill lanes of the wavefront's buckets cost one test each;
//   - pair-parallel evaluation: a warp owns 32 rays. For each supercluster
//     that some of its rays pass (a ballot), every lane loads 4 of its 128
//     triangles (coalesced, from L2: the planes are 5.1 MB at the mesh
//     frame's 141k triangles), then for each passing ray in turn the warp
//     broadcasts the ray, all 32 lanes run Möller–Trumbore on their 4
//     triangles, and a shuffle reduction gives (min t, lowest index at
//     that t), which the owning lane folds into its carry. Most pairs hit
//     nothing nearer than the carry, and a warp vote skips their
//     reduction. (Two rays a step, for more independent work per lane,
//     measured slower: the registers it needs cost more than it gains.);
//   - a warp's work is uneven (most pairs fall to the warps whose rays
//     graze the mesh) and a batch may hold too few rays to fill the card
//     (the 16,384-ray soup makes 512 warps on 132 SMs), so in float32 the
//     group range is split across blockIdx.y (closest_split) and the parts
//     merge with a 64-bit atomicMin on
//     (float bits of t) << 32 | index: non-negative float32 bit patterns
//     order as unsigned integers, so the minimum is exactly (min t, lowest
//     index), whatever the order of the atomics; a second launch turns the
//     keys into (t, index). float64 does not split.
// No near-to-far order and no per-ray t cut: a box's rounded entry t is not
// a safe lower bound for a Möller–Trumbore t of a triangle inside it (a few
// ulps below, and the stored p1 + e1 is not the vertex the box was built
// from), so a cut would need a margin that was not proven bitwise.
//
// Shadow keeps the first design: one thread per ray, blocks of 128 rays,
// every supercluster walked in index order, __syncthreads_or skipping
// superclusters no ray of the block passes, the live supercluster's 9 x 128
// triangle components (plus rank and cast) staged in shared memory, and
// each ray that passed folding the 128 triangles into its carry.
// There is no resident/streaming split: the TPU kernel needed one for its
// 8 MB VMEM budget, and on the H100 the 141k-triangle planes (5.1 MB) and
// even a 512k-triangle soup (19 MB) sit in the 50 MB L2.
//
// What bounds them: FP32 (FP64) issue rate times the (ray, triangle) pairs
// evaluated — 128 per passed (ray, supercluster) slab test, about 46
// floating-point operations each with one IEEE division — plus the slab
// tests; the bytes (rays, planes, results) are a few MB.
//
// Plain C interface (loaded with ctypes): pointers and the stream come in
// as void*; rays are rows of 3 values with a row stride, so the views the
// wavefront hands over need no copy; the launch goes on the given stream,
// nothing synchronises or allocates. Each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr int kSC = 128;                 // triangles per supercluster
constexpr int kGroup = 32;               // superclusters per group box
constexpr int32_t kNoRank = 0x7fffffff;  // INT32_MAX: no hit
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClosestThreads = 128;     // 4 independent warps per block

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

// NaN-propagating min / max, like torch.minimum / torch.maximum
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}

template <typename T>
struct RayT {
  T o[3], d[3], inv[3];
};

template <typename T>
__device__ __forceinline__ RayT<T> load_ray(const T* orig, const T* dirs,
                                            int64_t ostride, int64_t dstride,
                                            int64_t r, bool alive) {
  RayT<T> ray;
  const T tiny = T(1e-12);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray.o[k] = alive ? orig[r * ostride + k] : T(0);
    ray.d[k] = alive ? dirs[r * dstride + k] : T(1);
    const T dk = ray.d[k];
    const T safe = absval(dk) < tiny ? (dk < T(0) ? -tiny : tiny) : dk;
    ray.inv[k] = T(1) / safe;
  }
  return ray;
}

// mesh_pallas._shortlist's slab test for one (ray, supercluster)
template <typename T>
__device__ __forceinline__ bool slab(const RayT<T>& ray,
                                     const T* __restrict__ bmin,
                                     const T* __restrict__ bmax, int s) {
  T lo = T(0), hi = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T t1 = (bmin[3 * s + k] - ray.o[k]) * ray.inv[k];
    const T t2 = (bmax[3 * s + k] - ray.o[k]) * ray.inv[k];
    const T mn = nan_min(t1, t2), mx = nan_max(t1, t2);
    lo = k == 0 ? mn : nan_max(lo, mn);
    hi = k == 0 ? mx : nan_min(hi, mx);
  }
  return lo <= hi && hi > T(0);
}

template <typename T>
struct TriT {
  T p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// triangle j of a supercluster whose 9 component rows start at c, `plane`
// values apart: [p1 | e1 | e2] x [x y z]
template <typename T>
__device__ __forceinline__ TriT<T> load_tri(const T* c, int64_t plane, int j) {
  return {c[0 * plane + j], c[1 * plane + j], c[2 * plane + j],
          c[3 * plane + j], c[4 * plane + j], c[5 * plane + j],
          c[6 * plane + j], c[7 * plane + j], c[8 * plane + j]};
}

// mesh_pallas._mt_core: ok is the triangle test without a sign test on t
template <typename T>
__device__ __forceinline__ T mt_core(const RayT<T>& ray, const TriT<T>& tr,
                                     bool& ok) {
  const T dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
  // pvec = d x e2
  const T px = dy * tr.e2z - dz * tr.e2y;
  const T py = dz * tr.e2x - dx * tr.e2z;
  const T pz = dx * tr.e2y - dy * tr.e2x;
  const T det = tr.e1x * px + tr.e1y * py + tr.e1z * pz;
  ok = absval(det) >= T(1e-5);
  const T f = T(1) / (ok ? det : T(1));
  const T tx = ray.o[0] - tr.p1x;
  const T ty = ray.o[1] - tr.p1y;
  const T tz = ray.o[2] - tr.p1z;
  const T u = f * (tx * px + ty * py + tz * pz);
  ok = ok && u >= T(0) && u <= T(1);
  // qvec = (o - p1) x e1
  const T qx = ty * tr.e1z - tz * tr.e1y;
  const T qy = tz * tr.e1x - tx * tr.e1z;
  const T qz = tx * tr.e1y - ty * tr.e1x;
  const T v = f * (dx * qx + dy * qy + dz * qz);
  ok = ok && v >= T(0) && u + v <= T(1);
  return f * (tr.e2x * qx + tr.e2y * qy + tr.e2z * qz);
}

// triangle j of the supercluster staged in shared memory (rows of kSC)
template <typename T>
__device__ __forceinline__ T moller_trumbore(const RayT<T>& ray,
                                             const T* c, int j, bool& ok) {
  return mt_core(ray, load_tri(c, kSC, j), ok);
}

template <typename T>
__device__ __forceinline__ void stage(T* s_tri, const T* __restrict__ tris,
                                      int nsc, int s) {
#pragma unroll
  for (int c = 0; c < 9; ++c)
    s_tri[c * kSC + threadIdx.x] =
        tris[((int64_t)c * nsc + s) * kSC + threadIdx.x];
}

template <typename T>
__device__ __forceinline__ T shfl(T x, int src) {
  return __shfl_sync(kFull, x, src);
}

// (t, index) < (t2, index2) in the order of the contract: smaller t, then
// the lower index
template <typename T>
__device__ __forceinline__ bool before(T t2, int j2, T t, int j) {
  return t2 < t || (t2 == t && j2 < j);
}

template <typename T, bool kKeep, bool kSplit>
__global__ void __launch_bounds__(kClosestThreads)
closest_kernel(const T* __restrict__ orig, const T* __restrict__ dirs,
               int64_t ostride, int64_t dstride, int64_t n,
               const T* __restrict__ tris, const T* __restrict__ bmin,
               const T* __restrict__ bmax, int nsc,
               const T* __restrict__ gmin, const T* __restrict__ gmax,
               const T* __restrict__ rmin, const T* __restrict__ rmax,
               int groups_per_part, const bool* __restrict__ keep,
               T* __restrict__ out_t, int32_t* __restrict__ out_i,
               unsigned long long* __restrict__ key) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kClosestThreads + threadIdx.x;
  const bool alive = r < n;
  const RayT<T> ray = load_ray(orig, dirs, ostride, dstride, r, alive);
  const bool live = alive && slab(ray, rmin, rmax, 0);
  T best_t = T(INFINITY);
  int32_t best_i = 0;
  if (__any_sync(kFull, live)) {
    const int64_t plane = (int64_t)nsc * kSC;
    const int ngroups = (nsc + kGroup - 1) / kGroup;
    const int g0 = blockIdx.y * groups_per_part;
    const int g1 = min(ngroups, g0 + groups_per_part);
    for (int g = g0; g < g1; ++g) {
      const bool in_g = live && slab(ray, gmin, gmax, g);
      if (!__any_sync(kFull, in_g)) continue;
      const int s1 = min(nsc, (g + 1) * kGroup);
      for (int s = g * kGroup; s < s1; ++s) {
        unsigned m = __ballot_sync(kFull, in_g && slab(ray, bmin, bmax, s));
        if (!m) continue;
        // this lane's 4 of the supercluster's 128 triangles
        TriT<T> tri[kSC / 32];
        bool kp[kSC / 32];
#pragma unroll
        for (int q = 0; q < kSC / 32; ++q) {
          tri[q] = load_tri(tris + (int64_t)s * kSC, plane, lane + 32 * q);
          if constexpr (kKeep) kp[q] = keep[(int64_t)s * kSC + lane + 32 * q];
        }
        for (; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          RayT<T> rb;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            rb.o[k] = shfl(ray.o[k], src);
            rb.d[k] = shfl(ray.d[k], src);
          }
          // lanes hold disjoint triangles in ascending q: keep the first
          // minimum, then reduce across lanes in the contract's order
          T t_l = T(INFINITY);
          int j_l = kSC;
#pragma unroll
          for (int q = 0; q < kSC / 32; ++q) {
            bool ok;
            const T t = mt_core(rb, tri[q], ok);
            ok = ok && t > T(0);
            if constexpr (kKeep) ok = ok && kp[q];
            if (ok && t < t_l) {
              t_l = t;
              j_l = lane + 32 * q;
            }
          }
          // most pairs hit nothing nearer than the owner's carry: skip the
          // reduction then (an equal t never replaces the carry, as every
          // index here is above the carry's)
          if (!__any_sync(kFull, t_l < shfl(best_t, src))) continue;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const T t2 = __shfl_xor_sync(kFull, t_l, o);
            const int j2 = __shfl_xor_sync(kFull, j_l, o);
            if (before(t2, j2, t_l, j_l)) {
              t_l = t2;
              j_l = j2;
            }
          }
          // superclusters come in index order: an equal t keeps the carry
          if (lane == src && t_l < best_t) {
            best_t = t_l;
            best_i = s * kSC + j_l;
          }
        }
      }
    }
  }
  if constexpr (kSplit) {
    if (alive && best_t < T(INFINITY))
      atomicMin(key + r, (unsigned long long)__float_as_uint((float)best_t)
                                 << 32 | (unsigned)best_i);
  } else if (alive) {
    out_t[r] = best_t;
    out_i[r] = best_i;
  }
}

// the merged keys of a split launch as (t, index); no key: (inf, 0)
__global__ void __launch_bounds__(256)
closest_keys_kernel(const unsigned long long* __restrict__ key, int64_t n,
                    float* __restrict__ out_t, int32_t* __restrict__ out_i) {
  const int64_t r = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (r >= n) return;
  const unsigned long long k = key[r];
  const bool hit = k != ~0ull;
  out_t[r] = hit ? __uint_as_float((unsigned)(k >> 32)) : INFINITY;
  out_i[r] = hit ? (int32_t)(k & 0xffffffffu) : 0;
}

template <typename T>
__global__ void __launch_bounds__(kSC)
shadow_kernel(const T* __restrict__ orig, const T* __restrict__ dirs,
              int64_t ostride, int64_t dstride, int64_t n,
              const T* __restrict__ tris, const T* __restrict__ bmin,
              const T* __restrict__ bmax, int nsc,
              const int32_t* __restrict__ rank,
              const bool* __restrict__ cast, T* __restrict__ out_t,
              int32_t* __restrict__ out_rank) {
  __shared__ T s_tri[9 * kSC];
  __shared__ int32_t s_rank[kSC];
  __shared__ bool s_cast[kSC];
  const int64_t r = (int64_t)blockIdx.x * kSC + threadIdx.x;
  const bool alive = r < n;
  const RayT<T> ray = load_ray(orig, dirs, ostride, dstride, r, alive);
  int32_t acc_r = kNoRank;
  T acc_t = T(INFINITY);
  for (int s = 0; s < nsc; ++s) {
    const bool hit = alive && slab(ray, bmin, bmax, s);
    if (!__syncthreads_or(hit)) continue;
    stage(s_tri, tris, nsc, s);
    s_rank[threadIdx.x] = rank[(int64_t)s * kSC + threadIdx.x];
    s_cast[threadIdx.x] = cast[(int64_t)s * kSC + threadIdx.x];
    __syncthreads();
    if (!hit) continue;
    for (int j = 0; j < kSC; ++j) {
      bool ok;
      const T t = moller_trumbore(ray, s_tri, j, ok);
      ok = ok && t > T(0);
      const int32_t rk = ok ? s_rank[j] : kNoRank;
      const T tc = (ok && s_cast[j]) ? t : T(INFINITY);
      if (rk < acc_r) {
        acc_r = rk;
        acc_t = tc;
      } else if (rk == acc_r && tc < acc_t) {
        acc_t = tc;
      }
    }
  }
  if (alive) {
    out_t[r] = acc_t;
    out_rank[r] = acc_r;
  }
}

inline unsigned blocks(int64_t n) { return (unsigned)((n + kSC - 1) / kSC); }

// Parts the group range is split into for n rays (float32; float64 never
// splits). At least kMinSplit: the pair work piles up in the few warps
// whose rays graze the mesh, and each part of a split warp runs on its
// own (16 measured near the best at the mesh frame's level 0 and probe
// shapes); more when the rays are too few to give every SM 32 warps a
// part. At most one part per group.
constexpr int kMinSplit = 16;

template <typename T>
int closest_split(int64_t n, int nsc) {
  if (sizeof(T) != 4 || n <= 0 || nsc <= 0) return 1;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t warps = (n + 31) / 32;
  const int64_t fill = ((int64_t)sms * 32 + warps - 1) / warps;
  const int64_t want = fill > kMinSplit ? fill : kMinSplit;
  const int ngroups = (nsc + kGroup - 1) / kGroup;
  return (int)(want > ngroups ? ngroups : want);
}

template <typename T, bool kKeep, bool kSplit>
void launch_closest(const void* orig, const void* dirs, int64_t ostride,
                    int64_t dstride, int64_t n, const void* tris,
                    const void* bmin, const void* bmax, int nsc,
                    const void* gmin, const void* gmax, const void* rmin,
                    const void* rmax, int split, const void* keep,
                    void* out_t, void* out_i, void* key,
                    cudaStream_t stream) {
  const int ngroups = (nsc + kGroup - 1) / kGroup;
  const int per = (ngroups + split - 1) / split;
  const dim3 grid((unsigned)((n + kClosestThreads - 1) / kClosestThreads),
                  (unsigned)((ngroups + per - 1) / per));
  closest_kernel<T, kKeep, kSplit><<<grid, kClosestThreads, 0, stream>>>(
      static_cast<const T*>(orig), static_cast<const T*>(dirs), ostride,
      dstride, n, static_cast<const T*>(tris), static_cast<const T*>(bmin),
      static_cast<const T*>(bmax), nsc, static_cast<const T*>(gmin),
      static_cast<const T*>(gmax), static_cast<const T*>(rmin),
      static_cast<const T*>(rmax), per, static_cast<const bool*>(keep),
      static_cast<T*>(out_t), static_cast<int32_t*>(out_i),
      static_cast<unsigned long long*>(key));
}

template <typename T, bool kSplit>
void launch_closest_keep(const void* orig, const void* dirs, int64_t ostride,
                         int64_t dstride, int64_t n, const void* tris,
                         const void* bmin, const void* bmax, int nsc,
                         const void* gmin, const void* gmax, const void* rmin,
                         const void* rmax, int split, const void* keep,
                         void* out_t, void* out_i, void* key,
                         cudaStream_t stream) {
  if (keep)
    launch_closest<T, true, kSplit>(orig, dirs, ostride, dstride, n, tris,
                                    bmin, bmax, nsc, gmin, gmax, rmin, rmax,
                                    split, keep, out_t, out_i, key, stream);
  else
    launch_closest<T, false, kSplit>(orig, dirs, ostride, dstride, n, tris,
                                     bmin, bmax, nsc, gmin, gmax, rmin, rmax,
                                     split, keep, out_t, out_i, key, stream);
}

// split > 1 (float32 only) needs `key`, n 64-bit words of scratch
template <typename T>
int closest(const void* orig, const void* dirs, int64_t ostride,
            int64_t dstride, int64_t n, const void* tris, const void* bmin,
            const void* bmax, int nsc, const void* gmin, const void* gmax,
            const void* rmin, const void* rmax, int split, const void* keep,
            void* out_t, void* out_i, void* key, void* stream_ptr) {
  const int ngroups = (nsc + kGroup - 1) / kGroup;
  if (nsc < 1 || split < 1 || split > ngroups ||
      (split > 1 && (sizeof(T) != 4 || !key)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if constexpr (sizeof(T) == 4) {
    if (split > 1) {
      const cudaError_t err = cudaMemsetAsync(key, 0xff, n * 8, stream);
      if (err != cudaSuccess) return (int)err;
      launch_closest_keep<T, true>(orig, dirs, ostride, dstride, n, tris,
                                   bmin, bmax, nsc, gmin, gmax, rmin, rmax,
                                   split, keep, out_t, out_i, key, stream);
      closest_keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<const unsigned long long*>(key), n,
          static_cast<float*>(out_t), static_cast<int32_t*>(out_i));
      return (int)cudaGetLastError();
    }
  }
  launch_closest_keep<T, false>(orig, dirs, ostride, dstride, n, tris, bmin,
                                bmax, nsc, gmin, gmax, rmin, rmax, 1, keep,
                                out_t, out_i, key, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int shadow(const void* orig, const void* dirs, int64_t ostride,
           int64_t dstride, int64_t n, const void* tris, const void* bmin,
           const void* bmax, int nsc, const void* rank, const void* cast,
           void* out_t, void* out_rank, void* stream) {
  if (n > 0)
    shadow_kernel<T><<<blocks(n), kSC, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(orig), static_cast<const T*>(dirs), ostride,
        dstride, n, static_cast<const T*>(tris), static_cast<const T*>(bmin),
        static_cast<const T*>(bmax), nsc, static_cast<const int32_t*>(rank),
        static_cast<const bool*>(cast), static_cast<T*>(out_t),
        static_cast<int32_t*>(out_rank));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int frt_mesh_sc() { return kSC; }
int frt_mesh_group() { return kGroup; }

#define FRT_MESH_ENTRIES(SUFFIX, T)                                          \
  int frt_mesh_closest_split_##SUFFIX(int64_t n, int nsc) {                  \
    return closest_split<T>(n, nsc);                                         \
  }                                                                          \
  int frt_mesh_closest_##SUFFIX(                                             \
      const void* orig, const void* dirs, int64_t ostride, int64_t dstride,  \
      int64_t n, const void* tris, const void* bmin, const void* bmax,       \
      int nsc, const void* gmin, const void* gmax, const void* rmin,         \
      const void* rmax, int split, const void* keep, void* out_t,            \
      void* out_i, void* key, void* stream) {                                \
    return closest<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax,     \
                      nsc, gmin, gmax, rmin, rmax, split, keep, out_t,       \
                      out_i, key, stream);                                   \
  }                                                                          \
  int frt_mesh_shadow_##SUFFIX(const void* orig, const void* dirs,           \
                               int64_t ostride, int64_t dstride, int64_t n,  \
                               const void* tris, const void* bmin,           \
                               const void* bmax, int nsc, const void* rank,  \
                               const void* cast, void* out_t,                \
                               void* out_rank, void* stream) {               \
    return shadow<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax, nsc, \
                     rank, cast, out_t, out_rank, stream);                   \
  }

FRT_MESH_ENTRIES(f32, float)
FRT_MESH_ENTRIES(f64, double)

}  // extern "C"
