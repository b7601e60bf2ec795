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
// Design, simple first: one thread per ray, blocks of 128 rays. The block
// walks every supercluster in index order; each thread slab-tests its own
// ray, __syncthreads_or skips superclusters no ray of the block passes,
// and otherwise the block stages the supercluster's 9 x 128 triangle
// components (plus keep, or rank and cast) in shared memory — one value
// per thread per plane, coalesced — and each ray that passed folds the
// 128 triangles into its carry, reading shared memory as broadcasts.
// There is no resident/streaming split: the TPU kernel needed one for its
// 8 MB VMEM budget, and on the H100 the 141k-triangle planes (5.1 MB) and
// even a 512k-triangle soup (19 MB) sit in the 50 MB L2.
//
// What bounds it: FP32 (FP64) issue rate times the (ray, triangle) pairs
// it evaluates — 128 per passed (ray, supercluster) slab test, about 45
// floating-point operations each with one IEEE division — plus the slab
// tests of every (ray, supercluster); the bytes (rays, planes, results)
// are a few MB. Visiting near-to-far with a per-ray t cut is the next step.
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
constexpr int32_t kNoRank = 0x7fffffff;  // INT32_MAX: no hit

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

// mesh_pallas._mt_core for triangle j of the staged supercluster c, laid
// out as 9 component rows of kSC values: [p1 | e1 | e2] x [x y z]
template <typename T>
__device__ __forceinline__ T moller_trumbore(const RayT<T>& ray,
                                             const T* c, int j, bool& ok) {
  const T p1x = c[0 * kSC + j], p1y = c[1 * kSC + j], p1z = c[2 * kSC + j];
  const T e1x = c[3 * kSC + j], e1y = c[4 * kSC + j], e1z = c[5 * kSC + j];
  const T e2x = c[6 * kSC + j], e2y = c[7 * kSC + j], e2z = c[8 * kSC + j];
  const T dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
  // pvec = d x e2
  const T px = dy * e2z - dz * e2y;
  const T py = dz * e2x - dx * e2z;
  const T pz = dx * e2y - dy * e2x;
  const T det = e1x * px + e1y * py + e1z * pz;
  ok = absval(det) >= T(1e-5);
  const T f = T(1) / (ok ? det : T(1));
  const T tx = ray.o[0] - p1x;
  const T ty = ray.o[1] - p1y;
  const T tz = ray.o[2] - p1z;
  const T u = f * (tx * px + ty * py + tz * pz);
  ok = ok && u >= T(0) && u <= T(1);
  // qvec = (o - p1) x e1
  const T qx = ty * e1z - tz * e1y;
  const T qy = tz * e1x - tx * e1z;
  const T qz = tx * e1y - ty * e1x;
  const T v = f * (dx * qx + dy * qy + dz * qz);
  ok = ok && v >= T(0) && u + v <= T(1);
  return f * (e2x * qx + e2y * qy + e2z * qz);
}

template <typename T>
__device__ __forceinline__ void stage(T* s_tri, const T* __restrict__ tris,
                                      int nsc, int s) {
#pragma unroll
  for (int c = 0; c < 9; ++c)
    s_tri[c * kSC + threadIdx.x] =
        tris[((int64_t)c * nsc + s) * kSC + threadIdx.x];
}

template <typename T, bool kKeep>
__global__ void __launch_bounds__(kSC)
closest_kernel(const T* __restrict__ orig, const T* __restrict__ dirs,
               int64_t ostride, int64_t dstride, int64_t n,
               const T* __restrict__ tris, const T* __restrict__ bmin,
               const T* __restrict__ bmax, int nsc,
               const bool* __restrict__ keep, T* __restrict__ out_t,
               int32_t* __restrict__ out_i) {
  __shared__ T s_tri[9 * kSC];
  __shared__ bool s_keep[kSC];
  const int64_t r = (int64_t)blockIdx.x * kSC + threadIdx.x;
  const bool alive = r < n;
  const RayT<T> ray = load_ray(orig, dirs, ostride, dstride, r, alive);
  T best_t = T(INFINITY);
  int32_t best_i = 0;
  for (int s = 0; s < nsc; ++s) {
    const bool hit = alive && slab(ray, bmin, bmax, s);
    // also the barrier that ends the previous supercluster's reads
    if (!__syncthreads_or(hit)) continue;
    stage(s_tri, tris, nsc, s);
    if constexpr (kKeep)
      s_keep[threadIdx.x] = keep[(int64_t)s * kSC + threadIdx.x];
    __syncthreads();
    if (!hit) continue;
    for (int j = 0; j < kSC; ++j) {
      bool ok;
      const T t = moller_trumbore(ray, s_tri, j, ok);
      ok = ok && t > T(0);
      if constexpr (kKeep) ok = ok && s_keep[j];
      if (ok && t < best_t) {
        best_t = t;
        best_i = s * kSC + j;
      }
    }
  }
  if (alive) {
    out_t[r] = best_t;
    out_i[r] = best_i;
  }
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

template <typename T, bool kKeep>
void launch_closest(const void* orig, const void* dirs, int64_t ostride,
                    int64_t dstride, int64_t n, const void* tris,
                    const void* bmin, const void* bmax, int nsc,
                    const void* keep, void* out_t, void* out_i,
                    void* stream) {
  closest_kernel<T, kKeep>
      <<<blocks(n), kSC, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(orig), static_cast<const T*>(dirs), ostride,
          dstride, n, static_cast<const T*>(tris),
          static_cast<const T*>(bmin), static_cast<const T*>(bmax), nsc,
          static_cast<const bool*>(keep), static_cast<T*>(out_t),
          static_cast<int32_t*>(out_i));
}

template <typename T>
int closest(const void* orig, const void* dirs, int64_t ostride,
            int64_t dstride, int64_t n, const void* tris, const void* bmin,
            const void* bmax, int nsc, const void* keep, void* out_t,
            void* out_i, void* stream) {
  if (n > 0 && keep)
    launch_closest<T, true>(orig, dirs, ostride, dstride, n, tris, bmin,
                            bmax, nsc, keep, out_t, out_i, stream);
  else if (n > 0)
    launch_closest<T, false>(orig, dirs, ostride, dstride, n, tris, bmin,
                             bmax, nsc, keep, out_t, out_i, stream);
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

#define FRT_MESH_ENTRIES(SUFFIX, T)                                          \
  int frt_mesh_closest_##SUFFIX(const void* orig, const void* dirs,          \
                                int64_t ostride, int64_t dstride, int64_t n, \
                                const void* tris, const void* bmin,          \
                                const void* bmax, int nsc, const void* keep, \
                                void* out_t, void* out_i, void* stream) {    \
    return closest<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax,     \
                      nsc, keep, out_t, out_i, stream);                      \
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
