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
// Both results are the minimum of a total order over the (ray, triangle)
// pairs — (t, index) for closest, (rank, casting t) for shadow, a miss being
// the order's top — so neither depends on the visit order or on which rays
// share a warp, which keeps the bucketed wavefront bitwise equal to the
// unrolled trace that batches rays differently.
//
// One kernel skeleton serves both queries (pair_kernel); a query is a
// policy (ClosestQ, ShadowQ) that says what a lane folds, how the warp
// reduces and how the parts of a split launch merge. The skeleton does
// work that follows the (ray, supercluster) pairs whose slab test passes.
// The first design (one thread per ray, a 128-ray block staging every
// supercluster any of its rays passed) left most threads idle behind the
// block's union and walked all superclusters for dead lanes; the TPU kernel
// never had that problem, as it evaluates a block's rays x 128 triangles as
// one vector operation on a shortlist. Here:
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
//     none of whose rays passes the root box writes the empty result and
//     stops, so the fill lanes of the wavefront's buckets cost one test
//     each;
//   - pair-parallel evaluation: a warp owns 32 rays. For each supercluster
//     that some of its rays pass (a ballot), every lane loads 4 of its 128
//     triangles and their per-triangle data (coalesced, from L2: the planes
//     are 5.1 MB at the mesh frame's 141k triangles), then for each passing
//     ray in turn the warp broadcasts the ray, all 32 lanes run
//     Möller–Trumbore on their 4 triangles and fold them, and a shuffle
//     reduction gives the supercluster's result, which the owning lane
//     folds into its carry. Most pairs change nothing, and a warp vote
//     skips their reduction. (Two rays a step, for more independent work
//     per lane, measured slower for closest: the registers it needs cost
//     more than it gains.);
//   - a warp's work is uneven (most pairs fall to the warps whose rays
//     graze the mesh) and a batch may hold too few rays to fill the card
//     (the 16,384-ray soup makes 512 warps on 132 SMs), so in float32 the
//     group range is split across blockIdx.y (split_parts) and the parts
//     merge with a 64-bit atomicMin on a key whose unsigned order is the
//     query's order, whatever the order of the atomics; a second launch
//     turns the keys into results. float64 does not split.
//       closest: (float bits of t) << 32 | index. Non-negative float32
//       bit patterns order as unsigned integers.
//       shadow:  (rank ^ 0x80000000) << 32 | float bits of casting t. The
//       sign flip orders every int32 rank as an unsigned word; a hit has
//       t > 0 and a non-casting hit t = +inf, both ordered as unsigned.
//     Keys start all-ones (a NaN t, never a hit) and decode to the empty
//     result.
//   - shadow's exact rank cull: pack stores each supercluster's and each
//     group's minimum rank. Every pair of a supercluster whose minimum rank
//     is strictly above the ray's carried rank yields a rank above it (a
//     miss yields INT32_MAX, above any carried hit), so it cannot change
//     the result and the lane leaves it out of the ballot; the same for a
//     whole group (tools/mesh_shadow_sweep.py: it took 15-20% off the
//     mesh frame's shadow launches). There is no cut on t: the query
//     returns hits beyond the light, and the integrator compares t with
//     the light's distance.
// No near-to-far order and no per-ray t cut for closest: a box's rounded
// entry t is not a safe lower bound for a Möller–Trumbore t of a triangle
// inside it (a few ulps below, and the stored p1 + e1 is not the vertex the
// box was built from), so a cut would need a margin that was not proven
// bitwise.
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
constexpr int kPerLane = kSC / 32;       // triangles per lane of a warp
constexpr int32_t kNoRank = 0x7fffffff;  // INT32_MAX: no hit
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairThreads = 128;        // 4 independent warps per block

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

template <typename T>
__device__ __forceinline__ T shfl(T x, int src) {
  return __shfl_sync(kFull, x, src);
}

// ---------------------------------------------------------------------------
// the queries, as policies of pair_kernel. Each has
//   Val          what a ray carries; carry0 the empty carry;
//   Aux, aux(j)  triangle j's data besides its planes;
//   eval         one passing ray, broadcast from lane src, against the
//                warp's 128 triangles of supercluster s (4 a lane): each
//                lane folds its 4, a warp vote skips the rest when no
//                lane's fold would change the owner's carry (most pairs),
//                else a shuffle reduction in the query's order and the
//                owner folds the result into its carry;
//   group_ok/sc_ok  whether a group / supercluster can change the carry;
//   finish<kSplit>  the carry into the outputs (t and the index or rank),
//                or into the merge key;
//   decode       a merged key into the outputs (second launch of a split).
// ---------------------------------------------------------------------------

// closest: (t, index), a smaller t first, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T t2, int j2, T t, int j) {
  return t2 < t || (t2 == t && j2 < j);
}

template <typename T, bool kKeep>
struct ClosestQ {
  const bool* keep;

  struct Val {
    T t;
    int32_t i;
  };
  using Aux = bool;

  __device__ static Val carry0() { return {T(INFINITY), 0}; }
  __device__ Aux aux(int64_t j) const {
    if constexpr (kKeep)
      return __ldg(reinterpret_cast<const unsigned char*>(keep) + j) != 0;
    return true;
  }
  __device__ static void eval(Val& c, const RayT<T>& rb,
                              const TriT<T> (&tri)[kPerLane],
                              const Aux (&kp)[kPerLane], int lane, int src,
                              int s) {
    // lanes hold disjoint triangles in ascending k: keep the first
    // minimum, then reduce across lanes in the contract's order
    T t_l = T(INFINITY);
    int j_l = kSC;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      bool ok;
      const T t = mt_core(rb, tri[k], ok);
      ok = ok && t > T(0);
      if constexpr (kKeep) ok = ok && kp[k];
      if (ok && t < t_l) {
        t_l = t;
        j_l = lane + 32 * k;
      }
    }
    // an equal t never replaces the carry: within a part superclusters
    // come in index order, so every index here is above the carry's
    if (!__any_sync(kFull, t_l < shfl(c.t, src))) return;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T t2 = __shfl_xor_sync(kFull, t_l, o);
      const int j2 = __shfl_xor_sync(kFull, j_l, o);
      if (before(t2, j2, t_l, j_l)) {
        t_l = t2;
        j_l = j2;
      }
    }
    if (lane == src && t_l < c.t) {
      c.t = t_l;
      c.i = s * kSC + j_l;
    }
  }
  __device__ bool group_ok(int, const Val&) const { return true; }
  __device__ bool sc_ok(int, const Val&) const { return true; }
  template <bool kSplit>
  __device__ static void finish(int64_t r, bool alive, const Val& c,
                                T* out_t, int32_t* out_i,
                                unsigned long long* key) {
    if constexpr (kSplit) {
      if (alive && c.t < T(INFINITY))
        atomicMin(key + r, (unsigned long long)__float_as_uint((float)c.t)
                               << 32 | (unsigned)c.i);
    } else if (alive) {
      out_t[r] = c.t;
      out_i[r] = c.i;
    }
  }
  // no key: (inf, 0)
  __device__ static void decode(unsigned long long k, T& t, int32_t& i) {
    const bool hit = k != ~0ull;
    t = hit ? __uint_as_float((unsigned)(k >> 32)) : INFINITY;
    i = hit ? (int32_t)(k & 0xffffffffu) : 0;
  }
};

// shadow: (rank, casting t), a lower rank first, then the lower casting t;
// a miss is (kNoRank, inf), a non-casting hit (rank, inf)
template <typename T>
__device__ __forceinline__ bool lower(int32_t r2, T t2, int32_t r, T t) {
  return r2 < r || (r2 == r && t2 < t);
}

template <typename T>
struct ShadowQ {
  const int32_t* rank;
  const bool* cast;
  const int32_t* sc_rank;     // (Nsc,) minimum rank of each supercluster
  const int32_t* group_rank;  // (ceil(Nsc / kGroup),) and of each group

  struct Val {
    int32_t r;
    T t;
  };
  struct Aux {
    int32_t r;
    bool c;
  };

  __device__ static Val carry0() { return {kNoRank, T(INFINITY)}; }
  __device__ Aux aux(int64_t j) const {
    return {__ldg(rank + j),
            __ldg(reinterpret_cast<const unsigned char*>(cast) + j) != 0};
  }
  __device__ static void eval(Val& c, const RayT<T>& rb,
                              const TriT<T> (&tri)[kPerLane],
                              const Aux (&a)[kPerLane], int lane, int src,
                              int) {
    Val v = carry0();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      bool ok;
      const T t = mt_core(rb, tri[k], ok);
      ok = ok && t > T(0);
      const int32_t rk = ok ? a[k].r : kNoRank;
      const T tc = (ok && a[k].c) ? t : T(INFINITY);
      if (lower(rk, tc, v.r, v.t)) {
        v.r = rk;
        v.t = tc;
      }
    }
    if (!__any_sync(kFull, lower(v.r, v.t, shfl(c.r, src), shfl(c.t, src))))
      return;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int32_t r2 = __shfl_xor_sync(kFull, v.r, o);
      const T t2 = __shfl_xor_sync(kFull, v.t, o);
      if (lower(r2, t2, v.r, v.t)) {
        v.r = r2;
        v.t = t2;
      }
    }
    if (lane == src && lower(v.r, v.t, c.r, c.t)) c = v;
  }
  // the rank cull: a pair can change the carry only if some triangle of
  // its supercluster ranks at or below the carried rank
  __device__ bool group_ok(int g, const Val& c) const {
    return __ldg(group_rank + g) <= c.r;
  }
  __device__ bool sc_ok(int s, const Val& c) const {
    return __ldg(sc_rank + s) <= c.r;
  }
  template <bool kSplit>
  __device__ static void finish(int64_t r, bool alive, const Val& c,
                                T* out_t, int32_t* out_r,
                                unsigned long long* key) {
    if constexpr (kSplit) {
      if (alive && lower(c.r, c.t, kNoRank, T(INFINITY)))
        atomicMin(key + r,
                  (unsigned long long)((unsigned)c.r ^ 0x80000000u) << 32 |
                      __float_as_uint((float)c.t));
    } else if (alive) {
      out_t[r] = c.t;
      out_r[r] = c.r;
    }
  }
  // no key: (kNoRank, inf)
  __device__ static void decode(unsigned long long k, T& t, int32_t& rank) {
    const bool hit = k != ~0ull;
    rank = hit ? (int32_t)((unsigned)(k >> 32) ^ 0x80000000u) : kNoRank;
    t = hit ? __uint_as_float((unsigned)k) : INFINITY;
  }
};

// ---------------------------------------------------------------------------
// the skeleton
// ---------------------------------------------------------------------------

template <typename T, typename Q, bool kSplit>
__global__ void __launch_bounds__(kPairThreads)
pair_kernel(const T* __restrict__ orig, const T* __restrict__ dirs,
            int64_t ostride, int64_t dstride, int64_t n,
            const T* __restrict__ tris, const T* __restrict__ bmin,
            const T* __restrict__ bmax, int nsc,
            const T* __restrict__ gmin, const T* __restrict__ gmax,
            const T* __restrict__ rmin, const T* __restrict__ rmax,
            int groups_per_part, const Q q, T* __restrict__ out_t,
            int32_t* __restrict__ out_i, unsigned long long* __restrict__ key) {
  using Val = typename Q::Val;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kPairThreads + threadIdx.x;
  const bool alive = r < n;
  const RayT<T> ray = load_ray(orig, dirs, ostride, dstride, r, alive);
  const bool live = alive && slab(ray, rmin, rmax, 0);
  Val c = Q::carry0();
  if (__any_sync(kFull, live)) {
    const int64_t plane = (int64_t)nsc * kSC;
    const int ngroups = (nsc + kGroup - 1) / kGroup;
    const int g0 = blockIdx.y * groups_per_part;
    const int g1 = min(ngroups, g0 + groups_per_part);
    for (int g = g0; g < g1; ++g) {
      const bool in_g = live && q.group_ok(g, c) && slab(ray, gmin, gmax, g);
      if (!__any_sync(kFull, in_g)) continue;
      const int s1 = min(nsc, (g + 1) * kGroup);
      for (int s = g * kGroup; s < s1; ++s) {
        unsigned m = __ballot_sync(
            kFull, in_g && q.sc_ok(s, c) && slab(ray, bmin, bmax, s));
        if (!m) continue;
        // this lane's 4 of the supercluster's 128 triangles
        TriT<T> tri[kPerLane];
        typename Q::Aux aux[kPerLane];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          tri[k] = load_tri(tris + (int64_t)s * kSC, plane, lane + 32 * k);
          aux[k] = q.aux((int64_t)s * kSC + lane + 32 * k);
        }
        for (; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          RayT<T> rb;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            rb.o[k] = shfl(ray.o[k], src);
            rb.d[k] = shfl(ray.d[k], src);
          }
          Q::eval(c, rb, tri, aux, lane, src, s);
        }
      }
    }
  }
  Q::template finish<kSplit>(r, alive, c, out_t, out_i, key);
}

// the merged keys of a split launch into the query's outputs
template <typename T, typename Q>
__global__ void __launch_bounds__(256)
keys_kernel(const unsigned long long* __restrict__ key, int64_t n,
            T* __restrict__ out_t, int32_t* __restrict__ out_i) {
  const int64_t r = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (r < n) Q::decode(key[r], out_t[r], out_i[r]);
}

// Parts the group range is split into for n rays (float32; float64 never
// splits). At least min_split: the pair work piles up in the few warps
// whose rays graze the mesh, and each part of a split warp runs on its
// own; more when the rays are too few to give every SM 32 warps a part.
// At most one part per group. The floors were measured
// (tools/mesh_shadow_sweep.py for shadow): 16 near the best for closest
// at the mesh frame's level 0 and probe shapes; 32 for shadow, whose
// in-frame launches hold few live rays behind many parked ones, so a few
// warps walk alone.
constexpr int kClosestMinSplit = 16;
constexpr int kShadowMinSplit = 32;

template <typename T>
int split_parts(int64_t n, int nsc, int min_split) {
  if (sizeof(T) != 4 || n <= 0 || nsc <= 0) return 1;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t warps = (n + 31) / 32;
  const int64_t fill = ((int64_t)sms * 32 + warps - 1) / warps;
  const int64_t want = fill > min_split ? fill : min_split;
  const int ngroups = (nsc + kGroup - 1) / kGroup;
  return (int)(want > ngroups ? ngroups : want);
}

// The query q over n rays into (out_t, out_i): split > 1 (float32 only)
// needs key, n 64-bit words of scratch.
template <typename T, typename Q>
int run(const void* orig, const void* dirs, int64_t ostride, int64_t dstride,
        int64_t n, const void* tris, const void* bmin, const void* bmax,
        int nsc, const void* gmin, const void* gmax, const void* rmin,
        const void* rmax, int split, const Q& q, void* out_t, void* out_i,
        void* key, void* stream_ptr) {
  const int ngroups = (nsc + kGroup - 1) / kGroup;
  if (nsc < 1 || split < 1 || split > ngroups ||
      (split > 1 && (sizeof(T) != 4 || !key)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int per = (ngroups + split - 1) / split;
  const dim3 grid((unsigned)((n + kPairThreads - 1) / kPairThreads),
                  (unsigned)((ngroups + per - 1) / per));
  const T* o = static_cast<const T*>(orig);
  const T* d = static_cast<const T*>(dirs);
  const T* tr = static_cast<const T*>(tris);
  const T* bn = static_cast<const T*>(bmin);
  const T* bx = static_cast<const T*>(bmax);
  const T* gn = static_cast<const T*>(gmin);
  const T* gx = static_cast<const T*>(gmax);
  const T* rn = static_cast<const T*>(rmin);
  const T* rx = static_cast<const T*>(rmax);
  T* ot = static_cast<T*>(out_t);
  int32_t* oi = static_cast<int32_t*>(out_i);
  auto* k = static_cast<unsigned long long*>(key);
  if constexpr (sizeof(T) == 4) {
    if (split > 1) {
      const cudaError_t err = cudaMemsetAsync(k, 0xff, n * 8, stream);
      if (err != cudaSuccess) return (int)err;
      pair_kernel<T, Q, true><<<grid, kPairThreads, 0, stream>>>(
          o, d, ostride, dstride, n, tr, bn, bx, nsc, gn, gx, rn, rx, per, q,
          ot, oi, k);
      keys_kernel<T, Q><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          k, n, ot, oi);
      return (int)cudaGetLastError();
    }
  }
  pair_kernel<T, Q, false><<<grid, kPairThreads, 0, stream>>>(
      o, d, ostride, dstride, n, tr, bn, bx, nsc, gn, gx, rn, rx, per, q, ot,
      oi, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int frt_mesh_sc() { return kSC; }
int frt_mesh_group() { return kGroup; }

#define FRT_MESH_ENTRIES(SUFFIX, T)                                           \
  int frt_mesh_closest_split_##SUFFIX(int64_t n, int nsc) {                   \
    return split_parts<T>(n, nsc, kClosestMinSplit);                          \
  }                                                                           \
  int frt_mesh_shadow_split_##SUFFIX(int64_t n, int nsc) {                    \
    return split_parts<T>(n, nsc, kShadowMinSplit);                           \
  }                                                                           \
  int frt_mesh_closest_##SUFFIX(                                              \
      const void* orig, const void* dirs, int64_t ostride, int64_t dstride,   \
      int64_t n, const void* tris, const void* bmin, const void* bmax,        \
      int nsc, const void* gmin, const void* gmax, const void* rmin,          \
      const void* rmax, int split, const void* keep, void* out_t,             \
      void* out_i, void* key, void* stream) {                                 \
    const bool* kp = static_cast<const bool*>(keep);                          \
    if (kp)                                                                   \
      return run<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax, nsc,   \
                    gmin, gmax, rmin, rmax, split, ClosestQ<T, true>{kp},     \
                    out_t, out_i, key, stream);                               \
    return run<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax, nsc,     \
                  gmin, gmax, rmin, rmax, split, ClosestQ<T, false>{kp},      \
                  out_t, out_i, key, stream);                                 \
  }                                                                           \
  int frt_mesh_shadow_##SUFFIX(                                               \
      const void* orig, const void* dirs, int64_t ostride, int64_t dstride,   \
      int64_t n, const void* tris, const void* bmin, const void* bmax,        \
      int nsc, const void* gmin, const void* gmax, const void* rmin,          \
      const void* rmax, int split, const void* rank, const void* cast,        \
      const void* sc_rank, const void* group_rank, void* out_t,               \
      void* out_rank, void* key, void* stream) {                              \
    if (!rank || !cast || !sc_rank || !group_rank)                            \
      return (int)cudaErrorInvalidValue;                                      \
    return run<T>(orig, dirs, ostride, dstride, n, tris, bmin, bmax, nsc,     \
                  gmin, gmax, rmin, rmax, split,                              \
                  ShadowQ<T>{static_cast<const int32_t*>(rank),               \
                             static_cast<const bool*>(cast),                  \
                             static_cast<const int32_t*>(sc_rank),            \
                             static_cast<const int32_t*>(group_rank)},        \
                  out_t, out_rank, key, stream);                              \
  }

FRT_MESH_ENTRIES(f32, float)
FRT_MESH_ENTRIES(f64, double)

}  // extern "C"
