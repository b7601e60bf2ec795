"""Clustered-mesh ray queries: Möller–Trumbore over 128-triangle
superclusters behind a per-ray slab test.

`pack(ir, ...)` lays a clustered mesh out once per scene as `MeshTables`:
the triangle soup as 9 component planes (9, Nsc, 128) [p1|e1|e2 x xyz],
the AABB of each supercluster (two adjacent Morton-ordered 64-triangle
clusters), the boxes of groups of GROUP consecutive superclusters and the
root box over all of them (the kernels' cull), per-triangle planes of
shadow-walk rank, casts-shadow flag and (for refraction) Ni, and the
minimum rank of each supercluster and of each group (the shadow kernel's
rank cull).
Then:
- `closest(m, orig, dirs, keep)`: per ray the minimum positive t and the
  lowest triangle index at that t; (inf, 0) on a miss; `keep` drops
  triangles from the query;
- `shadow(m, orig, dirs)`: the reference's early-exit shadow walk as a
  rank-lexicographic monoid — the minimum shadow-walk rank among positive
  hits (INT32_MAX when none), then the nearest casting t within it;
- `containers(m, orig, dirs, t_hit, hit_tri)`: the mesh's share of the
  refraction containers walk (plain torch only, as in the JAX package).

On a CUDA tensor `closest` and `shadow` launch the hand-written kernels
of `csrc/mesh.cu` (replacing the TPU kernels `_closest_kernel`,
`_stream_closest_kernel`, `_shadow_kernel` and `_stream_shadow_kernel` of
fast_ray_tracer_tpu/ops/mesh_pallas.py); on a CPU tensor they take the
plain torch versions below, which define the contract the kernels are
held to bit for bit:
- the cull is per ray: a ray takes hits only from superclusters whose
  slab test it passes itself (mesh_pallas._shortlist's test: the 1e-12
  safe inverse, tmin <= tmax, tmax > 0). The TPU kernel culls per 32-ray
  block; per ray, the result does not depend on which rays share a block;
- the Möller–Trumbore arithmetic is mesh_pallas._mt_core, term for term;
- on equal t the lowest triangle index wins, independent of visit order.
The plain versions gather the (ray, supercluster) pairs that pass the
slab test, in chunks, so memory stays bounded; they sync with the host
once per chunk (the tracer's site `mesh_pairs`, as does `containers`,
which runs on every device) and may be slow. None of the TPU kernel's
gates carry over (f32 only, ranks below 2^24, Nsc <= 16384, the VMEM
budget): the kernels take float32 and float64 and ranks as int32.
`LAUNCHES` counts kernel launches per query.

Neither the kernels nor the plain versions record an autograd graph: the
callers run them under no_grad, and integrator.mesh_hit_t gives the
closest hit's t its gradient through `moller_trumbore` on the winning
triangle (the same route on both devices). The shadow and containers
queries stay gradient-free, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch.constants import EPSILON
from fast_ray_tracer_tpu_torch.utils.profiling import CounterGroup, host_sync

SC = 128                   # triangles per supercluster (two clusters of 64)
GROUP = 32                 # superclusters per group box
INT32_MAX = 2**31 - 1
_BIG = 1e30                # empty-box sentinel of padded superclusters
# elements of the largest (rays x boxes x 3) or (pairs x SC) temporaries
_CHUNK_ELEMS = 1 << 22

# kernel launches per query since the last reset (a plain int each); the
# tracer's counters launches.mesh_closest and launches.mesh_shadow
LAUNCHES = CounterGroup("launches.", "mesh_closest", "mesh_shadow")


class MeshTables(NamedTuple):
    """A clustered mesh packed for the queries, on the scene's device."""
    tris: torch.Tensor           # (9, Nsc, SC) [p1|e1|e2 x xyz]
    box_min: torch.Tensor        # (Nsc, 3) supercluster AABBs
    box_max: torch.Tensor
    rank: torch.Tensor           # (Nsc, SC) int32 shadow-walk rank
    cast: torch.Tensor           # (Nsc, SC) bool casts shadow
    ni: Optional[torch.Tensor]   # (Nsc, SC) Ni, for the containers walk
    # the kernels' cull (group_boxes): (ceil(Nsc / GROUP), 3) group boxes
    # and the (1, 3) root box
    group_min: Optional[torch.Tensor] = None
    group_max: Optional[torch.Tensor] = None
    root_min: Optional[torch.Tensor] = None
    root_max: Optional[torch.Tensor] = None
    # the shadow kernel's rank cull (min_ranks): (Nsc,) and
    # (ceil(Nsc / GROUP),) int32 minimum ranks
    sc_rank: Optional[torch.Tensor] = None
    group_rank: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# packing (once per scene)
# ---------------------------------------------------------------------------

def pack_plane(vals, fill):
    """(Nt,) per-triangle values -> (Nsc, SC), the tail padded with fill."""
    nt = vals.shape[0]
    pad = -nt % SC
    tail = torch.full((pad,), fill, dtype=vals.dtype, device=vals.device)
    return torch.cat([vals, tail]).reshape(-1, SC).contiguous()


def pack_tris(p1, e1, e2):
    """(9, Nsc, SC) component planes, padded with zero triangles (zero
    edges: det = 0, never a hit)."""
    return torch.stack([pack_plane(a[:, k], 0.0)
                        for a in (p1, e1, e2) for k in range(3)])


def sc_boxes(cluster_min, cluster_max):
    """Supercluster AABBs: the union of each pair of adjacent 64-triangle
    clusters; an odd last cluster pairs with an empty box."""
    per = 2
    pad = -cluster_min.shape[0] % per
    big = lambda v: torch.full((pad, 3), v, dtype=cluster_min.dtype,
                               device=cluster_min.device)
    cmin = torch.cat([cluster_min, big(_BIG)]).reshape(-1, per, 3)
    cmax = torch.cat([cluster_max, big(-_BIG)]).reshape(-1, per, 3)
    return cmin.amin(1).contiguous(), cmax.amax(1).contiguous()


def group_boxes(box_min, box_max):
    """Boxes of GROUP consecutive superclusters, and the root box over all:
    (group_min, group_max) (ceil(Nsc / GROUP), 3) and (root_min, root_max)
    (1, 3), each the exact componentwise min / max of its members' bounds.
    A member bound that is NaN fails every slab test, so it is left out.
    The last group is not padded with boxes: the kernel takes its members
    by count (the empty-box sentinel _BIG would pass every live ray's slab
    test)."""
    nsc = box_min.shape[0]
    pad = -nsc % GROUP
    dt, dev = box_min.dtype, box_min.device

    def reduce(x, neutral, op):
        x = torch.where(torch.isnan(x), neutral, x)
        x = torch.cat([x, torch.full((pad, 3), neutral, dtype=dt,
                                     device=dev)])
        g = op(x.reshape(-1, GROUP, 3), 1).contiguous()
        return g, op(g, 0, keepdim=True).contiguous()

    (gmin, rmin), (gmax, rmax) = (reduce(box_min, torch.inf, torch.amin),
                                  reduce(box_max, -torch.inf, torch.amax))
    return gmin, gmax, rmin, rmax


def min_ranks(rank):
    """The minimum of each supercluster's rank row (Nsc,) and of each group
    of GROUP consecutive superclusters (ceil(Nsc / GROUP),), the last group
    over the superclusters it holds. A padded triangle's INT32_MAX is
    counted like any rank: it only lowers a minimum, which keeps the cull
    exact."""
    sc = rank.amin(1)
    pad = torch.full((-sc.shape[0] % GROUP,), INT32_MAX, dtype=sc.dtype,
                     device=sc.device)
    return sc, torch.cat([sc, pad]).reshape(-1, GROUP).amin(1)


_FITS_INT32 = (torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def _int32_ranks(tri_rank):
    """tri_rank as int32; raises on a value outside int32. A dtype that
    can hold one is range-checked, which on the card costs one host sync
    (once per pack, outside the chunk loop)."""
    if tri_rank.dtype not in _FITS_INT32 and tri_rank.numel():
        with host_sync("mesh_pack"):
            lo, hi = (int(x) for x in torch.aminmax(tri_rank))
        if lo < -2**31 or hi > INT32_MAX:
            raise ValueError(f"mesh ranks must fit in int32: [{lo}, {hi}]")
    return tri_rank.to(torch.int32)


def pack(ir, tri_rank, tri_shadow, tri_ni=None) -> MeshTables:
    """Pack a clustered mesh (ir.meta.use_clusters, cluster_size 64)."""
    box_min, box_max = sc_boxes(ir.cluster_min, ir.cluster_max)
    rank = pack_plane(_int32_ranks(tri_rank), INT32_MAX)
    sc_rank, group_rank = min_ranks(rank)
    return MeshTables(
        tris=pack_tris(ir.tri_p1, ir.tri_e1, ir.tri_e2),
        box_min=box_min, box_max=box_max, rank=rank,
        cast=pack_plane(tri_shadow, False),
        ni=None if tri_ni is None else pack_plane(tri_ni, 1.0),
        **dict(zip(("group_min", "group_max", "root_min", "root_max"),
                   group_boxes(box_min, box_max))),
        sc_rank=sc_rank, group_rank=group_rank)


# ---------------------------------------------------------------------------
# the arithmetic shared with the dense intersector
# ---------------------------------------------------------------------------

def moller_trumbore(o, d, comp):
    """Möller–Trumbore (src/shapes/triangle.c:10-44) in the term order of
    mesh_pallas._mt_core. o, d: 3 tensors each (x, y, z), comp: 9 tensors
    [p1x..e2z], all broadcastable. Returns (t, u, v, ok): ok is the
    triangle test without any sign condition on t."""
    ox, oy, oz = o
    dx, dy, dz = d
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z = comp
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= EPSILON
    f = 1.0 / torch.where(ok, det, 1.0)
    tx = ox - p1x
    ty = oy - p1y
    tz = oz - p1z
    u = f * (tx * px + ty * py + tz * pz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    # qvec = (o - p1) x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return t, u, v, ok


def cluster_mask(box_min, box_max, orig, dirs, line: bool = False):
    """Ray-vs-AABB slab test, (R, Nb) bool (mesh_pallas._shortlist's
    arithmetic). line=True keeps boxes behind the origin (tmax <= 0): the
    refraction containers walk counts intersections of any sign, and the
    reference's bounding_box_intersects has no positivity test
    (bounding_box.c:165-175)."""
    tiny = torch.full_like(dirs, 1e-12)
    safe = torch.where(dirs.abs() < tiny, torch.where(dirs < 0, -tiny, tiny),
                       dirs)
    inv = 1.0 / safe
    lo = hi = None
    for k in range(3):
        o_k, i_k = orig[:, k:k + 1], inv[:, k:k + 1]
        t1 = (box_min[None, :, k] - o_k) * i_k
        t2 = (box_max[None, :, k] - o_k) * i_k
        mn, mx = torch.minimum(t1, t2), torch.maximum(t1, t2)
        lo = mn if lo is None else torch.maximum(lo, mn)
        hi = mx if hi is None else torch.minimum(hi, mx)
    hit = lo <= hi
    return hit if line else hit & (hi > 0.0)


# ---------------------------------------------------------------------------
# plain torch versions (CPU path and reference)
# ---------------------------------------------------------------------------

def _pairs(m: MeshTables, orig, dirs, line: bool = False):
    """The (ray, supercluster) pairs whose slab test passes, in chunks of
    at most _CHUNK_ELEMS / SC pairs: yields (ray ids, supercluster ids),
    each chunk's rays in order."""
    nsc = m.box_min.shape[0]
    rows = max(1, _CHUNK_ELEMS // (3 * nsc))
    per = max(1, _CHUNK_ELEMS // SC)
    for r0 in range(0, orig.shape[0], rows):
        hit = cluster_mask(m.box_min, m.box_max, orig[r0:r0 + rows],
                           dirs[r0:r0 + rows], line)
        with host_sync("mesh_pairs"):
            r, s = hit.nonzero(as_tuple=True)
        for p0 in range(0, r.shape[0], per):
            yield r[p0:p0 + per] + r0, s[p0:p0 + per]


def _pair_hits(m: MeshTables, orig, dirs, r, s):
    """Möller–Trumbore of each pair's ray against its supercluster's 128
    triangles: (t, ok), each (P, SC)."""
    o, d = orig[r], dirs[r]
    comp = m.tris[:, s]                                   # (9, P, SC)
    t, _, _, ok = moller_trumbore(
        [o[:, k:k + 1] for k in range(3)], [d[:, k:k + 1] for k in range(3)],
        list(comp))
    return t, ok


def _cat(parts, dtype, device):
    """torch.cat of per-chunk results, empty when no pair passed."""
    return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype,
                                                     device=device)


def _lowest_lane(tm, val):
    """Per row of tm (P, SC), the lowest lane whose value is `val` (P,)."""
    lane = torch.arange(SC, device=tm.device)
    return torch.where(tm == val[:, None], lane, SC).amin(1)


def closest_plain(m: MeshTables, orig, dirs, keep=None):
    """Plain torch closest: (t (R,), tri_index (R,) int32). `keep`: an
    optional (Nsc, SC) bool plane."""
    n, dev = orig.shape[0], orig.device
    pr, pt, pi = [], [], []
    for r, s in _pairs(m, orig, dirs):
        t, ok = _pair_hits(m, orig, dirs, r, s)
        ok = ok & (t > 0.0)
        if keep is not None:
            ok = ok & keep[s]
        tm = torch.where(ok, t, torch.inf)
        tmin = tm.amin(1)
        pr.append(r)
        pt.append(tmin)
        pi.append(s * SC + _lowest_lane(tm, tmin))
    r = _cat(pr, torch.long, dev)
    pt = _cat(pt, orig.dtype, dev)
    pi = _cat(pi, torch.long, dev)
    best_t = torch.full((n,), torch.inf, dtype=orig.dtype, device=dev)
    best_t.scatter_reduce_(0, r, pt, "amin")
    cand = torch.where((pt == best_t[r]) & torch.isfinite(pt), pi, INT32_MAX)
    best_i = torch.full((n,), INT32_MAX, dtype=torch.long, device=dev)
    best_i.scatter_reduce_(0, r, cand, "amin")
    idx = torch.where(torch.isfinite(best_t), best_i, 0)
    return best_t, idx.to(torch.int32)


def shadow_plain(m: MeshTables, orig, dirs):
    """Plain torch shadow: (rank (R,) int32, t (R,))."""
    n, dev = orig.shape[0], orig.device
    pr, prk, pt = [], [], []
    for r, s in _pairs(m, orig, dirs):
        t, ok = _pair_hits(m, orig, dirs, r, s)
        ok = ok & (t > 0.0)
        rk = torch.where(ok, m.rank[s], INT32_MAX)
        rmin = rk.amin(1)
        sel = ok & (rk == rmin[:, None]) & m.cast[s]
        pr.append(r)
        prk.append(rmin)
        pt.append(torch.where(sel, t, torch.inf).amin(1))
    r = _cat(pr, torch.long, dev)
    prk = _cat(prk, torch.int32, dev)
    pt = _cat(pt, orig.dtype, dev)
    best_r = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
    best_r.scatter_reduce_(0, r, prk, "amin")
    best_t = torch.full((n,), torch.inf, dtype=orig.dtype, device=dev)
    best_t.scatter_reduce_(0, r, torch.where(prk == best_r[r], pt, torch.inf),
                           "amin")
    return best_r, best_t


def containers(m: MeshTables, orig, dirs, t_hit, hit_tri):
    """The clustered mesh's share of the refraction containers walk
    (renderer.c:406-447), the port of intersect.mesh_containers.

    The walk runs over the fully sorted intersection list, negative t
    included. A triangle gives a ray at most one intersection, so its
    parity before the hit is "has an entry with t < t_hit", and the walk's
    candidate is the included entry with the latest t. The inclusive walk
    (n2) also counts the hit triangle itself (`hit_tri`, -1 when the hit
    is not on the mesh). Every supercluster whose box the line of a ray
    with a hit crosses is folded. Returns (t1, ni1, t2, ni2): the latest
    included entry's t (-inf if none) and its Ni (1.0 if none) for each
    walk; on equal t the lowest triangle index gives the Ni."""
    n, dev, dt = orig.shape[0], orig.device, orig.dtype
    lane = torch.arange(SC, device=dev)
    # a ray without a hit (t_hit = -inf, hit_tri = -1) includes no entry
    with host_sync("mesh_pairs"):
        live = torch.isfinite(t_hit).nonzero()[:, 0]
    o_live, d_live = orig[live], dirs[live]
    pr, pts, pis = [], ([], []), ([], [])
    for r, s in _pairs(m, o_live, d_live, line=True):
        t, ok = _pair_hits(m, o_live, d_live, r, s)
        r = live[r]
        fin = ok & torch.isfinite(t)
        inc1 = fin & (t < t_hit[r][:, None])
        inc2 = inc1 | (fin & (s[:, None] * SC + lane == hit_tri[r][:, None]))
        pr.append(r)
        for k, inc in enumerate((inc1, inc2)):
            tm = torch.where(inc, t, -torch.inf)
            tmax = tm.amax(1)
            pts[k].append(tmax)
            pis[k].append(s * SC + _lowest_lane(tm, tmax))
    r = _cat(pr, torch.long, dev)
    ni = m.ni.reshape(-1)
    out = []
    for k in range(2):
        pt = _cat(pts[k], dt, dev)
        pi = _cat(pis[k], torch.long, dev)
        best = torch.full((n,), -torch.inf, dtype=dt, device=dev)
        best.scatter_reduce_(0, r, pt, "amax")
        cand = torch.where((pt == best[r]) & torch.isfinite(pt), pi,
                           INT32_MAX)
        arg = torch.full((n,), INT32_MAX, dtype=torch.long, device=dev)
        arg.scatter_reduce_(0, r, cand, "amin")
        fin = torch.isfinite(best)
        out += [best, torch.where(fin, ni[torch.where(fin, arg, 0)], 1.0)]
    return tuple(out)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_lib = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("mesh")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        rays_tree = [vp, vp, i64, i64, i64, vp, vp, vp, i32, vp, vp, vp, vp,
                     i32]
        for sfx in _SUFFIX.values():
            for query in ("closest", "shadow"):
                fn = getattr(lib, f"frt_mesh_{query}_split_{sfx}")
                fn.argtypes = [i64, i32]
                fn.restype = i32
            fn = getattr(lib, f"frt_mesh_closest_{sfx}")
            fn.argtypes = rays_tree + [vp, vp, vp, vp, vp]
            fn.restype = i32
            fn = getattr(lib, f"frt_mesh_shadow_{sfx}")
            fn.argtypes = rays_tree + [vp, vp, vp, vp, vp, vp, vp, vp]
            fn.restype = i32
        lib.frt_mesh_sc.restype = i32
        lib.frt_mesh_group.restype = i32
        if (lib.frt_mesh_sc(), lib.frt_mesh_group()) != (SC, GROUP):
            raise RuntimeError("csrc/mesh.cu and ops/mesh.py disagree on "
                               "the supercluster or group size")
        _lib = lib
    return _lib


def _check(m: MeshTables, orig, dirs, what: str, shadow: bool = False):
    """The kernels' preconditions; raises on anything they do not take.
    Both kernels need the group and root boxes, shadow the minimum ranks
    too (mesh.pack builds them)."""
    dt, dev = orig.dtype, orig.device
    if dt not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 rays, got {dt}")
    for name, x in (("orig", orig), ("dirs", dirs)):
        if x.dim() != 2 or x.shape[1] != 3 or x.stride(1) != 1:
            raise ValueError(f"{what}: {name} must be (R, 3) with unit "
                             "column stride")
    if orig.shape[0] != dirs.shape[0] or orig.shape[0] >= 2**31:
        raise ValueError(f"{what}: {orig.shape[0]} origins, "
                         f"{dirs.shape[0]} directions")
    nsc = m.box_min.shape[0]
    ng = -(-nsc // GROUP)
    tables = {"tris": ((9, nsc, SC), dt), "box_min": ((nsc, 3), dt),
              "box_max": ((nsc, 3), dt), "rank": ((nsc, SC), torch.int32),
              "cast": ((nsc, SC), torch.bool),
              "group_min": ((ng, 3), dt), "group_max": ((ng, 3), dt),
              "root_min": ((1, 3), dt), "root_max": ((1, 3), dt)}
    if shadow:
        tables.update(sc_rank=((nsc,), torch.int32),
                      group_rank=((ng,), torch.int32))
    if dirs.dtype != dt:
        raise TypeError(f"{what}: mixed dtypes {dt} and {dirs.dtype}")
    for name, (shape, dtype) in tables.items():
        x = getattr(m, name)
        if x is None or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != dev or x.dtype != dtype:
            raise ValueError(f"{what}: {name} must be a contiguous {shape} "
                             f"{dtype} tensor on {dev} (mesh.pack builds "
                             "it)")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _rays_tree(m: MeshTables, orig, dirs, split):
    """The leading arguments of both kernel entries."""
    return (orig.data_ptr(), dirs.data_ptr(), orig.stride(0), dirs.stride(0),
            orig.shape[0], m.tris.data_ptr(), m.box_min.data_ptr(),
            m.box_max.data_ptr(), m.box_min.shape[0], m.group_min.data_ptr(),
            m.group_max.data_ptr(), m.root_min.data_ptr(),
            m.root_max.data_ptr(), split)


def _split(lib, query: str, m: MeshTables, orig):
    """Parts of a launch and their merge keys: float32 splits the group
    range (csrc/mesh.cu split_parts) and the parts merge through 64-bit
    keys."""
    n = orig.shape[0]
    split = getattr(lib, f"frt_mesh_{query}_split_"
                    + _SUFFIX[orig.dtype])(n, m.box_min.shape[0])
    key = torch.empty(n, dtype=torch.int64, device=orig.device) \
        if split > 1 else None
    return split, key


def closest_cuda(m: MeshTables, orig, dirs, keep=None):
    """closest through the CUDA kernel (csrc/mesh.cu)."""
    _check(m, orig, dirs, "mesh closest")
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != m.rank.shape
                             or not keep.is_contiguous()
                             or keep.device != orig.device):
        raise ValueError("mesh closest: keep must be a contiguous bool "
                         f"{tuple(m.rank.shape)} plane on {orig.device}")
    lib = _load()
    n = orig.shape[0]
    with torch.cuda.device(orig.device):
        t = torch.empty(n, dtype=orig.dtype, device=orig.device)
        idx = torch.empty(n, dtype=torch.int32, device=orig.device)
        split, key = _split(lib, "closest", m, orig)
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        err = getattr(lib, "frt_mesh_closest_" + _SUFFIX[orig.dtype])(
            *_rays_tree(m, orig, dirs, split),
            None if keep is None else keep.data_ptr(), t.data_ptr(),
            idx.data_ptr(), None if key is None else key.data_ptr(), stream)
        LAUNCHES.add("mesh_closest")
    _raise_on(err, "mesh closest")
    return t, idx


def shadow_cuda(m: MeshTables, orig, dirs):
    """shadow through the CUDA kernel (csrc/mesh.cu)."""
    _check(m, orig, dirs, "mesh shadow", shadow=True)
    lib = _load()
    n = orig.shape[0]
    with torch.cuda.device(orig.device):
        t = torch.empty(n, dtype=orig.dtype, device=orig.device)
        rank = torch.empty(n, dtype=torch.int32, device=orig.device)
        split, key = _split(lib, "shadow", m, orig)
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        err = getattr(lib, "frt_mesh_shadow_" + _SUFFIX[orig.dtype])(
            *_rays_tree(m, orig, dirs, split), m.rank.data_ptr(),
            m.cast.data_ptr(), m.sc_rank.data_ptr(), m.group_rank.data_ptr(),
            t.data_ptr(), rank.data_ptr(),
            None if key is None else key.data_ptr(), stream)
        LAUNCHES.add("mesh_shadow")
    _raise_on(err, "mesh shadow")
    return rank, t


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _on(x, plain, cuda):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no mesh query for tensors on {x.device}")


def closest(m: MeshTables, orig, dirs, keep=None):
    """Nearest positive triangle hit per ray: (t (R,), tri_index (R,)
    int32); (inf, 0) on a miss. `keep`: optional (Nt,) bool — triangles
    to consider (the photon pass's shadow-caster filter); the others are
    transparent to the query."""
    kp = None if keep is None else pack_plane(keep, False)
    return _on(orig, closest_plain, closest_cuda)(m, orig, dirs, kp)


def shadow(m: MeshTables, orig, dirs):
    """Early-exit shadow components per ray: (min shadow-walk rank among
    positive hits (R,) int32, INT32_MAX when none; nearest casting t
    within that rank (R,), inf when none)."""
    return _on(orig, shadow_plain, shadow_cuda)(m, orig, dirs)
