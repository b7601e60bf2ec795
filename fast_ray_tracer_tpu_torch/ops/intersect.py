"""Batched ray-primitive intersection.

Each primitive type block is intersected as one dense batched computation
over (rays x prims); hits reduce with masked min. Every analytic primitive
contributes its type's maximum intersection count of t-slots (sphere/cube
2, plane 1, cylinder/cone/toroid 4 — src/shapes/* xs scratch sizes), and
a mesh too small to be clustered (under 2048 triangles) one slot per
triangle; misses are +inf, and the slot-to-primitive map is static per
scene (`slot_tables`). Clustered meshes are queried apart from these
slots, through ops/mesh.py. Type-specific epsilon behaviour matches the C
code (EPSILON `equal` tests for degenerate quadratics, cap tests, the
Möller-Trumbore determinant cutoff). CSG trees filter their slots with the
reference's truth tables (`apply_csg_filter`).

Arithmetic is written term by term (ops/vec.py, ops/mesh.py), so a lane's
result does not depend on the batch it is traced in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.constants import EPSILON
from fast_ray_tracer_tpu_torch.ops.gather import take_rows
from fast_ray_tracer_tpu_torch.ops.mesh import moller_trumbore
from fast_ray_tracer_tpu_torch.ops.quartic import solve_quartic
from fast_ray_tracer_tpu_torch.ops.vec import dot3
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

_INT32_MAX = 2**31 - 1
_DEAD_ORIGIN = 1e30   # dead-lane sentinel: misses every cluster AABB


def slot_tables(meta) -> np.ndarray:
    """Static slot -> global-prim-index map: the analytic blocks, plus one
    slot per triangle when the mesh is small (not clustered)."""
    ids = []
    for typ, start, count in meta.type_ranges:
        k = IR.TYPE_MAX_HITS[typ]
        for p in range(start, start + count):
            ids.extend([p] * k)
    if not meta.use_clusters:
        ids.extend(range(meta.n_analytic, meta.n_analytic + meta.n_triangles))
    if not ids:
        # no analytic prims beside a clustered mesh: one dead slot (its t
        # is always +inf) keeps slot-indexed gathers in range
        ids = [0]
    return np.asarray(ids, dtype=np.int64)


# ---------------------------------------------------------------------------
# per-type local intersectors: object-space rays (R, N, 3) -> t (R, N, k)
# ---------------------------------------------------------------------------

def _finite(c):
    """(c where finite else 0, the finite mask). A ray far outside the
    scene (the bucket's fill rows start at 1e30) overflows a quadratic's
    c to inf in float32, and its disc to -inf or NaN: no root, as here.
    But the backward of `a * c` then multiplies a zero cotangent by inf,
    a NaN that reaches the transform's gradient; the cut-off c keeps the
    product finite, the mask keeps the lane rootless."""
    fin = torch.isfinite(c)
    return torch.where(fin, c, 0.0), fin


def _sphere_t(o, d):
    """src/shapes/sphere.c:13-39 (unit sphere at origin)."""
    a = dot3(d, d)
    b = 2.0 * dot3(d, o)
    c, fin = _finite(dot3(o, o) - 1.0)
    # a zero direction (in float32, a final-gather ray from a fill row,
    # whose normal underflows to 0) has no root; its 1 / 2a would make the
    # backward's zero cotangent NaN
    fin = fin & (a > 0.0)
    disc = b * b - 4.0 * a * c
    ok = fin & (disc >= 0.0)
    # double-where grad guard: sqrt'(0)=inf at tangent hits / misses
    pos = fin & (disc > 0.0)
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv2a = 1.0 / (2.0 * torch.where(fin, a, 1.0))
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return torch.stack([torch.where(ok, t0, torch.inf),
                        torch.where(ok, t1, torch.inf)], -1)


def _plane_t(o, d):
    """src/shapes/plane.c:10-24 (xz plane)."""
    ok = d[..., 1].abs() >= EPSILON
    t = -o[..., 1] / torch.where(ok, d[..., 1], 1.0)
    return torch.where(ok, t, torch.inf)[..., None]


def _cube_t(o, d):
    """src/shapes/cube.c slab test, with its inf handling."""
    def axis(oc, dc):
        tmin_n = -1.0 - oc
        tmax_n = 1.0 - oc
        use_div = dc.abs() >= EPSILON
        safe = torch.where(use_div, dc, 1.0)
        tmin = torch.where(use_div, tmin_n / safe,
                           torch.where(tmin_n < 0, -torch.inf, torch.inf))
        tmax = torch.where(use_div, tmax_n / safe,
                           torch.where(tmax_n < 0, -torch.inf, torch.inf))
        return torch.minimum(tmin, tmax), torch.maximum(tmin, tmax)

    xmin, xmax = axis(o[..., 0], d[..., 0])
    ymin, ymax = axis(o[..., 1], d[..., 1])
    zmin, zmax = axis(o[..., 2], d[..., 2])
    tmin = torch.maximum(torch.maximum(xmin, ymin), zmin)
    tmax = torch.minimum(torch.minimum(xmax, ymax), zmax)
    ok = tmin <= tmax
    return torch.stack([torch.where(ok, tmin, torch.inf),
                        torch.where(ok, tmax, torch.inf)], -1)


def _quadratic_pair(a, b, c, ok):
    """(lo, hi) roots of a t^2 + b t + c where `ok` (a != 0, disc >= 0),
    with the double-where guard on the sqrt, and on a c that overflowed
    (`_finite`)."""
    c, fin = _finite(c)
    disc = b * b - 4.0 * a * c
    pos = fin & (disc > 0.0)
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    safe_a = torch.where(ok, a, 1.0)
    t0 = (-b - sq) / (2.0 * safe_a)
    t1 = (-b + sq) / (2.0 * safe_a)
    return (torch.minimum(t0, t1), torch.maximum(t0, t1),
            ok & fin & (disc >= 0.0))


def _caps(o, d, mn, mx, closed, r_min, r_max):
    """End-cap hits at y = mn and y = mx of a cylinder (radius^2 1) or a
    cone (radius^2 |y|): t where x^2 + z^2 <= the cap's radius^2."""
    dy_ok = d[..., 1].abs() >= EPSILON
    safe_dy = torch.where(dy_ok, d[..., 1], 1.0)
    cap_ok = closed & dy_ok
    out = []
    for y, r2 in ((mn, r_min), (mx, r_max)):
        t = (y - o[..., 1]) / safe_dy
        x = o[..., 0] + t * d[..., 0]
        z = o[..., 2] + t * d[..., 2]
        out.append(torch.where(cap_ok & (x * x + z * z <= r2), t, torch.inf))
    return out


def _cylinder_t(o, d, params):
    """src/shapes/cylinder.c:42-87 — body quadratic + caps."""
    mn, mx = params[..., 0], params[..., 1]
    closed = params[..., 2] > 0.5
    a = d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    c = o[..., 0] * o[..., 0] + o[..., 2] * o[..., 2] - 1.0
    lo, hi, ok = _quadratic_pair(a, b, c, a.abs() >= EPSILON)
    y0 = o[..., 1] + lo * d[..., 1]
    y1 = o[..., 1] + hi * d[..., 1]
    body0 = torch.where(ok & (mn <= y0) & (y0 <= mx), lo, torch.inf)
    body1 = torch.where(ok & (mn <= y1) & (y1 <= mx), hi, torch.inf)
    cap0, cap1 = _caps(o, d, mn, mx, closed, 1.0, 1.0)
    return torch.stack([body0, body1, cap0, cap1], -1)


def _cone_t(o, d, params):
    """src/shapes/cone.c:42-97 — double cone + caps (|y| cap radius). The
    body bounds are strict (cone.c:82-89), and a ray parallel to the
    surface (a == 0) takes the linear root (cone.c:60-70)."""
    mn, mx = params[..., 0], params[..., 1]
    closed = params[..., 2] > 0.5
    a = d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2] - d[..., 1] * d[..., 1]
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2]
               - o[..., 1] * d[..., 1])
    c = o[..., 0] * o[..., 0] + o[..., 2] * o[..., 2] - o[..., 1] * o[..., 1]

    a_zero = a.abs() < EPSILON
    b_zero = b.abs() < EPSILON
    # the linear root's value as the reference's; an overflowed c
    # (`_finite`) reaches only c's own gradient
    c_safe, fin = _finite(c)
    den = torch.where(b_zero, 1.0, 2.0 * b)
    t_lin = torch.where(fin, -c_safe / den, -c / den.detach())
    lin0 = torch.where(a_zero & ~b_zero, t_lin, torch.inf)

    lo, hi, ok = _quadratic_pair(a, b, c, ~a_zero)
    y0 = o[..., 1] + lo * d[..., 1]
    y1 = o[..., 1] + hi * d[..., 1]
    body0 = torch.where(ok & (mn < y0) & (y0 < mx), lo, torch.inf)
    body1 = torch.where(ok & (mn < y1) & (y1 < mx), hi, torch.inf)
    slot0 = torch.where(a_zero, lin0, body0)
    slot1 = torch.where(a_zero, torch.inf, body1)
    cap0, cap1 = _caps(o, d, mn, mx, closed, mn.abs(), mx.abs())
    return torch.stack([slot0, slot1, cap0, cap1], -1)


def _toroid_t(o, d, params):
    """src/shapes/toroid.c:14-52 — the quartic, solved in float64 whatever
    the frame's dtype (on the H100 that is real float64 at half the
    float32 rate)."""
    dtype = o.dtype
    o64, d64 = o.double(), d.double()
    r1 = params[..., 0].double()
    r2 = params[..., 1].double()
    sum_d_sq = dot3(d64, d64)
    e = dot3(o64, o64) - r1 * r1 - r2 * r2
    f = dot3(o64, d64)
    four_a_sq = 4.0 * r1 * r1
    oy, dy = o64[..., 1], d64[..., 1]
    c0 = e * e - four_a_sq * (r2 * r2 - oy * oy)
    c1 = 4.0 * f * e + 2.0 * four_a_sq * oy * dy
    c2 = 2.0 * sum_d_sq * e + 4.0 * f * f + four_a_sq * dy * dy
    c3 = 4.0 * sum_d_sq * f
    c4 = sum_d_sq * sum_d_sq
    return solve_quartic(c0, c1, c2, c3, c4).to(dtype)


_LOCAL_T = {
    IR.SPHERE: lambda o, d, params: _sphere_t(o, d),
    IR.PLANE: lambda o, d, params: _plane_t(o, d),
    IR.CUBE: lambda o, d, params: _cube_t(o, d),
    IR.CYLINDER: _cylinder_t,
    IR.CONE: _cone_t,
    IR.TOROID: _toroid_t,
}


def _triangle_t(orig, dirs, p1, e1, e2):
    """Möller-Trumbore (src/shapes/triangle.c:10-44), world space.
    orig/dirs: (R, 3); p1/e1/e2: (N, 3) -> t (R, N), +inf where the ray
    misses."""
    t, _, _, ok = moller_trumbore(
        [orig[:, k:k + 1] for k in range(3)],
        [dirs[:, k:k + 1] for k in range(3)],
        [a[None, :, k] for a in (p1, e1, e2) for k in range(3)])
    return torch.where(ok, t, torch.inf)


def triangle_uv_at(ir: SceneIR, tri_idx, orig, dirs):
    """Barycentric (u, v) of triangle tri_idx (R,) along each ray."""
    comp = [take_rows(ir.tri_p1, tri_idx), take_rows(ir.tri_e1, tri_idx),
            take_rows(ir.tri_e2, tri_idx)]
    _, u, v, _ = moller_trumbore(
        [orig[:, k] for k in range(3)], [dirs[:, k] for k in range(3)],
        [a[:, k] for a in comp for k in range(3)])
    return u, v


def neutralize_rays(orig, dirs, active):
    """Park inactive lanes far outside every cluster AABB, pointing away,
    so the mesh queries skip them (their shading contribution is masked
    anyway)."""
    a = active[:, None]
    return (torch.where(a, orig, _DEAD_ORIGIN),
            torch.where(a, dirs, 1.0))


def intersect_candidates(ir: SceneIR, orig, dirs) -> torch.Tensor:
    """All candidate hit t values: (R, H), +inf for misses.

    Slot order matches slot_tables(meta)."""
    meta = ir.meta
    parts = []
    for typ, start, count in meta.type_ranges:
        inv = ir.inv_tf[start:start + count]          # (N,4,4)
        lin = inv[None, :, :3, :3]                    # (1,N,3,3)
        trans = inv[None, :, :3, 3]                   # (1,N,3)
        ob = orig[:, None, None, :]                   # (R,1,1,3)
        db = dirs[:, None, None, :]
        # object-space rays (R, N, 3): o_i = sum_j lin[i, j] * orig_j + t_i
        o = dot3(lin, ob) + trans
        d = dot3(lin, db)
        params = ir.prim_params[start:start + count][None]   # (1,N,4)
        t = _LOCAL_T[typ](o, d, params)
        parts.append(t.reshape(t.shape[0], -1))
    if meta.n_triangles and not meta.use_clusters:
        parts.append(_triangle_t(orig, dirs, ir.tri_p1, ir.tri_e1,
                                 ir.tri_e2))
    if not parts:
        return torch.full((orig.shape[0], 1), torch.inf, dtype=orig.dtype,
                          device=orig.device)
    return torch.cat(parts, dim=-1)


class Hit(NamedTuple):
    valid: torch.Tensor     # (R,) bool
    t: torch.Tensor         # (R,)
    prim: torch.Tensor      # (R,) int64 global primitive index (0 if none)


def closest_hit(t_cand, slot_prim, mask=None) -> Hit:
    """First intersection with t > 0 (reference `hit()`,
    src/intersection/intersection.c:41-54). `slot_prim`: (H,) int64 tensor
    on the rays' device; `mask`: (H,) slot filter."""
    t = torch.where(t_cand > 0.0, t_cand, torch.inf)
    if mask is not None:
        t = torch.where(mask[None], t, torch.inf)
    if t.requires_grad:
        # the first minimal slot on ties; the hit's t splits its gradient
        # evenly over exactly tied slots, as the JAX package's jnp.min does
        # (a ray along the seam of two walls)
        tbest, idx = t.amin(-1), t.argmin(-1)
    else:
        tbest, idx = torch.min(t, dim=-1)     # first minimal slot on ties
    prim = slot_prim[idx]
    return Hit(valid=torch.isfinite(tbest), t=tbest, prim=prim)


def containers_n1_n2(meta, t_cand, t_hit, prim_ni, with_entry_t=False):
    """Sort-free "containers" walk (renderer.c:406-447) over the dense
    candidate slots: an object is in the containers iff it has an odd
    number of entries before the hit (exclusive for n1, inclusive for n2),
    and n1/n2 is the Ni of the inside object whose latest entry is last in
    walk order (t, then slot). A primitive's slots are contiguous and
    static, so per-prim counts and last entries are reshape reductions.

    with_entry_t=True also returns each walk's latest included entry t
    (-inf when no object is inside), for the merge with the clustered
    mesh's walk (ops/mesh.containers)."""
    R, H = t_cand.shape
    dev = t_cand.device
    valid = torch.isfinite(t_cand)
    slot_idx = torch.arange(H, device=dev)
    is_hit = valid & (t_cand == t_hit[:, None])
    hit_slot = torch.argmax(is_hit.to(torch.int8), dim=-1)
    before1 = valid & (t_cand < t_hit[:, None])
    before2 = before1 | (is_hit & (slot_idx[None] == hit_slot[:, None]))

    # static per-block layout (offset, count, k); the blocks cover the
    # analytic prims 0..Na-1 and then any dense triangles in order, so
    # prim_ni is already per column
    blocks = []
    off = 0
    for typ, start, count in meta.type_ranges:
        k = IR.TYPE_MAX_HITS[typ]
        blocks.append((off, count, k))
        off += count * k
    if meta.n_triangles and not meta.use_clusters:
        blocks.append((off, meta.n_triangles, 1))
    neg_inf = -torch.inf

    def solve(before):
        cnts, lts, lslots = [], [], []
        for boff, count, k in blocks:
            b = before[:, boff:boff + count * k].reshape(R, count, k)
            t = t_cand[:, boff:boff + count * k].reshape(R, count, k)
            sl = slot_idx[boff:boff + count * k].reshape(count, k)
            cnts.append(b.sum(-1))
            tm = torch.where(b, t, neg_inf)
            lt = tm.amax(-1)
            lts.append(lt)
            lslots.append(torch.where(tm == lt[..., None], sl[None], -1)
                          .amax(-1))
        cnt = torch.cat(cnts, -1)                              # (R,P)
        lt = torch.cat(lts, -1)
        lslot = torch.cat(lslots, -1)
        inside = (cnt & 1) == 1
        m = torch.where(inside, lt, neg_inf).amax(-1)
        score = torch.where(inside & (lt == m[:, None]), lslot, -1)
        best_score, best = score.max(-1)
        any_in = best_score >= 0
        ni = prim_ni[best]
        return (torch.where(any_in, ni, torch.ones_like(ni)),
                torch.where(any_in, m, neg_inf))

    (n1, m1), (n2, m2) = solve(before1), solve(before2)
    if with_entry_t:
        return n1, n2, m1, m2
    return n1, n2


def shadow_hit_early_exit(t_cand, slot_rank, slot_shadow_mask, dist):
    """Reference-faithful shadow test (is_shadowed, renderer.c:73-93).

    The reference's shadow walk stops at the FIRST leaf in post-divide DFS
    order with any t > 0 intersection (group.c:108-123), and only that
    leaf's hits reach `hit(xs, true)`. Per ray: the minimum shadow-walk
    rank among leaves with a positive hit; shadowed iff that leaf casts
    shadows and its nearest positive t < light distance.

    t_cand: (R,H); slot_rank: (H,) int; slot_shadow_mask: (H,) bool;
    dist: (R,). Returns (R,) bool."""
    _, cast_t = shadow_components(t_cand, slot_rank, slot_shadow_mask)
    return cast_t < dist


def shadow_components(t_cand, slot_rank, slot_shadow_mask):
    """Per ray: (min shadow-walk rank among positive hits, nearest positive
    casts_shadow t within that leaf — inf if it has no casting hit)."""
    tpos = torch.where(t_cand > 0.0, t_cand, torch.inf)
    valid = torch.isfinite(tpos)
    rank = torch.where(valid, slot_rank[None], _INT32_MAX)
    min_rank = rank.amin(-1)
    sel = valid & (rank == min_rank[:, None]) & slot_shadow_mask[None]
    cast_t = torch.where(sel, tpos, torch.inf).amin(-1)
    return min_rank, cast_t


# ---------------------------------------------------------------------------
# CSG filtering
# ---------------------------------------------------------------------------

def csg_static_tables(meta, slot_prim: np.ndarray, prim_csg, prim_anc,
                      prim_side):
    """Static per-tree slot lists and the postorder filter program, as
    host numpy arrays (`csg_device_tables` moves them to a device).

    prim_csg/prim_anc/prim_side are sequences of Python ints (arbitrary
    precision, so trees of any node count): the per-node membership and
    side bits are resolved here into static (K,) bool arrays per program
    entry."""
    trees = []
    slot_csg = np.asarray([prim_csg[p] for p in slot_prim], np.int64)
    for t, prog in enumerate(meta.csg_trees):
        slots = np.nonzero(slot_csg == t)[0].astype(np.int32)
        tree_prims = slot_prim[slots]
        entries = []
        for e in prog:
            if e[0] == "c":
                _, nid, op = e
                in_node = np.asarray(
                    [(prim_anc[p] >> nid) & 1 == 1 for p in tree_prims])
                lhit = np.asarray(
                    [(prim_side[p] >> nid) & 1 == 0 for p in tree_prims])
                entries.append(("c", in_node, lhit, op))
            else:
                # branch index per tree slot (-1 = not under this group)
                branch = np.full(len(slots), -1, np.int32)
                for b, prims in enumerate(e[1]):
                    for prim in prims:
                        branch[tree_prims == prim] = b
                entries.append(("g", len(e[1]), branch))
        trees.append((slots, tuple(entries)))
    return trees


def csg_device_tables(tables, device):
    """csg_static_tables' arrays as tensors on `device` (int64 indices)."""
    dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    out = []
    for slots, prog in tables:
        entries = tuple(
            ("c", dev(e[1]), dev(e[2]), e[3]) if e[0] == "c"
            else ("g", e[1], dev(e[2], torch.int64)) for e in prog)
        out.append((dev(slots, torch.int64), entries))
    return tuple(out)


def apply_csg_filter(t_cand, csg_tables, shadow: bool = False):
    """Kill the intersections the csg truth tables disallow
    (csg_filter_intersections, src/shapes/csg.c:27-125).

    Per tree (csg_device_tables): sort the tree's candidate ts ascending,
    stably, so exact ties keep slot order (misses, +inf, sort last), then
    run the tree's postorder program: at a csg node a surviving hit
    toggles the node's in-left/in-right state and is kept iff the op's
    truth table allows it; children filter their own hits before the
    parent sees them, as the recursive csg_local_intersect does.

    shadow=True also applies the reference's stop_after_first_hit group
    truncation inside csg trees (group.c:104-123): at each internal group,
    child subtrees after the first one that produced a t > 0 hit
    contribute nothing (is_shadowed passes true, renderer.c:73-93).

    The JAX package has a second, sort-free pairwise form for trees of up
    to 16 slots, because variadic sorts were slow on the TPU; it yields
    the same stable (t, slot) order, so one sorted form serves here."""
    out = None
    for slots, prog in csg_tables:
        if slots.shape[0] == 0:
            continue
        if out is None:
            out = t_cand.clone()
        ts_s, order = torch.sort(t_cand[:, slots], dim=-1, stable=True)
        alive = torch.isfinite(ts_s)
        for e in prog:
            if e[0] == "g":
                if not shadow:
                    continue
                _, n_branches, branch = e
                branch_s = branch[order]                     # (R,K)
                stopped = torch.zeros_like(alive[:, 0])
                for b in range(n_branches):
                    member = branch_s == b
                    alive = alive & ~(member & stopped[:, None])
                    stopped = stopped | (member & alive
                                         & (ts_s > 0.0)).any(-1)
                continue
            _, in_node_static, lhit_static, op = e
            in_node = alive & in_node_static[order]
            lhit = lhit_static[order]
            l_tog = (in_node & lhit).to(torch.int32)
            r_tog = (in_node & ~lhit).to(torch.int32)
            inl = (l_tog.cumsum(-1) - l_tog) % 2 == 1
            inr = (r_tog.cumsum(-1) - r_tog) % 2 == 1
            if op == 0:        # union
                allowed = (lhit & ~inr) | (~lhit & ~inl)
            elif op == 1:      # intersection
                allowed = (lhit & inr) | (~lhit & inl)
            else:              # difference
                allowed = (lhit & ~inr) | (~lhit & inl)
            alive = alive & (allowed | ~in_node)
        ts_s = torch.where(alive, ts_s, torch.inf)
        # back to slot order through the sort's permutation
        out.index_copy_(1, slots, torch.empty_like(ts_s).scatter_(
            1, order, ts_s))
    return t_cand if out is None else out
