"""Batched ray-primitive intersection.

Each primitive type block is intersected as one dense batched computation
over (rays x prims); hits reduce with masked min. Every analytic primitive
contributes its type's maximum intersection count of t-slots (sphere 2,
plane 1), and a mesh too small to be clustered (under 2048 triangles) one
slot per triangle; misses are +inf, and the slot-to-primitive map is
static per scene (`slot_tables`). Clustered meshes are queried apart from
these slots, through ops/mesh.py.

Arithmetic is written term by term (ops/vec.py, ops/mesh.py), so a lane's
result does not depend on the batch it is traced in.

The port intersects spheres, planes and triangles; the other analytic
shapes come in a later slice and raise NotImplementedError here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.constants import EPSILON
from fast_ray_tracer_tpu_torch.ops.mesh import moller_trumbore
from fast_ray_tracer_tpu_torch.ops.vec import dot3
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

_PORTED_TYPES = (IR.SPHERE, IR.PLANE)
_INT32_MAX = 2**31 - 1
_DEAD_ORIGIN = 1e30   # dead-lane sentinel: misses every cluster AABB


def check_ported_types(meta) -> None:
    for typ, _, _ in meta.type_ranges:
        if typ not in _PORTED_TYPES:
            raise NotImplementedError(
                f"{IR.ANALYTIC_TYPE_NAMES[typ]} primitives are not ported yet")


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

def _sphere_t(o, d):
    """src/shapes/sphere.c:13-39 (unit sphere at origin)."""
    a = dot3(d, d)
    b = 2.0 * dot3(d, o)
    c = dot3(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    # double-where grad guard: sqrt'(0)=inf at tangent hits / misses
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv2a = 1.0 / (2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return torch.stack([torch.where(ok, t0, torch.inf),
                        torch.where(ok, t1, torch.inf)], -1)


def _plane_t(o, d):
    """src/shapes/plane.c:10-24 (xz plane)."""
    ok = d[..., 1].abs() >= EPSILON
    t = -o[..., 1] / torch.where(ok, d[..., 1], 1.0)
    return torch.where(ok, t, torch.inf)[..., None]


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
    comp = [ir.tri_p1[tri_idx], ir.tri_e1[tri_idx], ir.tri_e2[tri_idx]]
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
    check_ported_types(meta)
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
        t = _sphere_t(o, d) if typ == IR.SPHERE else _plane_t(o, d)
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
