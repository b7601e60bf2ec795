"""The algebra of the mesh shadow kernel (csrc/mesh.cu ShadowQ), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to ops/mesh.shadow_plain; ops/mesh.shadow_plain is held to the JAX
package in tests/test_torch_mesh.py. What the kernel's design relies on is
checked here against shadow_plain itself, in float32:
- the split merge's 64-bit key, emulated in int64, orders exactly as
  (rank, casting t), and all-ones decodes to (INT32_MAX, inf);
- shadow_plain on the parts of the supercluster range that a split launch
  forms (whole groups), merged by the minimum key, equals shadow_plain on
  the whole mesh, with every rank equal (casting t decides across parts,
  and copies of superclusters in other parts tie exactly) and permuted;
- pack's minimum-rank tables, and a per-ray walk with the rank cull
  (root, groups, members by count, in index order) equals shadow_plain;
- shadow_cuda raises without the tables it needs: nothing falls back;
- pack refuses ranks outside int32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu_torch.ops import mesh as tmesh
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, SceneMeta

from test_torch_mesh import _group_soup, _soup_rays

torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
INT64_MIN = -2**63
ALL_ONES = -1                  # the uint64 0xffff...ff as an int64


# ---------------------------------------------------------------------------
# the merge key, emulated in int64 (the uint64's bit pattern)
# ---------------------------------------------------------------------------

def encode(rank, t):
    """(uint32)(rank ^ 0x80000000) << 32 | float bits of t, as the int64
    with the same 64 bits."""
    hi = rank.to(torch.int64) ^ -2**31           # the high word as an int32
    lo = t.to(torch.float32).view(torch.int32).to(torch.int64) & 0xffffffff
    return hi * 2**32 + lo


def unsigned_order(key):
    """An int64 whose signed order is the key's unsigned order."""
    return key ^ INT64_MIN


def decode(key):
    """(rank int32, t float32) of a key; all-ones: (INT32_MAX, inf)."""
    hit = key != ALL_ONES
    rank = ((key >> 32) ^ -2**31).to(torch.int32)
    lo = key & 0xffffffff
    t = torch.where(lo >= 2**31, lo - 2**32, lo).to(torch.int32).view(
        torch.float32)
    return (torch.where(hit, rank, INT32_MAX),
            torch.where(hit, t, torch.inf))


def _key_samples():
    """Seeded (rank, t) pairs of hits: ranks across int32 (0, negative,
    INT32_MIN, INT32_MAX - 1, INT32_MAX) with repeats; t positive, subnormal,
    the largest float32 and +inf (a non-casting hit), with ties."""
    rng = np.random.default_rng(21)
    special_r = np.array([0, -1, -2**31, INT32_MAX - 1, INT32_MAX, 1, 7],
                         dtype=np.int64)
    r = np.concatenate([special_r, rng.integers(-2**31, 2**31, 120),
                        rng.choice(special_r, 120)])
    f32 = np.finfo(np.float32)
    special_t = np.array([np.inf, f32.smallest_subnormal,
                          3 * f32.smallest_subnormal, f32.tiny, 1.0,
                          f32.max, 1e-30], dtype=np.float32)
    t = np.concatenate([rng.choice(special_t, 127),
                        rng.uniform(0, 100, 120).astype(np.float32)])
    rng.shuffle(t)
    return torch.from_numpy(r.astype(np.int32)), torch.from_numpy(t)


def test_key_orders_as_rank_then_t():
    """Unsigned key order == lexicographic (rank, casting t), equal keys
    exactly for equal pairs, and decode inverts encode."""
    r, t = _key_samples()
    u = unsigned_order(encode(r, t))
    less = (r[:, None] < r[None, :]) | ((r[:, None] == r[None, :])
                                        & (t[:, None] < t[None, :]))
    same = (r[:, None] == r[None, :]) & (t[:, None] == t[None, :])
    assert bool(same.sum() > r.shape[0])            # the samples hold ties
    assert torch.equal(u[:, None] < u[None, :], less)
    assert torch.equal(u[:, None] == u[None, :], same)
    dr, dt = decode(encode(r, t))
    assert torch.equal(dr, r) and torch.equal(dt, t)


def test_all_ones_decodes_to_no_hit():
    """The keys start all-ones: above every hit's key, and decoded as the
    empty result. No hit encodes to all-ones (its low word is a NaN)."""
    r, t = _key_samples()
    top = unsigned_order(torch.tensor([ALL_ONES]))
    assert bool((unsigned_order(encode(r, t)) < top).all())
    dr, dt = decode(torch.tensor([ALL_ONES]))
    assert int(dr) == INT32_MAX and float(dt) == float("inf")
    assert dr.dtype == torch.int32 and dt.dtype == torch.float32


# ---------------------------------------------------------------------------
# the split merge
# ---------------------------------------------------------------------------

def _sub(m, s0, s1):
    """The tables of superclusters [s0, s1) (what shadow_plain reads)."""
    return m._replace(tris=m.tris[:, s0:s1], box_min=m.box_min[s0:s1],
                      box_max=m.box_max[s0:s1], rank=m.rank[s0:s1],
                      cast=m.cast[s0:s1])


def _part_bounds(nsc, split):
    """The superclusters of each part, as csrc/mesh.cu run() cuts the
    group range: ceil(groups / split) whole groups a part."""
    ng = -(-nsc // tmesh.GROUP)
    per = -(-ng // split)
    return [(g * tmesh.GROUP, min(nsc, (g + per) * tmesh.GROUP))
            for g in range(0, ng, per)]


def _merge(results):
    """The minimum key over the parts' (rank, t); a part without a hit
    leaves the key alone (all-ones), as the kernel skips its atomic."""
    key = None
    for rank, t in results:
        k = encode(rank, t)
        empty = (rank == INT32_MAX) & torch.isinf(t)
        k = torch.where(empty, ALL_ONES, k)
        key = k if key is None else torch.where(
            unsigned_order(k) < unsigned_order(key), k, key)
    return decode(key)


def _split_soup(ranks):
    """_group_soup with 406 superclusters (13 groups, the last of 22: 2, 7
    and 13 parts are all whole), its last 20 superclusters copies of the
    first 20 (so a pair ties exactly with one in another part), random
    casts, and every rank equal or ranks permuted."""
    m = _group_soup(n_sc=406, seed=17)
    g = torch.Generator().manual_seed(4)
    tris, bmin, bmax = m.tris.clone(), m.box_min.clone(), m.box_max.clone()
    tris[:, -20:], bmin[-20:], bmax[-20:] = tris[:, :20], bmin[:20], bmax[:20]
    nt = m.rank.numel()
    rank = torch.zeros(nt, dtype=torch.int32) if ranks == "equal" else \
        torch.randperm(nt, generator=g).to(torch.int32)
    cast = torch.rand(nt, generator=g) < 0.7
    sc_rank, group_rank = tmesh.min_ranks(rank.reshape(-1, tmesh.SC))
    return m._replace(
        tris=tris, box_min=bmin, box_max=bmax,
        rank=rank.reshape(-1, tmesh.SC), cast=cast.reshape(-1, tmesh.SC),
        sc_rank=sc_rank, group_rank=group_rank,
        **dict(zip(("group_min", "group_max", "root_min", "root_max"),
                   tmesh.group_boxes(bmin, bmax))))


@pytest.mark.parametrize("ranks", ["equal", "permuted"])
@pytest.mark.parametrize("split", [1, 2, 7, "groups"])
def test_split_merge_equals_whole(ranks, split):
    """shadow_plain per part, merged by the minimum key, equals shadow_plain
    on the whole, bit for bit."""
    m = _split_soup(ranks)
    nsc = m.box_min.shape[0]
    split = -(-nsc // tmesh.GROUP) if split == "groups" else split
    o, d = (torch.from_numpy(x) for x in _soup_rays(13, 300))
    o = o * 1.5
    want = tmesh.shadow_plain(m, o, d)
    bounds = _part_bounds(nsc, split)
    assert len(bounds) == split
    got = _merge(tmesh.shadow_plain(_sub(m, s0, s1), o, d)
                 for s0, s1 in bounds)
    assert int((want[0] < INT32_MAX).sum()) > 100
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the rank cull
# ---------------------------------------------------------------------------

def _soup_ir(m):
    """The SceneIR of a packed soup of whole superclusters (to pack it
    again): its triangles, and each supercluster's box as both of its
    clusters' boxes."""
    comp = m.tris.reshape(9, -1)
    nc = 2 * m.box_min.shape[0]
    twice = lambda b: torch.stack([b, b], 1).reshape(nc, 3)
    return SceneIR(meta=SceneMeta(n_triangles=comp.shape[1],
                                  use_clusters=True, n_clusters=nc,
                                  cluster_size=64),
                   tri_p1=comp[0:3].T.contiguous(),
                   tri_e1=comp[3:6].T.contiguous(),
                   tri_e2=comp[6:9].T.contiguous(),
                   cluster_min=twice(m.box_min), cluster_max=twice(m.box_max))


@pytest.mark.parametrize("n_sc", [37, 250])
def test_min_rank_tables(n_sc):
    """pack's sc_rank and group_rank are the minimum of their members (a
    group over the superclusters it holds; the last supercluster's padded
    rows rank INT32_MAX), int32 and contiguous."""
    ir = _soup_ir(_group_soup(n_sc=n_sc))
    nt = ir.tri_p1.shape[0] - 50
    ir = dataclasses.replace(ir, tri_p1=ir.tri_p1[:nt],
                             tri_e1=ir.tri_e1[:nt], tri_e2=ir.tri_e2[:nt])
    rank = torch.randperm(nt, generator=torch.Generator().manual_seed(n_sc))
    m = tmesh.pack(ir, rank, torch.ones(nt, dtype=torch.bool))
    ng = -(-n_sc // tmesh.GROUP)
    assert m.sc_rank.shape == (n_sc,) and m.group_rank.shape == (ng,)
    for x in (m.sc_rank, m.group_rank):
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert torch.equal(m.rank.reshape(-1)[:nt], rank.to(torch.int32))
    assert bool((m.rank.reshape(-1)[nt:] == INT32_MAX).all())
    for s in range(n_sc):
        assert int(m.sc_rank[s]) == int(m.rank[s].min())
    for g in range(ng):
        members = m.rank[g * tmesh.GROUP:min(n_sc, (g + 1) * tmesh.GROUP)]
        assert int(m.group_rank[g]) == int(members.min())


def _pair_results(m, o, d):
    """(rank, casting t) of every (ray, supercluster) pair: the monoid over
    the supercluster's 128 triangles, computed for all pairs at once."""
    t, _, _, ok = tmesh.moller_trumbore(
        [o[:, k, None, None] for k in range(3)],
        [d[:, k, None, None] for k in range(3)], list(m.tris))
    ok = ok & (t > 0)
    rk = torch.where(ok, m.rank, INT32_MAX)
    rmin = rk.amin(2)
    tc = torch.where(ok & m.cast & (rk == rmin[..., None]), t, torch.inf)
    return rmin, tc.amin(2)


def _culled_walk(m, o, d):
    """The kernel's walk for each ray alone: the root box, then each group
    whose box it passes and whose minimum rank is not above the carried
    rank, then that group's members by count, each taken only if its slab
    test passes and its minimum rank is not above the carried rank; the
    carry is the lexicographic minimum. Returns (rank, t, culled pairs)."""
    nsc = m.box_min.shape[0]
    root = tmesh.cluster_mask(m.root_min, m.root_max, o, d)[:, 0]
    grp = tmesh.cluster_mask(m.group_min, m.group_max, o, d)
    sc = tmesh.cluster_mask(m.box_min, m.box_max, o, d)
    prk, pt = _pair_results(m, o, d)
    sc_rank, group_rank = m.sc_rank.tolist(), m.group_rank.tolist()
    out_r, out_t, culled = [], [], 0
    for r in range(o.shape[0]):
        carry = (INT32_MAX, float("inf"))
        for g in range(grp.shape[1]) if root[r] else ():
            members = range(g * tmesh.GROUP, min(nsc, (g + 1) * tmesh.GROUP))
            if not grp[r, g]:
                continue
            if group_rank[g] > carry[0]:
                culled += sum(bool(sc[r, s]) for s in members)
                continue
            for s in members:
                if not sc[r, s]:
                    continue
                if sc_rank[s] > carry[0]:
                    culled += 1
                    continue
                carry = min(carry, (int(prk[r, s]), float(pt[r, s])))
        out_r.append(carry[0])
        out_t.append(carry[1])
    return (torch.tensor(out_r, dtype=torch.int32),
            torch.tensor(out_t, dtype=torch.float32), culled)


@pytest.mark.parametrize("ranks", ["index order", "reversed", "permuted"])
def test_rank_cull_walk_equals_plain(ranks):
    """The culled walk gives shadow_plain's answer bit for bit; with ranks
    that follow the visit order it culls many pairs, and ranks against it
    or at random still agree."""
    m = _group_soup(n_sc=37, seed=5)
    nt = m.rank.numel()
    rank = {"index order": torch.arange(nt),
            "reversed": torch.arange(nt).flip(0),
            "permuted": torch.randperm(
                nt, generator=torch.Generator().manual_seed(6))}[ranks]
    rank = rank.to(torch.int32).reshape(-1, tmesh.SC)
    cast = (torch.rand(nt, generator=torch.Generator().manual_seed(7))
            < 0.6).reshape(-1, tmesh.SC)
    sc_rank, group_rank = tmesh.min_ranks(rank)
    m = m._replace(rank=rank, cast=cast, sc_rank=sc_rank,
                   group_rank=group_rank)
    o, d = (torch.from_numpy(x) for x in _soup_rays(14, 160))
    o = o * 1.5
    want_r, want_t = tmesh.shadow_plain(m, o, d)
    got_r, got_t, culled = _culled_walk(m, o, d)
    assert int((want_r < INT32_MAX).sum()) > 30
    assert torch.equal(got_r, want_r) and torch.equal(got_t, want_t)
    if ranks == "index order":
        assert culled > 100


# ---------------------------------------------------------------------------
# the wrapper's preconditions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", ["group_min", "group_max", "root_min",
                                     "root_max", "sc_rank", "group_rank"])
def test_shadow_cuda_needs_its_tables(missing):
    """Without the group and root boxes or the minimum ranks shadow_cuda
    raises before it would load the kernel: no fallback."""
    m = _group_soup()
    o, d = (torch.from_numpy(x) for x in _soup_rays(2, 8))
    with pytest.raises(ValueError, match=missing):
        tmesh.shadow_cuda(m._replace(**{missing: None}), o, d)


@pytest.mark.parametrize("bad", [2**31, -2**31 - 1])
def test_pack_refuses_ranks_outside_int32(bad):
    """pack converts ranks to int32 with a check, never silently."""
    m = _group_soup(n_sc=3)
    ir = _soup_ir(m)
    nt = ir.tri_p1.shape[0]
    rank = torch.arange(nt, dtype=torch.int64)
    cast = torch.ones(nt, dtype=torch.bool)
    with pytest.raises(ValueError, match="int32"):
        tmesh.pack(ir, torch.where(rank == 5, bad, rank), cast)
    edge = torch.where(rank == 5, INT32_MAX, torch.where(rank == 6, -2**31,
                                                         rank))
    for ranks in (edge, edge.to(torch.int32)):
        got = tmesh.pack(ir, ranks, cast).rank.reshape(-1)
        assert got.dtype == torch.int32 and torch.equal(got.long(), edge)
