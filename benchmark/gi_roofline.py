"""The least time of the photon-GI irradiance estimates, whatever
implements them, from what each call's inputs need.

A call answers R queries (a point and a direction each) against a photon
map: each query's estimate sums its `num` nearest photons closer than the
search radius r (all of them where fewer lie within r). Its work is at
least one squared distance, 8 operations (3 subtractions, 3
multiplications, 2 additions), for each photon a query sums, min(photons
within r, num) a query, which every implementation must weigh, however
it finds them (a grid, a shrinking-radius heap, a finer map): at the
float32 peak. Its bytes are at least the queries read once (6 values
each), the estimates written once (3 values and the int64 `found`), and
each photon that some query sums read once (its position, power and
direction, 9 values): at the HBM peak. The larger of the two is the
call's least time. The photons are counted with the benchmark's own map
(reference/gi.py), never the program's.
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.reference import gi

PAIR_OPS = 8
# queries whose cells one block of the count looks up, and the candidate
# slots one block may hold
QUERY_BLOCK = 1 << 20
BLOCK_SLOTS = 1 << 26


def pairs_within(grid: gi.GridMap, points, radius: float, num: int):
    """(the photons the queries sum: min(photons closer than `radius`,
    `num`) a query, added over the queries; the photons that some query
    sums) over `grid`'s photons, counted in blocks."""
    r2 = radius * radius
    used = torch.zeros(grid.n, dtype=torch.bool, device=points.device)
    pairs = 0
    for q0 in range(0, points.shape[0], QUERY_BLOCK):
        pts = points[q0:q0 + QUERY_BLOCK]
        s, e = gi.neighbor_extents(grid, pts)
        total = (e - s).sum(1)
        block = max(1, BLOCK_SLOTS // max(int(total.max()), 1))
        for lo in range(0, pts.shape[0], block):
            bs, be = s[lo:lo + block], e[lo:lo + block]
            bt = total[lo:lo + block]
            width = int(bt.max())
            if width == 0:
                continue
            lens = be - bs
            cum = torch.cumsum(lens, 1)
            jj = torch.arange(width, device=pts.device).expand(
                bs.shape[0], width).contiguous()
            cj = torch.searchsorted(cum, jj, right=True).clamp(max=26)
            ok = jj < bt[:, None]
            idx = torch.where(ok, bs.gather(1, cj) + jj
                              - (cum - lens).gather(1, cj), 0)
            d = grid.pos[idx] - pts[lo:lo + block, None, :]
            d2 = (d * d).sum(-1)
            hit = ok & (d2 < r2)
            if width > num:
                # each query's `num` nearest within reach
                near, at = torch.where(hit, d2, torch.inf).topk(
                    num, 1, largest=False)
                hit, idx = near.isfinite(), idx.gather(1, at)
            pairs += int(hit.sum())
            used[idx[hit]] = True
    return pairs, int(used.sum())


def estimate_bound(pairs: int, queries: int, photons: int,
                   itemsize: int = 4):
    """Least time of one estimate call -> (seconds, "operations" or
    "bytes"): `pairs` summed (pairs_within), `queries` answered,
    `photons` that some query sums."""
    t_ops = pairs * PAIR_OPS / roofline.FP32_OPS_PER_S
    nbytes = queries * (6 + 3) * itemsize + queries * 8 \
        + photons * 9 * itemsize
    t_bytes = roofline.bytes_seconds(nbytes)
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
