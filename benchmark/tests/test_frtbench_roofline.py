"""The yardstick's arithmetic against hand counts on small shapes."""

import pytest
import torch

from benchmark import roofline
from benchmark.reference.frt.ops.mesh import cluster_mask


def test_compaction_bytes_by_hand():
    # 10 rows of 6 float32 into a bucket of 8: rows 240 B, flags 10 B,
    # bucket 192 B
    assert roofline.compact_bytes(10, 6, 8, 4) == 240 + 10 + 192
    # a bucket of 8 rows of 9 float32 back to 10 rows
    assert roofline.expand_bytes(10, 9, 8, 4) == 288 + 10 + 360
    assert roofline.bytes_seconds(3.35e12) == pytest.approx(1.0)


def test_mesh_bound_by_bytes():
    # 3 passed pairs, 4 rays, 2 superclusters (9 x 2 x 128 plane values)
    ops = 3 * 128 * 46
    nbytes = (4 * 6 + 2304 + 6 * 2) * 4 + 4 * 8
    t, by = roofline.mesh_bound(3, 4, 2, 2304, 0)
    assert by == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12)
    assert ops / 67e12 < t


def test_mesh_bound_by_operations():
    # a million passed pairs over 100 rays: the Moller-Trumbores dominate
    t, by = roofline.mesh_bound(10**6, 100, 2, 2304, 5)
    assert by == "operations"
    assert t == pytest.approx(10**6 * 128 * 46 / 67e12)
    # the shadow query's 5 bytes a triangle enter the byte count
    _, _ = roofline.mesh_bound(1, 100, 2, 2304, 5)
    b0 = roofline.mesh_bound(0, 100, 2, 2304, 0)[0]
    b5 = roofline.mesh_bound(0, 100, 2, 2304, 5)[0]
    assert (b5 - b0) * 3.35e12 == pytest.approx(5 * 2 * 128)


def test_passed_pairs_by_hand():
    # two unit boxes at x in [0, 1] and x in [3, 4]; rays along +x from
    # x = -1 (passes both), along -x from x = -1 (passes none: behind),
    # and along +x from x = 2 (passes the second only)
    bmin = torch.tensor([[0.0, 0, 0], [3.0, 0, 0]])
    bmax = torch.tensor([[1.0, 1, 1], [4.0, 1, 1]])
    orig = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 0.5, 0.5],
                         [2.0, 0.5, 0.5]])
    dirs = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [1.0, 0, 0]])
    assert roofline.passed_pairs(cluster_mask, bmin, bmax, orig, dirs) == 3
