"""The yardstick's peaks and the least work of the port's hand-written
kernels, computed from the shapes of each call.

Frozen copies of the arithmetic of the port's `chip_smoke.py`: the
compaction kernels' byte count (each input read once, each output
written once) and `mesh_bound`, the least time of a mesh query on its
inputs. The peaks are NVIDIA's published figures for one H100 SXM
(dense, without sparsity) at its full 700 W; a card whose power limit
is lower is reported beside them (`power_limit`), never rescaled.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
# operations per (ray, triangle) Moller-Trumbore and per (ray,
# supercluster) slab test, counted from the port's csrc/mesh.cu: 46
# add/sub/mul/div; 6 sub, 6 mul, 6 min/max, 4 min/max across axes, 2
# compares
MT_OPS, SLAB_OPS = 46, 24
SC = 128                       # triangles per supercluster


def compact_bytes(n: int, c: int, b: int, itemsize: int) -> int:
    """compact_rows over n rows of c elements into a bucket of b rows:
    the rows and the n one-byte flags read once, the bucket written
    once."""
    return n * c * itemsize + n + b * c * itemsize


def expand_bytes(n: int, c: int, b: int, itemsize: int) -> int:
    """expand_rows of a bucket of b rows of c elements back to n rows: the
    bucket and the flags read once, the n rows written once."""
    return b * c * itemsize + n + n * c * itemsize


def bytes_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def mesh_bound(passed: int, n_rays: int, n_sc: int, tris_elems: int,
               aux_bytes: int, itemsize: int = 4):
    """Least time of a mesh query on its inputs, by what they need: every
    (ray, supercluster) pair whose slab test passes (`passed`) takes a
    Moller-Trumbore against each of the supercluster's SC triangles, at
    the float32 peak; against it, the bytes: the rays (6 values each),
    the triangle planes (`tris_elems` values) and the supercluster boxes
    read once, t and an index written once (8 bytes a ray), and
    `aux_bytes` a triangle of further planes (5 for the shadow query's
    rank and flag, 0 for closest). Returns (seconds, "operations" or
    "bytes")."""
    ops = passed * SC * MT_OPS
    nbytes = (n_rays * 6 + tris_elems + 6 * n_sc) * itemsize + n_rays * 8 \
        + aux_bytes * n_sc * SC
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def passed_pairs(cluster_mask, box_min, box_max, orig, dirs) -> int:
    """The (ray, supercluster) pairs whose slab test passes, counted in
    blocks of rays. `cluster_mask(box_min, box_max, orig, dirs)` is the
    slab test, (rays, superclusters) bool."""
    n, nsc = orig.shape[0], box_min.shape[0]
    rows = max(1, (1 << 22) // max(nsc, 1))
    return sum(int(cluster_mask(box_min, box_max, orig[r:r + rows],
                                dirs[r:r + rows]).sum())
               for r in range(0, n, rows))


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or "" where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out[0] if out else ""
