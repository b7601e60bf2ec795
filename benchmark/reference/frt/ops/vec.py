"""Small per-lane vector helpers shared by the device modules.

Each is written term by term rather than as a matmul or a reduction: a
lane's result then depends only on that lane's inputs, never on the batch
size or on how a library kernel splits the work, which keeps the
static-bucket wavefront bit-identical to the unrolled trace on the card.
The term order (x, then y, then z) is the JAX package's summation order.
"""

from __future__ import annotations

import torch


def dot3(a, b):
    """Dot product over the last axis of length 3."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def normalize(v):
    """v / |v| over the last axis, with the norm floored at the dtype's
    tiny (a zero vector stays zero, and its gradient finite)."""
    n2 = dot3(v, v)[..., None]
    return v / torch.sqrt(n2.clamp(min=torch.finfo(v.dtype).tiny))


def xform_points(m, p):
    """Affine map of (R,3) points by (R,4,4) or (4,4) matrices."""
    return torch.stack([dot3(m[..., i, :3], p) + m[..., i, 3]
                        for i in range(3)], -1)


def xform_normals(m, n):
    """Transposed linear part of (R,4,4) matrices applied to (R,3)."""
    return torch.stack([dot3(m[..., :3, i], n) for i in range(3)], -1)
