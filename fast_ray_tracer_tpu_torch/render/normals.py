"""Surface normals, batched.

Matches local_normal_at per type (src/shapes/*.c) followed by
normal_to_world (src/shapes/shapes.c:91-113). Parent chains are
pre-composed at compile, so the world normal is
normalize(inv_tf^T[:3,:3] @ local_normal). Triangles interpolate their
pre-transformed, unnormalized vertex normals at the hit's barycentric
(u, v) (smooth triangles; a flat triangle's three normals are equal) —
identical to transforming the object-space interpolation.

The port has the sphere, the plane and triangles, without bump maps; the
other shapes raise in ops/intersect.py before a normal is asked for.
"""

from __future__ import annotations

import torch

from fast_ray_tracer_tpu_torch.ops.patterns import ShapeCtx
from fast_ray_tracer_tpu_torch.ops.vec import (
    normalize, xform_normals, xform_points,
)
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR


def _local_normal(stype, p):
    """Object-space normal for spheres (p) and planes (+y); p: (R,3)."""
    plane = torch.zeros_like(p)
    plane[:, 1] = 1.0
    return torch.where((stype == IR.SPHERE)[:, None], p, plane)


def normal_at(ir: SceneIR, ctx: ShapeCtx, prim, world_pt, tri_u, tri_v):
    """World-space unit normal at the hit of global primitive `prim` (R,);
    tri_u/tri_v: (R,) barycentric coordinates of triangle hits."""
    meta = ir.meta
    if meta.any_bump:
        raise NotImplementedError("bump maps are not ported yet")
    obj_pt = xform_points(ctx.obj_inv, world_pt)
    local = _local_normal(ctx.shape_type, obj_pt)
    # normal_to_world: inv^T on the linear part, then normalize
    world = xform_normals(ctx.obj_inv, local)
    if meta.n_triangles:
        na = meta.n_analytic
        t_idx = (prim - na).clamp(0, meta.n_triangles - 1)
        w = (1.0 - tri_u - tri_v)[:, None]
        tri_n = (w * ir.tri_n1[t_idx] + tri_u[:, None] * ir.tri_n2[t_idx]
                 + tri_v[:, None] * ir.tri_n3[t_idx])
        world = torch.where((prim >= na)[:, None], tri_n, world)
    return normalize(world)
