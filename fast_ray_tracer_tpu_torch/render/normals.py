"""Surface normals, batched.

Matches local_normal_at per type (src/shapes/*.c) followed by
normal_to_world (src/shapes/shapes.c:91-113). Parent chains are
pre-composed at compile, so the world normal is
normalize(inv_tf^T[:3,:3] @ local_normal).

This slice has the sphere and the plane, without bump maps; the other
shapes raise in ops/intersect.py before a normal is asked for.
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


def normal_at(ir: SceneIR, ctx: ShapeCtx, world_pt):
    """World-space unit normal at the hit (the JAX package's prim and
    triangle-uv arguments serve meshes, which this slice does not have)."""
    if ir.meta.any_bump:
        raise NotImplementedError("bump maps are not ported yet")
    obj_pt = xform_points(ctx.obj_inv, world_pt)
    local = _local_normal(ctx.shape_type, obj_pt)
    # normal_to_world: inv^T on the linear part, then normalize
    return normalize(xform_normals(ctx.obj_inv, local))
