"""Surface normals, batched.

Matches local_normal_at per type (src/shapes/*.c) followed by
normal_to_world (src/shapes/shapes.c:91-113). Parent chains are
pre-composed at compile, so the world normal is
normalize(inv_tf^T[:3,:3] @ local_normal). Triangles interpolate their
pre-transformed, unnormalized vertex normals at the hit's barycentric
(u, v) (smooth triangles; a flat triangle's three normals are equal) —
identical to transforming the object-space interpolation.

Bump mapping (shape_normal_at, shapes.c:62-89): world_normal +=
2 * map_bump(world_point) - 1, then normalize.
"""

from __future__ import annotations

import torch

from fast_ray_tracer_tpu_torch.constants import EPSILON
from fast_ray_tracer_tpu_torch.ops.gather import take_rows
from fast_ray_tracer_tpu_torch.ops.patterns import ShapeCtx, eval_pattern
from fast_ray_tracer_tpu_torch.ops.vec import (
    normalize, xform_normals, xform_points,
)
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR


def _local_normal(stype, params, p, types):
    """Object-space normal per analytic type (src/shapes/*.c
    local_normal_at); p: (R,3). `types` prunes the formulas to the types
    present (a lane of a type left out gets another type's formula); with
    all six it selects as the JAX package does, the toroid's formula
    serving any other type id (triangles)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    up = torch.stack([zero, one, zero], -1)
    mn, mx = params[..., 0], params[..., 1]
    dist = x * x + z * z

    def capped(side):
        # cylinder and cone: the caps inside radius 1 (cylinder.c:89-104)
        return torch.where(((dist < 1) & (y >= mx - EPSILON))[..., None], up,
                           torch.where(((dist < 1)
                                        & (y <= mn + EPSILON))[..., None],
                                       -up, side))

    def cube():
        ax, ay, az = x.abs(), y.abs(), z.abs()
        maxc = torch.maximum(torch.maximum(ax, ay), az)
        eq = lambda a, b: (a - b).abs() < EPSILON
        return torch.where(eq(maxc, ax)[..., None],
                           torch.stack([x, zero, zero], -1),
                           torch.where(eq(maxc, ay)[..., None],
                                       torch.stack([zero, y, zero], -1),
                                       torch.stack([zero, zero, z], -1)))

    def cone():
        pos = dist > 0.0
        cy = torch.where(pos, torch.sqrt(torch.where(pos, dist, 1.0)), 0.0)
        cy = torch.where(y > 0, -cy, cy)
        return capped(torch.stack([x, cy, z], -1))

    def toroid():
        r1, r2 = params[..., 0], params[..., 1]
        p_sq = r1 * r1 + r2 * r2
        mag = x * x + y * y + z * z
        tor = torch.stack([4.0 * x * (mag - p_sq),
                           4.0 * y * (mag - p_sq + 2.0 * r1 * r1),
                           4.0 * z * (mag - p_sq)], -1)
        return normalize(tor)

    formulas = {
        IR.SPHERE: lambda: p,
        IR.PLANE: lambda: up,
        IR.CUBE: cube,
        IR.CYLINDER: lambda: capped(torch.stack([x, zero, z], -1)),
        IR.CONE: cone,
        IR.TOROID: toroid,
    }
    # a select chain over the present types, the last one the default
    types = sorted(types)
    out = formulas[types[-1]]()
    for typ in reversed(types[:-1]):
        out = torch.where((stype == typ)[..., None], formulas[typ](), out)
    return out


def normal_at(ir: SceneIR, ctx: ShapeCtx, prim, world_pt, tri_u, tri_v,
              mat_bump_pid=None):
    """World-space unit normal at the hit of global primitive `prim` (R,);
    tri_u/tri_v: (R,) barycentric coordinates of triangle hits;
    mat_bump_pid: (R,) the material's map_bump pattern (-1: none)."""
    meta = ir.meta
    obj_pt = xform_points(ctx.obj_inv, world_pt)
    types = [typ for typ, _, _ in meta.type_ranges] or [IR.SPHERE]
    local = _local_normal(ctx.shape_type, ctx.params, obj_pt, types)
    # normal_to_world: inv^T on the linear part, then normalize
    world = xform_normals(ctx.obj_inv, local)
    if meta.n_triangles:
        na = meta.n_analytic
        t_idx = (prim - na).clamp(0, meta.n_triangles - 1)
        w = (1.0 - tri_u - tri_v)[:, None]
        tri_n = (w * take_rows(ir.tri_n1, t_idx)
                 + tri_u[:, None] * take_rows(ir.tri_n2, t_idx)
                 + tri_v[:, None] * take_rows(ir.tri_n3, t_idx))
        world = torch.where((prim >= na)[:, None], tri_n, world)
    world = normalize(world)
    if mat_bump_pid is not None and meta.any_bump:
        bump = eval_pattern(ir, mat_bump_pid, ctx, world_pt)
        world = normalize(torch.where((mat_bump_pid >= 0)[:, None],
                                      world + (2.0 * bump - 1.0), world))
    return world
