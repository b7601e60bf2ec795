"""Vectorized procedural pattern evaluation.

Every pattern is a row in the SceneIR pattern table; evaluation computes
the formulas of the kinds present in the scene (meta.pattern_kinds) for
the whole shading batch and selects per point by the pattern's type.
Semantics follow src/pattern/pattern.c: world -> object -> pattern space
transforms (base_pattern_at_shape:9-28), and the C `(int)t % 2 == 0`
parity test for stripes and checkers.

This slice evaluates `stripe` and `checker`, the kinds of the flagship
scene; any other kind present in a scene raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fast_ray_tracer_tpu_torch.ops.vec import xform_points
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

_PORTED_KINDS = {IR.PAT_CHECKER, IR.PAT_STRIPE}
SHAPE_TRIANGLE = 6   # shape_type value for triangles in ShapeCtx


class ShapeCtx(NamedTuple):
    """Per-shading-point shape data the pattern and normal code needs. The
    triangle fields serve the triangle uv map; they are None in a scene
    without triangles."""
    obj_inv: torch.Tensor     # (R,4,4) world->object (identity: triangle)
    shape_type: torch.Tensor  # (R,) int64: 0..5 analytic type, 6 triangle
    params: torch.Tensor      # (R,4) cylinder/cone min,max / toroid r1,r2
    tri_p1: Optional[torch.Tensor] = None     # (R,3)
    tri_e1: Optional[torch.Tensor] = None
    tri_e2: Optional[torch.Tensor] = None
    tri_t1: Optional[torch.Tensor] = None     # (R,2)
    tri_t2: Optional[torch.Tensor] = None
    tri_t3: Optional[torch.Tensor] = None
    tri_use_tex: Optional[torch.Tensor] = None  # (R,) bool


def build_shape_ctx(ir: SceneIR, prim) -> ShapeCtx:
    meta = ir.meta
    na, nt = meta.n_analytic, meta.n_triangles
    a_idx = prim.clamp(0, max(na - 1, 0))
    # static type per prim from the block layout (no host table to copy)
    stype = torch.zeros_like(a_idx)
    for typ, start, count in meta.type_ranges:
        stype = torch.where((a_idx >= start) & (a_idx < start + count),
                            typ, stype)
    if not nt:
        return ShapeCtx(obj_inv=ir.inv_tf[a_idx], shape_type=stype,
                        params=ir.prim_params[a_idx])
    is_tri = prim >= na
    t_idx = (prim - na).clamp(0, nt - 1)
    eye = torch.eye(4, dtype=ir.inv_tf.dtype, device=prim.device)
    if na:
        obj_inv = torch.where(is_tri[:, None, None], eye, ir.inv_tf[a_idx])
        params = torch.where(is_tri[:, None], 0.0, ir.prim_params[a_idx])
    else:
        obj_inv = eye.expand(prim.shape[0], 4, 4)
        params = torch.zeros((prim.shape[0], 4), dtype=eye.dtype,
                             device=prim.device)
    return ShapeCtx(
        obj_inv=obj_inv, shape_type=torch.where(is_tri, SHAPE_TRIANGLE, stype),
        params=params,
        tri_p1=ir.tri_p1[t_idx], tri_e1=ir.tri_e1[t_idx],
        tri_e2=ir.tri_e2[t_idx], tri_t1=ir.tri_t1[t_idx],
        tri_t2=ir.tri_t2[t_idx], tri_t3=ir.tri_t3[t_idx],
        tri_use_tex=ir.tri_use_tex[t_idx])


def _cmod2(t):
    """C `(int)t % 2 == 0` parity selector: True -> color a."""
    return (t.to(torch.int32) % 2) == 0


def eval_pattern(ir: SceneIR, pid, ctx: ShapeCtx, world_pt):
    """pattern_at_shape for a batch: pid (R,), world_pt (R,3) -> (R,3).

    Rows with pid < 0 return black (callers select the material constant).
    """
    meta = ir.meta
    if meta.n_patterns == 0:
        return torch.zeros_like(world_pt)
    kinds = set(meta.pattern_kinds)
    missing = sorted(kinds - _PORTED_KINDS)
    if missing:
        raise NotImplementedError(f"pattern kinds {missing} not ported yet")
    valid = pid >= 0
    pid_c = pid.clamp(0, meta.n_patterns - 1)
    ptype = ir.pat_type[pid_c]
    colors = ir.pat_colors[pid_c]
    a, b = colors[:, 0], colors[:, 1]

    obj_pt = xform_points(ctx.obj_inv, world_pt)
    pat_pt = xform_points(ir.pat_inv_tf[pid_c], obj_pt)
    x, y, z = pat_pt[..., 0], pat_pt[..., 1], pat_pt[..., 2]

    conds, outs = [], []
    if IR.PAT_CHECKER in kinds:
        sel = _cmod2(torch.floor(x) + torch.floor(y) + torch.floor(z))
        conds.append((ptype == IR.PAT_CHECKER)[..., None])
        outs.append(torch.where(sel[..., None], a, b))
    if IR.PAT_STRIPE in kinds:
        conds.append((ptype == IR.PAT_STRIPE)[..., None])
        outs.append(torch.where(_cmod2(torch.floor(x))[..., None], a, b))

    out = outs[-1]
    for c, o in zip(conds[:-1][::-1], outs[:-1][::-1]):
        out = torch.where(c, o, out)
    return torch.where(valid[..., None], out, 0.0)
