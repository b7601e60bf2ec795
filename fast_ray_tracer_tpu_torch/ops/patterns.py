"""Vectorized procedural pattern and uv-map evaluation.

Every pattern is a row in the SceneIR pattern table; evaluation computes
the formulas of the kinds present in the scene for the whole shading batch
and selects per point by the pattern's type. The selection is statically
pruned as the JAX package prunes it: only the pattern kinds
(meta.pattern_kinds), uv-map kinds (meta.map_kinds), combinator depth
(meta.pattern_depth) and perlin octave count (meta.max_perlin_octaves)
present in the scene are evaluated.

Semantics follow src/pattern/pattern.c:
  * world -> object -> pattern space transforms (base_pattern_at_shape:9-28)
    and the C `(int)t % 2 == 0` parity test;
  * combinators (blended/nested/perturbed) act on the world point and
    delegate to children, which redo their own transforms (:30-116); the
    nested combinator overrides its primary's a/b colors (:41-76);
  * uv-map patterns pick a face, then evaluate the face's uv pattern
    (:197-217); all uv_map projections (:309-488), with the C fmod
    (truncation remainder) and the `equal()` epsilon cube-face choice.
Texture patterns (`uv_image`) take the nearest texel of their image in
the scene's flat texture atlas (pattern.c:285-297).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from fast_ray_tracer_tpu_torch.constants import EPSILON
from fast_ray_tracer_tpu_torch.ops.gather import take_rows
from fast_ray_tracer_tpu_torch.ops.perlin import _smooth3d, to_int32_saturated
from fast_ray_tracer_tpu_torch.ops.vec import dot3, xform_points
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

_CONCRETE = {IR.PAT_CHECKER, IR.PAT_GRADIENT, IR.PAT_RADIAL_GRADIENT,
             IR.PAT_RING, IR.PAT_STRIPE}
_COMBINATORS = {IR.PAT_BLENDED, IR.PAT_NESTED, IR.PAT_PERTURBED}
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
        return ShapeCtx(obj_inv=take_rows(ir.inv_tf, a_idx),
                        shape_type=stype,
                        params=take_rows(ir.prim_params, a_idx))
    is_tri = prim >= na
    t_idx = (prim - na).clamp(0, nt - 1)
    eye = torch.eye(4, dtype=ir.inv_tf.dtype, device=prim.device)
    if na:
        obj_inv = torch.where(is_tri[:, None, None], eye,
                              take_rows(ir.inv_tf, a_idx))
        params = torch.where(is_tri[:, None], 0.0,
                             take_rows(ir.prim_params, a_idx))
    else:
        obj_inv = eye.expand(prim.shape[0], 4, 4)
        params = torch.zeros((prim.shape[0], 4), dtype=eye.dtype,
                             device=prim.device)
    return ShapeCtx(
        obj_inv=obj_inv, shape_type=torch.where(is_tri, SHAPE_TRIANGLE, stype),
        params=params,
        tri_p1=take_rows(ir.tri_p1, t_idx),
        tri_e1=take_rows(ir.tri_e1, t_idx),
        tri_e2=take_rows(ir.tri_e2, t_idx),
        tri_t1=take_rows(ir.tri_t1, t_idx),
        tri_t2=take_rows(ir.tri_t2, t_idx),
        tri_t3=take_rows(ir.tri_t3, t_idx),
        tri_use_tex=ir.tri_use_tex[t_idx])


def _select(conds, outs):
    """jnp.select's order: the first true condition wins; the last output
    is the default."""
    out = outs[-1]
    for c, o in zip(conds[:-1][::-1], outs[:-1][::-1]):
        out = torch.where(c, o, out)
    return out


def _fmod(x, y):
    """C fmod: truncation remainder (keeps the sign of x)."""
    return x - y * torch.trunc(x / y)


def _cmod2(t):
    """C `(int)t % 2 == 0` parity selector: True -> color a. The
    conversion saturates (to_int32_saturated), so out-of-range and
    non-finite values of dead lanes convert alike on every device."""
    return to_int32_saturated(t) % 2 == 0


# ---------------------------------------------------------------------------
# uv maps (face, u, v per point)
# ---------------------------------------------------------------------------

def _uv_map(map_kind, ctx: ShapeCtx, p, kinds):
    """(face, u, v) for the map kinds present, selected by map_kind."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    conds_f, us, vs = [], [], []
    conds_face, faces = [], []
    two_pi = 2.0 * math.pi

    if IR.MAP_SPHERE in kinds:
        theta = torch.atan2(x, z)
        radius = torch.sqrt(dot3(p, p))
        phi = torch.acos((y / torch.where(radius == 0, 1.0, radius))
                         .clamp(-1, 1))
        conds_f.append(map_kind == IR.MAP_SPHERE)
        us.append(1.0 - (theta / two_pi + 0.5))
        vs.append(1.0 - phi / math.pi)

    if IR.MAP_PLANE in kinds:
        pl_u = _fmod(x, 1.0)
        pl_v = _fmod(z, 1.0)
        conds_f.append(map_kind == IR.MAP_PLANE)
        us.append(torch.where(pl_u < 0, pl_u + 1.0, pl_u))
        vs.append(torch.where(pl_v < 0, pl_v + 1.0, pl_v))

    if IR.MAP_CYLINDER in kinds:
        theta = torch.atan2(x, z)
        cyl_min, cyl_max = ctx.params[..., 0], ctx.params[..., 1]
        cyl_face = torch.where((cyl_max - EPSILON) <= y, 1,
                               torch.where((cyl_min + EPSILON) >= y, 2, 0))
        cap_u = _fmod(x + 1.0, 2.0) / 2.0
        top_v = _fmod(1.0 - z, 2.0) / 2.0
        bot_v = _fmod(z + 1.0, 2.0) / 2.0
        conds_f.append(map_kind == IR.MAP_CYLINDER)
        us.append(torch.where(cyl_face == 0,
                              1.0 - (theta / two_pi + 0.5), cap_u))
        vs.append(torch.where(cyl_face == 0, _fmod(y, 1.0),
                              torch.where(cyl_face == 1, top_v, bot_v)))
        conds_face.append(map_kind == IR.MAP_CYLINDER)
        faces.append(cyl_face)

    if IR.MAP_CUBE in kinds:
        ax, ay, az = x.abs(), y.abs(), z.abs()
        coord = torch.maximum(torch.maximum(ax, ay), az)
        eq = lambda a, b: (a - b).abs() < EPSILON
        cube_face = torch.where(eq(coord, x), 0,
                    torch.where(eq(coord, -x), 1,
                    torch.where(eq(coord, y), 2,
                    torch.where(eq(coord, -y), 3,
                    torch.where(eq(coord, z), 4, 5)))))
        u_x = _fmod(x + 1.0, 2.0) / 2.0
        sel = [cube_face == f for f in range(5)]
        conds_f.append(map_kind == IR.MAP_CUBE)
        us.append(_select(sel + [None], [
            _fmod(1.0 - z, 2.0) / 2.0,      # right
            _fmod(z + 1.0, 2.0) / 2.0,      # left
            u_x, u_x, u_x,                  # up, down, front
            _fmod(1.0 - x, 2.0) / 2.0]))    # back
        vs.append(_select(sel[2:4] + [None], [
            _fmod(1.0 - z, 2.0) / 2.0,      # up
            _fmod(z + 1.0, 2.0) / 2.0,      # down
            _fmod(y + 1.0, 2.0) / 2.0]))
        conds_face.append(map_kind == IR.MAP_CUBE)
        faces.append(cube_face)

    if IR.MAP_TOROID in kinds:
        tor_r1 = ctx.params[..., 0]
        tlen = torch.sqrt(x * x + z * z)
        conds_f.append(map_kind == IR.MAP_TOROID)
        us.append(1.0 - (torch.atan2(z, x) + math.pi) / two_pi)
        vs.append((torch.atan2(y, tlen - tor_r1) + math.pi) / two_pi)

    if IR.MAP_TRIANGLE in kinds:
        if ctx.tri_p1 is None:      # no triangles: the JAX package's zeros
            zeros = lambda w: torch.zeros(p.shape[:-1] + (w,),
                                          dtype=p.dtype, device=p.device)
            ctx = ctx._replace(
                tri_p1=zeros(3), tri_e1=zeros(3), tri_e2=zeros(3),
                tri_t1=zeros(2), tri_t2=zeros(2), tri_t3=zeros(2),
                tri_use_tex=torch.zeros_like(x, dtype=torch.bool))
        e1, e2 = ctx.tri_e1, ctx.tri_e2
        v2 = p - ctx.tri_p1
        d00, d01, d11 = dot3(e1, e1), dot3(e1, e2), dot3(e2, e2)
        d20, d21 = dot3(v2, e1), dot3(v2, e2)
        denom = d00 * d11 - d01 * d01
        inv_den = 1.0 / torch.where(denom == 0, 1.0, denom)
        bv = _fmod((d11 * d20 - d01 * d21) * inv_den, 1.0)
        bw = _fmod((d00 * d21 - d01 * d20) * inv_den, 1.0)
        bu = 1.0 - bv - bw
        t_interp = (bu[..., None] * ctx.tri_t1 + bv[..., None] * ctx.tri_t2
                    + (1.0 - bu - bv)[..., None] * ctx.tri_t3)
        tri_u = torch.where(ctx.tri_use_tex, _fmod(t_interp[..., 0], 1.0), bu)
        tri_v = torch.where(ctx.tri_use_tex, _fmod(t_interp[..., 1], 1.0), bv)
        conds_f.append(map_kind == IR.MAP_TRIANGLE)
        us.append(torch.where(tri_u < 0, tri_u + 1.0, tri_u))
        vs.append(torch.where(tri_v < 0, tri_v + 1.0, tri_v))

    face = (_select(conds_face + [None], faces + [torch.zeros_like(map_kind)])
            if faces else torch.zeros_like(map_kind))
    return face, _select(conds_f, us), _select(conds_f, vs)


# ---------------------------------------------------------------------------
# uv patterns
# ---------------------------------------------------------------------------

def texel_index(ir: SceneIR, pid, u, v):
    """The atlas row of texture pattern pid's texel at (u, v)
    (pattern.c:285-297): v flips and the nearest texel rounds half up;
    the flat index is clamped into the atlas."""
    tex_id = ir.pat_tex[pid].clamp(0, ir.tex_offset.shape[0] - 1)
    tw = ir.tex_width[tex_id]
    th = ir.tex_height[tex_id]
    col = to_int32_saturated(torch.floor(u * (tw - 1).to(u.dtype) + 0.5))
    row = to_int32_saturated(
        torch.floor((1.0 - v) * (th - 1).to(u.dtype) + 0.5))
    idx = ir.tex_offset[tex_id] + row * tw + col
    return idx.clamp(0, ir.tex_data.shape[0] - 1)


def _eval_uv(ir: SceneIR, pid, u, v, kinds):
    """A uv pattern row at (u, v); pid: (R,) (clamped here)."""
    pid = pid.clamp(0, max(ir.meta.n_patterns - 1, 0))
    ptype = ir.pat_type[pid]
    colors = take_rows(ir.pat_colors, pid)      # (R,5,3)
    params = take_rows(ir.pat_params, pid)
    a, b = colors[:, 0], colors[:, 1]
    conds, outs = [], []

    if IR.PAT_UV_CHECKER in kinds:
        # uv_check_uv_pattern_at (pattern.c:251-265)
        u2 = to_int32_saturated(torch.floor(u * params[..., 0]))
        v2 = to_int32_saturated(torch.floor(v * params[..., 1]))
        conds.append((ptype == IR.PAT_UV_CHECKER)[..., None])
        outs.append(torch.where(((u2 + v2) % 2 == 0)[..., None], a, b))

    if IR.PAT_UV_ALIGN_CHECK in kinds:
        # (pattern.c:228-249): colors = main, ul, ur, bl, br
        main, ul, ur, bl, br = (colors[:, i] for i in range(5))
        left, right = (u < 0.2)[..., None], (u > 0.8)[..., None]
        top = torch.where(left, ul, torch.where(right, ur, main))
        bottom = torch.where(left, bl, torch.where(right, br, main))
        conds.append((ptype == IR.PAT_UV_ALIGN_CHECK)[..., None])
        outs.append(torch.where((v > 0.8)[..., None], top,
                                torch.where((v < 0.2)[..., None], bottom,
                                            main)))

    if IR.PAT_UV_TEXTURE in kinds:
        conds.append((ptype == IR.PAT_UV_TEXTURE)[..., None])
        outs.append(take_rows(ir.tex_data, texel_index(ir, pid, u, v)))

    if IR.PAT_UV_GRADIENT in kinds:
        conds.append((ptype == IR.PAT_UV_GRADIENT)[..., None])
        outs.append(a + (b - a) * (u - torch.floor(u))[..., None])

    if IR.PAT_UV_RADIAL_GRADIENT in kinds:
        # |u| where the JAX package has sqrt(u*u): equal in the forward
        # pass (but for under- or overflow), with a finite gradient at 0
        # (ROADMAP C3)
        mag = u.abs()
        conds.append((ptype == IR.PAT_UV_RADIAL_GRADIENT)[..., None])
        outs.append(a + (b - a) * (mag - torch.floor(mag))[..., None])

    if not outs:
        return torch.zeros(u.shape + (3,), dtype=u.dtype, device=u.device)
    return _select(conds, outs)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

def eval_pattern(ir: SceneIR, pid, ctx: ShapeCtx, world_pt, ov_a=None,
                 ov_b=None, depth=None):
    """pattern_at_shape for a batch: pid (R,), world_pt (R,3) -> (R,3).

    Rows with pid < 0 return black (callers select the material constant).
    ov_a/ov_b override the a/b colors (the nested combinator's children);
    `depth` bounds the combinator recursion (default meta.pattern_depth).
    """
    meta = ir.meta
    if meta.n_patterns == 0:
        return torch.zeros_like(world_pt)
    kinds = set(meta.pattern_kinds)
    if depth is None:
        depth = meta.pattern_depth
    valid = pid >= 0
    pid_c = pid.clamp(0, meta.n_patterns - 1)
    ptype = ir.pat_type[pid_c]
    colors = take_rows(ir.pat_colors, pid_c)
    a = colors[:, 0] if ov_a is None else ov_a
    b = colors[:, 1] if ov_b is None else ov_b
    conds, outs = [], []

    if kinds & _CONCRETE or IR.PAT_MAP in kinds:
        obj_pt = xform_points(ctx.obj_inv, world_pt)
        pat_pt = xform_points(take_rows(ir.pat_inv_tf, pid_c), obj_pt)
        x, y, z = pat_pt[..., 0], pat_pt[..., 1], pat_pt[..., 2]

    def lerp(frac):
        return a + (b - a) * frac[..., None]

    if IR.PAT_CHECKER in kinds:
        sel = _cmod2(torch.floor(x) + torch.floor(y) + torch.floor(z))
        conds.append((ptype == IR.PAT_CHECKER)[..., None])
        outs.append(torch.where(sel[..., None], a, b))
    if IR.PAT_GRADIENT in kinds:
        conds.append((ptype == IR.PAT_GRADIENT)[..., None])
        outs.append(lerp(x - torch.floor(x)))
    if kinds & {IR.PAT_RADIAL_GRADIENT, IR.PAT_RING}:
        mag = torch.sqrt(x * x + z * z)
    if IR.PAT_RADIAL_GRADIENT in kinds:
        conds.append((ptype == IR.PAT_RADIAL_GRADIENT)[..., None])
        outs.append(lerp(mag - torch.floor(mag)))
    if IR.PAT_RING in kinds:
        conds.append((ptype == IR.PAT_RING)[..., None])
        outs.append(torch.where(_cmod2(torch.floor(mag))[..., None], a, b))
    if IR.PAT_STRIPE in kinds:
        conds.append((ptype == IR.PAT_STRIPE)[..., None])
        outs.append(torch.where(_cmod2(torch.floor(x))[..., None], a, b))

    if IR.PAT_MAP in kinds:
        face, u, v = _uv_map(ir.pat_map_kind[pid_c], ctx, pat_pt,
                             set(meta.map_kinds))
        face_pid = torch.gather(ir.pat_children[pid_c], 1, face[:, None])[:, 0]
        conds.append((ptype == IR.PAT_MAP)[..., None])
        outs.append(_eval_uv(ir, face_pid, u, v, kinds))

    if depth > 0 and kinds & _COMBINATORS:
        kids = ir.pat_children[pid_c]                     # (R,6)

        def child(is_kind, k, pt=world_pt, **kw):
            return eval_pattern(ir, torch.where(is_kind, kids[:, k], -1),
                                ctx, pt, depth=depth - 1, **kw)

        if IR.PAT_BLENDED in kinds:
            isb = ptype == IR.PAT_BLENDED
            conds.append(isb[..., None])
            outs.append((child(isb, 0) + child(isb, 1)) / 2.0)
        if IR.PAT_NESTED in kinds:
            # child 2/3 colors override child 1's a/b (pattern.c:41-76)
            isn = ptype == IR.PAT_NESTED
            n2, n3 = child(isn, 1), child(isn, 2)
            conds.append(isn[..., None])
            outs.append(child(isn, 0, ov_a=n2, ov_b=n3))
        if IR.PAT_PERTURBED in kinds:
            # 3x noise domain warp of the world point (pattern.c:78-116):
            # the x, y and z warps sample the noise at z, z +- 1, z +- 2
            params = take_rows(ir.pat_params, pid_c)
            freq, scale, persist = params[:, 0], params[:, 1], params[:, 2]
            seed, octaves = params[:, 4], params[:, 3]
            px, py, pz = world_pt[..., 0], world_pt[..., 1], world_pt[..., 2]
            step = lambda zz: torch.where(zz < 0, zz - 1.0, zz + 1.0)
            zs = torch.stack([pz, step(pz), step(step(pz))], -1)  # (R,3)
            noise = _pnoise(ir, px[:, None].expand_as(zs),
                            py[:, None].expand_as(zs), zs, persist, freq,
                            seed, octaves)
            isp = ptype == IR.PAT_PERTURBED
            wpt = torch.where(isp[..., None],
                              world_pt + scale[:, None] * noise, world_pt)
            conds.append(isp[..., None])
            outs.append(child(isp, 0, pt=wpt))

    # uv types reached directly (only through faces in practice) -> black
    if not outs:
        return torch.zeros_like(world_pt)
    return torch.where(valid[..., None], _select(conds, outs), 0.0)


def _pnoise(ir, x, y, z, persistence, frequency, seed, octaves_f):
    """pnoise3d with a per-lane octave count, the octaves unrolled to the
    largest count in the scene and masked. x, y, z: (R, k); persistence,
    frequency, seed, octaves_f: (R,) per lane. The octaves run as one
    batch along a new last axis and are summed in octave order, so each
    lane's arithmetic is the sequential loop's."""
    n_oct = max(1, ir.meta.max_perlin_octaves)
    freqs, amps = [frequency], [torch.ones_like(frequency)]
    for _ in range(n_oct - 1):
        freqs.append(freqs[-1] / 2.0)
        amps.append(amps[-1] * persistence)
    f = torch.stack(freqs, -1)[:, None, :]                   # (R,1,O)
    octave = torch.arange(n_oct, device=x.device)
    noise = _smooth3d(x[..., None] * f, y[..., None] * f, z[..., None] * f,
                      octave, to_int32_saturated(seed)[:, None, None])
    terms = torch.where(octave < octaves_f[:, None, None],
                        noise * torch.stack(amps, -1)[:, None, :], 0.0)
    total = torch.zeros_like(x)
    for i in range(n_oct):
        total = total + terms[..., i]
    return total
