"""The Whitted integrator, batched and unrolled by wavefront level.

The reference recurses per ray: color_at -> shade_hit -> reflected_color/
refracted_color -> color_at (src/renderer/renderer.c:347-827). Here each
level of that recursion is one batch: `trace` evaluates the full 2^depth
wavefront (the exact oracle), `trace_bucketed` compacts each level's live
children into a static bucket of B lanes on the device. Ambient, diffuse
and specular accumulate in separate channels through the recursion and
the final pixel is (A + D + S) / 3 (renderer.c:226-230, color.h:24-26).

The stream compaction of `trace_bucketed` and the closest-hit and shadow
queries of clustered meshes run in hand-written CUDA kernels on the card
(ops/compact.py, ops/mesh.py); on the CPU they take their plain torch
versions.

Stochastic scenes pass an RNG node (sampling/rng.py) down the trace, and
each draw sits where the JAX package draws from its key: level `lvl`
folds in lvl, and shade_direct splits three ways per light (the shadow
test's and the shading's sample tables, then the rest), before the GI
hook (render/photon.py) draws its final-gather directions. The draws of
a level are indexed by its rows, so the bucketed and the unrolled trace
draw alike only where their levels hold the same rows.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from fast_ray_tracer_tpu_torch.constants import EPSILON, SQRT3
from fast_ray_tracer_tpu_torch.ops import compact, mesh
from fast_ray_tracer_tpu_torch.ops.gather import take_rows
from fast_ray_tracer_tpu_torch.ops.intersect import (
    Hit, apply_csg_filter, closest_hit, containers_n1_n2, csg_device_tables,
    csg_static_tables, intersect_candidates, neutralize_rays,
    shadow_components, shadow_hit_early_exit, slot_tables, triangle_uv_at,
)
from fast_ray_tracer_tpu_torch.ops.patterns import (
    ShapeCtx, build_shape_ctx, eval_pattern,
)
from fast_ray_tracer_tpu_torch.ops.vec import dot3, normalize
from fast_ray_tracer_tpu_torch.render.normals import normal_at
from fast_ray_tracer_tpu_torch.sampling.cmj import (
    cmj_points_batched, draw_cmj_batched,
)
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR
from fast_ray_tracer_tpu_torch.scene.model import ConfigDesc
from fast_ray_tracer_tpu_torch.utils.profiling import host_sync

# bucket fill row (origin | direction) for the lanes past the live count:
# far outside the scene, so every fill lane misses
FILL_ROW = (1e30, 1e30, 1e30, 1.0, 1.0, 1.0)
# spawn_counts' internal buckets, as a multiple of the primary batch
PROBE_CEILING = 3.0


class Triple(NamedTuple):
    """Separate ambient/diffuse/specular accumulators (ColorTriple)."""
    a: torch.Tensor   # (R,3)
    d: torch.Tensor
    s: torch.Tensor

    @staticmethod
    def zeros(r, dtype, device):
        z = torch.zeros((r, 3), dtype=dtype, device=device)
        return Triple(z, z, z)

    def __add__(self, o):
        return Triple(self.a + o.a, self.d + o.d, self.s + o.s)

    def scale(self, f):
        return Triple(self.a * f, self.d * f, self.s * f)

    def mask(self, m):
        m = m[..., None]
        return Triple(torch.where(m, self.a, 0.0),
                      torch.where(m, self.d, 0.0),
                      torch.where(m, self.s, 0.0))


class RenderStatics(NamedTuple):
    """Per-scene derived tables, on the scene's device. With
    meta.use_clusters the slot_* tables cover the analytic block only and
    `mesh` holds the clustered mesh packed for its queries."""
    slot_prim: torch.Tensor      # (H,) int64 global prim per candidate slot
    prim_mat: torch.Tensor       # (N_prims,) int64 material per prim
    slot_shadow: torch.Tensor    # (H,) bool casts_shadow per slot
    slot_rank: torch.Tensor      # (H,) int64 shadow-walk rank per slot
    prim_ni: torch.Tensor        # (N_prims,) refractive index per prim
    mesh: Optional[mesh.MeshTables]   # clustered mesh (use_clusters only)
    csg_tables: tuple            # per csg tree: (slots, filter program)
    cfg: ConfigDesc
    # the photon-map GI term (render/photon.make_gi_hook), attached by
    # render_scene after the photon pass
    gi_hook: Optional[object] = None


def build_statics(ir: SceneIR, cfg: ConfigDesc) -> RenderStatics:
    meta = ir.meta
    slot_np = slot_tables(meta)
    with host_sync("upload"):
        slot_prim = torch.as_tensor(slot_np).to(ir.inv_tf.device)
    csg_tables = ()
    if meta.has_csg:
        # static host tables from the Python-int tags in meta, moved to the
        # device once; triangles take part like any other leaf
        csg_tables = csg_device_tables(csg_static_tables(
            meta, slot_np, meta.csg_prim_leaf, meta.csg_prim_anc,
            meta.csg_prim_side), ir.inv_tf.device)
    prim_mat = torch.cat([ir.material_id, ir.tri_material_id])
    packed = None
    if meta.use_clusters:
        tri_mat = ir.tri_material_id
        packed = mesh.pack(
            ir, tri_rank=ir.prim_shadow_rank[meta.n_analytic:],
            tri_shadow=ir.mat_casts_shadow[tri_mat],
            tri_ni=ir.mat_Ni[tri_mat] if meta.needs_hit_sort else None)
    return RenderStatics(
        slot_prim=slot_prim, prim_mat=prim_mat,
        slot_shadow=ir.mat_casts_shadow[prim_mat[slot_prim]],
        slot_rank=ir.prim_shadow_rank[slot_prim],
        prim_ni=ir.mat_Ni[prim_mat], mesh=packed, csg_tables=csg_tables,
        cfg=cfg)


def closest_query(ir: SceneIR, rt: RenderStatics, orig, dirs,
                  shadow_filter: bool = False):
    """Nearest positive hit over the analytic prims and the mesh.
    Returns (Hit, t_cand) — t_cand feeds the containers walk.
    shadow_filter=True takes hits on casts_shadow materials only (the
    reference's `hit(xs, true)`, which the photon pass uses,
    photon_tracer.c:190): the slot filter, and the mesh query's keep.

    The mesh query (kernel or plain version) runs without autograd and
    gives (t, triangle); its t carries the gradient of Möller–Trumbore on
    that triangle with the live tables (mesh_hit_t), on every device."""
    meta = ir.meta
    t_cand = intersect_candidates(ir, orig, dirs)
    if meta.has_csg:
        t_cand = apply_csg_filter(t_cand, rt.csg_tables)
    hit = closest_hit(t_cand, rt.slot_prim,
                      mask=rt.slot_shadow if shadow_filter else None)
    if not meta.use_clusters:
        return hit, t_cand
    keep = ir.mat_casts_shadow[ir.tri_material_id] if shadow_filter else None
    with torch.no_grad():
        t_m, idx_m = mesh.closest(rt.mesh, orig, dirs, keep)
    t_m = mesh_hit_t(ir, t_m, idx_m, orig, dirs)
    use_m = t_m < hit.t
    return Hit(valid=hit.valid | torch.isfinite(t_m),
               t=torch.where(use_m, t_m, hit.t),
               prim=torch.where(use_m, idx_m + meta.n_analytic,
                                hit.prim)), t_cand


def mesh_hit_t(ir: SceneIR, t, idx, orig, dirs):
    """The mesh query's hit distances t (R,) with the gradient of the
    winning triangle's Möller–Trumbore t in the live tri_p1/e1/e2 and in
    the ray, as the JAX package's plain mesh path differentiates through
    its min (on a tie its min splits the cotangent; here the lowest index
    takes it all). The forward value stays the query's t, bit for bit;
    without autograd t comes back as it is."""
    if not torch.is_grad_enabled() or not (
            orig.requires_grad or dirs.requires_grad
            or ir.tri_p1.requires_grad or ir.tri_e1.requires_grad
            or ir.tri_e2.requires_grad):
        return t
    i = idx.long()
    comp = [take_rows(ir.tri_p1, i), take_rows(ir.tri_e1, i),
            take_rows(ir.tri_e2, i)]
    t_re, _, _, _ = mesh.moller_trumbore(
        [orig[:, k] for k in range(3)], [dirs[:, k] for k in range(3)],
        [a[:, k] for a in comp for k in range(3)])
    return torch.where(torch.isfinite(t), t + (t_re - t_re.detach()), t)


class Comps(NamedTuple):
    """prepare_computations outputs (renderer.c:368-495), batched."""
    valid: torch.Tensor
    t: torch.Tensor
    prim: torch.Tensor
    p: torch.Tensor
    eyev: torch.Tensor
    normalv: torch.Tensor
    reflectv: torch.Tensor
    over_point: torch.Tensor
    under_point: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    inside: torch.Tensor
    mat: torch.Tensor          # (R,) material index
    over_Ka: torch.Tensor      # (R,3) pattern-sampled or constant
    over_Kd: torch.Tensor
    over_Ks: torch.Tensor
    over_refl: torch.Tensor
    over_Ns: torch.Tensor      # (R,)
    over_d: torch.Tensor       # (R,) dissolve = 1 - Tr
    tf: torch.Tensor           # (R,3) mat_Tf[mat]
    tr: torch.Tensor           # (R,)  mat_Tr[mat]
    refl_flag: torch.Tensor    # (R,)  mat_reflective[mat]
    ctx: ShapeCtx


def prepare_computations(ir: SceneIR, rt: RenderStatics, orig, dirs,
                         shadow_filter: bool = False) -> Comps:
    meta = ir.meta
    hit, t_cand = closest_query(ir, rt, orig, dirs, shadow_filter)
    t = torch.where(hit.valid, hit.t, 1.0)
    prim = hit.prim
    p = orig + t[:, None] * dirs
    eyev = -dirs

    ctx = build_shape_ctx(ir, prim)
    mat = rt.prim_mat[prim]

    # barycentric (u, v) of triangle hits, for the smooth normals
    na = meta.n_analytic
    if meta.n_triangles:
        u, v = triangle_uv_at(ir, (prim - na).clamp(0, meta.n_triangles - 1),
                              orig, dirs)
        is_tri = prim >= na
        u = torch.where(is_tri, u, 0.0)
        v = torch.where(is_tri, v, 0.0)
    else:
        u = v = torch.zeros_like(t)

    bump_pid = ir.mat_map[mat, IR.SLOT_BUMP] if meta.any_bump else None
    normalv = normal_at(ir, ctx, prim, p, u, v, mat_bump_pid=bump_pid)
    inside = dot3(normalv, eyev) < 0.0
    normalv = torch.where(inside[:, None], -normalv, normalv)
    reflectv = dirs - normalv * (2.0 * dot3(dirs, normalv))[:, None]
    over_point = p + normalv * EPSILON
    under_point = p - normalv * EPSILON

    if not meta.needs_hit_sort:
        n1 = torch.ones_like(t)
        n2 = torch.ones_like(t)
    elif not meta.use_clusters:
        n1, n2 = containers_n1_n2(meta, t_cand, hit.t, rt.prim_ni)
    else:
        # merge the dense-table walk with the clustered mesh's: the later
        # included entry (larger t) is the containers' last object, so its
        # Ni wins per walk (renderer.c:406-447)
        neg = torch.full_like(t, -torch.inf)
        if na:
            dn1, dn2, dm1, dm2 = containers_n1_n2(
                meta, t_cand, hit.t, rt.prim_ni, with_entry_t=True)
        else:
            dn1 = dn2 = torch.ones_like(t)
            dm1 = dm2 = neg
        hit_tri = torch.where(hit.valid & (prim >= na), prim - na, -1)
        # gradient-free: the walk's t values only order its entries, and
        # its Ni is the step-constant packed plane
        with torch.no_grad():
            mt1, mn1, mt2, mn2 = mesh.containers(
                rt.mesh, orig, dirs, torch.where(hit.valid, hit.t, neg),
                hit_tri)
        n1 = torch.where(mt1 > dm1, mn1, dn1)
        n2 = torch.where(mt2 > dm2, mn2, dn2)

    # material map sampling at over_point (renderer.c:449-494); slots with
    # no pattern anywhere in the scene skip the pattern evaluation
    def slot_color(slot, const):
        if slot not in meta.pattern_slots:
            return const
        pid = ir.mat_map[mat, slot]
        patc = eval_pattern(ir, pid, ctx, over_point)
        return torch.where((pid >= 0)[:, None], patc, const)

    m_Tr = take_rows(ir.mat_Tr, mat)
    ones3 = torch.ones((1, 3), dtype=t.dtype, device=t.device)
    return Comps(
        valid=hit.valid, t=hit.t, prim=prim, p=p, eyev=eyev,
        normalv=normalv, reflectv=reflectv, over_point=over_point,
        under_point=under_point, n1=n1, n2=n2, inside=inside, mat=mat,
        over_Ka=slot_color(IR.SLOT_KA, take_rows(ir.mat_Ka, mat)),
        over_Kd=slot_color(IR.SLOT_KD, take_rows(ir.mat_Kd, mat)),
        over_Ks=slot_color(IR.SLOT_KS, take_rows(ir.mat_Ks, mat)),
        over_refl=slot_color(IR.SLOT_REFL, take_rows(ir.mat_refl, mat)),
        over_Ns=slot_color(IR.SLOT_NS,
                           take_rows(ir.mat_Ns, mat)[:, None] * ones3)[:, 0],
        over_d=slot_color(IR.SLOT_D, (1.0 - m_Tr)[:, None] * ones3)[:, 0],
        tf=take_rows(ir.mat_Tf, mat), tr=m_Tr,
        refl_flag=ir.mat_reflective[mat],
        ctx=ctx)


# ---------------------------------------------------------------------------
# shadows and direct lighting
# ---------------------------------------------------------------------------

def is_shadowed(ir: SceneIR, rt: RenderStatics, light_pts, p, active):
    """Batched is_shadowed (renderer.c:73-93). light_pts: (R,S,3), p: (R,3)
    -> (R,S) bool. `active`: (R,) lanes whose result matters; on clustered
    scenes the others are parked outside the scene, so the mesh query
    skips them."""
    R, S, _ = light_pts.shape
    v = light_pts - p[:, None, :]
    dist = torch.sqrt(dot3(v, v))
    direction = v / dist[..., None].clamp(min=1e-30)
    o = p[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    d = direction.reshape(R * S, 3)
    if ir.meta.use_clusters:
        o, d = neutralize_rays(
            o, d, active[:, None].expand(R, S).reshape(R * S))
    df = dist.reshape(R * S)
    t_cand = intersect_candidates(ir, o, d)
    if ir.meta.has_csg:
        # is_shadowed passes stop_after_first_hit, which truncates group
        # walks inside csg trees (renderer.c:73-93)
        t_cand = apply_csg_filter(t_cand, rt.csg_tables, shadow=True)
    if not ir.meta.use_clusters:
        shadowed = shadow_hit_early_exit(t_cand, rt.slot_rank,
                                         rt.slot_shadow, df)
        return shadowed.reshape(R, S)
    # the analytic and mesh early-exit components: the lower rank wins
    a_rank, a_t = shadow_components(t_cand, rt.slot_rank, rt.slot_shadow)
    with torch.no_grad():
        m_rank, m_t = mesh.shadow(rt.mesh, o, d)
    t = torch.where(m_rank < a_rank, m_t, a_t)
    return (t < df).reshape(R, S)


def _light_sample_points(ir: SceneIR, li: int, R: int, rng=None):
    """Surface sample points of light li: (R, S, 3). Without `rng`, or
    for point, hemisphere and unjittered lights, the compile-time cache
    broadcast to every lane (point and hemisphere lights have one point,
    their position; area and circle lights their S CMJ points). A
    jittered area or circle light draws a fresh CMJ table per lane from
    `rng` (the reference picks one of 65536 pre-jittered tables per
    query, light.c:193-198 — statistically the same)."""
    typ, usteps, vsteps, jitter, num = ir.meta.light_info[li]
    if not jitter or rng is None or typ in (IR.LIGHT_POINT,
                                            IR.LIGHT_HEMISPHERE):
        return ir.light_points[li, :num][None].expand(R, num, 3)
    tables = cmj_points_batched(
        *draw_cmj_batched(rng, R, usteps, vsteps, ir.light_pos.dtype),
        usteps, vsteps)
    return jittered_light_points(ir, li, tables)


def jittered_light_points(ir: SceneIR, li: int, tables):
    """Light li's sample points (R, S, 3) from CMJ tables (R, S, 2): the
    area light's corner + u steps * uvec + v steps * vvec, the circle
    light's uniform disc in its frame (sampler.c:116-139)."""
    typ, usteps, vsteps = ir.meta.light_info[li][:3]
    pos = ir.light_pos[li][None, None]
    if typ == IR.LIGHT_AREA:
        u = tables[..., 0] * usteps
        v = tables[..., 1] * vsteps
        return (pos + u[..., None] * ir.light_uvec[li][None, None]
                + v[..., None] * ir.light_vvec[li][None, None])
    theta = 2.0 * math.pi * tables[..., 0]
    r = ir.light_radius[li] * torch.sqrt(tables[..., 1])
    nt, nb = coordinate_frame(ir.light_normal[li][None])
    return (pos + (r * torch.cos(theta))[..., None] * nb[None]
            + (r * torch.sin(theta))[..., None] * nt[None])


def coordinate_frame(n):
    """create_coordinate_system (sampler.c:66-85) per row of n (R, 3):
    (nt, nb), nt the negated normalized perpendicular, nb = n x nt."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    zero = torch.zeros_like(x)

    def unit(v, a, b):
        return v / torch.sqrt((a * a + b * b).clamp(min=1e-30))[:, None]
    use_x = (x.abs() > y.abs())[:, None]
    nt = -torch.where(use_x, unit(torch.stack([z, zero, -x], -1), x, z),
                      unit(torch.stack([zero, -z, y], -1), y, z))
    return nt, torch.linalg.cross(n, nt)


def lighting_microfacet(ir: SceneIR, rt: RenderStatics, comps: Comps,
                        li: int, light_pts, shade_intensity) -> Triple:
    """Cook-Torrance-style direct term (renderer.c:894-979)."""
    cfg = rt.cfg
    R = comps.p.shape[0]
    dtype, dev = comps.p.dtype, comps.p.device
    I = ir.light_intensity[li][None]            # (1,3)
    num_samples = ir.meta.light_info[li][4]

    ambient = comps.over_Ka * I
    res = Triple.zeros(R, dtype, dev)

    if cfg.include_diffuse or cfg.include_specular_highlight:
        point = comps.over_point
        n = comps.normalv
        eyev = comps.eyev
        ndote = dot3(n, eyev)
        lightv = normalize(light_pts - point[:, None, :])      # (R,S,3)
        ldotn = dot3(lightv, n[:, None, :])                   # (R,S)
        cond = ldotn >= 0.0

        d_acc = torch.zeros((R, 3), dtype=dtype, device=dev)
        s_acc = torch.zeros((R, 3), dtype=dtype, device=dev)
        if cfg.include_diffuse:
            contrib = comps.over_Kd[:, None, :] * I[None] * ldotn[..., None]
            d_acc = torch.where(cond[..., None], contrib, 0.0).sum(1)
        if cfg.include_specular_highlight:
            h = normalize(lightv + eyev[:, None, :])
            ndoth = dot3(n[:, None, :], h).clamp(min=0.0)
            edoth = dot3(eyev[:, None, :], h)
            # reference: 1/fmax(0, edoth) (renderer.c:953) — inf allowed,
            # saturated away by the fmin below; saturate explicitly so the
            # backward stays finite, and reproduce C fmin's NaN handling
            e_pos = edoth > 1e-8
            edoth_inv = torch.where(
                e_pos, 1.0 / torch.where(e_pos, edoth, 1.0), 1e30)
            ldoth = dot3(lightv, h)
            Ns = comps.over_Ns[:, None]
            # pow(0, Ns) = 0 but its Ns-derivative is NaN: guard the base
            pos = ndoth > 0.0
            pw = torch.where(
                pos, torch.pow(torch.where(pos, ndoth, 1.0), Ns), 0.0)
            D = (Ns + 2.0) * pw * (0.5 / math.pi)
            gc = 2.0 * ndoth * edoth_inv
            G = torch.minimum(gc * ndote[:, None], gc * ldotn).clamp(max=1.0)
            fct = torch.pow(1.0 - ldoth, 5.0)
            Ks = comps.over_Ks[:, None, :]
            F = Ks + (1.0 - Ks) * fct[..., None]
            denom = 4.0 * ldotn * ndote[:, None]
            safe = cond & (denom > 1e-30)
            brdf = torch.where(
                safe, D * G / torch.where(safe, denom, 1.0), 0.0)
            s_acc = torch.where(safe[..., None],
                                F * I[None] * brdf[..., None], 0.0).sum(1)
        scaling = (shade_intensity / num_samples)[:, None]
        # equal(shade_intensity, 0) -> ambient only (renderer.c:904-909)
        lit = (shade_intensity.abs() >= EPSILON)[:, None]
        res = Triple(res.a, res.d + torch.where(lit, d_acc * scaling, 0.0),
                     res.s + torch.where(lit, s_acc * scaling, 0.0))

    if cfg.include_ambient:
        res = Triple(res.a + ambient, res.d, res.s)
    return res


def intensity_at(ir: SceneIR, rt: RenderStatics, li: int, p, active,
                 rng=None):
    """The unshadowed fraction of light li's samples seen from p (R, 3)
    (light.c:229-251), and the sample points (drawn from `rng` for a
    jittered light)."""
    pts = _light_sample_points(ir, li, p.shape[0], rng)
    shadowed = is_shadowed(ir, rt, pts, p, active)
    return (1.0 - shadowed.to(p.dtype)).mean(-1), pts


def shade_direct(ir: SceneIR, rt: RenderStatics, comps: Comps,
                 rng=None) -> Triple:
    """The non-recursive part of shade_hit (renderer.c:689-770): direct
    lighting per light, then the photon-map GI terms. Point and
    hemisphere lights cast one shadow ray per lane; area and circle
    lights cast one to each of their S sample points, an (R * S)-ray
    shadow query, and light the lane from every sample point. A jittered
    light draws two independent tables per lane, one for the shadow test
    and one for the shading (k1, k2 of the JAX package's split; the
    reference draws afresh for each too)."""
    R = comps.p.shape[0]
    surface = Triple.zeros(R, comps.p.dtype, comps.p.device)
    if rt.cfg.include_direct:
        for li in range(ir.meta.n_lights):
            k1 = k2 = None
            if rng is not None:
                rng, k1, k2 = rng.split(3)
            intensity, pts = intensity_at(ir, rt, li, comps.over_point,
                                          comps.valid, k1)
            if k2 is not None and ir.meta.light_info[li][3]:
                pts = _light_sample_points(ir, li, R, k2)
            surface = surface + lighting_microfacet(
                ir, rt, comps, li, pts, intensity)
    if rt.gi_hook is not None:
        a = surface.a + rt.gi_hook(ir, rt, comps, rng)
        # the L1 clamp of the ambient channel (renderer.c:765-769); the GI
        # block, clamp included, is gated on over_Kd > 0 (renderer.c:728):
        # black-diffuse lanes keep an unclamped ambient
        l1 = a.sum(-1, keepdim=True)
        over = l1 > SQRT3
        clamped = torch.where(over, a * SQRT3 / torch.where(over, l1, 1.0),
                              a)
        gate = (comps.over_Kd > 0.0).any(-1, keepdim=True)
        surface = Triple(torch.where(gate, clamped, a), surface.d, surface.s)
    return surface


def combine_specular(ir: SceneIR, rt: RenderStatics, comps: Comps,
                     surface: Triple, reflected_raw: Optional[Triple],
                     refracted_raw: Optional[Triple]) -> Triple:
    """The specular tail of shade_hit (renderer.c:772-822): scale the child
    results by over_refl / Tf*over_d, schlick-blend, apply the dissolve
    multiply (which runs even when children are black), and accumulate.

    reflected_raw/refracted_raw are the child color_at results (or None at
    the recursion leaf / when statically absent)."""
    if not rt.cfg.include_specular or not (ir.meta.has_reflective
                                           or ir.meta.has_refractive):
        return surface
    R = comps.p.shape[0]
    dtype, dev = comps.p.dtype, comps.p.device

    if reflected_raw is None or not ir.meta.has_reflective:
        reflected = Triple.zeros(R, dtype, dev)
    else:
        reflected = reflected_raw.scale(comps.over_refl).mask(
            comps.refl_flag & comps.valid)

    if refracted_raw is None or not ir.meta.has_refractive:
        refracted = Triple.zeros(R, dtype, dev)
    else:
        refracted = refracted_raw.scale(
            comps.tf * comps.over_d[:, None]).mask(refract_active(comps))

    both = comps.refl_flag & (comps.over_d < 1.0)
    reflectance = schlick(comps)
    reflected = reflected.scale(
        torch.where(both, reflectance, 1.0)[:, None])
    refracted = refracted.scale(
        torch.where(both, 1.0 - reflectance, 1.0)[:, None])

    surface = surface + reflected
    dis = (comps.tr > 0.0) & (comps.over_d > 0.0)
    surface = surface.scale(torch.where(dis, 1.0 - comps.over_d, 1.0)[:, None])
    return surface + refracted


def _sin2_t(comps: Comps):
    n_ratio = comps.n1 / comps.n2
    cos_i = dot3(comps.eyev, comps.normalv)
    return n_ratio, cos_i, n_ratio * n_ratio * (1.0 - cos_i * cos_i)


def refract_active(comps: Comps):
    """Mask of lanes where refracted_color proceeds (over_d > 0, no TIR)."""
    _, _, sin2_t = _sin2_t(comps)
    return (comps.over_d > 0.0) & comps.valid & (sin2_t <= 1.0)


def _cos_t(sin2_t):
    # double-where: sqrt'(0) = inf would poison gradients at grazing /
    # TIR-boundary lanes; forward values are unchanged
    inner = sin2_t < 1.0
    return torch.where(
        inner, torch.sqrt(torch.where(inner, (1.0 - sin2_t).clamp(min=0.0),
                                      1.0)), 0.0)


def refract_direction(comps: Comps):
    """Snell construction (renderer.c:560-572)."""
    n_ratio, cos_i, sin2_t = _sin2_t(comps)
    cos_t = _cos_t(sin2_t)
    return comps.normalv * (n_ratio * cos_i - cos_t)[:, None] \
        - comps.eyev * n_ratio[:, None]


def schlick(comps: Comps):
    """renderer.c:607-624."""
    n, co, sin2_t = _sin2_t(comps)
    cos_t = _cos_t(sin2_t)
    co_eff = torch.where(comps.n1 > comps.n2, cos_t, co)
    r = (comps.n1 - comps.n2) / (comps.n1 + comps.n2)
    r0 = r * r
    x = 1.0 - co_eff
    x2 = x * x
    # x**5 by binary exponentiation, the JAX package's integer_pow order
    reflectance = r0 + (1.0 - r0) * (x * (x2 * x2))
    tir = (comps.n1 > comps.n2) & (sin2_t > 1.0)
    return torch.where(tir, 1.0, reflectance)


# ---------------------------------------------------------------------------
# wavefront traces
# ---------------------------------------------------------------------------

def _level(ir, rt, orig, dirs, rng=None):
    comps = prepare_computations(ir, rt, orig, dirs)
    return comps, shade_direct(ir, rt, comps, rng)


# matrix-product operators: what the "dots" remat mode keeps saved
_DOT_OPS = frozenset((torch.ops.aten.mm, torch.ops.aten.bmm,
                      torch.ops.aten.addmm, torch.ops.aten.baddbmm,
                      torch.ops.aten.dot, torch.ops.aten.mv))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots": `op` is an overload
    (aten.mm.default), the set holds their packets."""
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, **kw):
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _make_level_fn(remat):
    """(ir, rt, o, d, rng) -> (Comps, direct Triple), optionally
    checkpointed (a recomputed level draws the same numbers again):
    under autograd each wavefront level's big intermediates (candidate t
    tables, shadow-ray batches, pattern evaluations) are recomputed in the
    backward instead of stored, so activation memory grows with the lanes
    a level keeps, not with its temporaries. Without autograd a
    checkpointed level runs as the plain one. The compaction between
    levels stays outside the checkpointed function, so recomputing a
    level never launches a compaction kernel again.

    remat modes (the JAX package's `_make_level_fn` strings):
      False/"none"  store everything (least recompute, most memory)
      True/"level"  one checkpoint per wavefront level
      "nested"      the level checkpoint plus inner ones around
                    prepare_computations and shade_direct: the level's
                    backward holds one sub-block's internals at a time
      "dots"        the level checkpoint with a selective policy that
                    keeps matrix-product outputs saved and recomputes the
                    rest. The port writes the ray transforms term by term
                    (ops/vec.py) so that a lane's result never depends on
                    its batch; no matrix product runs in a level, so this
                    mode saves what "level" saves: the level's inputs and
                    outputs."""
    if remat is True:
        remat = "level"
    if not remat or remat == "none":
        return _level
    if remat == "level":
        return _checkpointed(_level)
    if remat == "nested":
        prep = _checkpointed(prepare_computations)
        shade = _checkpointed(shade_direct)

        def _level_nested(ir, rt, orig, dirs, rng=None):
            comps = prep(ir, rt, orig, dirs)
            return comps, shade(ir, rt, comps, rng)
        return _checkpointed(_level_nested)
    if remat == "dots":
        return _checkpointed(_level, context_fn=partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat must be False, True, 'none', 'level', "
                     f"'nested' or 'dots': {remat!r}")


def _wants(ir: SceneIR, rt: RenderStatics, depth: int):
    spec = rt.cfg.include_specular and depth > 0
    return spec and ir.meta.has_reflective, spec and ir.meta.has_refractive


def _split_children(total: Triple, n: int, want_refl: bool,
                    want_refr: bool):
    """Child results laid out [reflect lanes 0..n) | refract lanes n..2n)."""
    refl_raw = refr_raw = None
    off = 0
    if want_refl:
        refl_raw = Triple(total.a[off:off + n], total.d[off:off + n],
                          total.s[off:off + n])
        off += n
    if want_refr:
        refr_raw = Triple(total.a[off:off + n], total.d[off:off + n],
                          total.s[off:off + n])
    return refl_raw, refr_raw


def trace(ir: SceneIR, rt: RenderStatics, orig, dirs, depth: int,
          remat=False, rng=None) -> Triple:
    """Wavefront Whitted trace: the reference's branching recursion
    (reflect + refract children, depth `remaining`) evaluated one level at
    a time over concatenated child batches — the exact oracle, 2^depth
    lanes at the last level, same arithmetic per lane. `remat` checkpoints
    each level for the backward (`_make_level_fn`); `rng` is the trace's
    RNG node, or None for a scene that draws nothing."""
    want_refl, want_refr = _wants(ir, rt, depth)
    level_fn = _make_level_fn(remat)
    levels = []
    cur_o, cur_d = orig, dirs
    for lvl in range(depth + 1):
        comps, direct = level_fn(ir, rt, cur_o, cur_d,
                                 None if rng is None else rng.fold(lvl))
        levels.append((comps, direct))
        if lvl == depth or not (want_refl or want_refr):
            break
        # on clustered scenes dead children are parked outside the scene,
        # so the mesh queries skip them (their results are masked anyway)
        children_o, children_d = [], []
        if want_refl:
            o_c, d_c = comps.over_point, comps.reflectv
            if ir.meta.use_clusters:
                o_c, d_c = neutralize_rays(o_c, d_c,
                                           comps.refl_flag & comps.valid)
            children_o.append(o_c)
            children_d.append(d_c)
        if want_refr:
            o_c, d_c = comps.under_point, refract_direction(comps)
            if ir.meta.use_clusters:
                o_c, d_c = neutralize_rays(o_c, d_c, refract_active(comps))
            children_o.append(o_c)
            children_d.append(d_c)
        cur_o = torch.cat(children_o)
        cur_d = torch.cat(children_d)

    child_total: Optional[Triple] = None
    for comps, direct in reversed(levels):
        refl_raw = refr_raw = None
        if child_total is not None:
            refl_raw, refr_raw = _split_children(
                child_total, comps.p.shape[0], want_refl, want_refr)
        total = combine_specular(ir, rt, comps, direct, refl_raw, refr_raw)
        child_total = total.mask(comps.valid)
    return child_total


def _spawn(comps: Comps, want_refl: bool, want_refr: bool):
    """Per-level child spawn mask and packed (origin | direction) rows,
    laid out [reflect lanes | refract lanes]. Children whose contribution
    is provably zero are not spawned (the value gates): reflect scales by
    over_refl, refract by Tf * over_d (combine_specular), and a zero color
    kills the whole subtree."""
    acts, rows = [], []
    if want_refl:
        acts.append(comps.refl_flag & comps.valid
                    & (comps.over_refl != 0.0).any(-1))
        rows.append(torch.cat([comps.over_point, comps.reflectv], -1))
    if want_refr:
        acts.append(refract_active(comps) & (comps.tf != 0.0).any(-1))
        rows.append(torch.cat([comps.under_point, refract_direction(comps)],
                              -1))
    return torch.cat(acts), torch.cat(rows)


def trace_bucketed(ir: SceneIR, rt: RenderStatics, orig, dirs, depth: int,
                   buckets, remat=False, rng=None):
    """Wavefront trace with device-side static-bucket compaction.

    Each level's live children are compacted, in order, into a bucket of
    B = buckets[lvl] lanes (rows past the live count get FILL_ROW); the
    upward combine routes each child's result back through the same
    positions. No host sync anywhere in the trace: a level whose live
    children exceed its bucket drops the surplus, and the returned
    `overflow` flag (a bool tensor on the device) says so — the caller
    checks it once per chunk and re-renders (render.py).

    Per-lane arithmetic is identical to `trace`, so the canvas is too.

    Differentiable: compact_rows and expand_rows are each other's VJP, so
    the backward runs both kernels again on the card. The value gates of
    `_spawn` stay on under autograd (ungated spawning regrows the 2^depth
    graph), so a material whose refl or Tf is exactly zero gets
    subgradient 0 through the subtree it prunes; any nonzero channel gets
    the exact gradient. `remat` checkpoints each level (`_make_level_fn`);
    the compactions stay outside the checkpoints. `rng` as in `trace`,
    except that a trace with no children draws from `rng` itself (the
    JAX package's quirk: its one level takes the key unfolded)."""
    want_refl, want_refr = _wants(ir, rt, depth)
    level_fn = _make_level_fn(remat)
    overflow = torch.zeros((), dtype=torch.bool, device=orig.device)
    if not (want_refl or want_refr):
        comps, direct = level_fn(ir, rt, orig, dirs, rng)
        return combine_specular(ir, rt, comps, direct, None,
                                None).mask(comps.valid), overflow

    levels = []
    cur_o, cur_d = orig, dirs
    for lvl in range(depth + 1):
        comps, direct = level_fn(ir, rt, cur_o, cur_d,
                                 None if rng is None else rng.fold(lvl))
        entry = {"comps": comps, "direct": direct, "act": None, "bucket": 0}
        levels.append(entry)
        if lvl == depth:
            break
        act, src = _spawn(comps, want_refl, want_refr)
        B = int(buckets[lvl]) if lvl < len(buckets) else cur_o.shape[0]
        overflow = overflow | (act.sum() > B)
        entry["act"] = act
        entry["bucket"] = B
        rows = compact.compact_rows(src, act, B, FILL_ROW)
        cur_o = rows[:, :3]
        cur_d = rows[:, 3:6]

    child_total: Optional[Triple] = None
    for e in reversed(levels):
        comps = e["comps"]
        refl_raw = refr_raw = None
        if child_total is not None:
            packed = torch.cat([child_total.a, child_total.d,
                                child_total.s], -1)
            g = compact.expand_rows(packed, e["act"])
            refl_raw, refr_raw = _split_children(
                Triple(g[:, 0:3], g[:, 3:6], g[:, 6:9]), comps.p.shape[0],
                want_refl, want_refr)
        total = combine_specular(ir, rt, comps, e["direct"],
                                 refl_raw, refr_raw)
        child_total = total.mask(comps.valid)
    return child_total, overflow


def spawn_counts(ir: SceneIR, rt: RenderStatics, orig, dirs, depth: int):
    """Per-level live-children counts for bucket calibration, as a list of
    0-d device tensors (the caller syncs once for all of them). Uses
    buckets of PROBE_CEILING x the primary batch internally, so the counts
    are exact unless a level spawns more than that."""
    want_refl, want_refr = _wants(ir, rt, depth)
    if not (want_refl or want_refr):
        return []
    B = int(np.ceil(orig.shape[0] * PROBE_CEILING / 256.0)) * 256
    counts = []
    cur_o, cur_d = orig, dirs
    for _ in range(depth):
        comps = prepare_computations(ir, rt, cur_o, cur_d)
        act, src = _spawn(comps, want_refl, want_refr)
        counts.append(act.sum())
        rows = compact.compact_rows(src, act, B, FILL_ROW)
        cur_o = rows[:, :3]
        cur_d = rows[:, 3:6]
    return counts


def default_buckets(n0: int, depth: int):
    """Bucket sizes per spawn level, as multiples of the primary batch.

    The fractions follow measured worst-case spawn fractions on the
    glass-scene family (up to ~2.0x the primary batch by depth 5). The
    overflow flag + caller fallback guarantees correctness regardless."""
    out = []
    for lvl in range(depth):
        b = int(np.ceil(n0 * min(2.4, 1.4 + 0.25 * lvl) / 256.0)) * 256
        out.append(max(256, b))
    return out
