"""The PyTorch port's mesh slice against the JAX package on the CPU.

The same inputs, made with numpy from fixed seeds, go through both:
- compile_scene on an OBJ torus of 3,072 smooth triangles plus per-row
  triangles: every table and the SceneMeta equal, in float64;
- the port's plain mesh queries (ops/mesh.py), which the CUDA kernels are
  held to bit for bit on the card, against the JAX package's jnp fold in
  float64 (t to 1e-12, ranks exact, triangle indices equal except where
  two triangles tie on t) and against its Pallas kernels in interpret
  mode, resident and streaming, in float32 (rtol 1e-6, the two sides
  round the same operations in another order);
- the refraction containers fold in float64 to 1e-12;
- dense (unclustered) triangle slots, triangle uv and smooth normals;
- the C++ OBJ scan and divide walk against their Python references, bit
  for bit;
- the 64x32 depth-5 mesh_torus canvas, opaque and glass, in float64 to
  1e-9 (the frameworks round a pow or a sqrt one ulp apart).
"""

import copy
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import intersect as jint
from fast_ray_tracer_tpu.ops import mesh_pallas as jmp
from fast_ray_tracer_tpu.ops import patterns as jpat
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.render import normals as jnorm
from fast_ray_tracer_tpu.render import render as jrender
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
from fast_ray_tracer_tpu.scene.ir import SceneIR as JSceneIR
from fast_ray_tracer_tpu.scene.ir import SceneMeta as JSceneMeta

from fast_ray_tracer_tpu_torch import native
from fast_ray_tracer_tpu_torch.ops import intersect as tint
from fast_ray_tracer_tpu_torch.ops import mesh as tmesh
from fast_ray_tracer_tpu_torch.ops import patterns as tpat
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import normals as tnorm
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import divide as tdiv
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene import obj_loader as tobj
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, SceneMeta
from fast_ray_tracer_tpu_torch.scene.ir import scene_ir_from_numpy

from scene_convert import convert, jax_tables

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEGMENTS = (48, 32)          # 3,072 triangles: the smallest meshes cluster


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _mesh_scene(obj_path):
    """The OBJ torus under a transform and a YAML material, a flat and a
    smooth per-row triangle, a sphere and a plane."""
    m = tmodel
    tri_mat = m.MaterialDesc(color=(0.2, 0.7, 0.3), reflective=0.2)
    world = [
        m.ShapeDesc(kind="plane", material=m.MaterialDesc(reflective=0.3)),
        m.ShapeDesc(kind="sphere", transform=[["translate", 2.2, 1.0, 0.5]],
                    material=m.MaterialDesc(transparency=0.8,
                                            refractive_index=1.3)),
        m.ShapeDesc(kind="obj", file=str(obj_path),
                    transform=[["rotate-x", 1.1], ["translate", 0, 1.2, 0]],
                    material=m.MaterialDesc(color=(0.8, 0.4, 0.2),
                                            reflective=0.3)),
        m.ShapeDesc(kind="triangle", p1=(-3, 0.5, 1), p2=(-2, 2, 1),
                    p3=(-1, 0.5, 1.5), material=tri_mat),
        m.ShapeDesc(kind="group", transform=[["scale", 1, 1.5, 1]],
                    children=[m.ShapeDesc(
                        kind="smooth_triangle", p1=(1, 0.2, 2),
                        p2=(2, 1.5, 2), p3=(3, 0.2, 2.5), n1=(0, 0, -1),
                        n2=(0.3, 0.2, -1), n3=(-0.2, 0.1, -1))]),
    ]
    return m.SceneDesc(
        camera=m.CameraDesc(width=32, height=16, field_of_view=1.0,
                            frm=(0, 2.5, -6), to=(0, 1, 0)),
        lights=[m.LightDesc(kind="point", at=(-4, 6, -5))],
        world=world, config=m.ConfigDesc(divide_threshold=1))


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    return tdemo.write_torus_obj(
        tmp_path_factory.mktemp("obj") / "torus.obj", *SEGMENTS)


@pytest.fixture(scope="module")
def mesh_pair(obj_path):
    """The mesh scene compiled by both packages in f64."""
    tsc = _mesh_scene(obj_path)
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    return jir, tir


def _rays(seed, n, dead=5):
    """Rays from around the scene toward the mesh, plus dead lanes parked
    where the wavefront parks them (float64 numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-5, -1, -6], [5, 5, 6], (n, 3))
    d = rng.uniform([-1.2, 0.3, -1.2], [1.2, 2.0, 1.2], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[n - dead:] = 1e30
    d[n - dead:] = 1.0
    return o, d


def _packed(tir, shadow=None, ni=None):
    na = tir.meta.n_analytic
    tri_mat = tir.tri_material_id
    return tmesh.pack(
        tir, tri_rank=tir.prim_shadow_rank[na:],
        tri_shadow=(tir.mat_casts_shadow[tri_mat] if shadow is None
                    else _t(shadow)),
        tri_ni=None if ni is None else _t(ni))


def _same_index_or_tie(idx_got, idx_want, t_got, t_want, atol):
    """Indices equal, except where the two winners tie on t."""
    diff = np.asarray(idx_got) != np.asarray(idx_want)
    np.testing.assert_allclose(np.asarray(t_got)[diff],
                               np.asarray(t_want)[diff], rtol=0, atol=atol)
    assert diff.mean() < 0.01


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

def test_compile_mesh_tables_match(mesh_pair):
    """Every table equal and SceneMeta field for field: clusters, padding,
    Morton order, ranks, smooth and flat normals."""
    jir, tir = mesh_pair
    assert tir.meta.use_clusters and tir.meta.n_triangles == 3136
    assert tir.meta.n_clusters == 49            # odd: a padded supercluster
    assert dataclasses.asdict(tir.meta) == dataclasses.asdict(jir.meta)
    ref = scene_ir_from_numpy(jax_tables(jir), tir.meta, "cpu", torch.float64)
    for field in SceneIR.table_names():
        a, b = getattr(tir, field), getattr(ref, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


# ---------------------------------------------------------------------------
# the plain mesh queries against the jnp fold (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_keep", [False, True])
def test_closest_matches_jnp_fold(mesh_pair, monkeypatch, with_keep):
    monkeypatch.setenv("FRT_MESH_PALLAS", "0")
    jir, tir = mesh_pair
    o, d = _rays(1, 600)
    nt = tir.meta.n_triangles
    keep = np.random.default_rng(2).random(nt) < 0.6 if with_keep else None
    jt, ji = jax.jit(lambda a, b, k: jint.mesh_closest(jir, a, b, keep=k))(
        jnp.asarray(o), jnp.asarray(d),
        None if keep is None else jnp.asarray(keep))
    kp = None if keep is None else tmesh.pack_plane(_t(keep), False)
    tt, ti = tmesh.closest_plain(_packed(tir), _t(o), _t(d), kp)
    jt, ji = np.asarray(jt), np.asarray(ji)
    hit = np.isfinite(jt)
    assert hit.sum() > 150
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=0, atol=1e-12)
    _same_index_or_tie(ti.numpy(), ji, tt.numpy(), jt, 1e-12)
    assert ti.dtype == torch.int32 and (ti.numpy()[~hit] == 0).all()
    if keep is not None:
        assert keep[ti.numpy()[hit]].all()


def test_shadow_matches_jnp_fold(mesh_pair, monkeypatch):
    monkeypatch.setenv("FRT_MESH_PALLAS", "0")
    jir, tir = mesh_pair
    o, d = _rays(3, 600)
    na, nt = tir.meta.n_analytic, tir.meta.n_triangles
    shadow = np.random.default_rng(4).random(nt) < 0.7
    jr, jt = jax.jit(lambda *a: jint.mesh_shadow_reduce(jir, *a))(
        jir.prim_shadow_rank[na:], jnp.asarray(shadow), jnp.asarray(o),
        jnp.asarray(d))
    tr, tt = tmesh.shadow_plain(_packed(tir, shadow=shadow), _t(o), _t(d))
    jr, jt = np.asarray(jr), np.asarray(jt)
    assert (jr < 2**31 - 1).sum() > 150
    assert tr.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), jr)
    fin = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), fin)
    np.testing.assert_allclose(tt.numpy()[fin], jt[fin], rtol=0, atol=1e-12)


def test_containers_matches_jax(mesh_pair, monkeypatch):
    """The mesh's share of the containers walk, with a per-triangle Ni, on
    hits from the mesh, misses, and hits elsewhere (hit_tri = -1). Each
    side takes the mesh hits of its own closest query, as the integrator
    does: the hit triangle's own entry must compare equal to t_hit."""
    monkeypatch.setenv("FRT_MESH_PALLAS", "0")
    jir, tir = mesh_pair
    o, d = _rays(5, 400)
    nt = tir.meta.n_triangles
    rng = np.random.default_rng(6)
    ni = rng.uniform(1.0, 2.0, nt)
    other = rng.random(len(o)) < 0.2             # an analytic hit instead
    other[-5:] = False                           # not on the dead lanes
    t_other = rng.uniform(0.5, 9.0, other.sum())
    m = _packed(tir, ni=ni)

    def walk_inputs(t_m, i_m):
        hit = np.isfinite(t_m)
        t_hit = np.where(hit, t_m, -np.inf)
        t_hit[other] = t_other
        return t_hit, np.where(hit & ~other, i_m, -1)

    jt_hit, jhit_tri = walk_inputs(*(np.asarray(x) for x in jax.jit(
        lambda a, b: jint.mesh_closest(jir, a, b))(jnp.asarray(o),
                                                   jnp.asarray(d))))
    want = jax.jit(lambda *a: jint.mesh_containers(jir, *a))(
        jnp.asarray(ni), jnp.asarray(o), jnp.asarray(d), jnp.asarray(jt_hit),
        jnp.asarray(jhit_tri))
    tt_hit, thit_tri = walk_inputs(*(x.numpy() for x in tmesh.closest_plain(
        m, _t(o), _t(d))))
    got = tmesh.containers(m, _t(o), _t(d), _t(tt_hit),
                           _t(thit_tri.astype(np.int64)))
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        if k % 2 == 0:                           # latest included entry t
            assert fin.sum() > 20
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-12)
        else:                                     # its Ni
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the plain mesh queries against the Pallas kernels (interpret, float32)
# ---------------------------------------------------------------------------

C, NC = 64, 10                 # tests/test_mesh_pallas.py's soup
NT = NC * C


def _soup(seed=0):
    """tests/test_mesh_pallas.py's random clustered soup: 640 triangles in
    10 spatially coherent clusters (5 superclusters), for both packages."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (NC, 1, 3))
    base = centers + rng.normal(0, 0.4, (NC, C, 3))
    p1 = base.reshape(NT, 3).astype(np.float32)
    e1 = rng.normal(0, 0.5, (NT, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (NT, 3)).astype(np.float32)
    v = np.stack([p1, p1 + e1, p1 + e2], 1)
    cmin = v.reshape(NC, C * 3, 3).min(1)
    cmax = v.reshape(NC, C * 3, 3).max(1)
    kw = dict(n_triangles=NT, use_clusters=True, n_clusters=NC,
              cluster_size=C)
    arrays = dict(tri_p1=p1, tri_e1=e1, tri_e2=e2, cluster_min=cmin,
                  cluster_max=cmax)
    jir = JSceneIR(meta=JSceneMeta(**kw),
                   **{k: jnp.asarray(a) for k, a in arrays.items()})
    tir = SceneIR(meta=SceneMeta(**kw),
                  **{k: torch.from_numpy(a) for k, a in arrays.items()})
    return jir, tir


def _soup_rays(seed=1, n=97):
    """Random rays aimed at the soup + a few parked dead lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[-3:] = 1e30
    d[-3:] = 1.0
    return o, d.astype(np.float32)


@pytest.mark.parametrize("vmem", ["resident", "streaming"])
def test_queries_match_pallas_interpret(monkeypatch, vmem):
    """closest (with and without keep) and shadow against the four Pallas
    kernel bodies in interpret mode; `streaming` shrinks the VMEM budget
    so the DMA-ring kernels run, as tests/test_mesh_pallas.py does."""
    monkeypatch.setenv("FRT_MESH_PALLAS", "interpret")
    if vmem == "streaming":
        monkeypatch.setenv("FRT_MESH_PALLAS_VMEM", "1024")
    rng = np.random.default_rng(9)
    rank = np.repeat(rng.permutation(NC * 2) * 100, C // 2).astype(np.int32)
    cast = rng.random(NT) < 0.7
    keep = np.random.default_rng(5).random(NT) < 0.5
    for seed, with_keep in ((0, False), (3, True)):
        jir, tir = _soup(seed)
        assert jmp._resident_fits(jir, 1) == (vmem == "resident")
        o, d = _soup_rays(seed + 1)
        jt, ji = (np.asarray(x) for x in jax.jit(
            lambda a, b, k: jmp.closest(jir, a, b, keep=k))(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(keep) if with_keep else None))
        m = tmesh.pack(tir, _t(rank), _t(cast))
        tt, ti = tmesh.closest(m, _t(o), _t(d),
                               keep=_t(keep) if with_keep else None)
        tt, ti = tt.numpy(), ti.numpy()
        hit = np.isfinite(jt)
        assert hit.sum() > 20
        np.testing.assert_array_equal(np.isfinite(tt), hit)
        np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6)
        diff = hit & (ti != ji)
        np.testing.assert_allclose(tt[diff], jt[diff], rtol=1e-6)
        if with_keep:
            assert keep[ti[hit]].all()
    jir, tir = _soup(7)
    o, d = _soup_rays(8)
    jr, jt = (np.asarray(x) for x in jax.jit(
        lambda *a: jmp.shadow(jir, *a))(
        jnp.asarray(rank), jnp.asarray(cast), jnp.asarray(o), jnp.asarray(d)))
    tr, tt = tmesh.shadow(tmesh.pack(tir, _t(rank), _t(cast)), _t(o), _t(d))
    np.testing.assert_array_equal(tr.numpy(), jr)
    fin = np.isfinite(jt)
    assert fin.sum() > 10
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), fin)
    np.testing.assert_allclose(tt.numpy()[fin], jt[fin], rtol=1e-6)


# ---------------------------------------------------------------------------
# the closest kernel's cull: group and root boxes (ops/mesh.group_boxes)
# ---------------------------------------------------------------------------

def _group_soup(n_sc=37, seed=11):
    """A float32 clustered soup of n_sc superclusters (two groups at 37:
    32 members and 5), as the port's tables only."""
    nc = 2 * n_sc
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (nc, 1, 3))
    p1 = (centers + rng.normal(0, 0.5, (nc, C, 3))).reshape(-1, 3)
    e1 = rng.normal(0, 0.4, p1.shape)
    e2 = rng.normal(0, 0.4, p1.shape)
    v = np.stack([p1, p1 + e1, p1 + e2], 1).reshape(nc, C * 3, 3)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    tir = SceneIR(meta=SceneMeta(n_triangles=nc * C, use_clusters=True,
                                 n_clusters=nc, cluster_size=C),
                  tri_p1=f(p1), tri_e1=f(e1), tri_e2=f(e2),
                  cluster_min=f(v.min(1)), cluster_max=f(v.max(1)))
    nt = nc * C
    return tmesh.pack(tir, torch.zeros(nt, dtype=torch.int32),
                      torch.ones(nt, dtype=torch.bool))


def _cull_case(which, mesh_pair):
    """(packed tables, origins, directions): the mesh scene's tables in
    float64 with its rays, or the soup in float32 with rays aimed at it;
    both end in dead lanes parked at FILL_ROW."""
    if which == "mesh_torus":
        o, d = _rays(12, 800)
        return _packed(mesh_pair[1]), _t(o), _t(d)
    o, d = _soup_rays(13, 600)
    return _group_soup(), _t(o * np.float32(1.5)), _t(d)


@pytest.mark.parametrize("which", ["mesh_torus", "soup"])
def test_group_boxes_are_exact_bounds(mesh_pair, which):
    """Each group box is the exact min / max of its members' boxes (the
    last group holds only the superclusters that exist), and the root box
    the exact min / max of them all."""
    m, _, _ = _cull_case(which, mesh_pair)
    nsc = m.box_min.shape[0]
    ng = -(-nsc // tmesh.GROUP)
    assert m.group_min.shape == m.group_max.shape == (ng, 3)
    assert m.root_min.shape == m.root_max.shape == (1, 3)
    for g in range(ng):
        members = slice(g * tmesh.GROUP, min(nsc, (g + 1) * tmesh.GROUP))
        assert torch.equal(m.group_min[g], m.box_min[members].amin(0))
        assert torch.equal(m.group_max[g], m.box_max[members].amax(0))
    assert torch.equal(m.root_min[0], m.box_min.amin(0))
    assert torch.equal(m.root_max[0], m.box_max.amax(0))
    assert all(x.dtype == m.box_min.dtype and x.is_contiguous()
               for x in (m.group_min, m.group_max, m.root_min, m.root_max))


@pytest.mark.parametrize("which", ["mesh_torus", "soup"])
def test_group_cull_keeps_every_passing_pair(mesh_pair, which):
    """The exactness of the cull: every (ray, supercluster) pair that
    passes cluster_mask also passes the slab test of its group box and of
    the root box, in the same arithmetic; dead lanes fail the root box."""
    m, o, d = _cull_case(which, mesh_pair)
    sc = tmesh.cluster_mask(m.box_min, m.box_max, o, d)
    grp = tmesh.cluster_mask(m.group_min, m.group_max, o, d)
    root = tmesh.cluster_mask(m.root_min, m.root_max, o, d)[:, 0]
    s = torch.arange(sc.shape[1])
    assert int(sc.sum()) > 100
    assert not bool((sc & ~grp[:, s // tmesh.GROUP]).any())
    assert not bool((sc.any(1) & ~root).any())
    assert not bool(root[o[:, 0] >= 1e29].any())


def _tree_walk_pairs(m, o, d):
    """The (ray, supercluster) pairs the closest kernel evaluates: root
    box, then group boxes, then each group's members by count."""
    nsc = m.box_min.shape[0]
    root = tmesh.cluster_mask(m.root_min, m.root_max, o, d)[:, 0]
    grp = tmesh.cluster_mask(m.group_min, m.group_max, o, d)
    sc = tmesh.cluster_mask(m.box_min, m.box_max, o, d)
    pairs = set()
    for g in range(grp.shape[1]):
        for s in range(g * tmesh.GROUP, min(nsc, (g + 1) * tmesh.GROUP)):
            live = root & grp[:, g] & sc[:, s]
            pairs.update((int(r), s) for r in live.nonzero()[:, 0])
    return pairs


@pytest.mark.parametrize("which", ["mesh_torus", "soup"])
def test_padded_groups_never_taken(mesh_pair, which):
    """The walk over groups takes exactly the pairs cluster_mask passes:
    no supercluster past the last one (a group's tail is not padded with
    boxes, and an inverted box would pass the slab test) and none lost."""
    m, o, d = _cull_case(which, mesh_pair)
    walked = _tree_walk_pairs(m, o, d)
    sc = tmesh.cluster_mask(m.box_min, m.box_max, o, d)
    want = {(int(r), int(s)) for r, s in sc.nonzero()}
    assert walked == want
    assert max(s for _, s in walked) < m.box_min.shape[0]
    # why not: the empty-box sentinel of a padded slot (min _BIG, max
    # -_BIG) passes the slab test of every live ray
    big = torch.full((1, 3), tmesh._BIG, dtype=o.dtype)
    live = o[:, 0] < 1e29
    assert bool(tmesh.cluster_mask(big, -big, o[live], d[live]).all())


def test_no_fallback_off_cpu():
    """Only a CPU tensor takes a plain version: any other device launches
    the kernel or raises."""
    _, tir = _soup()
    m = tmesh.MeshTables(*(x.to("meta") for x in tmesh.pack(
        tir, torch.zeros(NT, dtype=torch.int32),
        torch.ones(NT, dtype=torch.bool))[:5]), None)
    rays = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tmesh.closest(m, rays, rays)
    with pytest.raises(ValueError):
        tmesh.shadow(m, rays, rays)


# ---------------------------------------------------------------------------
# dense triangles, uv and normals
# ---------------------------------------------------------------------------

def test_dense_triangle_candidates(tmp_path):
    """Under 2,048 triangles the mesh takes one candidate slot per
    triangle: candidates, closest hit, containers walk and shadow test."""
    path = tdemo.write_torus_obj(tmp_path / "small.obj", 16, 12)
    tsc = _mesh_scene(path)
    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    assert not tir.meta.use_clusters and tir.meta.n_triangles == 386
    jrt = jintg.build_statics(jir, jsc.config)
    trt = tintg.build_statics(tir, tsc.config)
    np.testing.assert_array_equal(trt.slot_prim.numpy(), jrt.slot_prim)
    # no dead lanes: their line runs through the scene from 1e30, and the
    # u, v sums cancel to noise that the two summation orders round apart
    o, d = _rays(7, 500, dead=0)
    dist = np.random.default_rng(8).uniform(0.1, 8.0, len(o))

    @jax.jit
    def jax_side(o, d, dist):
        t = jint.intersect_candidates(jir, o, d)
        h = jint.closest_hit(t, jrt.slot_prim)
        n1, n2 = jint.containers_n1_n2(jir.meta, t, h.t, jrt.prim_ni)
        shadowed = jint.shadow_hit_early_exit(t, jrt.slot_rank,
                                              jrt.slot_shadow, dist)
        return t, h.t, h.prim, n1, n2, shadowed

    jt, jht, jprim, j1, j2, js = (np.asarray(x) for x in jax_side(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist)))
    tt = tint.intersect_candidates(tir, _t(o), _t(d)).numpy()
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=1e-12)
    # the reductions on the JAX candidates, so a one-ulp t difference
    # cannot flip a discrete decision
    th = tint.closest_hit(_t(jt), trt.slot_prim)
    np.testing.assert_array_equal(th.prim.numpy(), jprim)
    assert (jprim >= tir.meta.n_analytic).sum() > 50
    t1, t2 = tint.containers_n1_n2(tir.meta, _t(jt), _t(jht), trt.prim_ni)
    np.testing.assert_array_equal(t1.numpy(), j1)
    np.testing.assert_array_equal(t2.numpy(), j2)
    ts = tint.shadow_hit_early_exit(_t(jt), trt.slot_rank, trt.slot_shadow,
                                    _t(dist))
    np.testing.assert_array_equal(ts.numpy(), js)


def test_triangle_uv_ctx_and_normals(mesh_pair):
    """triangle_uv_at, the ShapeCtx of mixed analytic / triangle hits, and
    the smooth-normal interpolation."""
    jir, tir = mesh_pair
    na, nt = tir.meta.n_analytic, tir.meta.n_triangles
    rng = np.random.default_rng(10)
    n = 2048
    prim = np.where(rng.random(n) < 0.8, na + rng.integers(0, nt - 70, n),
                    rng.integers(0, na, n))
    o, d = _rays(11, n, dead=0)
    t_idx = np.clip(prim - na, 0, None)
    ju, jv = (np.asarray(x) for x in jax.jit(
        lambda *a: jint.triangle_uv_at(jir, *a))(
        jnp.asarray(t_idx), jnp.asarray(o), jnp.asarray(d)))
    tu, tv = tint.triangle_uv_at(tir, _t(t_idx), _t(o), _t(d))
    ok = np.abs(ju) < 1e6                        # away from det ~ 0
    for g, w in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(g.numpy()[ok], w[ok], rtol=1e-12,
                                   atol=1e-12)
    # barycentrics inside the triangle, points anywhere
    u = rng.random(n) * 0.6
    v = rng.random(n) * 0.4
    pts = rng.uniform(-3, 3, (n, 3))

    @jax.jit
    def jax_side(prim, pts, u, v):
        ctx = jpat.build_shape_ctx(jir, prim)
        return ctx, jnorm.normal_at(jir, ctx, prim, pts, u, v)

    jctx, want = jax_side(jnp.asarray(prim, jnp.int32), jnp.asarray(pts),
                          jnp.asarray(u), jnp.asarray(v))
    tctx = tpat.build_shape_ctx(tir, _t(prim))
    np.testing.assert_array_equal(tctx.shape_type.numpy(),
                                  np.asarray(jctx.shape_type))
    for field in ("obj_inv", "params", "tri_p1", "tri_e1", "tri_e2",
                  "tri_t1", "tri_t2", "tri_t3", "tri_use_tex"):
        np.testing.assert_array_equal(getattr(tctx, field).numpy(),
                                      np.asarray(getattr(jctx, field)))
    got = tnorm.normal_at(tir, tctx, _t(prim), _t(pts), _t(u), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# host C++ against the Python references
# ---------------------------------------------------------------------------

OBJ_TEXT = """# groups, materials, texture coordinates, fans, short faces
mtllib none.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0 0.5
vt 1 1
vn 0 0 1
vn 0 1 0
f 1 2 3
g first
usemtl red
f 1/1 2/2 3/3 4/1
f 1//1 2//2 5//1
g second
f 2/1/1 3/2/2 5/3/1
f 4 5
g first
usemtl blue
f 5 1 2 3 4
"""


def test_native_obj_scan_matches_python(tmp_path, obj_path):
    hand = tmp_path / "hand.obj"
    hand.write_text(OBJ_TEXT)
    for path in (str(hand), str(obj_path)):
        g = native.parse_obj(path)
        p = tobj._scan_obj_python(path)
        for k in ("v", "vt", "vn", "tri", "use_n", "use_t", "group",
                  "event"):
            np.testing.assert_array_equal(getattr(g, k), getattr(p, k),
                                          err_msg=k)
        assert g.group_names == p.group_names
        assert g.events == p.events


def _divide_tree(scene):
    tables = tcomp._Tables(lambda c: np.asarray(c, np.float64),
                           scene.root_dir)
    root = tdiv.Node(kind="group", transform=list(tdiv.IDENTITY))
    for shape in scene.world:
        tcomp._walk(shape, np.eye(4), tables, None, root.children)
    return root, tables.next_leaf


def _random_tree(rng, n_leaves=200):
    """tests/test_native.py's random tree, without the CSG node: random
    transforms and a nested group."""
    leaves = []
    for i in range(n_leaves):
        t = list(tdiv.IDENTITY)
        t[3], t[7], t[11] = (float(x) for x in rng.uniform(-10, 10, 3))
        t[0] = t[5] = t[10] = float(rng.uniform(0.1, 2.0))
        kind = ["sphere", "cube", "cylinder"][i % 3]
        leaves.append(tdiv.Node(
            kind=kind, transform=t, leaf_id=i,
            obj_box=tdiv.leaf_box(kind, minimum=-1.0, maximum=1.0)))
    g1 = tdiv.Node(kind="group", transform=list(tdiv.IDENTITY),
                   children=leaves[: n_leaves // 3])
    return tdiv.Node(kind="group", transform=list(tdiv.IDENTITY),
                     children=[g1] + leaves[n_leaves // 3:]), n_leaves


@pytest.mark.parametrize("threshold", [1, 4])
def test_native_divide_matches_python(obj_path, threshold):
    """The C++ divide walk gives the Python walk's ranks on the mesh scene
    (a leafblock of 3,072 triangles beside per-row leaves) and on a random
    tree of transformed primitives."""
    for root, n in (_divide_tree(_mesh_scene(obj_path)),
                    _random_tree(np.random.default_rng(threshold))):
        want = tdiv.shadow_ranks_python(copy.deepcopy(root), threshold, n)
        assert tdiv.shadow_ranks(root, threshold, n) == want


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("glass", [False, True])
def test_mesh_torus_render_matches_jax(glass, tmp_path, monkeypatch):
    """64x32 depth 5, f64, two chunks: the mesh_torus canvases agree to
    1e-9 (glass runs the containers walk over the mesh)."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    tsc = tdemo.mesh_torus(64, 32, glass=glass, segments=SEGMENTS)
    want = jrender.render_scene(convert(tsc, jmodel), dtype=jnp.float64,
                                chunk_pixels=1024)
    stats = {}
    got = trender.render_scene(tsc, dtype=torch.float64, chunk_pixels=1024,
                               device="cpu", stats=stats)
    assert stats["escalations"] == 0 and stats["exact_chunks"] == 0
    assert got.shape == (32, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_bucketed_matches_unrolled_on_mesh():
    """The bucketed wavefront equals the unrolled trace bit for bit on the
    glass torus: the per-ray cull does not depend on the batch."""
    sc = tdemo.mesh_torus(32, 16, glass=True, segments=SEGMENTS)
    ir = tcomp.compile_scene(sc, dtype=torch.float64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    cam = sc.camera
    crt = tcam.build_camera(cam, dtype=torch.float64, device="cpu")
    n = cam.width * cam.height
    o, d = tcam.rays_for_pixels(
        crt, torch.arange(cam.width).repeat(cam.height),
        torch.arange(cam.height).repeat_interleave(cam.width),
        torch.full((n, 2), 0.5, dtype=torch.float64),
        torch.zeros((n, 2), dtype=torch.float64))
    exact = tintg.trace(ir, rt, o, d, 5)
    counts = [int(c) for c in tintg.spawn_counts(ir, rt, o, d, 5)]
    buckets = [max(64, int(np.ceil(c * 1.25 / 64)) * 64) for c in counts]
    got, ovf = tintg.trace_bucketed(ir, rt, o, d, 5, buckets)
    assert not bool(ovf)
    for x, y in zip(exact, got):
        assert torch.equal(x, y)


def test_entry_points_default_to_cuda():
    """With no device given, the entry points go to the CUDA card: without
    one they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc = tdemo.glass_spheres(8, 4)
    for call in (lambda: tcomp.compile_scene(sc),
                 lambda: tcam.build_camera(sc.camera),
                 lambda: trender.render_scene(sc)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_mesh_modules_import_no_jax():
    """With jax and yaml unimportable, the port's mesh modules import and
    render a small torus on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import torch\n"
        "from fast_ray_tracer_tpu_torch import _build, native\n"
        "from fast_ray_tracer_tpu_torch.ops import mesh\n"
        "from fast_ray_tracer_tpu_torch.scene import obj_loader\n"
        "from fast_ray_tracer_tpu_torch.render.render import render_scene\n"
        "from fast_ray_tracer_tpu_torch.scene.demo import mesh_torus\n"
        "c = render_scene(mesh_torus(8, 4, segments=(48, 32)),"
        " dtype=torch.float32, device='cpu')\n"
        "assert c.shape == (4, 8, 3) and (c == c).all()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
