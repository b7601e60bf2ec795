"""The port's CSG against the JAX package on the CPU: the static filter
tables, the truth-table filter itself (with and without the shadow walk's
group truncation), the compiled tables of CSG scenes (the repo's
tools/golden_scenes/csg_test.yml, an OBJ mesh inside a CSG tree, and
scene/demo.primitives_showcase), the
C++ divide walk over a tree holding a CSG node, and csg_test.yml's
64x32 depth-5 canvas.

Tolerances: the tables are equal (byte for byte) and the filter is
bitwise equal, exact t ties included (both keep a stable (t, slot) order:
the JAX package by its pairwise predecessor count for trees of up to 16
slots and by argsort above, the port by one stable sort). The canvas
agrees to 1e-9 in float64: the frameworks round a pow or a sqrt one ulp
apart (the largest difference seen is 9.1e-15).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas as cp
from fast_ray_tracer_tpu.ops import intersect as jint
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
from fast_ray_tracer_tpu.scene.yaml_loader import load_scene

from fast_ray_tracer_tpu_torch.ops import intersect as tint
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import divide as tdiv
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR
from fast_ray_tracer_tpu_torch import native

from scene_convert import convert, ir_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSG_YML = ROOT / "tools" / "golden_scenes" / "csg_test.yml"

CUBE_OBJ = """# a unit cube of 12 triangles
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 3 2
f 1 4 3
f 5 6 7
f 5 7 8
f 1 2 6
f 1 6 5
f 4 8 7
f 4 7 3
f 1 5 8
f 1 8 4
f 2 3 7
f 2 7 6
"""


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _grouped_scene(m, obj_path=None):
    """CSG trees with groups inside (the shadow walk's truncation points),
    a tree of more than 16 leaf slots (the JAX package's argsort path), a
    nested tree, and optionally an OBJ mesh as a CSG child."""
    S = m.ShapeDesc
    mat = lambda c: m.MaterialDesc(color=c)
    spheres = [S(kind="sphere", material=mat((0.8, 0.2, 0.2)),
                 transform=[["scale", 0.3, 0.3, 0.3],
                            ["translate", 0.5 * (i % 3) - 0.5,
                             0.5 * (i // 3) - 0.5, 0.0]])
               for i in range(9)]
    world = [
        S(kind="plane", material=mat((0.7, 0.7, 0.7))),
        # union(group of 9 spheres, cube): 20 slots
        S(kind="csg", op="union", transform=[["translate", -2, 1, 0]],
          left=S(kind="group", children=spheres),
          right=S(kind="cube", material=mat((0.2, 0.8, 0.2)),
                  transform=[["scale", 0.4, 0.4, 0.4]])),
        # difference(group(cylinder, cone), intersection(sphere, cube))
        S(kind="csg", op="difference", transform=[["translate", 1.5, 1, 0]],
          left=S(kind="group", children=[
              S(kind="cylinder", minimum=-1, maximum=1, closed=True,
                material=mat((0.2, 0.2, 0.9))),
              S(kind="cone", minimum=-1.5, maximum=0, closed=True,
                transform=[["translate", 0, 1.2, 0]])]),
          right=S(kind="csg", op="intersection", left=S(kind="sphere"),
                  right=S(kind="cube", transform=[
                      ["scale", 0.8, 0.8, 0.8], ["translate", 0, 0.5, -0.7]]))),
        S(kind="toroid", transform=[["translate", 0, 2.5, 1]]),
    ]
    if obj_path is not None:
        world.append(S(kind="csg", op="difference",
                       transform=[["translate", 0, 1, -2]],
                       left=S(kind="obj", file=str(obj_path),
                              material=mat((0.9, 0.9, 0.2))),
                       right=S(kind="sphere", transform=[
                           ["scale", 1.2, 1.2, 1.2]])))
    return m.SceneDesc(
        camera=m.CameraDesc(width=16, height=8, field_of_view=1.0,
                            frm=(0, 2, -6), to=(0, 1, 0)),
        lights=[m.LightDesc(kind="point", at=(-5, 6, -5))],
        world=world, config=m.ConfigDesc(divide_threshold=1),
        root_dir=str(obj_path.parent) if obj_path is not None else ".")


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("csg") / "cube.obj"
    path.write_text(CUBE_OBJ)
    return path


def _scenes(obj_path):
    return {"csg_test": convert(load_scene(str(CSG_YML)), tmodel),
            "grouped": _grouped_scene(tmodel),
            "obj_in_csg": _grouped_scene(tmodel, obj_path),
            "showcase": tdemo.primitives_showcase(64, 32)}


@pytest.mark.parametrize("name", ["csg_test", "grouped", "obj_in_csg",
                                  "showcase"])
def test_compile_scene_tables_match(name, obj_path):
    """The port's compile_scene builds the JAX package's tables (every
    table equal) and SceneMeta (csg programs and tags) field for field."""
    tsc = _scenes(obj_path)[name]
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    assert tir.meta.has_csg and not tir.meta.use_clusters
    ref = ir_from_jax(jir, "cpu", torch.float64)
    assert tir.meta == ref.meta
    for field in SceneIR.table_names():
        a, b = getattr(tir, field), getattr(ref, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _tables_pair(tsc):
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    jrt = jintg.build_statics(jir, tsc.config)
    trt = tintg.build_statics(tir, tsc.config)
    return jir, jrt, tir, trt


def test_csg_static_tables_match(obj_path):
    sizes, groups = [], 0
    for tsc in _scenes(obj_path).values():
        jir, jrt, tir, trt = _tables_pair(tsc)
        m = tir.meta
        want = jint.csg_static_tables(jir.meta, jrt.slot_prim,
                                      m.csg_prim_leaf, m.csg_prim_anc,
                                      m.csg_prim_side)
        got = tint.csg_static_tables(m, trt.slot_prim.numpy(),
                                     m.csg_prim_leaf, m.csg_prim_anc,
                                     m.csg_prim_side)
        assert len(got) == len(want)
        for (gs, gp), (ws, wp) in zip(got, want):
            np.testing.assert_array_equal(gs, ws)
            assert len(gp) == len(wp)
            for ge, we in zip(gp, wp):
                assert ge[0] == we[0] and len(ge) == len(we)
                for a, b in zip(ge[1:], we[1:]):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
                groups += ge[0] == "g"
        sizes += [len(s) for s, _ in got]
    # both of the JAX package's filter paths, and shadow truncation points
    assert max(sizes) > 16 and min(sizes) <= 16 and groups > 0


def _candidates(rng, n, h):
    """Candidate t rows: misses (+inf), negative t, and values drawn from
    a small set so that exact ties within a tree are common."""
    t = rng.choice([-1.5, -0.25, 0.5, 1.0, 1.25, 2.0, 3.5], (n, h))
    t = t + np.where(rng.random((n, h)) < 0.4, rng.uniform(0, 2, (n, h)), 0)
    return np.where(rng.random((n, h)) < 0.25, np.inf, t)


@pytest.mark.parametrize("shadow", [False, True])
def test_apply_csg_filter_bitwise(obj_path, shadow):
    rng = np.random.default_rng(int(shadow))
    for tsc in _scenes(obj_path).values():
        jir, jrt, tir, trt = _tables_pair(tsc)
        t = _candidates(rng, 4000, trt.slot_prim.shape[0])
        want = np.asarray(jint.apply_csg_filter(jnp.asarray(t),
                                                jrt.csg_tables,
                                                shadow=shadow))
        got = tint.apply_csg_filter(_t(t), trt.csg_tables, shadow=shadow)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (np.isinf(want) & np.isfinite(t)).any()


def test_native_divide_with_csg_matches_python():
    """The C++ divide walk serialises CSG nodes: the same ranks as the
    Python walk on a random tree holding a CSG subtree."""
    rng = np.random.default_rng(7)
    leaves = []
    for i in range(60):
        tf = list(tdiv.IDENTITY)
        tf[3], tf[7], tf[11] = (float(x) for x in rng.uniform(-10, 10, 3))
        kind = ["sphere", "cube", "cylinder"][i % 3]
        leaves.append(tdiv.Node(kind=kind, transform=tf, leaf_id=i,
                                obj_box=tdiv.leaf_box(kind, minimum=-1.0,
                                                      maximum=1.0)))
    csg = tdiv.Node(kind="csg", transform=list(tdiv.IDENTITY), leaf_id=60,
                    left=tdiv.Node(kind="group",
                                   transform=list(tdiv.IDENTITY),
                                   leaf_id=60, children=[
                                       tdiv.Node(kind="sphere",
                                                 transform=list(
                                                     tdiv.IDENTITY),
                                                 leaf_id=60,
                                                 obj_box=tdiv.leaf_box(
                                                     "sphere"))]),
                    right=tdiv.Node(kind="cube",
                                    transform=list(tdiv.IDENTITY),
                                    leaf_id=60,
                                    obj_box=tdiv.leaf_box("cube")))

    def tree():
        import copy
        return tdiv.Node(kind="group", transform=list(tdiv.IDENTITY),
                         children=copy.deepcopy(leaves[:30]) + [
                             copy.deepcopy(csg)] + copy.deepcopy(
                                 leaves[30:]))

    for threshold in (1, 4):
        assert native.shadow_ranks(tree(), threshold, 61) == \
            tdiv.shadow_ranks_python(tree(), threshold, 61)


def test_csg_scene_canvas_matches_jax():
    """tools/golden_scenes/csg_test.yml at 64x32, depth 5, float64: the
    port's trace_bucketed canvas against the JAX package's (its XLA
    nonzero/gather branch), with equal per-level spawn counts; the
    shadow rays go through the filter's group truncation."""
    W, H = 64, 32
    n = W * H
    jsc = load_scene(str(CSG_YML))
    jsc.camera.width, jsc.camera.height = W, H
    depth = jsc.config.di_path_length
    assert depth == 5
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    cam = jcam.build_camera(jsc.camera, dtype=jnp.float64)
    buckets = jintg.default_buckets(n, depth)

    @jax.jit
    def jax_side(px, py):
        uv = jnp.broadcast_to(jnp.asarray(cmj_points_static(1, 1)), (n, 2))
        o, d = jcam.rays_for_pixels(cam, px, py, uv, jnp.zeros((n, 2)))
        counts = jintg.spawn_counts(jir, jrt, o, d, depth, None)
        tr, ovf = jintg.trace_bucketed(jir, jrt, o, d, depth, None, buckets)
        return counts, (tr.a + tr.d + tr.s) / 3.0, ovf

    px = np.tile(np.arange(W), H)
    py = np.repeat(np.arange(H), W)
    with cp.override_mode("off"):
        j_counts, j_img, j_ovf = jax_side(jnp.asarray(px), jnp.asarray(py))
    assert not bool(j_ovf)

    tsc = convert(jsc, tmodel)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    tc = tcam.build_camera(tsc.camera, dtype=torch.float64, device="cpu")
    o, d = tcam.rays_for_pixels(
        tc, _t(px), _t(py),
        torch.as_tensor(cmj_points_static(1, 1)).expand(n, 2),
        torch.zeros((n, 2), dtype=torch.float64))
    t_counts = [int(c) for c in tintg.spawn_counts(tir, trt, o, d, depth)]
    tr, ovf = tintg.trace_bucketed(tir, trt, o, d, depth, buckets)
    assert not bool(ovf)
    assert t_counts == [int(c) for c in j_counts]
    got = ((tr.a + tr.d + tr.s) / 3.0).numpy()
    np.testing.assert_allclose(got, np.asarray(j_img), rtol=0, atol=1e-9)
    assert got.std() > 0.01
