"""Module-by-module parity of the PyTorch port (fast_ray_tracer_tpu_torch)
with the JAX package, in float64 on the CPU: the same inputs, made with
numpy from a fixed seed, go through both, and the outputs agree to 1e-12
(the two frameworks may round a sum or a sqrt one ulp apart; tables and
integer results are compared exactly)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.io import ppm as jppm
from fast_ray_tracer_tpu.ops import intersect as jint
from fast_ray_tracer_tpu.ops import patterns as jpat
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.render import normals as jnorm
from fast_ray_tracer_tpu.sampling import cmj as jcmj
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import demo as jdemo
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.io import ppm as tppm
from fast_ray_tracer_tpu_torch.ops import intersect as tint
from fast_ray_tracer_tpu_torch.ops import patterns as tpat
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import normals as tnorm
from fast_ray_tracer_tpu_torch.sampling import cmj as tcmj
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, scene_ir_from_numpy

from scene_convert import jax_tables

torch.set_num_threads(1)

ATOL = 1e-12
W, H = 64, 32


def _nested_scene(model):
    """A scene that exercises group nesting, inherited and default
    materials, stripe and checker patterns on material map slots, an RGB
    color space and two point lights. (glass_spheres binds its patterns
    under the key "pattern", which is no material map slot, so neither
    package evaluates them there.)"""
    m = model
    stripe = m.PatternDesc(kind="stripe", colors=[(0.9, 0.1, 0.1),
                                                  (0.1, 0.2, 0.9)],
                           transform=[["scale", .2, .2, .2],
                                      ["rotate-z", 0.5]])
    checker = m.PatternDesc(kind="checker", colors=[(0.3, 0.3, 0.3),
                                                    (0.7, 0.7, 0.6)],
                            transform=[["rotate-y", 0.4]])
    red = m.MaterialDesc(color=(0.9, 0.2, 0.1), reflective=0.5,
                         patterns={"map_Kd": stripe})
    inner = m.ShapeDesc(kind="group", transform=[["translate", 1, 0, 0]],
                        children=[
                            m.ShapeDesc(kind="sphere", material=red,
                                        transform=[["scale", .5, .5, .5]]),
                            m.ShapeDesc(kind="sphere",
                                        transform=[["translate", 0, 1, 0]])])
    world = [m.ShapeDesc(kind="plane", material=m.MaterialDesc(
                 reflective=0.3, patterns={"map_Ka": checker,
                                           "map_Kd": checker})),
             m.ShapeDesc(kind="group", transform=[["rotate-y", 0.3]],
                         children=[inner]),
             m.ShapeDesc(kind="sphere", transform=[["translate", -2, 1, 1]],
                         material=m.MaterialDesc(transparency=0.8,
                                                 refractive_index=1.3))]
    return m.SceneDesc(
        camera=m.CameraDesc(width=W, height=H, field_of_view=1.0,
                            frm=(0.0, 1.5, -5.0), to=(0.0, 1.0, 0.0)),
        lights=[m.LightDesc(kind="point", at=(-4, 4, -4)),
                m.LightDesc(kind="point", at=(3, 5, -2),
                            intensity=(0.5, 0.4, 0.3))],
        world=world,
        config=m.ConfigDesc(color_space="RGB", divide_threshold=1))


SCENES = {
    "glass_spheres": lambda m: (jdemo if m is jmodel else tdemo)
    .glass_spheres(W, H),
    "nested": _nested_scene,
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    """A scene compiled by both packages in f64, with their statics."""
    jsc = SCENES[request.param](jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    tsc = SCENES[request.param](tmodel)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    return jsc, jir, jrt, tsc, tir, trt


def _rays(seed=0, n=1536):
    """Rays from inside the room in random directions, plus the camera's
    primary rays (float64 numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.5, 0.1, -4.5], [4.5, 4.5, 4.5], (n, 3))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jsc = jdemo.glass_spheres(W, H)
    cam = jcam.build_camera(jsc.camera, dtype=jnp.float64)
    px = np.tile(np.arange(W), H)
    py = np.repeat(np.arange(H), W)
    uv = np.full((W * H, 2), 0.5)
    po, pd = jcam.rays_for_pixels(cam, jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(uv), jnp.zeros((W * H, 2)))
    return (np.concatenate([o, np.asarray(po)]),
            np.concatenate([d, np.asarray(pd)]))


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_tables_match(name):
    """The port's compile_scene builds the JAX package's tables: every
    table equal, and SceneMeta field for field."""
    jsc = SCENES[name](jmodel)
    tsc = SCENES[name](tmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    assert dataclasses.asdict(tir.meta) == dataclasses.asdict(jir.meta)
    ref = scene_ir_from_numpy(jax_tables(jir), tir.meta, "cpu",
                              torch.float64)
    for field in SceneIR.table_names():
        a, b = getattr(tir, field), getattr(ref, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def test_scene_ir_to_casts_floats_only():
    tir = tcomp.compile_scene(tdemo.glass_spheres(8, 4), dtype=torch.float64,
                              device="cpu")
    f32 = tir.to("cpu", torch.float32)
    assert f32.inv_tf.dtype == torch.float32
    assert f32.material_id.dtype == torch.int64
    assert f32.mat_reflective.dtype == torch.bool


@pytest.mark.parametrize("usteps,vsteps", [(1, 1), (2, 3), (4, 4)])
def test_cmj_points_static(usteps, vsteps):
    np.testing.assert_array_equal(tcmj.cmj_points_static(usteps, vsteps),
                                  jcmj.cmj_points_static(usteps, vsteps))


def test_rays_for_pixels():
    rng = np.random.default_rng(1)
    n = 4096
    px, py = rng.integers(0, W, n), rng.integers(0, H, n)
    uv = rng.random((n, 2))
    jc = jcam.build_camera(jdemo.glass_spheres(W, H).camera,
                           dtype=jnp.float64)
    tc = tcam.build_camera(tdemo.glass_spheres(W, H).camera,
                           dtype=torch.float64, device="cpu")
    jo, jd = jcam.rays_for_pixels(jc, jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(uv), jnp.zeros((n, 2)))
    to, td = tcam.rays_for_pixels(tc, _t(px), _t(py), _t(uv),
                                  torch.zeros((n, 2), dtype=torch.float64))
    # both cameras come from the same numpy code, bit for bit; then the
    # same formula in numpy, so a failure names the side that moved
    inv = np.asarray(jc.inv)
    _close(tc.inv, inv, 0)
    pix = np.stack([jc.half_width - (px + uv[:, 0]) * jc.pixel_size,
                    jc.half_height - (py + uv[:, 1]) * jc.pixel_size,
                    np.full(n, -jc.canvas_distance)], -1)
    v = pix @ inv[:3, :3].T
    ref = v / np.linalg.norm(v, axis=-1, keepdims=True)
    _close(td, ref)
    _close(jd, ref)
    _close(to, jo)
    _close(td, jd)


def test_intersection(scene_pair):
    _, jir, jrt, _, tir, trt = scene_pair
    o, d = _rays()
    jt = jint.intersect_candidates(jir, jnp.asarray(o), jnp.asarray(d))
    tt = tint.intersect_candidates(tir, _t(o), _t(d))
    _close(tt, jt)
    jh = jint.closest_hit(jt, jrt.slot_prim)
    th = tint.closest_hit(tt, trt.slot_prim)
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    _close(th.t, jh.t)
    # the containers walk and the shadow test on the JAX candidates, so a
    # one-ulp t difference cannot flip a discrete decision
    j1, j2 = jint.containers_n1_n2(jir.meta, jt, jh.t, jrt.prim_ni)
    t1, t2 = tint.containers_n1_n2(tir.meta, _t(jt), _t(jh.t), trt.prim_ni)
    _close(t1, j1, 0)
    _close(t2, j2, 0)
    dist = np.random.default_rng(2).uniform(0.1, 8.0, o.shape[0])
    js = jint.shadow_hit_early_exit(jt, jrt.slot_rank, jrt.slot_shadow,
                                    jnp.asarray(dist))
    ts = tint.shadow_hit_early_exit(_t(jt), trt.slot_rank, trt.slot_shadow,
                                    _t(dist))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("scene_pair", ["nested"], indirect=True)
@pytest.mark.parametrize("kind", ["stripe", "checker"])
def test_eval_pattern(scene_pair, kind):
    _, jir, _, _, tir, _ = scene_pair
    rng = np.random.default_rng(3)
    n = 4096
    pts = rng.uniform(-5, 5, (n, 3))
    # patterns of the kind (and -1 for none), on random analytic prims
    pids = [i for i, k in enumerate(np.asarray(jir.pat_type))
            if k == {"stripe": 4, "checker": 0}[kind]] + [-1]
    pid = rng.choice(pids, n)
    prim = rng.integers(0, jir.meta.n_analytic, n)
    jctx = jpat.build_shape_ctx(jir, jnp.asarray(prim, jnp.int32))
    tctx = tpat.build_shape_ctx(tir, _t(prim))
    _close(tctx.obj_inv, jctx.obj_inv, 0)
    np.testing.assert_array_equal(tctx.shape_type.numpy(),
                                  np.asarray(jctx.shape_type))
    want = jpat.eval_pattern(jir, jnp.asarray(pid, jnp.int32), jctx,
                             jnp.asarray(pts))
    got = tpat.eval_pattern(tir, _t(pid), tctx, _t(pts))
    _close(got, want)


def test_normal_at(scene_pair):
    _, jir, _, _, tir, _ = scene_pair
    rng = np.random.default_rng(4)
    n = 4096
    prim = rng.integers(0, jir.meta.n_analytic, n)
    pts = rng.uniform(-5, 5, (n, 3))
    jctx = jpat.build_shape_ctx(jir, jnp.asarray(prim, jnp.int32))
    tctx = tpat.build_shape_ctx(tir, _t(prim))
    zero = jnp.zeros(n, jnp.float64)
    want = jnorm.normal_at(jir, jctx, jnp.asarray(prim, jnp.int32),
                           jnp.asarray(pts), zero, zero)
    _close(tnorm.normal_at(tir, tctx, _t(prim), _t(pts),
                           _t(zero), _t(zero)), want)


def test_prepare_computations(scene_pair):
    _, jir, jrt, _, tir, trt = scene_pair
    o, d = _rays(5)
    want = jax.jit(lambda a, b: jintg.prepare_computations(
        jir, jrt, a, b))(jnp.asarray(o), jnp.asarray(d))
    got = tintg.prepare_computations(tir, trt, _t(o), _t(d))
    for field in tintg.Comps._fields:
        if field == "ctx":
            continue
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        if g.dtype in (torch.bool, torch.int64):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            _close(g.numpy(), w)
    # the shading and specular-combine helpers on the same comps
    for fn in ("refract_active", "refract_direction", "schlick"):
        g = getattr(tintg, fn)(got)
        w = getattr(jintg, fn)(want)
        _close(g.numpy().astype(np.float64), np.asarray(w, np.float64))
    want_direct = jintg.shade_direct(jir, jrt, want, None)
    got_direct = tintg.shade_direct(tir, trt, got)
    for g, w in zip(got_direct, want_direct):
        _close(g, w)


def test_default_buckets():
    for n0 in (100, 2048, 320000):
        assert tintg.default_buckets(n0, 5) == jintg.default_buckets(n0, 5)


def test_construct_ppm():
    canvas = np.random.default_rng(6).uniform(0, 1.5, (H, W, 3))
    canvas[0, 0] = 0.0
    for scaling in (True, False):
        assert tppm.construct_ppm(canvas, scaling) == \
            jppm.construct_ppm(canvas, scaling)


@pytest.mark.parametrize("change", ["photon_gi", "jitter", "area_jitter",
                                    "aperture"])
def test_unported_features_raise(change):
    """What raised before the stochastic slice renders now, from a seed
    and the same for the same seed; gradients through photon GI, which
    raised before the GI gradients, come out finite and non-zero, also
    in the light intensity through the live photon powers alone."""
    from fast_ray_tracer_tpu_torch.render import photon as tph
    from fast_ray_tracer_tpu_torch.render import render as trender
    sc = tdemo.glass_spheres(8, 4)
    if change == "photon_gi":
        sc.config.include_global = True
        sc.config.photon_count = 1000
    elif change == "jitter":
        sc.lights[0].jitter = True
    elif change == "area_jitter":
        sc.lights = [tmodel.LightDesc(kind="area", usteps=2, vsteps=2,
                                      jitter=True)]
    else:
        sc.camera.aperture = tmodel.ApertureDesc(kind="CIRCULAR_APERTURE",
                                                 size=0.1, params=(1.0,))
    a = trender.render_scene(sc, dtype=torch.float64, device="cpu", seed=2)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(
        a, trender.render_scene(sc, dtype=torch.float64, device="cpu",
                                seed=2))
    if change != "photon_gi":
        return
    from fast_ray_tracer_tpu_torch.sampling.rng import RNG
    ir = tcomp.compile_scene(sc, dtype=torch.float64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    maps = tph.trace_photons(ir, rt, RNG(2), torch.float64, caustic=False,
                             global_=True)
    rt = rt._replace(gi_hook=tph.make_gi_hook(maps, sc.config,
                                              live_power=True))
    cam_rt = tcam.build_camera(sc.camera, dtype=torch.float64, device="cpu")
    ir.mat_Kd.requires_grad_(True)
    ir.light_intensity.requires_grad_(True)
    n = 8
    img, _ = trender.pixel_colors(
        ir, rt, cam_rt, torch.arange(n), torch.full((n,), 3),
        torch.full((n, 2), 0.5, dtype=torch.float64),
        torch.zeros((n, 2), dtype=torch.float64), 1, 5, rng=RNG(3))
    g_kd, g_li = torch.autograd.grad(img.sum(), [ir.mat_Kd,
                                                 ir.light_intensity])
    for g in (g_kd, g_li):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0
    pm = maps[tph.GLOBAL]
    live = tph.live_photon_powers(pm, ir)
    assert torch.equal(live.detach(), pm.power)
    g_pw, = torch.autograd.grad(live.sum(), [ir.light_intensity])
    assert float(g_pw.abs().sum()) > 0.0


@pytest.mark.parametrize("change", ["area_light", "texture", "xyz"])
def test_ported_features_render(change, tmp_path):
    """What raised before the scene-frontend slice renders now: an
    unjittered area light, a texture pattern, the XYZ color space."""
    sc = tdemo.glass_spheres(8, 4)
    if change == "area_light":
        sc.lights = [tmodel.LightDesc(kind="area", usteps=2, vsteps=2,
                                      corner=(-4.9, 4.9, -1.0))]
    elif change == "texture":
        (tmp_path / "t.ppm").write_bytes(b"P6\n2 1\n255\n" + bytes(range(6)))
        sc.root_dir = str(tmp_path)
        sc.world[1].material.patterns["map_Kd"] = tmodel.PatternDesc(
            kind="map", mapping="plane", faces=[tmodel.PatternDesc(
                kind="uv_image", file="t.ppm", decode_to_linear=True)])
    else:
        sc.config.color_space = "XYZ"
    from fast_ray_tracer_tpu_torch.render.render import render_scene
    img = render_scene(sc, dtype=torch.float64, device="cpu")
    assert img.shape == (4, 8, 3) and np.isfinite(img).all()
