"""The port's stochastic sampling against the JAX package on the CPU, in
float64, with the JAX side's draws fed to the port (scene_convert.JaxKeys):

- the RNG tree: a node's draws depend on its path alone; seeds differ;
- cmj_points and cmj_points_batched, square and not, bitwise;
- every aperture kind, the rejection samplers' fallback to the last try
  included, bitwise; the camera's per-chunk samples (jittered CMJ tables
  and aperture offsets from one chunk key), bitwise, rays to 1e-12;
- jittered area and circle light points to 1e-12;
- a 32x16 depth-5 frame with jittered area and circle lights through
  trace_bucketed on the port's calibrated buckets, fed JAX's key tree
  (chunk fold_in(key, c), then fold_in(ck, 1), then the level, then
  split(key, 3) per light): within 1e-9;
- render_scene: the same seed gives the same frame bit for bit, another
  seed another frame; a deterministic scene draws nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.sampling import cmj as jcmj
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.sampling import cmj as tcmj
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel

from scene_convert import JaxKeys, convert

torch.set_num_threads(1)

F64 = torch.float64


def test_rng_tree_is_a_function_of_the_path():
    a, b = RNG(7), RNG(7)
    x = a.fold(3).split(2)[1].uniform((5,), F64)
    assert torch.equal(x, b.fold(3).split(2)[1].uniform((5,), F64))
    # the same node drawn twice gives the same numbers, as a reused key
    n = a.fold(1)
    assert torch.equal(n.normal((4,), F64), n.normal((4,), F64))
    others = [a.fold(4).split(2)[1], a.fold(3).split(2)[0],
              a.fold(3).split(3)[1], RNG(8).fold(3).split(2)[1]]
    for o in others:
        assert not torch.equal(x, o.uniform((5,), F64))
    r = a.fold(9).randint((1000,), 2, 5)
    assert r.dtype == torch.int64 and set(r.tolist()) == {2, 3, 4}
    u = a.fold(10).uniform((10000,), torch.float32)
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) \
        and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.02


STEPS = [(1, 1), (3, 2), (2, 5), (4, 4), (10, 10)]


@pytest.mark.parametrize("usteps,vsteps", STEPS)
def test_cmj_points_match_jax(usteps, vsteps):
    key = jax.random.PRNGKey(usteps * 31 + vsteps)
    want = np.asarray(jcmj.cmj_points(key, usteps, vsteps, True,
                                      jnp.float64))
    got = tcmj.cmj_points(*tcmj.draw_cmj(JaxKeys(key), usteps, vsteps, F64),
                          usteps, vsteps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("usteps,vsteps", STEPS)
def test_cmj_points_batched_match_jax(usteps, vsteps):
    key = jax.random.PRNGKey(usteps * 7 + vsteps)
    R = 64
    want = np.asarray(jcmj.cmj_points_batched(key, R, usteps, vsteps,
                                              jnp.float64))
    got = tcmj.cmj_points_batched(
        *tcmj.draw_cmj_batched(JaxKeys(key), R, usteps, vsteps, F64),
        usteps, vsteps)
    np.testing.assert_array_equal(got.numpy(), want)
    # each table is a CMJ arrangement: one point per row and column stratum
    n = usteps * vsteps
    x = np.floor(got[..., 0].numpy() * n)
    assert all(len(set(row)) == n for row in x)


APERTURES = [
    ("SQUARE_APERTURE", ()),
    ("CIRCULAR_APERTURE", (1.0,)),
    ("DOUGHNUT_APERTURE", (0.8, 0.3)),
    # a narrow cross: about half the rays take the last try
    ("CROSS_APERTURE", (-0.01, 0.01, -0.01, 0.01)),
    ("DIAMOND_APERTURE", (-1.0, 1.0, -1.0, 1.0)),
    ("POINT_APERTURE", ()),
    ("HEXAGONAL_APERTURE", ()),
]


def _camera(kind, params, jitter, usteps=2, vsteps=2, w=8, h=6):
    return tmodel.CameraDesc(
        width=w, height=h, field_of_view=1.0, frm=(0.0, 1.0, -5.0),
        to=(0.0, 1.0, 0.0), usteps=usteps, vsteps=vsteps,
        aperture=tmodel.ApertureDesc(kind=kind, size=0.2, params=params,
                                     jitter=jitter))


@pytest.mark.parametrize("kind,params", APERTURES, ids=[a[0] for a in
                                                          APERTURES])
def test_sample_aperture_matches_jax(kind, params):
    cam = _camera(kind, params, False)
    jrt = jcam.build_camera(convert(cam, jmodel), dtype=jnp.float64)
    trt = tcam.build_camera(cam, dtype=F64, device="cpu")
    key = jax.random.PRNGKey(11)
    n = 4096
    want = np.asarray(jcam.sample_aperture(jrt, n, key, jnp.float64))
    xs = tcam.draw_aperture(trt, n, JaxKeys(key), F64)
    got = tcam.sample_aperture(trt, n, F64, "cpu", xs)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "CROSS_APERTURE":
        u = 2.0 * got.numpy()          # 2 * xs - 1
        inside = (np.abs(u[:, 0]) <= 0.01) | (np.abs(u[:, 1]) <= 0.01)
        assert 0.3 < 1.0 - inside.mean() < 0.7     # fallbacks happen


@pytest.mark.parametrize("jitter", [False, True])
def test_primary_samples_match_jax_chunk_rays(jitter):
    """The camera's per-chunk draws (render.py's chunk_rays in the JAX
    package): CMJ tables per pixel under camera jitter, aperture offsets,
    then the rays."""
    cam = _camera("CIRCULAR_APERTURE", (1.0,), jitter)
    jc = convert(cam, jmodel)
    jrt = jcam.build_camera(jc, dtype=jnp.float64)
    trt = tcam.build_camera(cam, dtype=F64, device="cpu")
    n, S = cam.width * cam.height, cam.usteps * cam.vsteps
    ck = jax.random.fold_in(jax.random.PRNGKey(2), 3)
    det = np.asarray(jcmj.cmj_points_static(cam.usteps, cam.vsteps))
    if jitter:
        kt, ap_key = jax.random.split(ck)
        uv = jcmj.cmj_points_batched(kt, n, cam.usteps, cam.vsteps,
                                     jnp.float64).reshape(n * S, 2)
    else:
        ap_key = ck
        uv = jnp.broadcast_to(jnp.asarray(det)[None], (n, S, 2)) \
            .reshape(n * S, 2)
    ap = jcam.sample_aperture(jrt, n * S, ap_key, jnp.float64)
    px = np.tile(np.arange(cam.width), cam.height)
    py = np.repeat(np.arange(cam.height), cam.width)
    jo, jd = jcam.rays_for_pixels(jrt, jnp.repeat(px, S), jnp.repeat(py, S),
                                  uv, ap)
    tpx, tpy, tuv, tap = trender.primary_samples(
        cam, trt, torch.from_numpy(det), torch.from_numpy(px),
        torch.from_numpy(py), JaxKeys(ck))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(uv))
    np.testing.assert_array_equal(tap.numpy(), np.asarray(ap))
    to, td = tcam.rays_for_pixels(trt, tpx, tpy, tuv, tap)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-12)


JITTERED_LIGHTS = [
    tmodel.LightDesc(kind="area", corner=(-3.0, 5.0, -4.0),
                     uvec=(2.0, 0.0, 0.5), vvec=(0.0, 0.4, 1.5), usteps=3,
                     vsteps=2, jitter=True, intensity=(0.6, 0.6, 0.55)),
    tmodel.LightDesc(kind="circle", at=(4.0, 4.0, -2.0), to=(0.0, 0.5, 0.0),
                     radius=0.7, usteps=2, vsteps=3, jitter=True,
                     intensity=(0.3, 0.35, 0.45)),
    tmodel.LightDesc(kind="point", at=(-5.0, 3.0, -6.0),
                     intensity=(0.15, 0.12, 0.1)),
]


def _jittered_scene(w=32, h=16):
    """Two spheres (one glass) and a reflective checkered floor under
    jittered area and circle lights and a point light."""
    m = tmodel
    return m.SceneDesc(
        camera=m.CameraDesc(width=w, height=h, field_of_view=1.0,
                            frm=(0.0, 2.0, -6.0), to=(0.0, 0.7, 0.0)),
        lights=list(JITTERED_LIGHTS),
        world=[
            m.ShapeDesc(kind="plane", material=m.MaterialDesc(
                specular=0.0, reflective=0.3, patterns={
                    "map_Kd": m.PatternDesc(
                        kind="checker", colors=[(0.3, 0.3, 0.3),
                                                (0.7, 0.7, 0.7)])})),
            m.ShapeDesc(kind="sphere", transform=[["translate", -1.0, 1.0,
                                                   0.0]],
                        material=m.MaterialDesc(color=(0.8, 0.3, 0.2),
                                                shininess=60.0)),
            m.ShapeDesc(kind="sphere", transform=[
                ["scale", 0.7, 0.7, 0.7], ["translate", 1.2, 0.7, -0.8]],
                material=m.MaterialDesc(
                    color=(0.1, 0.1, 0.1), ambient=0.0, diffuse=0.2,
                    reflective=0.9, transparency=0.9, refractive_index=1.5)),
        ],
        config=m.ConfigDesc(divide_threshold=1))


def test_jittered_light_points_match_jax():
    tsc = _jittered_scene()
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=F64, device="cpu")
    R = 50
    for li in range(len(JITTERED_LIGHTS)):
        key = jax.random.PRNGKey(40 + li)
        want = np.asarray(jintg._light_sample_points(jir, li, R, key))
        got = tintg._light_sample_points(tir, li, R, JaxKeys(key))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        if li < 2:     # jittered: every lane its own table
            assert not np.allclose(want[0], want[1])


def test_jittered_frame_matches_jax():
    """32x16 depth 5, float64, one chunk, both packages' trace_bucketed on
    the port's calibrated buckets; the port draws through JAX's keys."""
    tsc = _jittered_scene()
    w, h = tsc.camera.width, tsc.camera.height
    n = w * h
    depth = tsc.config.di_path_length
    tir = tcomp.compile_scene(tsc, dtype=F64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    crt = tcam.build_camera(tsc.camera, dtype=F64, device="cpu")
    px = torch.arange(w).repeat(h)
    py = torch.arange(h).repeat_interleave(w)
    uv = torch.full((n, 2), 0.5, dtype=F64)
    o, d = tcam.rays_for_pixels(crt, px, py, uv, torch.zeros((n, 2),
                                                             dtype=F64))
    buckets = trender.quantize_buckets(torch.stack(tintg.spawn_counts(
        tir, trt, o, d, depth)).tolist(), 1.5)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 0), 1)
    tr, ovf = tintg.trace_bucketed(tir, trt, o, d, depth, buckets,
                                   rng=JaxKeys(key))
    assert not bool(ovf)
    got = ((tr.a + tr.d + tr.s) / 3.0).numpy()

    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)

    @jax.jit
    def run(o, d, k):
        t, ovf = jintg.trace_bucketed(jir, jrt, o, d, depth, k,
                                      list(buckets))
        return (t.a + t.d + t.s) / 3.0, ovf

    with compact_pallas.override_mode("off"):
        want, jovf = run(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key)
    assert not bool(jovf)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-9)
    # the jitter shows: another key gives another frame
    tr2, _ = tintg.trace_bucketed(tir, trt, o, d, depth, buckets,
                                  rng=JaxKeys(jax.random.fold_in(key, 1)))
    assert np.abs(((tr2.a + tr2.d + tr2.s) / 3.0).numpy() - got).max() > 1e-3


def test_render_scene_seeds():
    """A jittered-camera, circular-aperture, jittered-light frame: the same
    seed bit for bit, another seed another frame."""
    sc = _jittered_scene(12, 8)
    sc.camera = dataclasses.replace(
        sc.camera, usteps=2, vsteps=2, aperture=tmodel.ApertureDesc(
            kind="CIRCULAR_APERTURE", size=0.05, params=(1.0,), jitter=True))
    kw = dict(dtype=F64, chunk_pixels=48, device="cpu")
    a = trender.render_scene(sc, seed=3, **kw)
    assert np.isfinite(a).all() and a.shape == (8, 12, 3)
    np.testing.assert_array_equal(a, trender.render_scene(sc, seed=3, **kw))
    assert np.abs(trender.render_scene(sc, seed=4, **kw) - a).max() > 1e-3


def test_deterministic_scene_draws_nothing(monkeypatch):
    sc = tdemo.glass_spheres(16, 8)
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    assert not trender.needs_rng(ir, sc.camera, sc.config)

    def no_draws(self):
        raise AssertionError("a deterministic frame drew random numbers")
    want = trender.render_scene(sc, dtype=F64, device="cpu")
    monkeypatch.setattr(RNG, "_generator", no_draws)
    np.testing.assert_array_equal(
        trender.render_scene(sc, dtype=F64, device="cpu", seed=9), want)
