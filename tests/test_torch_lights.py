"""The port's deterministic sampled lights against the JAX package on the
CPU: point, hemisphere, and unjittered area and circle lights.

- compile_scene's light tables (sample points from the CMJ cache on the
  host in float64, masks, edges, normals, radii, max_light_samples) to
  1e-12 in float64;
- _light_sample_points, is_shadowed, intensity_at and shade_direct on
  the same shading points in float64: the shadow flags of every sample
  bitwise, the unshadowed fractions to 1e-15 (XLA and torch divide the
  sum of S flags one ulp apart), the rest to 1e-12;
- 64x32 depth-5 canvases to 1e-9 in float64 (the port's render_scene,
  the JAX package's trace_bucketed on the same buckets), on an
  analytic scene and on a clustered mesh scene (the port's plain mesh
  queries against the JAX package's jnp fold); the frameworks round a
  pow or a sqrt one ulp apart;
- on the mesh scene in float32, one shading level of a strip through the
  JAX package's Pallas mesh kernels in interpret mode: the shadow
  queries take S-fold batches (R x S rays), and the shadow flags are
  equal for every sample of every lane; the direct light agrees to 2e-5
  relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel

from scene_convert import convert, jax_canvas

torch.set_num_threads(1)

W, H = 64, 32
SEGMENTS = (32, 32)          # 2,048 triangles: the smallest mesh clusters

LIGHTS = [
    tmodel.LightDesc(kind="area", corner=(-3.0, 5.0, -4.0),
                     uvec=(2.0, 0.0, 0.5), vvec=(0.0, 0.4, 1.5), usteps=3,
                     vsteps=2, intensity=(0.6, 0.6, 0.55)),
    tmodel.LightDesc(kind="circle", at=(4.0, 4.0, -2.0), to=(0.0, 0.5, 0.0),
                     radius=0.7, usteps=2, vsteps=3,
                     intensity=(0.3, 0.35, 0.45)),
    tmodel.LightDesc(kind="hemisphere", at=(0.5, 7.0, 1.0),
                     to=(0.0, 0.0, 0.0), intensity=(0.2, 0.2, 0.2)),
    tmodel.LightDesc(kind="point", at=(-5.0, 3.0, -6.0),
                     intensity=(0.15, 0.12, 0.1)),
]


def _analytic_scene(w=W, h=H):
    """Two spheres (one glass) and a reflective checkered floor under every
    light kind."""
    m = tmodel
    return m.SceneDesc(
        camera=m.CameraDesc(width=w, height=h, field_of_view=1.0,
                            frm=(0.0, 2.0, -6.0), to=(0.0, 0.7, 0.0)),
        lights=list(LIGHTS),
        world=[
            m.ShapeDesc(kind="plane", material=m.MaterialDesc(
                specular=0.0, reflective=0.3, patterns={"map_Kd": m.PatternDesc(
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


def _mesh_scene(w=W, h=H):
    """mesh_torus's small clustered torus under the sampled lights."""
    sc = tdemo.mesh_torus(w, h, segments=SEGMENTS)
    sc.lights = list(LIGHTS[:3])
    return sc


@pytest.fixture(scope="module")
def analytic_pair():
    tsc = _analytic_scene(16, 8)
    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    return (jsc, jir, jintg.build_statics(jir, jsc.config)), \
        (tsc, tir, tintg.build_statics(tir, tsc.config))


def test_light_tables_match_jax(analytic_pair):
    (_, jir, _), (_, tir, _) = analytic_pair
    assert tir.meta.light_info == jir.meta.light_info
    assert tir.meta.max_light_samples == jir.meta.max_light_samples == 6
    assert [i[4] for i in tir.meta.light_info] == [6, 6, 1, 1]
    for name in ("light_intensity", "light_pos", "light_uvec", "light_vvec",
                 "light_normal", "light_radius", "light_points"):
        np.testing.assert_allclose(getattr(tir, name).numpy(),
                                   np.asarray(getattr(jir, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
    assert np.array_equal(tir.light_mask.numpy(), np.asarray(jir.light_mask))


def _rays(n=96, seed=0):
    """Rays from the camera's side toward the scene, all hitting the floor
    or a sphere."""
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 2.0, -6.0], (n, 1)) + rng.normal(0, 0.2, (n, 3))
    tgt = rng.uniform([-3, 0, -2], [3, 1.5, 3], (n, 3))
    d = tgt - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_light_sampling_and_shading_match_jax(analytic_pair):
    """On the same shading points: each light's sample points, their
    shadow flags, the unshadowed fraction (intensity_at) and
    shade_direct's Triple."""
    (jsc, jir, jrt), (tsc, tir, trt) = analytic_pair
    o, d = _rays()
    n = len(o)

    @jax.jit
    def jax_side(o, d):
        c = jintg.prepare_computations(jir, jrt, o, d)
        per_light = []
        for li in range(len(LIGHTS)):
            pts = jintg._light_sample_points(jir, li, n, None)
            per_light.append((
                pts, jintg.is_shadowed(jir, jrt, pts, c.over_point, c.valid),
                jintg.intensity_at(jir, jrt, li, c.over_point, None,
                                   c.valid)[0]))
        return c.over_point, per_light, jintg.shade_direct(jir, jrt, c, None)

    jpoint, per_light, js = jax_side(jnp.asarray(o), jnp.asarray(d))
    tc = tintg.prepare_computations(tir, trt, torch.from_numpy(o),
                                    torch.from_numpy(d))
    p = np.array(jpoint)
    np.testing.assert_allclose(tc.over_point.numpy(), p, rtol=0, atol=1e-12)
    fractions = []
    for li, (jp, jflags, ji) in enumerate(per_light):
        tp = tintg._light_sample_points(tir, li, n)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-12)
        ts = tintg.is_shadowed(tir, trt, tp, torch.from_numpy(p), tc.valid)
        assert np.array_equal(ts.numpy(), np.asarray(jflags))
        ti, _ = tintg.intensity_at(tir, trt, li, torch.from_numpy(p),
                                   tc.valid)
        # the mean of S flags: XLA and torch divide one ulp apart
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                                   atol=1e-15)
        fractions.append(ti.numpy())
    # the area and circle lights are partly shadowed somewhere
    assert any(((f > 0) & (f < 1)).any() for f in fractions[:2])
    ts = tintg.shade_direct(tir, trt, tc)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("which", ["analytic", "mesh"])
def test_canvas_matches_jax(which, monkeypatch, tmp_path):
    """64x32 depth 5, float64, one chunk: the port's render_scene against
    the JAX package's trace_bucketed on the port's buckets; the canvases
    agree to 1e-9 (the mesh through the port's plain queries and the JAX
    jnp fold)."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    tsc = _analytic_scene() if which == "analytic" else _mesh_scene()
    stats = {}
    got = trender.render_scene(tsc, dtype=torch.float64, chunk_pixels=W * H,
                               device="cpu", stats=stats)
    assert stats["escalations"] == 0 and stats["exact_chunks"] == 0
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_canvas(tsc, stats["buckets"]),
                               rtol=0, atol=1e-9)
    assert got.std() > 0.02


def test_mesh_strip_matches_pallas_interpret(monkeypatch):
    """One shading level of a 64x2 strip of the mesh scene in float32: the
    JAX side runs its Pallas mesh kernels in interpret mode (the shadow
    kernel on the S-fold batches of the area and circle lights), the port
    its plain mesh queries, which the CUDA kernels equal bit for bit on
    the card."""
    monkeypatch.setenv("FRT_MESH_PALLAS", "interpret")
    tsc = _mesh_scene()
    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float32)
    tir = tcomp.compile_scene(tsc, dtype=torch.float32, device="cpu")
    assert tir.meta.use_clusters and tir.meta.max_light_samples == 6
    from fast_ray_tracer_tpu.ops import mesh_pallas as jmp
    assert jmp.enabled(jir, jnp.float32, aux_planes=2)
    jrt = jintg.build_statics(jir, jsc.config)
    trt = tintg.build_statics(tir, tsc.config)
    from fast_ray_tracer_tpu_torch.render import camera as tcam
    cam = tcam.build_camera(tsc.camera, dtype=torch.float64, device="cpu")
    n = 2 * W
    o, d = tcam.rays_for_pixels(
        cam, torch.arange(W).repeat(2),
        torch.arange(H // 2, H // 2 + 2).repeat_interleave(W),
        torch.full((n, 2), 0.5, dtype=torch.float64),
        torch.zeros((n, 2), dtype=torch.float64))
    o, d = o.float().numpy(), d.float().numpy()

    @jax.jit
    def jax_level(o, d):
        c = jintg.prepare_computations(jir, jrt, o, d)
        flags = [jintg.is_shadowed(
            jir, jrt, jintg._light_sample_points(jir, li, n, None),
            c.over_point, c.valid) for li in range(3)]
        return c.over_point, c.valid, flags, jintg.shade_direct(jir, jrt, c,
                                                                None)

    jp, jv, jflags, js = jax_level(jnp.asarray(o), jnp.asarray(d))
    tc = tintg.prepare_computations(tir, trt, torch.from_numpy(o),
                                    torch.from_numpy(d))
    assert np.array_equal(tc.valid.numpy(), np.asarray(jv))
    assert tc.valid.numpy().sum() > n // 2
    np.testing.assert_allclose(tc.over_point.numpy(), np.asarray(jp),
                               rtol=0, atol=1e-5)
    # the same shading points on both sides, so the shadow queries match
    p = torch.from_numpy(np.array(jp))
    for li in range(3):
        pts = tintg._light_sample_points(tir, li, n)
        flags = tintg.is_shadowed(tir, trt, pts, p, tc.valid).numpy()
        assert np.array_equal(flags, np.asarray(jflags[li])), li
    # some lanes see the area or circle light in part
    assert any((f.any(-1) & ~f.all(-1)).any()
               for f in map(np.asarray, jflags[:2]))
    ts = tintg.shade_direct(tir, trt, tc)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-6)
