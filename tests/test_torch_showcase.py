"""The scene-language slice as a whole: scene/demo.primitives_showcase
(every analytic shape, every procedural pattern and uv map, Perlin noise,
a bump map and a CSG difference) through the port's static-bucket
wavefront against the JAX package's, on the CPU, at 64x32, depth 5.

The JAX side runs its own spawn_counts and trace_bucketed, every level in
one batch shape (the probe's bucket), so that each operation compiles
once per shape (one jit over the whole depth-5 trace of this scene takes
XLA minutes to compile).

Tolerances: in float64 the canvases agree to 1e-9 with equal per-level
spawn counts; the frameworks round a transcendental or a sqrt one ulp
apart (the largest difference seen is 2.0e-11). In float32, 99.6% of
the pixels agree to 1e-4, and the test holds 99%: float32 rounding
differs between the frameworks (the JAX frame is partly float64, see
test_showcase_f32_matches_jax), and a lane near a pattern boundary
flips. The port's bucketed canvas equals its unrolled trace bit for bit
in both dtypes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas as cp
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render.render import render_scene
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo

from scene_convert import convert

torch.set_num_threads(1)

W, H, DEPTH = 64, 32, 5


def _jax_side(monkeypatch, dtype):
    """JAX spawn counts and canvas of the showcase at W x H. In float64
    the JAX side runs op by op: XLA's fused loops round some float64
    transcendentals otherwise than its single ops (and glibc) do, which
    moved one pixel by 2.4e-9 when prepare_computations was jitted. In
    float32 prepare_computations and shade_direct are jitted per batch
    shape."""
    n = W * H
    jsc = convert(tdemo.primitives_showcase(W, H), jmodel)
    jir = jcomp.compile_scene(jsc, dtype=dtype)
    jrt = jintg.build_statics(jir, jsc.config)
    if dtype == jnp.float32:
        prep_fn, shade_fn = jintg.prepare_computations, jintg.shade_direct
        prep = jax.jit(lambda o, d: prep_fn(jir, jrt, o, d))
        shade = jax.jit(lambda c: shade_fn(jir, jrt, c, None))
        monkeypatch.setattr(
            jintg, "prepare_computations",
            lambda ir, rt, o, d, shadow_filter=False: prep(o, d))
        monkeypatch.setattr(jintg, "shade_direct",
                            lambda ir, rt, comps, key: shade(comps))
    cam = jcam.build_camera(jsc.camera, dtype=dtype)
    uv = jnp.broadcast_to(jnp.asarray(cmj_points_static(1, 1), dtype),
                          (n, 2))
    o, d = jcam.rays_for_pixels(cam, jnp.asarray(np.tile(np.arange(W), H)),
                                jnp.asarray(np.repeat(np.arange(H), W)),
                                uv, jnp.zeros((n, 2), dtype))
    # the probe's bucket for every level, so each batch shape compiles once
    probe = int(np.ceil(n * 3.0 / 256.0)) * 256
    with cp.override_mode("off"):
        counts = [int(c) for c in jintg.spawn_counts(jir, jrt, o, d, DEPTH,
                                                     None)]
        tr, ovf = jintg.trace_bucketed(jir, jrt, o, d, DEPTH, None,
                                       [probe] * DEPTH)
    assert not bool(ovf)
    return counts, np.asarray((tr.a + tr.d + tr.s) / 3.0), probe


def _port_side(dtype, w=W, h=H):
    n = w * h
    sc = tdemo.primitives_showcase(w, h)
    ir = tcomp.compile_scene(sc, dtype=dtype, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    cam = tcam.build_camera(sc.camera, dtype=dtype, device="cpu")
    o, d = tcam.rays_for_pixels(
        cam, torch.arange(w).repeat(h), torch.arange(h).repeat_interleave(w),
        torch.as_tensor(cmj_points_static(1, 1), dtype=dtype).expand(n, 2),
        torch.zeros((n, 2), dtype=dtype))
    return ir, rt, o, d


def _canvas(triple):
    return ((triple.a + triple.d + triple.s) / 3.0).numpy()


def test_showcase_f64_matches_jax(monkeypatch):
    j_counts, j_img, probe = _jax_side(monkeypatch, jnp.float64)
    ir, rt, o, d = _port_side(torch.float64)
    assert ir.meta.has_csg and ir.meta.any_bump and ir.meta.needs_hit_sort
    t_counts = [int(c) for c in tintg.spawn_counts(ir, rt, o, d, DEPTH)]
    tr, ovf = tintg.trace_bucketed(ir, rt, o, d, DEPTH, [probe] * DEPTH)
    assert not bool(ovf)
    assert t_counts == j_counts and min(t_counts) > 0
    got = _canvas(tr)
    np.testing.assert_allclose(got, j_img, rtol=0, atol=1e-9)
    assert got.std() > 0.05


def test_showcase_f32_matches_jax(monkeypatch):
    """The JAX package's float32 frame of this scene is partly float64
    under jax_enable_x64 (the Perlin noise of the bump map widens the
    normals, and with them the secondary rays), which its Pallas
    compaction refuses even in interpret mode (ROADMAP C7); so the JAX
    side takes its XLA nonzero/gather compaction here."""
    _, j_img, probe = _jax_side(monkeypatch, jnp.float32)
    ir, rt, o, d = _port_side(torch.float32)
    tr, ovf = tintg.trace_bucketed(ir, rt, o, d, DEPTH, [probe] * DEPTH)
    assert not bool(ovf)
    close = np.all(np.abs(_canvas(tr) - j_img) <= 1e-4, axis=-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_showcase_bucketed_matches_unrolled(dtype):
    """trace_bucketed equals the unrolled exact trace bit for bit."""
    ir, rt, o, d = _port_side(dtype, 32, 16)
    exact = tintg.trace(ir, rt, o, d, DEPTH)
    counts = [int(c) for c in tintg.spawn_counts(ir, rt, o, d, DEPTH)]
    buckets = [max(64, int(np.ceil(c * 1.25 / 64)) * 64) for c in counts]
    got, ovf = tintg.trace_bucketed(ir, rt, o, d, DEPTH, buckets)
    assert not bool(ovf)
    for x, y in zip(exact, got):
        assert torch.equal(x, y)


def test_render_scene_showcase_on_cpu(monkeypatch, tmp_path):
    """render_scene takes the whole scene language on the CPU: a finite
    canvas of the right shape, no NotImplementedError."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    stats = {}
    img = render_scene(tdemo.primitives_showcase(16, 8), dtype=torch.float32,
                       device="cpu", stats=stats)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    assert stats["exact_chunks"] == 0
