"""The PyTorch port's whole render slice against the JAX package on the CPU:
the static-bucket wavefront (trace_bucketed) and the top-level render
loop (render_scene) on the flagship glass_spheres scene, depth 5.

Tolerances: in float64 the canvases agree to 1e-9 — the frameworks round a
pow or a sqrt one ulp apart, and no lane's branch flips on these inputs
(the largest difference seen is ~1e-13). In float32 the JAX package runs
its Pallas compaction kernels in interpret mode, and 99.5% of the pixels
agree to 1e-4.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas as cp
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.render import render as jrender
from fast_ray_tracer_tpu.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import demo as jdemo

from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEPTH = 5


def _port_rays(scene, dtype):
    cam = scene.camera
    n = cam.width * cam.height
    px = torch.arange(cam.width).repeat(cam.height)
    py = torch.arange(cam.height).repeat_interleave(cam.width)
    uv = torch.as_tensor(cmj_points_static(1, 1), dtype=dtype).expand(n, 2)
    rt = tcam.build_camera(cam, dtype=dtype, device="cpu")
    return tcam.rays_for_pixels(rt, px, py, uv, torch.zeros((n, 2),
                                                            dtype=dtype))


def _canvas(triple):
    return ((triple.a + triple.d + triple.s) / 3.0).numpy()


def test_trace_bucketed_matches_jax():
    """64x32, depth 5, f64: the port's trace_bucketed canvas matches the
    JAX trace_bucketed (its XLA nonzero/gather branch) to 1e-9, with
    identical per-level spawn counts."""
    W, H = 64, 32
    n = W * H
    jsc = jdemo.glass_spheres(W, H)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    cam = jcam.build_camera(jsc.camera, dtype=jnp.float64)
    buckets = jintg.default_buckets(n, DEPTH)

    @jax.jit
    def jax_side(px, py):
        uv = jnp.broadcast_to(jnp.asarray(cmj_points_static(1, 1)), (n, 2))
        o, d = jcam.rays_for_pixels(cam, px, py, uv, jnp.zeros((n, 2)))
        counts = jintg.spawn_counts(jir, jrt, o, d, DEPTH, None)
        tr, ovf = jintg.trace_bucketed(jir, jrt, o, d, DEPTH, None, buckets)
        return jnp.stack(counts), (tr.a + tr.d + tr.s) / 3.0, ovf

    with cp.override_mode("off"):
        j_counts, j_img, j_ovf = jax_side(
            jnp.asarray(np.tile(np.arange(W), H)),
            jnp.asarray(np.repeat(np.arange(H), W)))
    assert not bool(j_ovf)

    tsc = tdemo.glass_spheres(W, H)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    o, d = _port_rays(tsc, torch.float64)
    t_counts = [int(c) for c in tintg.spawn_counts(tir, trt, o, d, DEPTH)]
    tr, ovf = tintg.trace_bucketed(tir, trt, o, d, DEPTH, buckets)
    assert not bool(ovf)
    assert t_counts == [int(c) for c in np.asarray(j_counts)]
    np.testing.assert_allclose(_canvas(tr), np.asarray(j_img), rtol=0,
                               atol=1e-9)


def test_render_scene_matches_jax(tmp_path, monkeypatch):
    """64x32, depth 5, f64, two chunks: the two render_scene canvases agree to 1e-9."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    want = jrender.render_scene(jdemo.glass_spheres(64, 32),
                                dtype=jnp.float64, chunk_pixels=1024)
    stats = {}
    got = trender.render_scene(tdemo.glass_spheres(64, 32),
                               dtype=torch.float64, chunk_pixels=1024,
                               device="cpu", stats=stats)
    assert stats["escalations"] == 0 and stats["exact_chunks"] == 0
    assert got.shape == (32, 64, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_render_f32_matches_jax_interpret_kernels(tmp_path, monkeypatch):
    """32x16, f32, against the JAX render with its Pallas compaction
    kernels in interpret mode: 99.5% of pixels within 1e-4."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    with cp.override_mode("interpret"):
        assert cp.enabled(jnp.float32)
        want = jrender.render_scene(jdemo.glass_spheres(32, 16),
                                    dtype=jnp.float32, chunk_pixels=512)
    got = trender.render_scene(tdemo.glass_spheres(32, 16),
                               dtype=torch.float32, chunk_pixels=512,
                               device="cpu")
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.995, close.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucketed_matches_unrolled(dtype):
    """The port's trace_bucketed equals its unrolled exact trace, bit for
    bit (the port of tests/test_bucketed.py), and the overflow flag fires
    when a bucket is starved."""
    sc = tdemo.glass_spheres(64, 32)
    ir = tcomp.compile_scene(sc, dtype=dtype, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    o, d = _port_rays(sc, dtype)
    exact = tintg.trace(ir, rt, o, d, DEPTH)
    counts = [int(c) for c in tintg.spawn_counts(ir, rt, o, d, DEPTH)]
    buckets = [max(64, int(np.ceil(c * 1.25 / 64)) * 64) for c in counts]
    got, ovf = tintg.trace_bucketed(ir, rt, o, d, DEPTH, buckets)
    assert not bool(ovf)
    for x, y in zip(exact, got):
        assert torch.equal(x, y)
    _, ovf = tintg.trace_bucketed(ir, rt, o, d, DEPTH,
                                  [8] + buckets[1:])
    assert bool(ovf)


def test_render_overflow_falls_back_exactly(monkeypatch, tmp_path):
    """Undersized buckets: every chunk escalates, then re-renders on the
    exact trace — and the canvas is the same as the calibrated render's.
    The bucket cache lives in the test's own directory: the second render
    would otherwise read the first one's entry and never escalate, and
    the undersized escalation would be written for later renders."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    sc = tdemo.glass_spheres(32, 16)
    want = trender.render_scene(sc, dtype=torch.float64, chunk_pixels=256,
                                device="cpu")
    monkeypatch.setattr(trender, "quantize_buckets",
                        lambda counts, margin: (64,) * len(counts))
    (tmp_path / "frt_buckets.json").unlink()
    stats = {}
    got = trender.render_scene(sc, dtype=torch.float64, chunk_pixels=256,
                               device="cpu", stats=stats)
    assert stats["escalations"] == 2 and stats["exact_chunks"] == 2
    np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    """With jax and yaml unimportable, the port renders 8x4 on the CPU,
    its multi-device and profiler modules import, and chip_smoke.py
    imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import torch\n"
        "from fast_ray_tracer_tpu_torch.render.render import render_scene\n"
        "from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres\n"
        "import fast_ray_tracer_tpu_torch.parallel.mesh\n"
        "import fast_ray_tracer_tpu_torch.parallel.distributed\n"
        "import fast_ray_tracer_tpu_torch.utils.profiling\n"
        "from fast_ray_tracer_tpu_torch.parallel import make_mesh\n"
        "import chip_smoke\n"
        "c = render_scene(glass_spheres(8, 4), dtype=torch.float32,"
        " device='cpu')\n"
        "assert c.shape == (4, 8, 3) and (c == c).all()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero with no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
