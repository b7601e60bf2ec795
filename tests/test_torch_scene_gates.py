"""The port's frames on the CPU at tiny sizes, each held to the gates its
timing cell on the card used to raise on, one case a scene:

- flagship (glass_spheres 32x16): a `pixel_colors` frame on calibrated
  buckets (the spawn-count probe, then the margin ladder) with no
  overflow, finite, and bitwise the same frame on a repeat;
  `render_scene` with no escalation;
- fwd_bwd (glass_spheres 24x12): a train step in remat "level" and
  "none" on buckets at 1.2x the probe's counts, with no overflow, a finite
  loss and a finite, positive gradient L1;
- cornell_gi (cornell_box 8x8 without its block, 500 photons): the frame
  finite and of the right shape, with no escalation;
- fwd_bwd_cornell (the same scene): the forward+backward of the frame
  with live photon powers, a finite loss and gradient, and a nonzero
  Kd/intensity gradient;
- mesh (mesh_torus 24x12, 2 x 16 x 8 triangles): as cornell_gi;
- mesh_stream: `mesh.closest` equals `closest_plain` on the 4,096-triangle
  soup of chip_smoke.build_soup;
- scaling (glass_spheres 16x8, chunks of 64 pixels): render_scene(mesh=)
  over two gloo ranks gives the canvas of one rank (each world's ranks
  are processes of bench_torch/ranks.py);
- showcase, soft (2 x 4 x 2 triangles) and dof (16x8): no escalation, a
  finite canvas of the right shape, and a warm frame equal to the first.

One torch thread; the bucket calibrations go to a temporary
FRT_COMPILE_CACHE, so a warm frame reads what the first one wrote.
"""

import concurrent.futures
import os
import shutil

import numpy as np
import pytest
import torch

from bench_torch import ranks
from fast_ray_tracer_tpu_torch.ops import mesh as mesh_ops
from fast_ray_tracer_tpu_torch.parallel.train import (
    make_train_step, merge_params, split_params,
)
from fast_ray_tracer_tpu_torch.render import photon
from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts,
)
from fast_ray_tracer_tpu_torch.render.render import (
    PHOTON_FOLD, pixel_colors, primary_samples, quantize_buckets,
    render_scene,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import (
    cornell_box, glass_spheres, mesh_torus, primitives_showcase,
    soft_textured,
)
from fast_ray_tracer_tpu_torch.scene.model import ApertureDesc, replace

torch.set_num_threads(1)

F32 = torch.float32
SEED = 7                       # the stochastic frames' and photons' seed
MARGINS = (1.05, 1.12, 1.3, 1.6)


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "cache"))


def _assert_no_escalation(stats):
    assert stats["escalations"] == 0 and stats["exact_chunks"] == 0, stats


def _frame(scene, seed=None):
    """render_scene in float32 on the CPU, the whole frame one chunk:
    finite, of the scene's shape, with no escalation."""
    cam = scene.camera
    stats = {}
    canvas = render_scene(scene, dtype=F32, device="cpu",
                          chunk_pixels=cam.width * cam.height, seed=seed,
                          stats=stats)
    _assert_no_escalation(stats)
    assert canvas.shape == (cam.height, cam.width, 3)
    assert np.isfinite(canvas).all()
    return canvas


def _frame_twice(scene, seed=None):
    first = _frame(scene, seed)
    np.testing.assert_array_equal(_frame(scene, seed), first)


def _setup(scene):
    """The scene's tables, camera, statics and its frame's samples, one a
    pixel at the pixel's centre."""
    cam = scene.camera
    ir = compile_scene(scene, dtype=F32, device="cpu")
    cam_rt = build_camera(cam, dtype=F32, device="cpu")
    rt = build_statics(ir, scene.config)
    n = cam.width * cam.height
    px = torch.arange(cam.width).repeat(cam.height)
    py = torch.arange(cam.height).repeat_interleave(cam.width)
    uv = torch.as_tensor(cmj_points_static(1, 1), dtype=F32).expand(n, 2)
    return ir, cam_rt, rt, (px, py, uv, torch.zeros((n, 2), dtype=F32))


def _counts(ir, rt, cam_rt, args, depth):
    return torch.stack(spawn_counts(ir, rt, *rays_for_pixels(cam_rt, *args),
                                    depth)).tolist()


def flagship():
    scene = glass_spheres(32, 16)
    depth = scene.config.di_path_length
    ir, cam_rt, rt, args = _setup(scene)
    counts = _counts(ir, rt, cam_rt, args, depth)
    for margin in MARGINS:
        buckets = quantize_buckets(counts, margin)
        img, ovf = pixel_colors(ir, rt, cam_rt, *args, 1, depth,
                                buckets=buckets)
        if not bool(ovf):
            break
    else:
        pytest.fail(f"bucket overflow even at margin {MARGINS[-1]}")
    assert bool(torch.isfinite(img).all())
    again, ovf = pixel_colors(ir, rt, cam_rt, *args, 1, depth,
                              buckets=buckets)
    assert not bool(ovf) and torch.equal(again, img)
    _frame(scene)


def fwd_bwd():
    scene = glass_spheres(24, 12)
    depth = scene.config.di_path_length
    ir, cam_rt, rt, args = _setup(scene)
    buckets = quantize_buckets(_counts(ir, rt, cam_rt, args, depth), 1.2)
    target = torch.zeros((args[0].shape[0], 3), dtype=F32)
    for remat in ("level", "none"):
        params, static = split_params(ir)
        init, step = make_train_step(rt, cam_rt, static, 1, depth,
                                     remat=remat, buckets=buckets)
        _, loss, ovf = step(init(params), *args, target)
        l1 = float(sum(p.grad.abs().sum() for p in params.values()
                       if p.grad is not None))
        assert not bool(ovf), remat
        assert np.isfinite(float(loss)), remat
        assert np.isfinite(l1) and l1 > 0.0, (remat, l1)


def _cornell():
    scene = cornell_box(8, 8, mesh=False)
    scene.config = replace(scene.config, photon_count=500)
    return scene


def cornell_gi():
    _frame(_cornell(), SEED)


def fwd_bwd_cornell():
    """The whole frame's loss sum((img - 0.5)^2) through live photon powers
    and remat "level", one chunk drawing from the root's fold(0)."""
    scene = _cornell()
    cfg, cam = scene.config, scene.camera
    depth = cfg.di_path_length
    ir = compile_scene(scene, dtype=F32, device="cpu")
    rt = build_statics(ir, cfg)
    maps = photon.trace_photons(
        ir, rt, RNG(SEED, "cpu").fold(PHOTON_FOLD), F32,
        caustic=cfg.include_caustics, global_=cfg.include_final_gather)
    rt = rt._replace(gi_hook=photon.make_gi_hook(maps, cfg, live_power=True))
    cam_rt = build_camera(cam, dtype=F32, device="cpu")
    det = torch.as_tensor(cmj_points_static(1, 1), dtype=F32)
    idx = torch.arange(cam.width * cam.height)
    ck = RNG(SEED, "cpu").fold(0)
    samples = primary_samples(cam, cam_rt, det, idx % cam.width,
                              idx // cam.width, ck)
    counts = _counts(ir, rt, cam_rt, samples, depth)
    buckets = [max(256, int(np.ceil(c * 1.35 / 256.0)) * 256)
               for c in counts]
    params, static = split_params(ir)
    img, ovf = pixel_colors(merge_params(params, static), rt, cam_rt,
                            *samples, 1, depth, remat="level",
                            buckets=buckets, rng=ck.fold(1))
    loss = ((img - 0.5) ** 2).sum()
    loss.backward()
    assert not bool(ovf)
    g = {k: p.grad for k, p in params.items() if p.grad is not None}
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(x).all()) for x in g.values())
    assert float(g["mat_Kd"].abs().sum()
                 + g["light_intensity"].abs().sum()) > 0.0


def mesh():
    _frame(mesh_torus(24, 12, segments=(16, 8)))


def mesh_stream():
    from chip_smoke import build_soup
    ir, orig, dirs = build_soup("cpu", 4096, 256)
    nt = ir.tri_p1.shape[0]
    tables = mesh_ops.pack(ir, torch.arange(nt, dtype=torch.int32),
                           torch.ones(nt, dtype=torch.bool))
    got = mesh_ops.closest(tables, orig, dirs)
    want = mesh_ops.closest_plain(tables, orig, dirs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _scaling_rank(pmesh, out):
    """One rank of the scaling case: the sharded render; rank 0 leaves the
    canvas in `out`."""
    stats = {}
    canvas = render_scene(glass_spheres(16, 8), dtype=F32, chunk_pixels=64,
                          mesh=pmesh, stats=stats)
    if pmesh.rank == 0:
        np.save(os.path.join(out, "canvas.npy"), canvas)
    return {"stats": stats, "finite": bool(np.isfinite(canvas).all())}


def scaling():
    def world(n):
        _, res, out = ranks.spawn(
            "tests.test_torch_scene_gates:_scaling_rank", n, "cpu")
        try:
            canvas = np.load(os.path.join(out, "canvas.npy"))
        finally:
            shutil.rmtree(out, ignore_errors=True)
        for r in res:
            _assert_no_escalation(r["stats"])
            assert r["finite"]
        return canvas

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        one, two = pool.map(world, (1, 2))
    assert one.shape == (8, 16, 3)
    np.testing.assert_array_equal(two, one)


def showcase():
    _frame_twice(primitives_showcase(16, 8))


def soft():
    _frame_twice(soft_textured(16, 8, segments=(4, 2)))


def dof():
    sc = glass_spheres(16, 8)
    sc.camera = replace(sc.camera, usteps=2, vsteps=2, aperture=ApertureDesc(
        kind="CIRCULAR_APERTURE", size=0.05, params=(1.0,), jitter=True))
    _frame_twice(sc, SEED)


SCENES = {f.__name__: f for f in (
    flagship, fwd_bwd, cornell_gi, fwd_bwd_cornell, mesh, mesh_stream,
    scaling, showcase, soft, dof)}


@pytest.mark.parametrize("cell", list(SCENES))
def test_scene_gates(cell):
    SCENES[cell]()
