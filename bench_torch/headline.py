"""The headline cell: rays/s of the flagship Whitted frame (bench.py's
counterpart).

`glass_spheres` at 800x400 in float32, depth 5, the whole frame one
chunk, at the nominal 126 rays a pixel (63 trace and 63 shadow rays: the
depth-5 reflect/refract wavefront with one light), as bench.py counts
them. The spawn counts are probed once and the buckets climb the margin
ladder 1.05, 1.12, 1.3, 1.6 (render.quantize_buckets) until a frame does
not overflow. Then, `reps` times, REPS back-to-back `pixel_colors` calls
with their overflow flags kept on the device and one synchronize: the
rays/s of one round is REPS frames' rays over its wall. The flags are
read after the timed rounds, never inside them (reading one syncs the
stream). Then single calls, each with its flag read, and `render_scene`
cold (compile, probe, bucket cache entry written) and warm (the cache's
buckets, no probe).

With `profile` (a directory), one more round runs under torch.profiler
after the timed ones: its Chrome trace goes to DIR/trace.json, and the
cell reports the device busy time (kernels, copies and memsets, not the
profiler ranges' own rows), the idle share of the round's window and the
top kernels, and the idle share against an unprofiled round's wall too
(the profiler slows the host). This stands in for bench.py's jax.profiler trace and its
`utilization`, which reads XLA's cost analysis of the compiled program:
torch has no counterpart of that analysis.

`vs_baseline` divides by bench.py's reference, the C tracer's 400x200
frame of the same scene in 1.329 s on 2 CPU cores (7.585e6 rays/s,
`bench.py:37-39`), not by a TPU figure.
"""

from __future__ import annotations

import os
import statistics
import time

import torch

from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts,
)
from fast_ray_tracer_tpu_torch.render.render import (
    pixel_colors, quantize_buckets, render_scene,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres
from fast_ray_tracer_tpu_torch.utils.profiling import TRACE_FILE

from bench_torch.common import (
    COMPACTION, GateFailed, fresh_memory, launches, metric, peak_gib, rates,
    require_finite, require_launched, require_no_overflow, reset_launches,
    resolve, sync, timed,
)

METRIC = "glass_spheres_whitted_d5_rays_per_s"
RAYS_PER_PIXEL = 126      # 63 trace + 63 shadow (depth 5, 2 children, 1 light)
REF_RAYS_PER_S = 400 * 200 * RAYS_PER_PIXEL / 1.329
MARGINS = (1.05, 1.12, 1.3, 1.6)
REPS = 6


def flagship(device=None, reps=3, seed=None, width=800, height=400,
             profile=None):
    """The headline cell; `seed` is unused (the scene draws nothing)."""
    device = resolve(device)
    fresh_memory(device)
    scene = glass_spheres(width, height)
    depth = scene.config.di_path_length
    n = width * height
    t0 = time.perf_counter()
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    cam_rt = build_camera(scene.camera, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    px = torch.arange(width, device=device).repeat(height)
    py = torch.arange(height, device=device).repeat_interleave(width)
    uv = torch.as_tensor(cmj_points_static(1, 1), dtype=torch.float32) \
        .to(device).expand(n, 2)
    ap = torch.zeros((n, 2), dtype=torch.float32, device=device)
    args = (ir, rt, cam_rt, px, py, uv, ap, 1, depth)
    counts = torch.stack(spawn_counts(
        ir, rt, *rays_for_pixels(cam_rt, px, py, uv, ap), depth)).tolist()
    for margin in MARGINS:
        buckets = quantize_buckets(counts, margin)
        img, ovf = pixel_colors(*args, buckets=buckets)
        if not bool(ovf):
            break
    else:
        raise GateFailed(f"bucket overflow even at margin {MARGINS[-1]}")
    sync(device)
    cold = time.perf_counter() - t0

    def one_round():
        flags = []
        for _ in range(REPS):
            out, ovf = pixel_colors(*args, buckets=buckets)
            flags.append(ovf)
        return out, flags

    reset_launches()
    walls, flags = [], []
    for _ in range(max(reps, 1)):
        (out, fl), wall = timed(device, one_round)
        walls.append(wall / REPS)
        flags += fl
    counted = launches()
    if bool(torch.stack(flags).any()):
        raise GateFailed("a timed frame overflowed its buckets")
    require_launched(device, counted, COMPACTION, "the timed frames")
    require_finite(out, "the timed frame")
    if not torch.equal(out, img):
        raise GateFailed("a timed frame differs from the calibrated one")

    singles = []
    for _ in range(max(reps, 1)):
        (_, ovf), wall = timed(device,
                               lambda: pixel_colors(*args, buckets=buckets))
        if bool(ovf):
            raise GateFailed("a single frame overflowed its buckets")
        singles.append(wall)

    profiled = None if profile is None else profile_round(
        device, one_round, profile, REPS * statistics.median(walls))

    scene_walls = []
    for _ in range(1 + max(reps, 1)):
        stats = {}
        canvas, wall = timed(device, lambda: render_scene(
            scene, dtype=torch.float32, device=device, chunk_pixels=n,
            stats=stats))
        require_no_overflow(stats, "render_scene")
        if canvas.shape != (height, width, 3):
            raise GateFailed(f"render_scene canvas of shape {canvas.shape}")
        require_finite(canvas, "the render_scene canvas")
        scene_walls.append(wall)
    frame_rays = n * RAYS_PER_PIXEL
    metrics = {
        METRIC: metric(rates(frame_rays, walls), "rays/s"),
        "flagship_streamed_frame_s": metric(walls, "s"),
        "flagship_single_call_s": metric(singles, "s"),
        "flagship_cold_s": metric(cold, "s"),
        "flagship_render_scene_cold_s": metric(scene_walls[0], "s"),
        "flagship_render_scene_warm_s": metric(scene_walls[1:], "s"),
        "flagship_peak_gib": metric(peak_gib(device), "GiB"),
    }
    info = {"size": [width, height], "buckets": list(buckets),
            "spawn_counts": counts, "streamed_calls": REPS,
            "launches_per_round": {k: v // max(reps, 1)
                                   for k, v in counted.items()}}
    if profiled is not None:
        info["profile"] = profiled
    return {"metrics": metrics, "info": info,
            "image": img.detach().cpu().double().numpy()
            .reshape(height, width, 3)}


def profile_round(device, one_round, directory, round_s):
    """One round of the headline loop under torch.profiler: the Chrome trace
    in directory/TRACE_FILE, the device busy time (kernels, copies and
    memsets; a profiler range's own device row spans the kernels inside
    it and is left out), its idle share of the profiled round's window
    and of an unprofiled round's wall `round_s` (the profiler slows the
    host), and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, supported_activities
    os.makedirs(directory, exist_ok=True)
    sync(device)
    with profile(activities=supported_activities()) as prof:
        _, window = timed(device, one_round)
    prof.export_chrome_trace(os.path.join(directory, TRACE_FILE))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    by_name = {}
    for e in dev:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"trace": os.path.join(directory, TRACE_FILE),
            "window_s": window, "device_busy_s": busy,
            "idle_share": 1.0 - busy / window if dev else None,
            "unprofiled_round_s": round_s,
            "idle_share_unprofiled": 1.0 - busy / round_s if dev else None,
            "device_events": len(dev),
            "top_kernels_ms": [[name[:160], round(ms, 4), k]
                               for name, (ms, k) in top]}


def vs_baseline(rays_per_s):
    return None if rays_per_s is None else rays_per_s / REF_RAYS_PER_S

