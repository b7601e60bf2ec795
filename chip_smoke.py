"""Drive the PyTorch port's flagship render once on one CUDA card; check it.

    python3 chip_smoke.py [--reps N] [--profile PATH]

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi); exits non-zero
     without CUDA;
  2. build: builds the compaction kernels from csrc/ into build/kernels/;
  3. kernels: compact_rows (C=6) and expand_rows (C=9) at the level-0 shape
     of the 800x400 frame (N = 640,000; B from the bucket calibration), the
     CUDA kernel against its plain torch version on the same inputs, bit for
     bit, over act densities {0, .05, .5, .95, 1}, a ragged N, an overflow
     case, float64, a scan of more than 1024 tiles and a 5-row input, and
     the VJPs of the autograd pair; median times of both;
  4. render: render_scene(glass_spheres(800, 400)) in float32 on the card,
     the whole frame in one chunk: the launch counts of that call, then the
     warm wall (median of --reps, default 3) and rays/s at 126 rays/pixel;
  5. equality: the same frame with the plain compaction, and an 800x16
     strip through trace_bucketed against the unrolled trace, bit for bit;
  6. output: the PPM bytes of the frame, written to the temp directory.
Then a JSON line of per-kernel results and, last, the device JSON line.
Any failure raises and exits non-zero. --reps sets the number of warm
frames of each compaction. With --profile, the level-0 kernel and plain
calls and one warm frame run under torch.profiler, and their per-kernel
device-time tables are written to PATH.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from fast_ray_tracer_tpu_torch.io.ppm import construct_ppm
from fast_ray_tracer_tpu_torch.ops import compact
from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    FILL_ROW, build_statics, spawn_counts, trace, trace_bucketed,
)
from fast_ray_tracer_tpu_torch.render.render import (
    quantize_buckets, render_scene,
)
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres

W, H = 800, 400
RAYS_PER_PIXEL = 126      # 63 trace + 63 shadow rays (depth 5, 2 children)
SRC = "fast_ray_tracer_tpu_torch/csrc/compact.cu"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def pixel_rays(scene, device, rows=None):
    """Primary rays of the scene's camera for image rows `rows` (all)."""
    cam = scene.camera
    ys = torch.arange(cam.height, device=device) if rows is None else \
        torch.arange(rows[0], rows[1], device=device)
    py = ys.repeat_interleave(cam.width)
    px = torch.arange(cam.width, device=device).repeat(len(ys))
    n = px.shape[0]
    cam_rt = build_camera(cam, dtype=torch.float32, device=device)
    uv = torch.full((n, 2), 0.5, dtype=torch.float32, device=device)
    ap = torch.zeros((n, 2), dtype=torch.float32, device=device)
    return rays_for_pixels(cam_rt, px, py, uv, ap)


def median_ms(fn, reps=30):
    """Median device time of fn() in ms, each call between two events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(device, n0, b0, seed=0):
    """Kernel == plain, bitwise, over the case grid; returns per-kernel
    (max_abs_err, kernel ms, plain ms)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = 2 * n0
    cases = [(f"p={p}", n, p, b0, torch.float32)
             for p in (0.0, 0.05, 0.5, 0.95, 1.0)]
    cases += [("ragged", n - 333, 0.5, b0, torch.float32),
              ("overflow", n, 0.5, n // 4, torch.float32),
              ("float64", n, 0.5, b0, torch.float64),
              # more than 1024 tiles: the one-block scan loops and carries
              ("two-pass scan", 1_500_001, 0.5, 1_000_000, torch.float32),
              ("tiny", 5, 0.5, 8, torch.float32)]
    err = {"compact": 0.0, "expand": 0.0}
    for name, nn, p, b, dt in cases:
        act = torch.rand(nn, generator=g, device=device) < p
        src = torch.randn((nn, 6), generator=g, device=device, dtype=dt)
        child = torch.randn((b, 9), generator=g, device=device, dtype=dt)
        got_c = compact.compact_rows_cuda(src, act, b, FILL_ROW)
        want_c = compact.compact_rows_plain(src, act, b, FILL_ROW)
        got_e = compact.expand_rows_cuda(child, act)
        want_e = compact.expand_rows_plain(child, act)
        torch.cuda.synchronize()
        count = int(act.sum())
        ok = torch.equal(got_c, want_c) and torch.equal(got_e, want_e)
        err["compact"] = max(err["compact"],
                             float((got_c - want_c).abs().max()))
        err["expand"] = max(err["expand"], float((got_e - want_e).abs().max()))
        log("kernels", f"{name}: N={nn} B={b} live={count} "
            f"{'overflow ' if count > b else ''}{dt} equal={ok}")
        if not ok:
            raise AssertionError(f"kernel != plain in case {name}")

    # the autograd pair: each backward launches the other kernel
    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device, requires_grad=True)
    child = torch.randn((b0, 9), generator=g, device=device,
                        requires_grad=True)
    ct_b = torch.randn((b0, 6), generator=g, device=device)
    ct_n = torch.randn((n, 9), generator=g, device=device)
    compact.compact_rows(src, act, b0, FILL_ROW).backward(ct_b)
    compact.expand_rows(child, act).backward(ct_n)
    ok = (torch.equal(src.grad, compact.expand_rows_plain(ct_b, act))
          and torch.equal(child.grad, compact.compact_rows_plain(
              ct_n, act, b0, (0.0,) * 9)))
    log("kernels", f"backward: N={n} B={b0} equal={ok}")
    if not ok:
        raise AssertionError("kernel VJPs != plain")

    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device)
    child = torch.randn((b0, 9), generator=g, device=device)
    timing = {
        "compact": (
            median_ms(lambda: compact.compact_rows_cuda(src, act, b0,
                                                        FILL_ROW)),
            median_ms(lambda: compact.compact_rows_plain(src, act, b0,
                                                         FILL_ROW))),
        "expand": (
            median_ms(lambda: compact.expand_rows_cuda(child, act)),
            median_ms(lambda: compact.expand_rows_plain(child, act))),
    }
    for k, (kern, plain) in timing.items():
        log("kernels", f"{k}_rows N={n} B={b0} p=0.5: kernel "
            f"{kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us (median of 30)")
    return {k: (err[k], *timing[k]) for k in err}


def frame(device, compaction="auto", stats=None):
    t0 = time.perf_counter()
    canvas = render_scene(glass_spheres(W, H), dtype=torch.float32,
                          device=device, chunk_pixels=W * H,
                          compaction=compaction, stats=stats)
    torch.cuda.synchronize()
    return canvas, time.perf_counter() - t0


def check_strip(device):
    """800x16 strip: trace_bucketed == the unrolled trace, bit for bit."""
    scene = glass_spheres(W, H)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    depth = scene.config.di_path_length
    o, d = pixel_rays(scene, device, rows=(H // 2 - 8, H // 2 + 8))
    exact = trace(ir, rt, o, d, depth)
    counts = torch.stack(spawn_counts(ir, rt, o, d, depth)).tolist()
    buckets = [max(64, -(-int(c * 1.25) // 64) * 64) for c in counts]
    got, ovf = trace_bucketed(ir, rt, o, d, depth, buckets)
    diff = max(float((x - y).abs().max()) for x, y in zip(exact, got))
    same = all(torch.equal(x, y) for x, y in zip(exact, got))
    log("equal", f"800x16 strip: trace_bucketed vs trace bitwise={same} "
        f"max_abs_diff={diff} overflow={bool(ovf)} buckets={buckets}")
    if bool(ovf) or not same:
        raise AssertionError("bucketed strip differs from the unrolled trace")


def profile_to(path, device, b0, card, wall):
    """Per-kernel device times of the level-0 compaction calls (20 each)
    and of one warm frame, with the frame's device-busy share."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    g = torch.Generator(device=device).manual_seed(1)
    n = 2 * W * H
    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device)
    child = torch.randn((b0, 9), generator=g, device=device)
    calls = [lambda: compact.compact_rows_cuda(src, act, b0, FILL_ROW),
             lambda: compact.compact_rows_plain(src, act, b0, FILL_ROW),
             lambda: compact.expand_rows_cuda(child, act),
             lambda: compact.expand_rows_plain(child, act)]
    with profile(activities=acts) as kprof:
        for fn in calls:
            for _ in range(20):
                fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as fprof:
        _, t = frame(device)

    def device_us(prof):
        # device-side rows only (kernels, copies): an aten op's row repeats
        # the device time of the kernels it launched
        from torch.autograd import DeviceType
        return sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    busy = device_us(fprof) / 1e6
    with open(path, "w") as f:
        f.write(f"{card}\n\n== level-0 calls, 20 each: N={n} B={b0} "
                f"p=0.5 ==\n")
        f.write(kprof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=30))
        f.write(f"\n\n== one warm 800x400 frame: profiled wall {t:.4f} s, "
                f"device busy {busy:.4f} s; unprofiled warm wall {wall:.4f} "
                f"s -> device idle share {1 - busy / wall:.3f} ==\n")
        f.write(fprof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=40))
    log("profile", f"frame device busy {busy:.4f} s of warm wall {wall:.4f} "
        f"s; tables in {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3,
                    help="warm frames timed per compaction (median)")
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler's per-kernel tables of the "
                    "level-0 compaction calls and one warm frame here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    so = compact.build()
    log("build", f"{os.path.relpath(so)} in {time.perf_counter() - t0:.2f} s")

    # 3. kernels at the level-0 shape, B from the calibration
    scene = glass_spheres(W, H)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    counts = torch.stack(spawn_counts(ir, rt, o, d,
                                      scene.config.di_path_length)).tolist()
    b0 = quantize_buckets(counts, 1.5)[0]
    log("kernels", f"level spawn counts {counts}; level-0 bucket B={b0}")
    kstats = check_kernels(device, W * H, b0)

    # 4. render: the main path, counted
    compact.LAUNCHES.update(compact=0, expand=0)
    stats = {}
    canvas, cold = frame(device, stats=stats)
    launches = dict(compact.LAUNCHES)
    log("render", f"800x400 depth 5 float32: launches {launches}, "
        f"buckets {stats['buckets']}, escalations {stats['escalations']}, "
        f"exact chunks {stats['exact_chunks']}, first call {cold:.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    if canvas.shape != (H, W, 3) or not bool(torch.isfinite(
            torch.from_numpy(canvas)).all()):
        raise AssertionError("canvas not finite or of the wrong shape")
    walls, plain_walls = [], []
    plain = None
    for _ in range(args.reps):
        walls.append(frame(device)[1])
        plain, t = frame(device, compaction="plain")
        plain_walls.append(t)
    wall = statistics.median(walls)
    plain_wall = statistics.median(plain_walls)
    log("render", f"warm wall {wall:.4f} s (median of {walls}), "
        f"{W * H * RAYS_PER_PIXEL / wall:.4g} rays/s at {RAYS_PER_PIXEL} "
        f"rays/pixel; plain-compaction frame {plain_wall:.4f} s "
        f"(median of {plain_walls})")

    # 5. equality on the card
    same = torch.equal(torch.from_numpy(canvas), torch.from_numpy(plain))
    log("equal", f"kernel frame vs plain-compaction frame bitwise={same}")
    if not same:
        raise AssertionError("kernel frame differs from the plain frame")
    check_strip(device)

    # 6. output
    ppm = construct_ppm(canvas)
    path = os.path.join(tempfile.gettempdir(), "frt_glass_spheres_800x400.ppm")
    with open(path, "wb") as f:
        f.write(ppm)
    log("output", f"{path} sha256 {hashlib.sha256(ppm).hexdigest()}")

    if args.profile:
        profile_to(args.profile, device, b0, f"{kind}; {smi}", wall)

    rows = []
    for name, key, line in (("compact_rows", "compact", 132),
                            ("expand_rows", "expand", 247)):
        e, ms, plain_ms = kstats[key]
        rows.append({"name": name, "route": "cuda", "source": SRC,
                     "replaces": "fast_ray_tracer_tpu/ops/compact_pallas.py:"
                     f"{line}", "launches": launches[key], "max_abs_err": e,
                     "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
