"""Drive the PyTorch port's main paths once on one CUDA card; check them.

    python3 chip_smoke.py [--reps N] [--profile PATH]

Phases, one line each or more:
  1. device: the card's name and power limit (nvidia-smi); exits non-zero
     without CUDA;
  2. build: builds both kernel sources of csrc/ into build/kernels/, the
     two nvcc runs at once, and prints ptxas's register report;
  3. kernels: compact_rows (C=6) and expand_rows (C=9) at the level-0 shape
     of the 800x400 frame (N = 640,000; B from the bucket calibration), the
     CUDA kernel against its plain torch version on the same inputs, bit for
     bit, over act densities {0, .05, .5, .95, 1}, a ragged N, an overflow
     case, float64, a scan of more than 1024 tiles, a 5-row input, N an
     exact multiple of the compaction tile, N = 0, C = 32 in float64 and
     float32, two compactions back to back on one stream with different
     act (the look-back scratch resets), and the VJPs of the autograd
     pair, also on an overflowed level;
     median event times of both, and of the nearest single PyTorch call
     (library_ms), which the port never calls;
  4. render: render_scene(glass_spheres(800, 400)) in float32 on the card,
     the whole frame in one chunk: the launch counts of that call, then the
     warm wall (median of --reps, default 3) and rays/s at 126 rays/pixel;
  5. equality: the same frame with the plain compaction, and an 800x16
     strip through trace_bucketed against the unrolled trace, bit for bit;
  6. output: the PPM bytes of the frame, written to the temp directory;
  7. mesh kernels: mesh closest (with and without a keep plane) and mesh
     shadow, the CUDA kernel against its plain torch version, bit for bit
     (t, index, rank): at the level-0 shape of the mesh_torus frame
     (144,000 rays against 141,312 triangles) in float32 and float64, a
     ragged ray count, dead lanes, strided ray views, the probe's in-frame
     shape (the 144,000 rays followed by FILL_ROW rows up to the probe's
     432,128-lane bucket, as strided views of its rows), all-dead batches,
     and on the 512k-triangle x 16,384-ray soup of
     tools/bench_mesh_stream.py (shadow also ragged, in float64 and with
     every rank equal, so casting t ties across the split's parts); median
     times of both, beside two bounds: the flat walk's (every slab test)
     and the passed pairs' alone;
  8. mesh render: render_scene(mesh_torus(600, 240)) in float32, the whole
     frame in one chunk: the launch counts of that call (every kernel at
     least once), no bucket overflow, a finite canvas; the warm wall
     (median of --reps), pixels/s and traced rays/s (the probe's spawn
     counts plus the primary rays, each with one shadow ray per light);
     then the rays of each mesh.shadow call of one more warm frame: the
     shadow kernel on each against its plain version, bit for bit, and
     its median time on each beside its two bounds;
  9. mesh equality: a 600x16 strip of the opaque and of the glass torus,
     the kernel frame against the plain-mesh frame and trace_bucketed
     against the unrolled trace, bit for bit;
 10. mesh output: the sha256 of the mesh frame's PPM;
 11. showcase render: render_scene(primitives_showcase(800, 400)) in
     float32, the whole frame in one chunk (every analytic shape, pattern
     and uv map, Perlin noise, a bump map and CSG): the compaction
     launches of that call, no bucket overflow, a finite canvas; the warm
     wall (median of --reps), pixels/s and traced rays/s;
 12. showcase equality: the frame with the plain compaction bit for bit
     equal to the kernel frame, and an 800x16 strip through
     trace_bucketed bit for bit equal to the unrolled trace;
 13. card against CPU: the showcase at 64x32 in float64 through
     trace_bucketed on the card and on the CPU, within CARD_CPU_ATOL, with
     the share of pixels past 1e-9;
 14. showcase output: the sha256 of the showcase frame's PPM.
 15. soft frame: scene/demo.soft_textured(800, 400) in float32 through the
     command line (`python -m fast_ray_tracer_tpu_torch` as main([yml, -o
     build/out/soft_textured, ...]): YAML, PNG and PPM textures through
     an MTL file and a planar map, a 4x4 area, a 2x2 circle and a
     hemisphere light, a clustered 141,312-triangle torus, a glass
     sphere), the whole frame in one chunk: the launches of every kernel,
     no bucket overflow; the warm wall (median of --reps, load to files
     written), pixels/s, traced rays/s (each lane casts a shadow ray to
     every light sample), peak device memory; the PPM's sha256 equal to
     the kernel frame's encode, the PNG read back with the port's
     read_png bit for bit; the host time of each texture read (the
     frame's two PNGs and its PPM, and a 1024x1024 RGB PNG whose rows are
     filtered as libpng chooses, read back bit for bit); then a frame
     whose one chunk reaches the renderer's shadow-ray cap, its peak
     memory within PEAK_MEMORY_BUDGET;
 16. soft equality: the frame with the plain compaction, and an 800x16
     strip with the plain mesh queries and through the unrolled trace,
     bit for bit;
 17. soft shadow kernel: the area light's level-0 batch (R x 16 rays) of
     one frame, the mesh shadow kernel's median time on all of it beside
     its bounds, its output on the first 262,144 rays bitwise against the
     plain version;
 18. soft card against CPU: soft_textured at 64x32 with a 2,048-triangle
     torus in float64 through the unrolled trace: every pixel within
     CARD_CPU_ATOL except those where a lookup took another texel (under
     TEXEL_FLIP_SHARE of the frame), both counted.
 19. train: make_train_step on glass_spheres(800, 400) in float32, the
     whole frame one batch, buckets from one spawn-count probe at 1.2x,
     the target rendered with mat_Kd x 0.6, the backward over every float
     table (Adam updating TRAIN_TABLES), with remat="level" and "none":
     the compaction launches of one step's forward and of its backward
     (each > 0), then --reps timed steps (median ms), peak device memory,
     each step's loss (finite, falling), no overflow;
 20. train equality: on an 800x16 strip, the gradients with the CUDA
     compaction against those with the plain one (bitwise with
     deterministic algorithms, and within TRAIN_STRIP_RTOL without), and
     the bucketed trace's against the unrolled trace's within
     TRAIN_STRIP_RTOL but for the rows the value gates prune;
 21. train card against CPU: the gradients at 24x12 in float64, bucketed
     with remat="level", within TRAIN_CARD_CPU_RTOL of each field's
     largest |g|.
Then the compaction's device time per call from torch.profiler, one
profiled warm train step, and one
profiled warm showcase and soft frame each (device events, device busy
time, idle share against the warm wall, and top operators by device
time), after every wall-clock phase (the profiler leaves launches
slower); the card's
nvidia-smi line, a JSON line of per-kernel results and, last, the device
JSON line. Any failure raises and exits non-zero.
--reps sets the number of warm frames of each render. With --profile, the
level-0 compaction calls and one warm frame of each render run under
torch.profiler, and their per-kernel device-time tables go to PATH.
"""

import argparse
import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch.__main__ import main as cli_main
from fast_ray_tracer_tpu_torch.io.ppm import (
    construct_ppm, encode_png, png16, read_png, read_ppm,
)
from fast_ray_tracer_tpu_torch.ops import compact, mesh, patterns
from fast_ray_tracer_tpu_torch.ops.intersect import neutralize_rays
from fast_ray_tracer_tpu_torch.ops.vec import normalize
from fast_ray_tracer_tpu_torch.parallel.train import (
    adam, make_train_step, merge_params, split_params,
)
from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    FILL_ROW, PROBE_CEILING, build_statics, prepare_computations,
    spawn_counts, trace, trace_bucketed,
)
from fast_ray_tracer_tpu_torch.render.render import (
    SHADOW_RAYS_PER_CHUNK, pixel_colors, quantize_buckets, render_scene,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import (
    SOFT_DIR, glass_spheres, mesh_torus, primitives_showcase, soft_textured,
)
from fast_ray_tracer_tpu_torch.scene.ir import PAT_UV_TEXTURE, SceneIR, SceneMeta

W, H = 800, 400
RAYS_PER_PIXEL = 126      # 63 trace + 63 shadow rays (depth 5, 2 children)
MW, MH = 600, 240         # the mesh frame
SRC = "fast_ray_tracer_tpu_torch/csrc/compact.cu"
MESH_SRC = "fast_ray_tracer_tpu_torch/csrc/mesh.cu"
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "out")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
# operations per (ray, triangle) Möller-Trumbore and per (ray,
# supercluster) slab test, counted from csrc/mesh.cu: 46 add/sub/mul/div;
# 6 sub, 6 mul, 6 min/max, 4 min/max across axes, 2 compares
MT_OPS, SLAB_OPS = 46, 24


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def pixel_rays(scene, device, rows=None, dtype=torch.float32):
    """Primary rays of the scene's camera for image rows `rows` (all)."""
    cam = scene.camera
    ys = torch.arange(cam.height, device=device) if rows is None else \
        torch.arange(rows[0], rows[1], device=device)
    py = ys.repeat_interleave(cam.width)
    px = torch.arange(cam.width, device=device).repeat(len(ys))
    n = px.shape[0]
    cam_rt = build_camera(cam, dtype=dtype, device=device)
    uv = torch.full((n, 2), 0.5, dtype=dtype, device=device)
    ap = torch.zeros((n, 2), dtype=dtype, device=device)
    return rays_for_pixels(cam_rt, px, py, uv, ap)


def short_kernel_name(mangled):
    """A kernel's mangled name without its anonymous namespace and its
    parameter list: the kernel and its template arguments."""
    ns = re.match(r"_ZN(\d+)_GLOBAL__N", mangled)
    name = mangled[ns.end(1) + int(ns.group(1)):] if ns else mangled
    cut = name.find("Ev")
    return name[:cut + 2] if cut >= 0 else name


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


def device_us(prof):
    """Device time (us) in a torch.profiler run: device-side rows only
    (kernels, copies, memsets); an aten op's row repeats the device time of
    the kernels it launched."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def profiled_ms(fn, calls=20):
    """Device time per call of fn() in ms, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_us(prof) / calls / 1e3


def check_kernels(device, n0, b0, seed=0):
    """Kernel == plain, bitwise, over the case grid; returns per kernel
    its max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = 2 * n0
    f32, f64 = torch.float32, torch.float64
    tile = compact.compact_tile_rows(6, f32)
    cases = [(f"p={p}", n, p, b0, f32, 6) for p in (0.0, 0.05, 0.5, 0.95, 1.0)]
    cases += [("ragged", n - 333, 0.5, b0, f32, 6),
              ("overflow", n, 0.5, n // 4, f32, 6),
              ("float64", n, 0.5, b0, f64, 6),
              # more than 1024 tiles: the expansion's one-block scan carries
              ("two-pass scan", 1_500_001, 0.5, 1_000_000, f32, 6),
              ("tiny", 5, 0.5, 8, f32, 6),
              ("tile multiple", 400 * tile, 0.5, b0, f32, 6),
              ("N=0", 0, 0.5, 64, f32, 6),
              ("C=32 float64", 200_003, 0.5, 150_000, f64, 32),
              ("C=32 float32 overflow", 200_003, 0.5, 60_000, f32, 32)]
    err = {"compact": 0.0, "expand": 0.0}
    for name, nn, p, b, dt, c in cases:
        act = torch.rand(nn, generator=g, device=device) < p
        src = torch.randn((nn, c), generator=g, device=device, dtype=dt)
        child = torch.randn((b, 9), generator=g, device=device, dtype=dt)
        fill = (FILL_ROW * 6)[:c]
        got_c = compact.compact_rows_cuda(src, act, b, fill)
        want_c = compact.compact_rows_plain(src, act, b, fill)
        got_e = compact.expand_rows_cuda(child, act)
        want_e = compact.expand_rows_plain(child, act)
        torch.cuda.synchronize()
        count = int(act.sum())
        ok = torch.equal(got_c, want_c) and torch.equal(got_e, want_e)
        for k, (x, y) in (("compact", (got_c, want_c)),
                          ("expand", (got_e, want_e))):
            if x.numel():
                err[k] = max(err[k], float((x - y).abs().max()))
        log("kernels", f"{name}: N={nn} C={c} B={b} live={count} "
            f"{'overflow ' if count > b else ''}{dt} equal={ok}")
        if not ok:
            raise AssertionError(f"kernel != plain in case {name}")

    # two compactions back to back on one stream, no sync between: the
    # second must start from a clean ticket and clean status words
    acts = [torch.rand(n, generator=g, device=device) < p for p in (0.3, 0.7)]
    src = torch.randn((n, 6), generator=g, device=device)
    got = [compact.compact_rows_cuda(src, a, b0, FILL_ROW) for a in acts]
    torch.cuda.synchronize()
    ok = all(torch.equal(x, compact.compact_rows_plain(src, a, b0, FILL_ROW))
             for x, a in zip(got, acts))
    log("kernels", f"back to back: N={n} B={b0} "
        f"live={[int(a.sum()) for a in acts]} equal={ok}")
    if not ok:
        raise AssertionError("back-to-back compactions != plain")

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
    # the VJPs of a level that overflowed: the expand in compact's
    # backward meets more live rows than the bucket holds and must clamp
    # its reads to row B-1, as the plain version does
    bo = n // 4
    src = torch.randn((n, 6), generator=g, device=device, requires_grad=True)
    child = torch.randn((bo, 9), generator=g, device=device,
                        requires_grad=True)
    ct_b = torch.randn((bo, 6), generator=g, device=device)
    compact.compact_rows(src, act, bo, FILL_ROW).backward(ct_b)
    compact.expand_rows(child, act).backward(ct_n)
    ok = (torch.equal(src.grad, compact.expand_rows_plain(ct_b, act))
          and torch.equal(child.grad, compact.compact_rows_plain(
              ct_n, act, bo, (0.0,) * 9)))
    log("kernels", f"backward overflow: N={n} B={bo} live={int(act.sum())} "
        f"equal={ok}")
    if not ok:
        raise AssertionError("kernel VJPs != plain on an overflowed level")

    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device)
    child = torch.randn((b0, 9), generator=g, device=device)
    timing = {
        "compact": (median_ms(lambda: compact.compact_rows_cuda(
                        src, act, b0, FILL_ROW)),
                    median_ms(lambda: compact.compact_rows_plain(
                        src, act, b0, FILL_ROW))),
        "expand": (
            median_ms(lambda: compact.expand_rows_cuda(child, act)),
            median_ms(lambda: compact.expand_rows_plain(child, act))),
    }
    # the nearest single PyTorch calls, never called by the port: a
    # boolean-mask gather (a host sync sizes it to the live count: no fill
    # rows, no fixed bucket) and a masked scatter into a separate zero fill
    mask9 = act[:, None].expand(n, 9)
    library = {
        "compact": median_ms(lambda: src[act]),
        "expand": median_ms(lambda: torch.zeros(
            (n, 9), device=device).masked_scatter_(mask9, child)),
    }
    # bytes the function must move: each input once, each output once
    nbytes = {"compact": n * 6 * 4 + n + b0 * 6 * 4,
              "expand": b0 * 9 * 4 + n + n * 9 * 4}
    out = {}
    for k, (kern, plain) in timing.items():
        bound = nbytes[k] / HBM_BYTES_PER_S * 1e3
        log("kernels", f"{k}_rows N={n} B={b0} p=0.5: kernel "
            f"{kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
            f"library {library[k] * 1e3:.1f} us (median of 30); bound "
            f"{bound * 1e3:.2f} us ({nbytes[k]} B at 3.35 TB/s)")
        out[k] = {"max_abs_err": err[k], "ms": kern, "plain_ms": plain,
                  "bound_ms": bound, "bound_by": "bytes",
                  "library_ms": library[k]}
    return out


def compact_device_ms(device, n0, b0, event_ms):
    """The compaction's device time per call at the level-0 shape, from
    torch.profiler. The event time also holds the wrapper's host work
    (allocation, ctypes) whenever the card waits for it. Run after every
    wall-clock phase: once the profiler has run, launches cost more."""
    g = torch.Generator(device=device).manual_seed(3)
    n = 2 * n0
    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device)
    ms = profiled_ms(lambda: compact.compact_rows_cuda(src, act, b0,
                                                       FILL_ROW))
    log("kernels", f"compact_rows N={n} B={b0} p=0.5: device {ms * 1e3:.2f} "
        f"us a call (profiler, 20 calls) beside the event time "
        f"{event_ms * 1e3:.1f} us")
    return ms


def frame(device, compaction="auto", stats=None, scene=None):
    scene = glass_spheres(W, H) if scene is None else scene
    cam = scene.camera
    t0 = time.perf_counter()
    canvas = render_scene(scene, dtype=torch.float32, device=device,
                          chunk_pixels=cam.width * cam.height,
                          compaction=compaction, stats=stats)
    torch.cuda.synchronize()
    return canvas, time.perf_counter() - t0


def check_strip(device, scene=None, phase="equal"):
    """800x16 strip: trace_bucketed == the unrolled trace, bit for bit."""
    scene = glass_spheres(W, H) if scene is None else scene
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
    log(phase, f"{scene.camera.width}x16 strip: trace_bucketed vs trace "
        f"bitwise={same} max_abs_diff={diff} overflow={bool(ovf)} "
        f"buckets={buckets}")
    if bool(ovf) or not same:
        raise AssertionError("bucketed strip differs from the unrolled trace")


# ---------------------------------------------------------------------------
# the mesh slice
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_mesh():
    """Route the mesh queries of CUDA tensors to their plain versions, so
    a frame can be held against the kernel frame."""
    saved = mesh.closest_cuda, mesh.shadow_cuda
    mesh.closest_cuda, mesh.shadow_cuda = mesh.closest_plain, mesh.shadow_plain
    try:
        yield
    finally:
        mesh.closest_cuda, mesh.shadow_cuda = saved


def build_soup(device, n_tri=512 * 1024, n_rays=16384):
    """tools/bench_mesh_stream.py's soup and rays from the same seeds:
    64-triangle clusters along a coarse grid walk, rays between random
    points of the grid."""
    c = 64
    nc = n_tri // c
    rng = np.random.default_rng(0)
    g = max(2, int(round(nc ** (1 / 3))))
    idx = np.arange(nc)
    centers = np.stack([idx % g, (idx // g) % g, idx // (g * g)],
                       -1).astype(np.float32)
    centers += rng.normal(0, 0.1, centers.shape)
    base = centers[:, None, :] + rng.normal(0, 0.25, (nc, c, 3))
    p1 = base.reshape(-1, 3).astype(np.float32)
    e1 = rng.normal(0, 0.2, (nc * c, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.2, (nc * c, 3)).astype(np.float32)
    v = np.stack([p1, p1 + e1, p1 + e2], 1)
    meta = SceneMeta(n_triangles=nc * c, use_clusters=True, n_clusters=nc,
                     cluster_size=c)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ir = SceneIR(meta=meta, tri_p1=t(p1), tri_e1=t(e1), tri_e2=t(e2),
                 cluster_min=t(v.reshape(nc, c * 3, 3).min(1)),
                 cluster_max=t(v.reshape(nc, c * 3, 3).max(1)))
    extent = float(centers.max())
    rng = np.random.default_rng(1)
    o = rng.uniform(-2, extent + 2, (n_rays, 3)).astype(np.float32)
    tgt = rng.uniform(0, extent, (n_rays, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ir, t(o), t(d)


def mesh_bound(m, orig, dirs, aux_bytes):
    """Least time of a mesh query on these inputs, two ways. Bytes: rays,
    planes and boxes read once, t and index written once, at 3.35 TB/s.
    Float32 operations at 67 TFLOP/s: the flat walk's — every (ray,
    supercluster) slab test, and a Möller-Trumbore for each of the 128
    triangles behind every test that passes — and the passed pairs'
    alone, the least work any implementation of the contract does.
    Returns (flat ms, bound_by, flat ops, pairs ms, passed pairs)."""
    n, nsc = orig.shape[0], m.box_min.shape[0]
    rows = max(1, (1 << 22) // nsc)
    passed = sum(int(mesh.cluster_mask(m.box_min, m.box_max, orig[r:r + rows],
                                       dirs[r:r + rows]).sum())
                 for r in range(0, n, rows))
    pair_ops = passed * mesh.SC * MT_OPS
    ops = n * nsc * SLAB_OPS + pair_ops
    nbytes = (n * 6 + m.tris.numel() + 6 * nsc) * 4 + n * 8 \
        + aux_bytes * nsc * mesh.SC
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    t_pairs = max(pair_ops / FP32_OPS_PER_S, t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops,
            t_pairs * 1e3, passed)


def _equal_outputs(got, want):
    """Bitwise equality of two output tuples; max |difference| of the
    finite float values (inf == inf counts as equal)."""
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = 0.0
    for g, w in zip(got, want):
        if g.is_floating_point():
            fin = torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return same, err


def mesh_level0(device):
    """The mesh frame's tables, its primary rays (o, d) and its level-0
    shadow rays (so, sd): from the shading points toward the light, dead
    lanes parked as the integrator parks them."""
    scene = mesh_torus(MW, MH)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    comps = prepare_computations(ir, rt, o, d)
    so, sd = neutralize_rays(
        comps.over_point,
        normalize(ir.light_points[0, 0][None] - comps.over_point),
        comps.valid)
    return ir, rt.mesh, o, d, so, sd


def check_mesh_kernels(device):
    """Each mesh kernel against its plain version, bit for bit, over the
    case grid; returns per-kernel results at the level-0 shape."""
    ir, m, o, d, so, sd = mesh_level0(device)
    g = torch.Generator(device=device).manual_seed(2)
    keep = mesh.pack_plane(torch.rand(ir.tri_p1.shape[0], generator=g,
                                      device=device) < 0.5, False)
    dead = torch.arange(o.shape[0], device=device) % 7 == 0
    od = torch.where(dead[:, None], 1e30, o)
    dd = torch.where(dead[:, None], 1.0, d)
    rows = torch.cat([o, d], -1)               # strided (R, 3) views
    srows = torch.cat([so, sd], -1)
    sod = torch.where(dead[:, None], 1e30, so)
    sdd = torch.where(dead[:, None], 1.0, sd)
    m64 = m._replace(**{k: getattr(m, k).double() for k in (
        "tris", "box_min", "box_max", "group_min", "group_max", "root_min",
        "root_max")})
    n = o.shape[0]
    # the probe's in-frame shape: its bucket of PROBE_CEILING x the primary
    # rays, the live rays first and FILL_ROW past them, as strided views
    nprobe = int(np.ceil(n * PROBE_CEILING / 256.0)) * 256
    probe = torch.tensor(FILL_ROW, device=device).repeat(nprobe, 1)
    probe[:n] = rows
    sprobe = probe.clone()
    sprobe[:n] = srows
    all_dead = torch.tensor(FILL_ROW, device=device).repeat(16384, 1)
    cases = [
        ("closest f32", "closest", m, o, d, None),
        ("closest f32 keep", "closest", m, o, d, keep),
        ("closest ragged", "closest", m, o[:n - 333], d[:n - 333], None),
        ("closest dead lanes", "closest", m, od, dd, None),
        ("closest strided", "closest", m, rows[:, :3], rows[:, 3:], None),
        ("closest f64", "closest", m64, o.double(), d.double(), None),
        ("closest f64 keep", "closest", m64, o.double(), d.double(), keep),
        ("closest probe shape", "closest", m, probe[:, :3], probe[:, 3:],
         None),
        ("closest all dead", "closest", m, all_dead[:, :3], all_dead[:, 3:],
         None),
        ("closest all dead f64 ragged", "closest", m64,
         all_dead[:999, :3].double(), all_dead[:999, 3:].double(), None),
        ("shadow f32", "shadow", m, so, sd, None),
        ("shadow ragged", "shadow", m, so[:n - 333], sd[:n - 333], None),
        ("shadow f64", "shadow", m64, so.double(), sd.double(), None),
        ("shadow dead lanes", "shadow", m, sod, sdd, None),
        ("shadow strided", "shadow", m, srows[:, :3], srows[:, 3:], None),
        ("shadow probe shape", "shadow", m, sprobe[:, :3], sprobe[:, 3:],
         None),
        ("shadow all dead", "shadow", m, all_dead[:, :3], all_dead[:, 3:],
         None),
        ("shadow all dead f64 ragged", "shadow", m64,
         all_dead[:999, :3].double(), all_dead[:999, 3:].double(), None),
    ]
    sir, sorig, sdirs = build_soup(device)
    smesh = mesh.pack(sir, torch.randperm(sir.tri_p1.shape[0], generator=g,
                                          device=device),
                      torch.rand(sir.tri_p1.shape[0], generator=g,
                                 device=device) < 0.7)
    skeep = mesh.pack_plane(torch.rand(sir.tri_p1.shape[0], generator=g,
                                       device=device) < 0.5, False)
    smesh64 = smesh._replace(**{k: getattr(smesh, k).double() for k in (
        "tris", "box_min", "box_max", "group_min", "group_max", "root_min",
        "root_max")})
    # every rank equal: the casting t decides across superclusters and
    # across the parts of the split
    sequal = mesh.pack(sir, torch.zeros(sir.tri_p1.shape[0],
                                        dtype=torch.int32, device=device),
                       torch.rand(sir.tri_p1.shape[0], generator=g,
                                  device=device) < 0.7)
    cases += [("soup closest", "closest", smesh, sorig, sdirs, None),
              ("soup closest keep ragged", "closest", smesh, sorig[:-77],
               sdirs[:-77], skeep),
              ("soup shadow", "shadow", smesh, sorig, sdirs, None),
              ("soup shadow ragged", "shadow", smesh, sorig[:-77],
               sdirs[:-77], None),
              ("soup shadow f64", "shadow", smesh64, sorig.double(),
               sdirs.double(), None),
              ("soup shadow equal ranks", "shadow", sequal, sorig, sdirs,
               None)]
    fns = {"closest": (mesh.closest_cuda, mesh.closest_plain),
           "shadow": (mesh.shadow_cuda, mesh.shadow_plain)}
    err = {"closest": 0.0, "shadow": 0.0}
    for name, kind, mm, oo, dd_, kp in cases:
        kern, plain = fns[kind]
        args = (mm, oo, dd_) + ((kp,) if kind == "closest" else ())
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        same, e = _equal_outputs(got, want)
        hits = int(torch.isfinite(want[0] if kind == "closest"
                                  else want[1]).sum())
        err[kind] = max(err[kind], e)
        log("mesh-kernels", f"{name}: rays={oo.shape[0]} "
            f"triangles={mm.tris.shape[1] * mesh.SC} {oo.dtype} hits={hits} "
            f"equal={same}")
        if not same:
            raise AssertionError(f"mesh kernel != plain in case {name}")

    out = {}
    # aux bytes per triangle: the shadow query reads rank (4) and cast (1)
    for kind, (mm, oo, dd_, aux), label in (
            ("closest", (m, o, d, 0), "level 0"),
            ("shadow", (m, so, sd, 5), "level 0"),
            ("probe closest", (m, probe[:, :3], probe[:, 3:], 0),
             "probe shape"),
            ("soup closest", (smesh, sorig, sdirs, 0), "512k soup"),
            ("soup shadow", (smesh, sorig, sdirs, 5), "512k soup")):
        kern, plain = fns[kind.split()[-1]]
        ms = median_ms(lambda: kern(mm, oo, dd_), reps=20)
        plain_ms = median_ms(lambda: plain(mm, oo, dd_), reps=3)
        bound, by, ops, bound_pairs, passed = mesh_bound(mm, oo, dd_, aux)
        log("mesh-kernels", f"{kind} {label} ({oo.shape[0]} rays x "
            f"{mm.tris.shape[1] * mesh.SC} triangles): kernel {ms:.3f} ms "
            f"(median of 20), plain {plain_ms:.3f} ms (median of 3); bound "
            f"{bound:.4f} ms by {by} ({ops:.4g} float32 operations, "
            f"{bound / ms:.2%} of it reached); passed pairs {passed}: bound "
            f"{bound_pairs:.4f} ms ({bound_pairs / ms:.2%} reached)")
        if kind in err:
            out[kind] = {"max_abs_err": err[kind], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": None,
                         "bound_pairs_ms": bound_pairs}
    return out


def frame_shadow_calls(device, scene=None, keep=None):
    """(tables, origins, directions) of each mesh.shadow call of one warm
    frame of `scene` (mesh_torus), copied as the call received them; with
    `keep`, only the calls whose index is in it."""
    calls = []
    real = mesh.shadow_cuda
    count = [0]

    def record(m, orig, dirs):
        if keep is None or count[0] in keep:
            calls.append((m, orig.clone(), dirs.clone()))
        count[0] += 1
        return real(m, orig, dirs)

    mesh.shadow_cuda = record
    try:
        frame(device, scene=mesh_torus(MW, MH) if scene is None else scene)
    finally:
        mesh.shadow_cuda = real
    return calls


def time_frame_shadow(calls):
    """The shadow kernel on each in-frame launch's rays against its plain
    version, bit for bit, then its time (median of 20 events) beside the
    launch's two bounds; returns the sums."""
    tot = {"ms": 0.0, "bound_ms": 0.0, "bound_pairs_ms": 0.0}
    for i, (m, o, d) in enumerate(calls):
        same, _ = _equal_outputs(mesh.shadow_cuda(m, o, d),
                                 mesh.shadow_plain(m, o, d))
        if not same:
            raise AssertionError(f"mesh shadow != plain on launch {i} of "
                                 "the frame")
        ms = median_ms(lambda: mesh.shadow_cuda(m, o, d), reps=20)
        bound, by, ops, bound_pairs, passed = mesh_bound(m, o, d, 5)
        live = int((o[:, 0] < 1e29).sum())
        log("mesh-frame", f"shadow launch {i}: {o.shape[0]} rays ({live} "
            f"live): equal=True; kernel {ms:.3f} ms (median of 20); bound "
            f"{bound:.4f} ms by {by} ({bound / ms:.2%} reached); passed "
            f"pairs {passed}: "
            f"bound {bound_pairs:.4f} ms ({bound_pairs / ms:.2%} reached)")
        for k, v in (("ms", ms), ("bound_ms", bound),
                     ("bound_pairs_ms", bound_pairs)):
            tot[k] += v
    log("mesh-frame", f"shadow, the frame's {len(calls)} launches: "
        f"{tot['ms']:.3f} ms in all; bounds {tot['bound_ms']:.4f} ms (flat "
        f"walk), {tot['bound_pairs_ms']:.4f} ms (passed pairs)")
    return tot


def check_mesh_strip(device, glass=False, scene=None, label=None,
                     phase="mesh-equal"):
    """A 16-row strip through the middle of `scene` (mesh_torus, opaque or
    glass): the kernel frame against the plain-mesh frame, and
    trace_bucketed against the unrolled trace, bit for bit."""
    if scene is None:
        scene = mesh_torus(MW, MH, glass=glass)
        label = f"{MW}x16 strip {'glass' if glass else 'opaque'}"
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    depth = scene.config.di_path_length
    h = scene.camera.height
    o, d = pixel_rays(scene, device, rows=(h // 2 - 8, h // 2 + 8))
    counts = torch.stack(spawn_counts(ir, rt, o, d, depth)).tolist()
    buckets = [max(64, -(-int(c * 1.25) // 64) * 64) for c in counts]
    got, ovf = trace_bucketed(ir, rt, o, d, depth, buckets)
    with plain_mesh():
        plain, ovf_p = trace_bucketed(ir, rt, o, d, depth, buckets)
    exact = trace(ir, rt, o, d, depth)
    same_p = all(torch.equal(x, y) for x, y in zip(got, plain))
    same_e = all(torch.equal(x, y) for x, y in zip(got, exact))
    log(phase, f"{label}: "
        f"kernel vs plain-mesh bitwise={same_p}, trace_bucketed vs trace "
        f"bitwise={same_e}, overflow={bool(ovf) or bool(ovf_p)} "
        f"buckets={buckets}")
    if bool(ovf) or bool(ovf_p) or not (same_p and same_e):
        raise AssertionError("mesh strip differs")


def render_mesh(device, reps):
    """The mesh main path, counted: every kernel must launch."""
    scene = mesh_torus(MW, MH)
    for counts in (compact.LAUNCHES, mesh.LAUNCHES):
        for k in counts:
            counts[k] = 0
    stats = {}
    canvas, cold = frame(device, stats=stats, scene=scene)
    launches = {**compact.LAUNCHES, **mesh.LAUNCHES}
    log("mesh-render", f"{MW}x{MH} depth 5 float32: launches {launches}, "
        f"buckets "
        f"{stats['buckets']}, escalations {stats['escalations']}, exact "
        f"chunks {stats['exact_chunks']}, first call {cold:.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the mesh path never ran: "
                             f"{launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    if canvas.shape != (MH, MW, 3) or not np.isfinite(canvas).all():
        raise AssertionError("mesh canvas not finite or of the wrong shape")
    walls = [frame(device, scene=scene)[1] for _ in range(reps)]
    wall = statistics.median(walls)
    # the host's share of the wall: compile_scene runs in every frame
    compiles = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ir = compile_scene(scene, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        compiles.append(time.perf_counter() - t0)
    # traced rays: the primary rays and every spawned child, each with one
    # shadow ray per light (the probe's exact per-level counts)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    spawned = torch.stack(spawn_counts(ir, rt, o, d,
                                       scene.config.di_path_length)).tolist()
    traced = (MW * MH + sum(spawned)) * (1 + ir.meta.n_lights)
    log("mesh-render", f"warm wall {wall:.4f} s (median of {walls}), "
        f"{MW * MH / wall:.4g} pixels/s, {traced / wall:.4g} traced rays/s "
        f"({traced} rays: spawn counts {spawned}, one shadow ray per lane); "
        f"compile_scene alone {statistics.median(compiles):.4f} s (median "
        f"of {compiles})")
    return canvas, launches, wall


# ---------------------------------------------------------------------------
# the scene-language slice
# ---------------------------------------------------------------------------

# card against CPU, float64, showcase 64x32: the largest per-channel
# difference allowed. Both devices run the same torch program, but the
# card's elementwise kernels contract multiply-adds (FMA) and its atan2,
# acos, cos and pow may round an ulp away from the CPU's; measured on an
# NVIDIA H100 80GB HBM3 (700.00 W): at most 1.5e-13, a third of the
# pixels bitwise equal, none past 1e-12 (PERF.md, section 6). The
# bound is the CPU tests' bound against the JAX package.
CARD_CPU_ATOL = 1e-9


def render_showcase(device, reps):
    """The showcase main path, counted: both compaction kernels must
    launch; then the warm wall and the plain-compaction frame, bit for
    bit."""
    scene = primitives_showcase(W, H)
    compact.LAUNCHES.update(compact=0, expand=0)
    stats = {}
    canvas, cold = frame(device, stats=stats, scene=scene)
    launches = dict(compact.LAUNCHES)
    log("showcase", f"{W}x{H} depth 5 float32: launches {launches}, "
        f"buckets {stats['buckets']}, escalations {stats['escalations']}, "
        f"exact chunks {stats['exact_chunks']}, first call {cold:.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the showcase path never ran: "
                             f"{launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    if canvas.shape != (H, W, 3) or not np.isfinite(canvas).all():
        raise AssertionError("showcase canvas not finite or of the wrong "
                             "shape")
    walls = [frame(device, scene=scene)[1] for _ in range(reps)]
    wall = statistics.median(walls)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    spawned = torch.stack(spawn_counts(ir, rt, o, d,
                                       scene.config.di_path_length)).tolist()
    traced = (W * H + sum(spawned)) * (1 + ir.meta.n_lights)
    log("showcase", f"warm wall {wall:.4f} s (median of {walls}), "
        f"{W * H / wall:.4g} pixels/s, {traced / wall:.4g} traced rays/s "
        f"({traced} rays: spawn counts {spawned}, one shadow ray per lane)")
    plain, _ = frame(device, compaction="plain", scene=scene)
    same = torch.equal(torch.from_numpy(canvas), torch.from_numpy(plain))
    log("showcase-equal", f"kernel frame vs plain-compaction frame "
        f"bitwise={same}")
    if not same:
        raise AssertionError("showcase kernel frame differs from the plain "
                             "frame")
    return canvas, launches, wall


def check_card_vs_cpu(device, w=64, h=32):
    """The showcase at w x h in float64 through trace_bucketed on the card
    and on the CPU (one torch thread), every level in the probe's bucket;
    the canvases within CARD_CPU_ATOL."""
    scene = primitives_showcase(w, h)
    depth = scene.config.di_path_length
    buckets = [int(np.ceil(w * h * PROBE_CEILING / 256.0)) * 256] * depth
    canvases = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dev in (device, torch.device("cpu")):
            ir = compile_scene(scene, dtype=torch.float64, device=dev)
            rt = build_statics(ir, scene.config)
            o, d = pixel_rays(scene, dev, dtype=torch.float64)
            tr, ovf = trace_bucketed(ir, rt, o, d, depth, buckets)
            if bool(ovf):
                raise AssertionError("card-vs-CPU strip overflowed")
            canvases[dev.type] = ((tr.a + tr.d + tr.s) / 3.0).cpu().numpy()
    finally:
        torch.set_num_threads(threads)
    diff = np.abs(canvases["cuda"] - canvases["cpu"]).max(-1)
    log("card-vs-cpu", f"showcase {w}x{h} float64: max |card - cpu| "
        f"{diff.max():.3e}; pixels past 1e-6: {(diff > 1e-6).mean():.4%}, "
        f"past 1e-9: {(diff > 1e-9).mean():.4%}, past 1e-12: "
        f"{(diff > 1e-12).mean():.4%}, bitwise equal "
        f"{(diff == 0).mean():.4%}; tolerance {CARD_CPU_ATOL}")
    if not diff.max() <= CARD_CPU_ATOL:
        raise AssertionError("card and CPU canvases differ past "
                             f"{CARD_CPU_ATOL}")


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

# The tables Adam updates in the 800x400 steps (at the default rate); the
# backward covers every float table, the others take a rate of 0. The
# reference's shading is discontinuous in some tables at their starting
# values: an opaque material has mat_Tr = 0, and any Tr > 0 switches on
# the dissolve multiply (combine_specular), scaling its surface by Tr. A
# first Adam step moves every entry by about the rate whatever its
# gradient, so with every table updated (at 1e-3) the loss went 0.00464
# -> 0.0131 on the card in this phase's first version.
TRAIN_TABLES = ("mat_Ka", "mat_Kd", "mat_Ks", "mat_refl", "mat_Tf",
                "light_intensity")
# float32 on the card, an 800x16 strip: each field's gradient sums up to
# ~25,000 lane terms, in another order through the bucketed trace than
# through the unrolled one (and through atomics in autograd's scatter-adds
# of the table gathers): within this share of the field's largest |g|
TRAIN_STRIP_RTOL = 1e-4
# float64, 24x12, the card against the CPU: the bound of the CPU tests
# against the JAX package (the card contracts multiply-adds)
TRAIN_CARD_CPU_RTOL = 1e-9


class TrainSet:
    """glass_spheres' rows [y0, y1) as one batch for the train step, on
    `device` in `dtype`: the scene split into parameters, buckets from one
    spawn-count probe at 1.2x margin, and the target frame rendered with
    mat_Kd scaled by 0.6."""

    def __init__(self, device, dtype=torch.float32, w=W, h=H, rows=None):
        scene = glass_spheres(w, h)
        y0, y1 = rows or (0, h)
        self.ir = compile_scene(scene, dtype=dtype, device=device)
        self.rt = build_statics(self.ir, scene.config)
        self.cam = build_camera(scene.camera, dtype=dtype, device=device)
        self.depth = scene.config.di_path_length
        py = torch.arange(y0, y1, device=device).repeat_interleave(w)
        px = torch.arange(w, device=device).repeat(y1 - y0)
        n = px.shape[0]
        uv = torch.as_tensor(cmj_points_static(1, 1), dtype=dtype) \
            .to(device).expand(n, 2)
        self.args = (px, py, uv, torch.zeros((n, 2), dtype=dtype,
                                             device=device))
        counts = spawn_counts(self.ir, self.rt, *rays_for_pixels(
            self.cam, *self.args), self.depth)
        self.counts = torch.stack(counts).tolist()
        self.buckets = quantize_buckets(self.counts, 1.2)
        self.params, self.static = split_params(self.ir)
        scaled = dict(self.params)
        scaled["mat_Kd"] = self.params["mat_Kd"].detach() * 0.6
        with torch.no_grad():
            self.target, ovf = pixel_colors(
                merge_params(scaled, self.static), self.rt, self.cam,
                *self.args, 1, self.depth, buckets=self.buckets)
        if bool(ovf):
            raise AssertionError("the target frame overflowed its buckets")

    def fresh(self):
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in self.params.items()}

    def grads(self, **kw):
        """{key: gradient} of the MSE at the starting parameters."""
        params = self.fresh()
        img, ovf = pixel_colors(merge_params(params, self.static), self.rt,
                                self.cam, *self.args, 1, self.depth, **kw)
        if bool(ovf):
            raise AssertionError("a gradient frame overflowed its buckets")
        loss = torch.mean((img - self.target) ** 2)
        keys = [k for k, v in params.items() if v.numel()]
        gs = torch.autograd.grad(loss, [params[k] for k in keys],
                                 allow_unused=True)
        return {k: torch.zeros_like(params[k]) if g is None else g
                for k, g in zip(keys, gs)}


def train_steps(device, reps, remat, rows=None):
    """One warm-up and `reps` timed Adam steps over every parameter, the
    whole batch at once: per-step wall (forward, backward and update),
    peak device memory, each step's loss (finite and falling), no
    overflow, and the compaction launches of the warm-up step's forward
    and backward apart (every count > 0 in the backward)."""
    ts = TrainSet(device, rows=rows)
    params = ts.fresh()
    groups = [{"params": [params[k] for k in TRAIN_TABLES]},
              {"params": [p for k, p in params.items()
                          if k not in TRAIN_TABLES], "lr": 0.0}]
    init, step = make_train_step(ts.rt, ts.cam, ts.static, 1, ts.depth,
                                 remat=remat, buckets=ts.buckets,
                                 optimizer=lambda ps: adam(groups))
    state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fwd = {}
    compact.LAUNCHES.update(compact=0, expand=0)
    mesh.LAUNCHES.update(mesh_closest=0, mesh_shadow=0)
    state, loss, ovf = step(state, *ts.args, ts.target,
                            between=lambda: fwd.update(compact.LAUNCHES))
    torch.cuda.synchronize()
    total = dict(compact.LAUNCHES)
    bwd = {k: total[k] - fwd[k] for k in total}
    if any(mesh.LAUNCHES.values()):
        raise AssertionError(f"mesh kernels ran in training: {mesh.LAUNCHES}")
    losses, ovfs, times = [loss], [ovf], []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, loss, ovf = step(state, *ts.args, ts.target)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        ovfs.append(ovf)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    losses = [float(x) for x in losses]
    ms = statistics.median(times) * 1e3
    w, h = W, (rows[1] - rows[0]) if rows else H
    log("train", f"{w}x{h} depth 5 float32 remat={remat!r}: buckets "
        f"{ts.buckets} (spawn counts {ts.counts}); one step's forward "
        f"launches {fwd}, backward {bwd}; step (forward, backward over "
        f"{len(params)} tables, Adam on {len(TRAIN_TABLES)}) {ms:.1f} ms "
        f"(median of "
        f"{[round(t * 1e3, 1) for t in times]}); peak device memory "
        f"{peak:.3f} GiB; losses {losses}; overflow "
        f"{[bool(x) for x in ovfs]}")
    if any(bool(x) for x in ovfs):
        raise AssertionError("a train step overflowed its buckets")
    if min(bwd.values()) < 1 or min(fwd.values()) < 1:
        raise AssertionError(f"a compaction kernel did not run: forward "
                             f"{fwd}, backward {bwd}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"losses not finite and falling: {losses}")
    return {"ms": ms, "peak_gib": peak, "fwd": fwd, "bwd": bwd,
            "losses": losses}


def profile_train_step(device, step_ms, remat="level"):
    """One profiled warm train step at 800x400: device events, device busy
    time, idle share against the unprofiled step's wall, and the top
    operators by device time."""
    from torch.profiler import ProfilerActivity, profile
    ts = TrainSet(device)
    init, step = make_train_step(ts.rt, ts.cam, ts.static, 1, ts.depth,
                                 remat=remat, buckets=ts.buckets)
    state = init(ts.fresh())
    step(state, *ts.args, ts.target)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *ts.args, ts.target)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    kernels, copies, busy, top = profile_summary(prof)
    wall = step_ms / 1e3
    log("train-profile", f"one warm step remat={remat!r}: {kernels} kernel "
        f"launches and {copies} copies/memsets; profiled wall {t:.4f} s, "
        f"device busy {busy:.4f} s; unprofiled step {wall:.4f} s -> device "
        f"idle share {1 - busy / wall:.3f}; top operators by device time: "
        f"{top}")


def _grad_diff(got, want, rows_out=None):
    """max |got - want| / max |want| over each field (rows_out: per key, a
    row mask to leave out)."""
    out = {}
    for k, w in want.items():
        g = got[k]
        if rows_out and k in rows_out:
            g, w = g[~rows_out[k]], w[~rows_out[k]]
        scale = float(w.abs().max()) if w.numel() else 0.0
        diff = float((g - w).abs().max()) if w.numel() else 0.0
        out[k] = diff / scale if scale else diff
    return out


def check_train_strip(device):
    """800x16 strip, float32: the gradients with the CUDA compaction
    against those with the plain one (bitwise with deterministic
    algorithms; within TRAIN_STRIP_RTOL with autograd's atomics), and the
    bucketed against the unrolled trace's, but for the rows the value
    gates prune (all-zero Tf: subgradient 0 bucketed)."""
    ts = TrainSet(device, rows=(H // 2 - 8, H // 2 + 8))
    kern = ts.grads(buckets=ts.buckets)
    plain = ts.grads(buckets=ts.buckets, compaction="plain")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kern_d = ts.grads(buckets=ts.buckets)
        plain_d = ts.grads(buckets=ts.buckets, compaction="plain")
    finally:
        torch.use_deterministic_algorithms(False)
    unrolled = ts.grads()
    same_d = all(torch.equal(kern_d[k], plain_d[k]) for k in kern_d)
    same = all(torch.equal(kern[k], plain[k]) for k in kern)
    d_plain = max(_grad_diff(kern, plain).values())
    zero_tf = ~(ts.ir.mat_Tf != 0.0).any(-1)
    zero_rf = ~(ts.ir.mat_refl != 0.0).any(-1)
    d_unrolled = _grad_diff(kern, unrolled,
                            {"mat_Tf": zero_tf, "mat_refl": zero_rf})
    worst = max(d_unrolled, key=d_unrolled.get)
    pruned_zero = bool((kern["mat_Tf"][zero_tf] == 0.0).all())
    log("train-equal", f"{W}x16 strip float32, buckets {ts.buckets}: kernel "
        f"vs plain-compaction gradients bitwise={same} (largest share of a "
        f"field's max |g| {d_plain:.3e}), with deterministic algorithms "
        f"bitwise={same_d}; bucketed vs unrolled largest share "
        f"{d_unrolled[worst]:.3e} ({worst}), pruned mat_Tf rows zero="
        f"{pruned_zero}")
    if not same_d or d_plain > TRAIN_STRIP_RTOL:
        raise AssertionError("kernel gradients differ from the plain ones")
    if d_unrolled[worst] > TRAIN_STRIP_RTOL or not pruned_zero:
        raise AssertionError("bucketed gradients differ from the unrolled")


def check_train_card_vs_cpu(device, w=24, h=12):
    """24x12 in float64, bucketed with remat="level": each field's
    gradient on the card within TRAIN_CARD_CPU_RTOL of its largest |g| on
    the CPU."""
    card = TrainSet(device, torch.float64, w, h)
    cpu = TrainSet(torch.device("cpu"), torch.float64, w, h)
    got = card.grads(buckets=cpu.buckets, remat="level")
    want = cpu.grads(buckets=cpu.buckets, remat="level")
    diff = _grad_diff({k: v.cpu() for k, v in got.items()}, want)
    worst = max(diff, key=diff.get)
    log("train-card-cpu", f"{w}x{h} float64 gradients, {len(diff)} fields: "
        f"largest share of a field's max |g| {diff[worst]:.3e} ({worst}); "
        f"bound {TRAIN_CARD_CPU_RTOL}")
    if diff[worst] > TRAIN_CARD_CPU_RTOL:
        raise AssertionError("card gradients differ from the CPU's")


# ---------------------------------------------------------------------------
# the scene-frontend slice
# ---------------------------------------------------------------------------

# card against CPU, float64, soft_textured 64x32: every pixel within
# CARD_CPU_ATOL except pixels where a texture lookup took another texel on
# the card than on the CPU (a uv an ulp across a texel edge moves the
# whole texel); those are counted and must stay under this share of the
# frame.
TEXEL_FLIP_SHARE = 0.005
# device memory a soft_textured frame in one chunk at the renderer's
# SHADOW_RAYS_PER_CHUNK may peak at (it measured 7.767 GiB on an NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md, section 5)
PEAK_MEMORY_BUDGET = 16 << 30


def time_texture_reads(reps=5):
    """Host time (median of reps) of reading each of soft_textured's
    textures, and a 1024x1024 8-bit RGB PNG of smooth seeded content whose
    rows take the filter libpng would choose, which must read back bit
    for bit. Returns {file: ms}."""
    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:1024, 0:1024]
    img = (128.0 + 60.0 * np.sin(x / 37.0 + y / 53.0)[..., None]
           * np.array([1.0, 0.8, 0.6]) + 40.0 * np.cos(x / 91.0 - y / 29.0)
           [..., None] + rng.normal(0.0, 3.0, (1024, 1024, 3)))
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    big = os.path.join(OUT_DIR, "texture_1024.png")
    with open(big, "wb") as f:
        f.write(encode_png(img, adaptive=True))
    files = [str(SOFT_DIR / n) for n in ("stone.png", "stone_bump.png",
                                         "floor.ppm")] + [big]
    ms = {}
    for path in files:
        reader = read_ppm if path.endswith(".ppm") else read_png
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = reader(path)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[os.path.basename(path)] = statistics.median(times)
    if not np.array_equal(np.round(got * 255.0), img):
        raise AssertionError("the 1024x1024 PNG did not read back")
    log("soft-textures", "host read times, median of "
        f"{reps} (ms): {ms}; the 1024x1024 PNG read back bitwise")
    return ms


def soft_counts():
    """The launch counters of every kernel of the path, zeroed."""
    for counts in (compact.LAUNCHES, mesh.LAUNCHES):
        for k in counts:
            counts[k] = 0


def render_soft(device, reps):
    """The frontend main path through the command line, counted: every
    kernel must launch. Then the warm wall (median of reps), peak memory,
    the PPM's hash against the kernel frame's encode, the PNG read back
    bitwise, and the frame at the chunk cap against the memory budget."""
    scene = soft_textured(W, H)
    yml = str(SOFT_DIR / "soft_textured.yml")
    os.makedirs(OUT_DIR, exist_ok=True)
    stem = os.path.join(OUT_DIR, "soft_textured")
    argv = [yml, "-o", stem, "--chunk", str(W * H), "--quiet"]
    soft_counts()
    stats = {}
    t0 = time.perf_counter()
    cli_main(argv, stats=stats)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {**compact.LAUNCHES, **mesh.LAUNCHES}
    log("soft-frame", f"{W}x{H} depth 5 float32 through the command line: "
        f"launches {launches}, buckets {stats['buckets']}, escalations "
        f"{stats['escalations']}, exact chunks {stats['exact_chunks']}, "
        f"first call {cold:.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the frontend path never ran: "
                             f"{launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    walls = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    wall = statistics.median(walls)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    spawned = torch.stack(spawn_counts(ir, rt, o, d,
                                       scene.config.di_path_length)).tolist()
    # every lane casts one shadow ray to each sample of each light
    samples = sum(info[4] for info in ir.meta.light_info)
    traced = (W * H + sum(spawned)) * (1 + samples)
    log("soft-frame", f"warm wall {wall:.4f} s (median of {walls}; load, "
        f"compile, render, both files), {W * H / wall:.4g} pixels/s, "
        f"{traced / wall:.4g} traced rays/s ({traced} rays: spawn counts "
        f"{spawned}, {samples} shadow rays per lane); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    canvas, _ = frame(device, scene=scene)
    if canvas.shape != (H, W, 3) or not np.isfinite(canvas).all():
        raise AssertionError("soft canvas not finite or of the wrong shape")
    with open(stem + ".ppm", "rb") as f:
        ppm = f.read()
    png = np.round(read_png(stem + ".png") * 65535.0)
    same_ppm = ppm == construct_ppm(canvas)
    same_png = np.array_equal(png, png16(canvas))
    log("soft-frame", f"{stem}.ppm sha256 {hashlib.sha256(ppm).hexdigest()}"
        f"; equal to the kernel frame's encode: {same_ppm}; {stem}.png read "
        f"back bitwise equal to the frame's 16-bit encode: {same_png}")
    if not (same_ppm and same_png):
        raise AssertionError("the command line's files differ from the "
                             "frame")
    time_texture_reads()
    # the frame whose chunk reaches the cap: rays x light samples =
    # SHADOW_RAYS_PER_CHUNK, against the peak-memory budget
    cw = int(round((SHADOW_RAYS_PER_CHUNK // ir.meta.max_light_samples
                    // 2) ** 0.5))
    cap = soft_textured(2 * cw, cw)
    torch.cuda.reset_peak_memory_stats(device)
    frame(device, scene=cap)
    cap_peak = torch.cuda.max_memory_allocated(device)
    log("soft-frame", f"{2 * cw}x{cw} frame in one chunk "
        f"({2 * cw * cw * ir.meta.max_light_samples} rays x light samples, "
        f"the cap {SHADOW_RAYS_PER_CHUNK}): peak device memory "
        f"{cap_peak / 2**30:.3f} GiB, budget "
        f"{PEAK_MEMORY_BUDGET / 2**30:.0f} GiB")
    if cap_peak > PEAK_MEMORY_BUDGET:
        raise AssertionError("a chunk at the cap exceeds the memory budget")
    return canvas, launches, wall, {"peak": peak, "cap_peak": cap_peak,
                                    "traced": traced}


def check_soft_equal(device, canvas):
    """The kernel frame against the plain-compaction frame; a strip against
    the plain mesh queries and the unrolled trace; all bit for bit."""
    scene = soft_textured(W, H)
    plain, _ = frame(device, compaction="plain", scene=scene)
    same = np.array_equal(canvas, plain)
    log("soft-equal", f"kernel frame vs plain-compaction frame "
        f"bitwise={same}")
    if not same:
        raise AssertionError("soft kernel frame differs from the plain "
                             "frame")
    check_mesh_strip(device, scene=scene, label=f"{W}x16 strip",
                     phase="soft-equal")


def time_soft_shadow(device):
    """The area light's level-0 shadow batch (R x S rays, each origin S
    times in a row) from one warm frame: the kernel's time on all of it
    (median of 20 events) beside the bounds, and its output on the first
    262,144 rays bitwise against the plain version."""
    calls = frame_shadow_calls(device, soft_textured(W, H), keep={0})
    m, o, d = calls[0]
    n = o.shape[0]
    ms = median_ms(lambda: mesh.shadow_cuda(m, o, d), reps=20)
    head = 262144
    same, _ = _equal_outputs(mesh.shadow_cuda(m, o[:head], d[:head]),
                             mesh.shadow_plain(m, o[:head], d[:head]))
    plain_ms = median_ms(lambda: mesh.shadow_plain(m, o[:head], d[:head]),
                         reps=3)
    bound, by, ops, bound_pairs, passed = mesh_bound(m, o, d, 5)
    log("soft-shadow-kernel", f"area light, level 0: {n} rays "
        f"({n // (W * H)} per lane) x {m.tris.shape[1] * mesh.SC} triangles:"
        f" kernel {ms:.3f} ms (median of 20), {ms * 1e6 / n:.3f} ns a ray; "
        f"bound {bound:.4f} ms by {by} ({bound / ms:.2%} reached); passed "
        f"pairs {passed}: bound {bound_pairs:.4f} ms "
        f"({bound_pairs / ms:.2%} reached); first {head} rays against the "
        f"plain version ({plain_ms:.3f} ms): equal={same}")
    if not same:
        raise AssertionError("mesh shadow != plain on the S-fold batch")
    return {"soft_batch_rays": n, "soft_batch_ms": ms,
            "soft_batch_bound_ms": bound,
            "soft_batch_bound_pairs_ms": bound_pairs}


@contextlib.contextmanager
def texel_indices(out):
    """Append each texture lookup's (atlas index, lanes that use it) to
    `out` while the context is open."""
    real = patterns.texel_index

    def record(ir, pid, u, v):
        idx = real(ir, pid, u, v)
        used = ir.pat_type[pid.clamp(0, ir.meta.n_patterns - 1)] \
            == PAT_UV_TEXTURE
        out.append((idx.cpu(), used.cpu()))
        return idx

    patterns.texel_index = record
    try:
        yield
    finally:
        patterns.texel_index = real


def check_soft_card_vs_cpu(device, w=64, h=32):
    """soft_textured at w x h with a 2,048-triangle torus in float64
    through the unrolled trace (lane i of every level belongs to pixel
    i mod w*h) on the card and on the CPU (one torch thread): every pixel
    within CARD_CPU_ATOL but those where some lookup took another texel,
    which must stay under TEXEL_FLIP_SHARE."""
    scene = soft_textured(w, h, segments=(32, 32))
    depth = scene.config.di_path_length
    n = w * h
    canvases, lookups = [], []       # the card's, then the CPU's
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dev in (device, torch.device("cpu")):
            ir = compile_scene(scene, dtype=torch.float64, device=dev)
            rt = build_statics(ir, scene.config)
            o, d = pixel_rays(scene, dev, dtype=torch.float64)
            lookups.append([])
            with texel_indices(lookups[-1]):
                tr = trace(ir, rt, o, d, depth)
            canvases.append(((tr.a + tr.d + tr.s) / 3.0).cpu().numpy())
    finally:
        torch.set_num_threads(threads)
    if len(lookups[0]) != len(lookups[1]) or not lookups[0]:
        raise AssertionError("the card and the CPU made other lookups")
    flipped = np.zeros(n, bool)
    for (ia, ua), (ib, ub) in zip(*lookups):
        lane = ((ia != ib) & (ua | ub)).numpy()
        flipped[np.nonzero(lane)[0] % n] = True
    diff = np.abs(canvases[0] - canvases[1]).max(-1)
    rest = diff[~flipped]
    log("soft-card-vs-cpu", f"soft_textured {w}x{h} float64: "
        f"{len(lookups[0])} texture lookups; pixels with a texel "
        f"flipped {int(flipped.sum())} ({flipped.mean():.4%}, limit "
        f"{TEXEL_FLIP_SHARE:.1%}), their largest difference "
        f"{diff[flipped].max() if flipped.any() else 0.0:.3e}; the other "
        f"pixels: max |card - cpu| {rest.max():.3e}, past 1e-12 "
        f"{(rest > 1e-12).mean():.4%}, bitwise equal {(rest == 0).mean():.4%};"
        f" tolerance {CARD_CPU_ATOL}")
    if flipped.mean() >= TEXEL_FLIP_SHARE or not rest.max() <= CARD_CPU_ATOL:
        raise AssertionError("card and CPU soft canvases differ past the "
                             "texel-flip rule")


def profile_summary(prof):
    """(kernel launches, copies and memsets, device busy s, the top eight
    aten operators by device time as text) of a torch.profiler run."""
    from torch.autograd import DeviceType
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in dev if e.key.startswith(("Memcpy",
                                                             "Memset")))
    self_dev = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and self_dev(e) > 0),
                 key=self_dev, reverse=True)[:8]
    top = ", ".join(f"{e.key} {self_dev(e) / 1e3:.2f} ms ({e.count} calls)"
                    for e in ops)
    return (sum(e.count for e in dev) - copies, copies,
            device_us(prof) / 1e6, top)


def profile_showcase(device, wall, scene=None, phase="showcase-profile"):
    """One profiled warm frame of `scene` (primitives_showcase): its device
    events (kernels, and copies and memsets apart), device busy time, idle
    share against the unprofiled warm wall, and the top operators by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    scene = primitives_showcase(W, H) if scene is None else scene
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = frame(device, scene=scene)
    kernels, copies, busy, top = profile_summary(prof)
    log(phase, f"one warm frame: {kernels} kernel launches and "
        f"{copies} copies/memsets; profiled wall {t:.4f} s, device busy "
        f"{busy:.4f} s; unprofiled warm wall {wall:.4f} s -> device idle "
        f"share {1 - busy / wall:.3f}; top operators by device time: {top}")
    return {"launches": kernels, "busy_s": busy, "idle_share": 1 - busy / wall}


def profile_to(path, device, b0, card, wall, mesh_wall):
    """Per-kernel device times of the level-0 compaction calls (20 each)
    and of one warm frame of each render, with its device-busy share."""
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
    with profile(activities=acts) as mprof:
        _, mt = frame(device, scene=mesh_torus(MW, MH))

    busy = device_us(fprof) / 1e6
    mbusy = device_us(mprof) / 1e6
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
        f.write(f"\n\n== one warm {MW}x{MH} mesh_torus frame: profiled wall "
                f"{mt:.4f} s, device busy {mbusy:.4f} s; unprofiled warm "
                f"wall {mesh_wall:.4f} s -> device idle share "
                f"{1 - mbusy / mesh_wall:.3f} ==\n")
        f.write(mprof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=40))
    log("profile", f"frame device busy {busy:.4f} s of warm wall {wall:.4f} "
        f"s; mesh frame {mbusy:.4f} s of {mesh_wall:.4f} s; tables in {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3,
                    help="warm frames timed per render (median)")
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler's per-kernel tables of the "
                    "level-0 compaction calls and one warm frame of each "
                    "render here")
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

    # 2. build: both sources, the two nvcc runs at once
    t0 = time.perf_counter()
    libs = _build.build(*_build.CUDA_SOURCES)
    log("build", ", ".join(os.path.relpath(p) for p in libs.values())
        + f" in {time.perf_counter() - t0:.2f} s")
    for name, so in libs.items():
        report = so.with_name(so.name + ".log").read_text().splitlines()
        entry = ""
        for line in report:
            if "Compiling entry function" in line:
                entry = short_kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log("build", f"{name} {entry}: {line.strip()}")

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

    # 4. render: the flagship path, counted
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

    # 7. mesh kernels against their plain versions
    mstats = check_mesh_kernels(device)

    # 8. mesh render: the mesh path, counted
    mcanvas, mlaunches, mesh_wall = render_mesh(device, args.reps)
    calls = frame_shadow_calls(device)
    if len(calls) != mlaunches["mesh_shadow"]:
        raise AssertionError("the recorded frame made another number of "
                             "shadow calls than the counted one")
    frame_tot = time_frame_shadow(calls)
    mstats["shadow"].update(frame_ms=frame_tot["ms"],
                            frame_bound_ms=frame_tot["bound_ms"],
                            frame_bound_pairs_ms=frame_tot["bound_pairs_ms"])

    # 9. mesh equality on the card
    for glass in (False, True):
        check_mesh_strip(device, glass)

    # 10. mesh output
    ppm = construct_ppm(mcanvas)
    path = os.path.join(tempfile.gettempdir(), f"frt_mesh_torus_{MW}x{MH}.ppm")
    with open(path, "wb") as f:
        f.write(ppm)
    log("mesh-output", f"{path} sha256 {hashlib.sha256(ppm).hexdigest()}")

    # 11-12. the showcase path, counted, and its equality checks
    scanvas, slaunches, show_wall = render_showcase(device, args.reps)
    check_strip(device, primitives_showcase(W, H), phase="showcase-equal")

    # 13. card against CPU in float64
    check_card_vs_cpu(device)

    # 14. showcase output
    ppm = construct_ppm(scanvas)
    path = os.path.join(tempfile.gettempdir(),
                        f"frt_primitives_showcase_{W}x{H}.ppm")
    with open(path, "wb") as f:
        f.write(ppm)
    log("showcase-output", f"{path} sha256 {hashlib.sha256(ppm).hexdigest()}")

    # 15-18. the frontend path through the command line, counted; its
    # equality checks, the shadow kernel on the S-fold batch, and the card
    # against the CPU under the texel-flip rule
    softcanvas, softlaunches, soft_wall, soft = render_soft(device, args.reps)
    check_soft_equal(device, softcanvas)
    mstats["shadow"].update(time_soft_shadow(device))
    check_soft_card_vs_cpu(device)

    # 19-21. the training path: Adam steps at full width in both remat
    # modes, counted; the strip's gradients against the plain compaction
    # and the unrolled trace; the card against the CPU in float64
    t0 = time.perf_counter()
    tstats = {remat: train_steps(device, args.reps, remat)
              for remat in ("level", "none")}
    check_train_strip(device)
    check_train_card_vs_cpu(device)
    log("train", f"phases 19-21 took {time.perf_counter() - t0:.1f} s")

    kstats["compact"]["device_ms"] = compact_device_ms(
        device, W * H, b0, kstats["compact"]["ms"])
    profile_showcase(device, show_wall)
    profile_showcase(device, soft_wall, soft_textured(W, H), "soft-profile")
    profile_train_step(device, tstats["level"]["ms"])
    if args.profile:
        profile_to(args.profile, device, b0, f"{kind}; {smi}", wall,
                   mesh_wall)

    rows = []
    for name, key, replaces, src, count in (
            ("compact_rows", "compact",
             "fast_ray_tracer_tpu/ops/compact_pallas.py:132", SRC,
             launches["compact"]),
            ("expand_rows", "expand",
             "fast_ray_tracer_tpu/ops/compact_pallas.py:247", SRC,
             launches["expand"])):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": count,
                     "launches_showcase": slaunches[key],
                     "launches_soft": softlaunches[key],
                     "launches_train_fwd": tstats["level"]["fwd"][key],
                     "launches_train_bwd": tstats["level"]["bwd"][key],
                     **kstats[key]})
    for name, key, replaces in (
            ("mesh_closest", "closest",
             "fast_ray_tracer_tpu/ops/mesh_pallas.py:262"),
            ("mesh_shadow", "shadow",
             "fast_ray_tracer_tpu/ops/mesh_pallas.py:287")):
        rows.append({"name": name, "route": "cuda", "source": MESH_SRC,
                     "replaces": replaces,
                     "launches": mlaunches[f"mesh_{key}"],
                     "launches_soft": softlaunches[f"mesh_{key}"],
                     "launches_train_fwd": 0, "launches_train_bwd": 0,
                     **mstats[key]})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
