"""Drive the PyTorch port's main paths once on one CUDA card; check them.

    python3 chip_smoke.py [--reps N] [--profile PATH]

Phases, one line each or more:
  1. device: the card's name and power limit (nvidia-smi); exits non-zero
     without CUDA;
  2. build: builds both kernel sources of csrc/ into build/kernels/, the
     two nvcc runs at once, and prints ptxas's register and shared-memory
     report; the host C++ walks (native/) must build too, so no measured
     path falls back to the Python walks;
  3. kernels: compact_rows (C=6) and expand_rows (C=9) at the level-0 shape
     of the 800x400 frame (N = 640,000; B from the bucket calibration), the
     CUDA kernel against its plain torch version on the same inputs, bit for
     bit, over act densities {0, .05, .5, .95, 1}, a ragged N, an overflow
     case, float64, a scan of more than 1024 tiles, a 5-row input, N an
     exact multiple of the compaction tile, N = 0, C = 32 in float64 and
     float32, N an exact multiple of the expansion's tile and a ragged N,
     more than 1024 expansion tiles, C = 1 and C = 32 for both in float32
     and float64, two compactions back to back on one stream with
     different act (the look-back scratch resets), compact, expand,
     compact, expand back to back (the two share that scratch), an
     expansion of an unaligned child view, and the VJPs of the autograd
     pair, also on an overflowed level; median event times of both, and
     of the nearest single PyTorch call (library_ms), which the port
     never calls;
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
     largest |g|;
21b. train gathers: every take_rows call of one forward of the
     benchmark's reflect_refract train step (800x400, float32) recorded
     with its real index; on a seeded cotangent of each, the gather
     backward's kernel (csrc/gather.cu) against its plain version within
     TABLE_GRAD_RTOL of each slot's sum of |g|, and two kernel calls bit
     for bit; its device time over the step's calls beside the byte
     bound, ATen's backward of table[idx], index_add_ and a one-hot
     matrix product (cuBLAS, deterministic); the train step's gradient
     pass (remat "level") timed with the kernel and with the one-hot
     product in turns; then two identical train-step gradients bit for
     bit, with launches.table_grad_plain at 0. `--table-grad` runs the
     build, the kernel's size sweep (table_grad_sweep) and this phase
     alone.
 22. DoF frame: glass_spheres(800, 400) with a circular aperture and 2x2
     camera jitter at seed SEED, float32, one chunk: the launches of all
     four kernels (each compaction kernel at least once), no overflow, a finite canvas, the warm wall (median of
     --reps); the same seed bit for bit, the plain-compaction frame bit
     for bit, another seed another frame;
 23. photon pass: trace_photons for cornell_box(800, 800) (100,000
     photons a map, the 10x10 jittered area light, the 10,092-triangle
     block) in float32, from the render's photon root at SEED: seconds,
     batches and host syncs, photons stored per map and light against
     its target (a light that stalls prints why), each map's grid, peak
     device memory;
 24. Cornell GI frame: render_scene(cornell_box(800, 800)) in float32 at
     SEED, photon pass included, the whole frame one call: the launches
     of all five kernels (each at least once; no estimate on the torch
     route), no overflow, a finite
     canvas, every warm frame bitwise the first; the warm wall (median of
     --reps), the photon pass's share, pixels/s, traced rays/s (primary
     rays plus the probe's children, each with 100 shadow and 9 gather
     rays), peak device memory; then three kinds of mesh launch of one
     more warm frame, as the kernel took and returned them: the photon
     wave's first and last closest calls (with their keep), the frame's
     first shadow call (chunk 0, level 0: chunk rays x 100 light samples)
     and its first final-gather closest call (9 rays a lane); each
     kernel's in-frame output on every row (the wave's) or on rows spread
     over the batch at a fixed stride (the others) bitwise against the
     plain version, and its median time on the whole batch beside its
     bounds;
 25. GI equality: the Cornell frame with the plain compaction, bit for
     bit the kernel frame (the plain compaction changes no draw);
 26. GI card against CPU: the Cornell box at 32x32 in float64 with
     caustics and the global map's visualization, no final gather, the
     light unjittered (deterministic given the maps), the maps traced
     once on the CPU and moved to the card: within CARD_CPU_ATOL, with
     the share of pixels past 1e-9;
 27. GI output: the sha256 of the Cornell frame's PPM, and the PNG that
     `python -m fast_ray_tracer_tpu_torch` writes from cornell_box.yml
     with --seed SEED, read back bitwise equal to the frame's encode.
27b. irradiance kernel: the benchmark's Cornell cell (112x112, 4x4
     samples, 1,000,000 photons a map, an 8x8 gather) at SEED, each
     estimate call of a warm frame recorded (both maps; every call on the
     kernel, none on the torch route); on each, the query kernel
     (csrc/photon.cu) against the torch route: found and r^2 bitwise, irr
     within IRR_RTOL, the kernel again bitwise and bitwise its in-frame
     output; the queries by the kernel's route (light, heavy) and by the
     select; the kernel's and the torch route's device times, per call
     and over the frame. `--irradiance` runs the build and this phase
     alone.
 28. Cornell forward+backward set-up: cornell_box(800, 800) in float32,
     depth 5, the photon pass at SEED (no autograd), the GI hook with live
     photon powers, every float table a parameter (the block's tri_*
     too); chunks of FB_CHUNK pixels covering all 640,000, buckets from
     the most spawns any chunk's probe counts at FB_MARGIN (the JAX
     bench probes its chunk 0 alone: the port's chunk 0, the top rows,
     holds no specular surface); the live powers of both maps bitwise the
     stored ones;
 29. Cornell forward+backward: a warm-up chunk, then one frame, timed
     (fwd_bwd_ms_cornell_800x800, ms a chunk) and counting each kernel's
     launches in the chunks' forwards and backwards, the chunk
     losses sum((img - 0.5)^2) with remat="level", their gradients
     accumulating into the frame's; peak device memory within
     FB_PEAK_BUDGET; fails on an overflowed chunk, a non-finite loss or
     gradient, a zero L1 of the mat_Kd and light_intensity gradients or an
     all-zero tri_p1 gradient;
 30. forward+backward equality: the gradients of 8192 pixels through the
     spheres and the block (FB_HELD, its own probe's buckets) with the
     kernels against those with the plain compaction and the plain mesh
     queries, within TRAIN_STRIP_RTOL of each field's largest |g|;
 31. forward+backward card against CPU: cornell_box(16, 16) with the
     block in float64, 4,000 photons a map traced on the CPU, the draws
     made on the CPU for both sides: every field within
     TRAIN_CARD_CPU_RTOL of its largest |g|;
 32. Adam with the block: one make_train_step step with an RNG node on
     the held pixels moves the block's vertices; on the moved mesh the
     closest kernel equals its plain version bitwise on their camera
     rays.
 33. world of one: render_scene(glass_spheres(800, 400), mesh=...) on a
     one-rank NCCL process group in this process: phase 4's canvas bit
     for bit and its compaction launches; then the group is shut down.
 34-37. two ranks sharing the card: one spawn of RANKS worker processes
     (this script with --rank), both on cuda:0, joined over gloo through
     a file:// store, each with its own time limit (a rank that fails or
     does not finish fails the script):
 34. the flagship in one chunk: both canvases bitwise phase 4's, both
     compaction kernels launched on each rank, the warm wall of each rank
     (median of --reps; two ranks sharing one card, not a scaling
     figure);
 35. mesh_torus(600, 240): both canvases bitwise phase 8's, both mesh
     kernels launched on each rank;
 36. cornell_box(800, 800) at SEED: the photon maps' sha256 equal on the
     ranks, the canvases equal across ranks, finite, no exact chunk, the
     same seed twice bitwise, all four kernels launched on each rank, the
     wall;
 37. phase 19's train step (800x400, remat="level", its buckets) with
     the batch split over the ranks: the parameters after one step
     bitwise across ranks, the all-reduced gradients within
     TRAIN_STRIP_RTOL of each field's largest |g| of phase 19's first
     step, no overflow, the compaction launches of each rank's forward
     and backward, the step ms;
 38. the flagship in a fresh bucket cache, cold (probe, entry written)
     and warm (no probe), bitwise; then the command line's --profile on
     soft_textured.yml: the phase lines, and a trace naming the kernels
     of both sources. The whole script keeps its bucket cache in a
     temporary FRT_COMPILE_CACHE, so a frame after the first of its
     scene (the warm walls of phases 4, 8, 11 and others) skips the
     probe.
 39. (after the profiled sections below) the bench's entry points
     (bench_torch/): its flagship cell at 3 rounds (its gates: no
     overflow, finite frames, both compaction kernels launched), the
     cell's calibrated pixel_colors frame bitwise phase 4's canvas;
     entry()'s 64x32 forward step on the card (finite, no overflow);
     dryrun_multichip(1) (one NCCL rank) and dryrun_multichip(2) (two
     gloo ranks sharing cuda:0), both at once: finite, the same canvas bit
     for bit, losses within DRYRUN_LOSS_RTOL.
Then each compaction kernel's device time and kernel launches per call
from torch.profiler (the expansion must launch one), one
profiled warm train step, one profiled warm showcase and soft frame each
(device events, device busy time, idle share against the warm wall, and
top operators by device time), and the middle chunk of a warm Cornell
frame (the same, the chunk's idle share against its unprofiled wall,
and the irradiance estimate's device time and share) and the middle
chunk of the Cornell forward+backward (device events only: kernel
launches, busy time, idle share, top kernels), after every
wall-clock phase (the profiler leaves launches slower); the card's
nvidia-smi line, a JSON line of per-kernel results (with each kernel's
launches per rank in phases 34-37) and, last, the device JSON line. Any
failure raises and exits non-zero.
--reps sets the number of warm frames of each render. With --profile, the
level-0 compaction calls and one warm frame of each render run under
torch.profiler, and their per-kernel device-time tables go to PATH.
"""

import argparse
import concurrent.futures
import contextlib
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fast_ray_tracer_tpu_torch import _build, native
from fast_ray_tracer_tpu_torch.__main__ import main as cli_main
from fast_ray_tracer_tpu_torch.io.ppm import (
    construct_ppm, encode_png, png16, read_png, read_ppm,
)
from fast_ray_tracer_tpu_torch.ops import compact, gather, mesh, patterns
from fast_ray_tracer_tpu_torch.ops.intersect import neutralize_rays
from fast_ray_tracer_tpu_torch.ops.vec import normalize
from fast_ray_tracer_tpu_torch.parallel import distributed
from fast_ray_tracer_tpu_torch.parallel.mesh import (
    replicate_scene, shard_pixel_batch,
)
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
from fast_ray_tracer_tpu_torch.render import photon
from fast_ray_tracer_tpu_torch.render import render as render_module
from fast_ray_tracer_tpu_torch.render.render import (
    PHOTON_FOLD, SHADOW_RAYS_PER_CHUNK, pixel_colors, quantize_buckets,
    render_scene,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import (
    CORNELL_DIR, SOFT_DIR, cornell_box, glass_spheres, mesh_torus,
    primitives_showcase, soft_textured,
)
from fast_ray_tracer_tpu_torch.scene.model import replace
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene
from fast_ray_tracer_tpu_torch.scene.ir import PAT_UV_TEXTURE
from fast_ray_tracer_tpu_torch.utils.profiling import PhaseTimer, TRACE_FILE

from bench_torch.extras import build_soup, dof_scene

W, H = 800, 400
RAYS_PER_PIXEL = 126      # 63 trace + 63 shadow rays (depth 5, 2 children)
MW, MH = 600, 240         # the mesh frame
SRC = "fast_ray_tracer_tpu_torch/csrc/compact.cu"
MESH_SRC = "fast_ray_tracer_tpu_torch/csrc/mesh.cu"
GATHER_SRC = "fast_ray_tracer_tpu_torch/csrc/gather.cu"
PHOTON_SRC = "fast_ray_tracer_tpu_torch/csrc/photon.cu"
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


def device_us(prof, rows=None):
    """Device time (us) in a torch.profiler run: device-side rows only
    (kernels, copies, memsets); an aten op's row repeats the device time of
    the kernels it launched. `rows`: the run's key_averages(), when the
    caller has them already (each call walks every event again)."""
    from torch.autograd import DeviceType
    rows = prof.key_averages() if rows is None else rows
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in rows if e.device_type == DeviceType.CUDA)


def check_kernels(device, n0, b0, seed=0):
    """Kernel == plain, bitwise, over the case grid; returns per kernel
    its max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = 2 * n0
    f32, f64 = torch.float32, torch.float64
    tile = compact.tile_rows(6, f32)
    etile = compact.tile_rows(9, f32)
    # (name, N, p, B, dtype, compaction's C, expansion's C)
    cases = [(f"p={p}", n, p, b0, f32, 6, 9)
             for p in (0.0, 0.05, 0.5, 0.95, 1.0)]
    cases += [("ragged", n - 333, 0.5, b0, f32, 6, 9),
              ("overflow", n, 0.5, n // 4, f32, 6, 9),
              ("float64", n, 0.5, b0, f64, 6, 9),
              # more than 1024 tiles of either kernel (the look-back slides
              # over several rounds of 256 predecessors)
              ("two-pass scan", 1_500_001, 0.5, 1_000_000, f32, 6, 9),
              ("tiny", 5, 0.5, 8, f32, 6, 9),
              ("tile multiple", 400 * tile, 0.5, b0, f32, 6, 9),
              ("N=0", 0, 0.5, 64, f32, 6, 9),
              ("C=32 float64", 200_003, 0.5, 150_000, f64, 32, 9),
              ("C=32 float32 overflow", 200_003, 0.5, 60_000, f32, 32, 9),
              # the expansion's own tile: an exact multiple, a ragged N,
              # more than 1024 tiles, C = 1 and C = 32 in both dtypes (the
              # child span's 16-byte copies start mid-row and end ragged)
              ("expand tile multiple", 400 * etile, 0.5, b0, f32, 6, 9),
              ("expand ragged", 400 * etile + 77, 0.5, b0, f32, 6, 9),
              ("expand 1100 tiles", 1100 * etile + 13, 0.5, 700_000, f32,
               6, 9),
              ("C=1 float32", 300_007, 0.5, 200_000, f32, 1, 1),
              ("C=1 float64 overflow", 300_007, 0.5, 100_000, f64, 1, 1),
              ("C=32 float32", 100_003, 0.3, 40_000, f32, 32, 32),
              ("C=32 float64 overflow", 100_003, 0.7, 40_000, f64, 32, 32),
              ("C=1 dense overflow", 70_001, 0.95, 1_000, f32, 1, 1)]
    err = {"compact": 0.0, "expand": 0.0}
    for name, nn, p, b, dt, c, ce in cases:
        act = torch.rand(nn, generator=g, device=device) < p
        src = torch.randn((nn, c), generator=g, device=device, dtype=dt)
        child = torch.randn((b, ce), generator=g, device=device, dtype=dt)
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
        log("kernels", f"{name}: N={nn} C={c}/{ce} B={b} live={count} "
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
    # compact, expand, compact, expand on one stream with different act,
    # no sync between: both share the stream's scratch, and each call must
    # leave it clean for the other
    acts = [torch.rand(n, generator=g, device=device) < p
            for p in (0.2, 0.6, 0.9, 0.4)]
    child = torch.randn((b0, 9), generator=g, device=device)
    ops = [(compact.compact_rows_cuda, compact.compact_rows_plain,
            (src, ), (b0, FILL_ROW)),
           (compact.expand_rows_cuda, compact.expand_rows_plain,
            (child, ), ())] * 2
    got = [kern(*x, a, *rest) for (kern, _, x, rest), a in zip(ops, acts)]
    torch.cuda.synchronize()
    ok = all(torch.equal(y, plain(*x, a, *rest))
             for y, (_, plain, x, rest), a in zip(got, ops, acts))
    log("kernels", f"compact, expand, compact, expand back to back: N={n} "
        f"B={b0} live={[int(a.sum()) for a in acts]} equal={ok}")
    if not ok:
        raise AssertionError("alternating compactions and expansions != "
                             "plain")
    # a child that is a contiguous view 36 bytes into its storage: the
    # expansion stages its span with scalar loads
    act = torch.rand(n, generator=g, device=device) < 0.5
    child = torch.randn((b0 + 1, 9), generator=g, device=device)[1:]
    got = compact.expand_rows_cuda(child, act)
    ok = (child.data_ptr() % 16 != 0
          and torch.equal(got, compact.expand_rows_plain(child, act)))
    log("kernels", f"unaligned child: N={n} B={b0} offset "
        f"{child.data_ptr() % 16} B equal={ok}")
    if not ok:
        raise AssertionError("expand of an unaligned child != plain")

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


def kernel_device_ms(device, n0, b0, event_ms):
    """Each compaction kernel's device time and kernel launches per call
    at the level-0 shape, from torch.profiler (20 calls). The event time
    also holds the wrapper's host work (allocation, ctypes) whenever the
    card waits for it. Run after every wall-clock phase: once the profiler
    has run, launches cost more."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=device).manual_seed(3)
    n = 2 * n0
    act = torch.rand(n, generator=g, device=device) < 0.5
    src = torch.randn((n, 6), generator=g, device=device)
    child = torch.randn((b0, 9), generator=g, device=device)
    calls = 20
    out = {}
    for key, fn in (("compact", lambda: compact.compact_rows_cuda(
                         src, act, b0, FILL_ROW)),
                    ("expand", lambda: compact.expand_rows_cuda(child, act))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        kernels = profile_summary(prof, rows)[0]
        ms = device_us(prof, rows) / calls / 1e3
        out[key] = {"device_ms": ms, "launches_per_call": kernels / calls}
        log("kernels", f"{key}_rows N={n} B={b0} p=0.5: device "
            f"{ms * 1e3:.2f} us a call, {kernels / calls:g} kernel launches "
            f"a call (profiler, {calls} calls) beside the event time "
            f"{event_ms[key] * 1e3:.1f} us")
    if out["expand"]["launches_per_call"] != 1:
        raise AssertionError("expand_rows launched another number of "
                             "kernels than one a call")
    return out


def frame(device, compaction="auto", stats=None, scene=None, seed=None,
          pmesh=None, timer=None):
    """One render_scene call in float32, the whole frame one chunk, and its
    wall; with a mesh (`pmesh`), after a barrier of its ranks."""
    scene = glass_spheres(W, H) if scene is None else scene
    cam = scene.camera
    if pmesh is not None:
        torch.distributed.barrier(group=pmesh.group)
    t0 = time.perf_counter()
    canvas = render_scene(scene, dtype=torch.float32, device=device,
                          chunk_pixels=cam.width * cam.height,
                          compaction=compaction, stats=stats, seed=seed,
                          mesh=pmesh, timer=timer)
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
# the stochastic and photon-GI slice
# ---------------------------------------------------------------------------

SEED = 7                  # the stochastic frames' seed
CW = CH = 800             # the Cornell frame


def render_dof(device, reps):
    """The stochastic camera path, counted: both compaction kernels must
    launch; the same seed bitwise, the plain compaction bitwise, another
    seed another frame."""
    scene = dof_scene()
    soft_counts()
    stats = {}
    canvas, cold = frame(device, stats=stats, scene=scene, seed=SEED)
    launches = {**compact.LAUNCHES, **mesh.LAUNCHES}
    log("dof", f"{W}x{H} 2x2 jittered samples, circular aperture, depth 5 "
        f"float32, seed {SEED}: launches {launches}, buckets "
        f"{stats['buckets']}, escalations {stats['escalations']}, exact "
        f"chunks {stats['exact_chunks']}, first call {cold:.3f} s")
    if min(launches["compact"], launches["expand"]) < 1:
        raise AssertionError(f"a kernel of the DoF path never ran: "
                             f"{launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    if canvas.shape != (H, W, 3) or not np.isfinite(canvas).all():
        raise AssertionError("DoF canvas not finite or of the wrong shape")
    walls = []
    for _ in range(reps):
        again, t = frame(device, scene=scene, seed=SEED)
        walls.append(t)
    wall = statistics.median(walls)
    plain, _ = frame(device, compaction="plain", scene=scene, seed=SEED)
    other, _ = frame(device, scene=scene, seed=SEED + 1)
    same = np.array_equal(canvas, again)
    same_plain = np.array_equal(canvas, plain)
    moved = float(np.abs(other - canvas).max())
    log("dof", f"warm wall {wall:.4f} s (median of {walls}), "
        f"{W * H / wall:.4g} pixels/s; seed {SEED} again bitwise={same}; "
        f"plain-compaction frame bitwise={same_plain}; seed {SEED + 1}: max "
        f"|difference| {moved:.4f}")
    if not (same and same_plain):
        raise AssertionError("the DoF frame is not a function of its seed")
    if not moved > 1e-3:
        raise AssertionError("another seed rendered the same DoF frame")
    return launches, wall


def photon_pass(device):
    """The Cornell box's photon pass alone, as render_scene runs it at
    SEED: seconds, batches, syncs, stores per map and light, peak
    memory."""
    scene = cornell_box(CW, CH)
    cfg = scene.config
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    stats = {}
    maps = photon.trace_photons(
        ir, rt, RNG(SEED, device).fold(PHOTON_FOLD), torch.float32,
        caustic=cfg.include_caustics, global_=cfg.include_final_gather,
        stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    for m, name in ((photon.CAUSTIC, "caustic"), (photon.GLOBAL, "global")):
        st, pm = stats[m], maps[m]
        log("photons", f"{name} map: targets {st['targets']}, stored "
            f"{st['stored']}, {st['emitted']} photons emitted in "
            f"{st['batches']} batches, {st['syncs']} host syncs; grid "
            f"{pm.dims} of {pm.cell_size} cells, at most "
            f"{pm.max_neighbors} photons in a 27-cell block"
            + (f"; stalled: {st['stalled']}" if st["stalled"] else ""))
        if st["stored"] != st["targets"] and not st["stalled"]:
            raise AssertionError(f"the {name} map missed its targets")
    log("photons", f"{cfg.photon_count} photons a map, float32, seed {SEED}: "
        f"{secs:.4f} s, peak device memory {peak / 2**30:.3f} GiB")
    return {"seconds": secs, "peak": peak, "stats": stats}


def render_cornell(device, reps):
    """The GI main path, counted: every kernel must launch. Then the warm
    wall (median of reps), each warm frame bitwise the first, pixels/s,
    traced rays/s and peak memory."""
    scene = cornell_box(CW, CH)
    soft_counts()
    photon.LAUNCHES.update(irradiance=0, irradiance_plain=0)
    stats = {}
    canvas, cold = frame(device, stats=stats, scene=scene, seed=SEED)
    launches = {**compact.LAUNCHES, **mesh.LAUNCHES,
                "irradiance": photon.LAUNCHES["irradiance"]}
    if photon.LAUNCHES["irradiance_plain"]:
        raise AssertionError(f"a forward frame's estimate took the torch "
                             f"route: {photon.LAUNCHES}")
    log("cornell", f"{CW}x{CH} depth 5 float32, seed {SEED}, photon pass "
        f"included: launches {launches}, buckets {stats['buckets']}, "
        f"escalations {stats['escalations']}, exact chunks "
        f"{stats['exact_chunks']}, first call {cold:.3f} s (photon pass "
        f"{stats['photon_seconds']:.3f} s)")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the GI path never ran: "
                             f"{launches}")
    if stats["escalations"] or stats["exact_chunks"]:
        raise AssertionError("bucket overflow after calibration")
    if canvas.shape != (CH, CW, 3) or not np.isfinite(canvas).all():
        raise AssertionError("Cornell canvas not finite or of the wrong "
                             "shape")
    walls, photon_s = [], []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats(device)
        st = {}
        again, t = frame(device, stats=st, scene=scene, seed=SEED)
        walls.append(t)
        photon_s.append(st["photon_seconds"])
        if not np.array_equal(again, canvas):
            raise AssertionError("a warm Cornell frame differs from the "
                                 "first at the same seed")
    peak = torch.cuda.max_memory_allocated(device)
    wall = statistics.median(walls)
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    rt = build_statics(ir, scene.config)
    o, d = pixel_rays(scene, device)
    spawned = torch.stack(spawn_counts(ir, rt, o, d,
                                       scene.config.di_path_length)).tolist()
    cfg = scene.config
    per_lane = 1 + ir.meta.max_light_samples + cfg.gi_usteps * cfg.gi_vsteps
    traced = (CW * CH + sum(spawned)) * per_lane
    log("cornell", f"warm wall {wall:.4f} s (median of {walls}; photon "
        f"pass {statistics.median(photon_s):.4f} s of it), "
        f"{CW * CH / wall:.4g} pixels/s, {traced / wall:.4g} traced rays/s "
        f"({traced} rays: spawn counts {spawned}, {per_lane - 1} shadow and "
        f"gather rays per lane); peak device memory {peak / 2**30:.3f} GiB; "
        f"warm frames bitwise the first")
    return canvas, launches, wall, {"peak": peak, "traced": traced}


def cornell_mesh_calls(device):
    """One warm Cornell frame at SEED with four of its mesh launches
    recorded as the kernel took and returned them: the photon wave's first
    and last closest calls (with their keep), the frame's first shadow call
    (chunk 0, level 0) and its first final-gather closest call. Returns
    {label: (query, tables, origins, directions, keep, outputs)}."""
    calls, inside = {}, [None]
    real = {"closest": mesh.closest_cuda, "shadow": mesh.shadow_cuda,
            "wave": photon.photon_bounce_wave, "gather": photon.final_gather}
    labels = {("closest", "wave"): "photon wave closest",
              ("closest", "gather"): "gather closest",
              ("shadow", None): "shadow"}

    def within(name):
        def run(*args, **kw):
            inside[0] = name
            try:
                return real[name](*args, **kw)
            finally:
                inside[0] = None
        return run

    def record(query):
        def run(m, orig, dirs, *keep):
            out = real[query](m, orig, dirs, *keep)
            label = labels.get((query, inside[0]))
            if label == "photon wave closest" and label in calls:
                label = "photon wave closest, last"
            if label is not None and (label not in calls
                                      or label.endswith("last")):
                calls[label] = (query, m, orig.clone(), dirs.clone(),
                                keep[0] if keep else None,
                                tuple(x.clone() for x in out))
            return out
        return run

    mesh.closest_cuda, mesh.shadow_cuda = record("closest"), record("shadow")
    photon.photon_bounce_wave = within("wave")
    photon.final_gather = within("gather")
    try:
        frame(device, scene=cornell_box(CW, CH), seed=SEED)
    finally:
        mesh.closest_cuda, mesh.shadow_cuda = real["closest"], real["shadow"]
        photon.photon_bounce_wave = real["wave"]
        photon.final_gather = real["gather"]
    return calls


def check_cornell_mesh(device, rows=1 << 20):
    """The mesh kernels on the Cornell frame's recorded launches
    (cornell_mesh_calls): each in-frame output, on every row of a batch of
    at most `rows` rays and else on `rows` rays at a fixed stride through
    it, bitwise against the plain version on the same rows; the kernel
    again on the whole batch bitwise its in-frame output; its median time
    on the whole batch beside its two bounds. Returns per-label numbers."""
    calls = cornell_mesh_calls(device)
    want = ("photon wave closest", "photon wave closest, last", "shadow",
            "gather closest")
    if sorted(calls) != sorted(want):
        raise AssertionError(f"the Cornell frame made no {want} calls: "
                             f"{sorted(calls)}")
    fns = {"closest": (mesh.closest_cuda, mesh.closest_plain),
           "shadow": (mesh.shadow_cuda, mesh.shadow_plain)}
    out = {}
    for label in want:
        query, m, o, d, keep, got = calls[label]
        kern, plain = fns[query]
        args = (keep,) if query == "closest" else ()
        n = o.shape[0]
        step = -(-n // rows)
        idx = torch.arange(0, n, step, device=device)
        same, err = _equal_outputs(tuple(x[idx] for x in got),
                                   plain(m, o[idx], d[idx], *args))
        again, _ = _equal_outputs(kern(m, o, d, *args), got)
        ms = median_ms(lambda: kern(m, o, d, *args), reps=5)
        bound, by, ops, bound_pairs, passed = mesh_bound(
            m, o, d, 5 if query == "shadow" else 0)
        live = int((o[:, 0] < 1e29).sum())
        hits = int(torch.isfinite(got[0] if query == "closest"
                                  else got[1]).sum())
        log("cornell-mesh", f"{label}: {n} rays ({live} live, {hits} hits) "
            f"x {m.tris.shape[1] * mesh.SC} triangles"
            + (" with keep" if keep is not None else "")
            + f"; in-frame output on {idx.shape[0]} rows (stride {step}) "
            f"against the plain version: equal={same}; the kernel again on "
            f"all rows equal={again}; kernel {ms:.3f} ms (median of 5); "
            f"bound {bound:.4f} ms by {by} ({bound / ms:.2%} reached); "
            f"passed pairs {passed}: bound {bound_pairs:.4f} ms "
            f"({bound_pairs / ms:.2%} reached)")
        if not (same and again):
            raise AssertionError(f"mesh {query} != plain on the Cornell "
                                 f"frame's {label} launch")
        out[label] = {"rays": n, "ms": ms, "bound_ms": bound,
                      "bound_pairs_ms": bound_pairs, "max_abs_err": err}
    return out


def check_cornell_equal(device, canvas):
    plain, _ = frame(device, compaction="plain", scene=cornell_box(CW, CH),
                     seed=SEED)
    same = np.array_equal(canvas, plain)
    log("cornell-equal", f"kernel frame vs plain-compaction frame at seed "
        f"{SEED} bitwise={same}")
    if not same:
        raise AssertionError("the Cornell kernel frame differs from the "
                             "plain frame")


def check_cornell_card_vs_cpu(device, w=32, h=32, photons=4000):
    """The Cornell box at w x h in float64, caustics and the global map's
    visualization, no final gather, the light unjittered: the maps traced
    once on the CPU (one torch thread) and moved to the card; trace_bucketed
    on both devices, every level in the probe's bucket; within
    CARD_CPU_ATOL."""
    scene = cornell_box(w, h)
    scene.lights = [replace(scene.lights[0], jitter=False)]
    scene.config = replace(scene.config, photon_count=photons,
                           include_final_gather=False,
                           visualize_photon_map=True)
    cfg = scene.config
    depth = cfg.di_path_length
    buckets = [int(np.ceil(w * h * PROBE_CEILING / 256.0)) * 256] * depth
    cpu = torch.device("cpu")
    canvases = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ir = compile_scene(scene, dtype=torch.float64, device=cpu)
        maps = photon.trace_photons(ir, build_statics(ir, cfg), RNG(SEED),
                                    torch.float64, caustic=True,
                                    global_=True)
        for dev in (device, cpu):
            ir = compile_scene(scene, dtype=torch.float64, device=dev)
            rt = build_statics(ir, cfg)._replace(gi_hook=photon.make_gi_hook(
                {m: pm.to(dev) for m, pm in maps.items()}, cfg))
            o, d = pixel_rays(scene, dev, dtype=torch.float64)
            tr, ovf = trace_bucketed(ir, rt, o, d, depth, buckets)
            if bool(ovf):
                raise AssertionError("card-vs-CPU Cornell frame overflowed")
            canvases[dev.type] = ((tr.a + tr.d + tr.s) / 3.0).cpu().numpy()
    finally:
        torch.set_num_threads(threads)
    diff = np.abs(canvases["cuda"] - canvases["cpu"]).max(-1)
    log("cornell-card-vs-cpu", f"{w}x{h} float64, {photons} photons a map "
        f"({maps[photon.CAUSTIC].n} caustic, {maps[photon.GLOBAL].n} global "
        f"stored): max |card - cpu| {diff.max():.3e}; pixels past 1e-9: "
        f"{(diff > 1e-9).mean():.4%}, past 1e-12: {(diff > 1e-12).mean():.4%}"
        f", bitwise equal {(diff == 0).mean():.4%}; tolerance "
        f"{CARD_CPU_ATOL}")
    if not diff.max() <= CARD_CPU_ATOL:
        raise AssertionError("card and CPU Cornell canvases differ past "
                             f"{CARD_CPU_ATOL}")


def cornell_output(canvas):
    """The Cornell frame's PPM hash; the command line's PNG of
    cornell_box.yml at SEED, read back bitwise equal to the frame's
    encode."""
    ppm = construct_ppm(canvas)
    path = os.path.join(tempfile.gettempdir(), f"frt_cornell_box_{CW}x{CH}.ppm")
    with open(path, "wb") as f:
        f.write(ppm)
    log("cornell-output", f"{path} sha256 {hashlib.sha256(ppm).hexdigest()}")
    cornell_box(CW, CH)                  # writes the YAML at first use
    os.makedirs(OUT_DIR, exist_ok=True)
    stem = os.path.join(OUT_DIR, "cornell_box")
    t0 = time.perf_counter()
    cli_main([str(CORNELL_DIR / "cornell_box.yml"), "-o", stem, "--seed",
              str(SEED), "--quiet", "--png-only"])
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    with open(stem + ".png", "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    same = np.array_equal(np.round(read_png(stem + ".png") * 65535.0),
                          png16(canvas))
    log("cornell-output", f"{stem}.png (command line, --seed {SEED}, "
        f"{t:.3f} s) sha256 {digest}; read back bitwise equal to the "
        f"frame's 16-bit encode: {same}")
    if not same:
        raise AssertionError("the command line's Cornell PNG differs from "
                             "the frame")


# the benchmark's Cornell cell (cornell_gi_full): 112x112 in one chunk, 4x4
# samples a pixel, 1,000,000 photons a map, an 8x8 final gather
IW = IH = 112
# float32, the query kernel against the torch route on the same queries:
# the sums of a query's selected photons (every term >= 0) in another
# order, each within this share of the torch route's
IRR_RTOL = 1e-5


def cell_cornell():
    """The benchmark's Cornell cell as scene/demo builds it."""
    scene = cornell_box(IW, IH)
    scene.config = replace(scene.config, photon_count=1_000_000,
                           gi_usteps=8, gi_vsteps=8)
    scene.camera = replace(scene.camera, usteps=4, vsteps=4)
    return scene


def irradiance_calls(device, scene):
    """One warm frame of `scene` at SEED with each irradiance estimate
    recorded as the kernel took and returned it: [(map, pm, points, eyev,
    num, max_dist, cone_k, irr, found)], and photon.LAUNCHES over the
    frame."""
    calls, caustic = [], [False]
    real_est, real_caustics = (photon.irradiance_estimate,
                               photon._lighting_caustics)

    def est(pm, points, eyev, num, max_dist, cone_k):
        irr, found = real_est(pm, points, eyev, num, max_dist, cone_k)
        calls.append(("caustic" if caustic[0] else "global", pm,
                      points.detach().clone(), eyev.detach().clone(), num,
                      max_dist, cone_k, irr.clone(), found.clone()))
        return irr, found

    def caustics(*a, **k):
        caustic[0] = True
        try:
            return real_caustics(*a, **k)
        finally:
            caustic[0] = False

    photon.LAUNCHES.update(irradiance=0, irradiance_plain=0)
    photon.irradiance_estimate = est
    photon._lighting_caustics = caustics
    try:
        frame(device, scene=scene, seed=SEED)
    finally:
        photon.irradiance_estimate = real_est
        photon._lighting_caustics = real_caustics
    return calls, dict(photon.LAUNCHES)


def check_irradiance(device):
    """The query kernel on the Cornell cell's own estimate calls (both
    maps) against the torch route on the same queries: found and r^2
    bitwise, irr within IRR_RTOL, the kernel again bitwise and bitwise its
    in-frame output; each call's queries by the kernel's route (light: a
    warp; heavy: the block) and by the select (n_in >= num); the kernel's
    time (CUDA events around its one launch) and the torch route's device
    time (profiler), per call and over the frame."""
    from torch.profiler import ProfilerActivity, profile
    scene = cell_cornell()
    t0 = time.perf_counter()
    frame(device, scene=scene, seed=SEED)      # calibration, maps, build
    cold = time.perf_counter() - t0
    calls, launches = irradiance_calls(device, scene)
    log("irradiance", f"{IW}x{IH} Cornell cell at seed {SEED}: {len(calls)} "
        f"estimate calls in a warm frame, launches {launches} (first frame "
        f"{cold:.2f} s)")
    if launches != {"irradiance": len(calls), "irradiance_plain": 0} \
            or not calls:
        raise AssertionError(f"the forward frame's estimates did not all "
                             f"take the kernel: {launches}")
    light_max = int(photon._load().frt_irradiance_light_max())
    total = {"queries": 0, "heavy": 0, "dense": 0, "kernel_ms": 0.0,
             "plain_ms": 0.0, "max_rel_err": 0.0}
    out = []
    for i, (label, pm, pts, eye, num, md, ck, irr, found) in \
            enumerate(calls):
        R = pts.shape[0]
        r2k = torch.empty(R, dtype=pts.dtype, device=device)
        r2p = torch.empty(R, dtype=pts.dtype, device=device)

        def kernel():
            return photon.irradiance_cuda(pm, pts, eye, num, md, ck)
        kirr, kfound = photon.irradiance_cuda(pm, pts, eye, num, md, ck,
                                              r2_out=r2k)
        again = kernel()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                pirr, pfound = photon._irradiance_estimate(
                    pm, pts, eye, num, md, ck, r2_out=r2p)
            torch.cuda.synchronize()
        plain_ms = device_us(prof) / 1e3
        # the launch is the only work between the events: its device time
        k_ms = median_ms(kernel, reps=5)
        in_frame = torch.equal(kirr, irr) and torch.equal(kfound, found)
        repeat = torch.equal(again[0], kirr) and torch.equal(again[1], kfound)
        found_bad = int((kfound != pfound).sum())
        r2_bad = int((r2k.view(torch.int32) != r2p.view(torch.int32)).sum()
                     if pts.dtype == torch.float32 else (r2k != r2p).sum())
        ok = ((kirr - pirr).abs() <= IRR_RTOL * pirr.abs()) | (kirr == pirr)
        rel = float(((kirr - pirr).abs() / pirr.abs().clamp(min=1e-30))
                    .masked_fill(kirr == pirr, 0.0).max())
        s, e = photon._neighbor_extents(pm, pts)
        heavy = int(((e - s).sum(1) > light_max).sum())
        dense = int((pfound == num).sum())
        log("irradiance", f"call {i} ({label} map, {pm.n} photons in "
            f"{pm.cell_keys.shape[0]} cells): {R} queries ({R - heavy} "
            f"light, {heavy} heavy; {dense} with n_in >= {num}); found "
            f"mismatches {found_bad}, r2 bit mismatches {r2_bad}, irr "
            f"outside rtol {IRR_RTOL}: {int((~ok).sum())} (largest relative "
            f"difference {rel:.3e}); again bitwise {repeat}; in-frame output "
            f"bitwise {in_frame}; kernel {k_ms:.3f} ms (events, median "
            f"of 5), torch route {plain_ms:.1f} ms of device time "
            f"(profiler; {plain_ms / k_ms:.1f}x)")
        if found_bad or r2_bad or not bool(ok.all()) or not repeat \
                or not in_frame:
            raise AssertionError(f"the query kernel differs from the torch "
                                 f"route on call {i} of the Cornell frame")
        total["queries"] += R
        total["heavy"] += heavy
        total["dense"] += dense
        total["kernel_ms"] += k_ms
        total["plain_ms"] += plain_ms
        total["max_rel_err"] = max(total["max_rel_err"], rel)
        out.append({"map": label, "queries": R, "heavy": heavy,
                    "dense": dense, "kernel_ms": k_ms, "plain_ms": plain_ms,
                    "max_rel_err": rel})
        del r2k, r2p, pirr, pfound, kirr, kfound, again
    log("irradiance", f"the frame's {len(calls)} calls: {total['queries']} "
        f"queries ({total['heavy']} heavy, {total['dense']} selecting); "
        f"kernel {total['kernel_ms']:.2f} ms (events), torch route "
        f"{total['plain_ms']:.1f} ms of device time "
        f"({total['plain_ms'] / max(total['kernel_ms'], 1e-9):.1f}x); "
        f"largest relative irr difference {total['max_rel_err']:.3e}")
    return {"calls": out, **total}


@contextlib.contextmanager
def around_chunk(k, before, after):
    """Call before() and after() around chunk k's pixel_colors in every
    render_scene call inside the context, the card synchronized at both."""
    real = render_module.pixel_colors
    calls = [0]

    def run(*args, **kw):
        mine = calls[0] == k
        calls[0] += 1
        if mine:
            torch.cuda.synchronize()
            before()
        out = real(*args, **kw)
        if mine:
            torch.cuda.synchronize()
            after()
        return out

    render_module.pixel_colors = run
    try:
        yield
    finally:
        render_module.pixel_colors = real


def profile_cornell(device, k=1):
    """Chunk k (of 3) of a warm Cornell frame: its wall in one unprofiled
    frame, then its device events under torch.profiler in another: kernel
    launches, copies and memsets, device busy time and the idle share
    against the unprofiled chunk wall, the irradiance estimate's device
    time (the kernels launched inside its range) and share, and the top
    operators. Device busy counts kernels, copies and memsets, not the
    ranges' own device rows, which span the kernels inside them. One chunk:
    reading the events of a whole frame (~250,000 launches) takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    scene = cornell_box(CW, CH)
    span = []
    with around_chunk(k, lambda: span.append(time.perf_counter()),
                      lambda: span.append(time.perf_counter())):
        frame(device, scene=scene, seed=SEED)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with around_chunk(k, lambda: (prof.start(),
                                  span.append(time.perf_counter())),
                      lambda: (span.append(time.perf_counter()),
                               prof.stop())):
        frame(device, scene=scene, seed=SEED)
    if len(span) != 4:
        raise AssertionError(f"the Cornell frame has no chunk {k}")
    wall, profiled = span[1] - span[0], span[3] - span[2]
    t0 = time.perf_counter()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name == "irradiance_estimate"]
    irr = sum(e.device_time_total for e in ranges) / 1e6
    spans = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA
                and getattr(e, "is_user_annotation", False)) / 1e6
    ops = {}
    for e in cpu:
        if e.name.startswith("aten::"):
            t, n = ops.get(e.name, (0.0, 0))
            ops[e.name] = (t + e.self_device_time_total, n + 1)
    top = ", ".join(f"{name} {t / 1e3:.2f} ms ({n} calls)" for name, (t, n)
                    in sorted(ops.items(), key=lambda kv: -kv[1][0])[:8])
    log("cornell-profile", f"chunk {k} of a warm frame: "
        f"{len(dev) - copies} kernel launches and {copies} copies/memsets; "
        f"unprofiled chunk wall {wall:.4f} s (profiled {profiled:.4f} s), "
        f"device busy {busy:.4f} s -> device idle share "
        f"{1 - busy / wall:.3f}; irradiance estimates ({len(ranges)} calls) "
        f"{irr:.4f} s of device time ({irr / max(busy, 1e-12):.3f} of "
        f"busy; the ranges' own device rows span {spans:.4f} s); top operators by device time: {top}; events read in "
        f"{time.perf_counter() - t0:.1f} s")
    if not 0.0 < busy <= profiled:
        raise AssertionError("the chunk's device busy time lies outside "
                             "its profiled wall")
    return {"busy_s": busy, "wall_s": wall, "irradiance_s": irr}


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
# through the unrolled one (and through atomics in whatever scatter-adds
# autograd still runs): within this share of the field's largest |g|
TRAIN_STRIP_RTOL = 1e-4
# float64, 24x12, the card against the CPU: the bound of the CPU tests
# against the JAX package (the card contracts multiply-adds)
TRAIN_CARD_CPU_RTOL = 1e-9


class TrainSet:
    """glass_spheres' (or `scene`'s) rows [y0, y1) as one batch for the
    train step, on `device` in `dtype`: the scene split into parameters,
    buckets from one spawn-count probe at 1.2x margin, and the target
    frame rendered with mat_Kd scaled by 0.6."""

    def __init__(self, device, dtype=torch.float32, w=W, h=H, rows=None,
                 scene=None):
        scene = scene or glass_spheres(w, h)
        w, h = scene.camera.width, scene.camera.height
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
    gather.LAUNCHES.update(table_grad=0, table_grad_plain=0)
    state, loss, ovf = step(
        state, *ts.args, ts.target,
        between=lambda: fwd.update(compact.LAUNCHES, **gather.LAUNCHES))
    torch.cuda.synchronize()
    # the first step's gradients, for the two-rank step of phase 37
    grads = {k: torch.zeros_like(p) if p.grad is None
             else p.grad.detach().clone() for k, p in params.items()}
    total = {**compact.LAUNCHES, **gather.LAUNCHES}
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
    if min(bwd[k] for k in ("compact", "expand", "table_grad")) < 1 or \
            min(fwd[k] for k in ("compact", "expand")) < 1:
        raise AssertionError(f"a compaction or gather kernel did not run: "
                             f"forward {fwd}, backward {bwd}")
    if total["table_grad_plain"]:
        raise AssertionError(f"a table gather took the large-table route: "
                             f"forward {fwd}, backward {bwd}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"losses not finite and falling: {losses}")
    return {"ms": ms, "peak_gib": peak, "fwd": fwd, "bwd": bwd,
            "losses": losses, "grads": grads}


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
# the small-table gather backward (ops/gather.py, csrc/gather.cu)
# ---------------------------------------------------------------------------

# the benchmark's reflect_refract scene: its stripe and checker patterns
# sit in their material slots, so every gather of the train cell runs
BENCH_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmark", "scenes", "reflect_refract.yml")
# float32 on the card, the kernel's segmented sum against the plain
# version (index_add_, whose atomics add in another order): each slot
# within this share of its sum of |g|. Another order of float32 adds moves
# a sum by a few ulps of that magnitude (1.8e-7 measured at the cell's
# shapes on an H100); lanes added to the wrong row, column or twice move
# it by their share of it.
TABLE_GRAD_RTOL = 1e-5


def gather_calls(ts):
    """(table, idx) of every take_rows call on the grad path of one forward
    of `ts`, in call order (every remat mode makes the same calls; "level"
    makes each twice, the recompute's in the backward)."""
    calls, real = [], gather._TakeRows

    class Recorder:
        @staticmethod
        def apply(table, idx):
            calls.append((table.detach(), idx))
            return real.apply(table, idx)

    params = ts.fresh()
    gather._TakeRows = Recorder
    try:
        img, ovf = pixel_colors(merge_params(params, ts.static), ts.rt,
                                ts.cam, *ts.args, 1, ts.depth,
                                buckets=ts.buckets)
    finally:
        gather._TakeRows = real
    if bool(ovf):
        raise AssertionError("the recorded forward overflowed its buckets")
    return calls


def _table_grad_bytes(n, table, blocks):
    """Bytes a call must move (cotangent, int64 index, gradient) and the
    partial sums' round trip past one block."""
    kw = table.numel()
    e = table.element_size()
    return n * (kw // table.shape[0] * e + 8) + kw * e, \
        (2 * blocks * kw * e if blocks > 1 else 0)


def _profiled_device_us(fn, reps):
    """Device time (us) a call of fn, over reps calls under the profiler,
    and the run's kernel events in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return device_us(prof) / reps, kernels


def table_grad_onehot(g, idx, shape):
    """The library formulation of table_grad_ref, timed beside the kernel:
    a one-hot (N, K) matrix's transpose times the cotangent, in cuBLAS's
    fixed reduction order."""
    k, w = shape[0], math.prod(shape[1:])
    hot = torch.nn.functional.one_hot(torch.where(idx < 0, idx + k, idx),
                                      k).to(g.dtype)
    return (hot.T @ g.reshape(g.shape[0], w)).view(shape)


# the sweep's tables (K rows of W float32 elements) up to the kernel's cap,
# at the 800x400 frame's level-0 lane count
SWEEP_SHAPES = [(k, 16) for k in (1, 2, 5, 10, 14, 20, 28, 42, 56)] + \
    [(k, 3) for k in (10, 40, 149, 298)] + [(10, 1)]
SWEEP_N = 320_000


def table_grad_sweep(device, reps=20):
    """The kernel's device time over table sizes (the sweep that set
    ops/gather.MAX_TABLE_BYTES): for each of SWEEP_SHAPES, float32, N =
    SWEEP_N, indices uniform over the rows and the same sorted (long runs,
    as coherent rays give); beside it its byte bound, ATen's backward of
    table[idx] (zeros + index_put_ with accumulate), index_add_ and the
    one-hot product. One log line a case; the cases' records."""
    lib = gather._load()
    gen = torch.Generator(device=device).manual_seed(5)
    n, out = SWEEP_N, []
    for k, w in SWEEP_SHAPES:
        table = torch.zeros((k, w), device=device)
        if table.numel() * 4 > gather.MAX_TABLE_BYTES:
            raise AssertionError(f"sweep shape {(k, w)} past the cap")
        g = torch.randn((n, w), generator=gen, device=device)
        uniform = torch.randint(0, k, (n,), generator=gen, device=device)
        for order, idx in (("uniform", uniform),
                           ("runs", torch.sort(uniform).values)):
            got = gather.table_grad_cuda(g, idx, table.shape)
            want = gather.table_grad_ref(g.double(), idx, table.shape)
            blocks = lib.frt_table_grad_blocks(n, k, w, 4, device.index)
            need, _ = _table_grad_bytes(n, table, blocks)
            rec = {"k": k, "w": w, "table_bytes": k * w * 4, "order": order,
                   "blocks": blocks,
                   "max_abs_err_vs_f64": float((got.double() - want)
                                               .abs().max()),
                   "bound_us": need / HBM_BYTES_PER_S * 1e6}
            for name, fn in (
                    ("kernel", lambda: gather.table_grad_cuda(
                        g, idx, table.shape)),
                    ("index_put", lambda: torch.zeros_like(table).index_put_(
                        (idx,), g, accumulate=True)),
                    ("index_add", lambda: torch.zeros_like(table).index_add_(
                        0, idx, g)),
                    ("onehot", lambda: table_grad_onehot(g, idx,
                                                         table.shape))):
                rec[f"{name}_us"] = _profiled_device_us(fn, reps)[0]
            log("table-grad-sweep", json.dumps(rec))
            out.append(rec)
    return out


def check_table_grad(device, reps=20, steps=8):
    """The gather backward on the train cell's own calls: the benchmark's
    reflect_refract at 800x400 in float32. Every take_rows call of one
    forward is recorded with its real index; a seeded cotangent of its
    shape then goes through the kernel and through the plain version
    (within TABLE_GRAD_RTOL), the kernel twice (bitwise), and each call is
    timed on the device beside its byte bound, ATen's backward of
    table[idx] (zeros + index_put_ with accumulate), index_add_ and the
    one-hot product (table_grad_onehot). The step's gradient pass (remat
    "level", its overflow read back) is timed `steps` times each with the
    kernel and with the one-hot product in its place, in turns. Then two
    identical train-step gradients must be bitwise equal, with the
    large-table route never taken."""
    lib = gather._load()
    if (lib.frt_table_grad_max_bytes(), lib.frt_table_grad_max_row()) != \
            (gather.MAX_TABLE_BYTES, gather.MAX_ROW):
        raise AssertionError("ops/gather.MAX_TABLE_BYTES or MAX_ROW is not "
                             "the kernel's own limit")
    ts = TrainSet(device, scene=load_scene(BENCH_SCENE))
    calls = [(t, i) for t, i in gather_calls(ts) if i.numel()]
    gen = torch.Generator(device=device).manual_seed(11)
    cases, worst, worst_exact = [], 0.0, 0.0
    for table, idx in calls:
        n = idx.shape[0]
        g = torch.randn((n, *table.shape[1:]), generator=gen, device=device,
                        dtype=table.dtype)
        got = gather.table_grad_cuda(g, idx, table.shape)
        again = gather.table_grad_cuda(g, idx, table.shape)
        if not torch.equal(got, again):
            raise AssertionError(f"two kernel calls differ: {tuple(table.shape)}"
                                 f" N={n}")
        plain = gather.table_grad_ref(g, idx, table.shape)
        exact = gather.table_grad_ref(g.double(), idx, table.shape)
        mag = gather.table_grad_ref(g.double().abs(), idx, table.shape)
        scale = mag.clamp_min(1e-30)
        worst = max(worst, float(((got - plain).abs() / scale).max()))
        worst_exact = max(worst_exact,
                          float(((got.double() - exact).abs() / scale).max()))
        kw = table.numel()
        blocks = lib.frt_table_grad_blocks(n, table.shape[0], kw //
                                           table.shape[0],
                                           table.element_size(), device.index)
        cases.append((table, idx, g, blocks))
    # device time of each variant over the whole step's calls
    def run(variant):
        def fn():
            for table, idx, g, _ in cases:
                if variant == "kernel":
                    gather.table_grad_cuda(g, idx, table.shape)
                elif variant == "index_put":
                    torch.zeros_like(table).index_put_((idx,), g,
                                                       accumulate=True)
                elif variant == "index_add":
                    torch.zeros_like(table).index_add_(0, idx, g)
                else:
                    table_grad_onehot(g, idx, table.shape)
        return fn
    totals, kernels = {}, None
    for variant in ("kernel", "index_put", "index_add", "onehot"):
        us, ev = _profiled_device_us(run(variant), reps)
        totals[variant] = us
        if variant == "kernel":
            kernels = ev
    # per call: its kernel events (one, or two past one block) of the
    # first repetition
    per_call, k = [], 0
    for table, idx, g, blocks in cases:
        m = 1 + (blocks > 1)
        names = [e.name for e in kernels[k:k + m]]
        if not all("slice_kernel" in x or "sum_kernel" in x for x in names):
            raise AssertionError(f"unexpected kernels in the profile: {names}")
        us = sum(e.time_range.elapsed_us() for e in kernels[k:k + m])
        k += m
        need, extra = _table_grad_bytes(idx.shape[0], table, blocks)
        per_call.append((us, need / HBM_BYTES_PER_S * 1e6,
                         (need + extra) / HBM_BYTES_PER_S * 1e6,
                         idx.shape[0], tuple(table.shape), blocks))
    need_us = sum(c[1] for c in per_call)
    kern_us = sum(c[0] for c in per_call)
    longest = max(per_call)
    log("table-grad", f"{len(cases)} take_rows calls of one forward "
        f"(reflect_refract 800x400 float32; N {min(c[3] for c in per_call)}"
        f"-{max(c[3] for c in per_call)}; tables "
        f"{sorted(set(c[4] for c in per_call))}): kernel vs plain "
        f"(index_add_) largest share of a slot's sum |g| {worst:.3e} "
        f"(bound {TABLE_GRAD_RTOL}), kernel vs float64 exact {worst_exact:.3e}"
        f"; two kernel calls bitwise equal on every call")
    log("table-grad", f"device time over the step's calls: kernel "
        f"{totals['kernel']:.1f} us (the calls' kernels alone {kern_us:.1f} "
        f"us, byte bound {need_us:.1f} us: {100 * need_us / kern_us:.1f}% "
        f"of it), index_put_ (ATen's backward of table[idx]) "
        f"{totals['index_put']:.1f} us, index_add_ {totals['index_add']:.1f}"
        f" us, one-hot product {totals['onehot']:.1f} us; longest call {longest[0]:.2f} us (N={longest[3]}, table "
        f"{longest[4]}, {longest[5]} blocks, bound {longest[1]:.2f} us, "
        f"{longest[2]:.2f} us with the partial sums)")
    if worst > TABLE_GRAD_RTOL:
        raise AssertionError("the kernel's gradient differs from the plain "
                             "version's")
    # the step's gradient pass with the kernel and with the one-hot
    # product, in turns, each from a collected heap; walls and peak memory
    walls = {"kernel": [], "onehot": []}
    peaks = {k: 0 for k in walls}
    real = gather.table_grad_cuda
    try:
        for i in range(steps + 1):
            for variant in walls:
                gather.table_grad_cuda = real if variant == "kernel" \
                    else table_grad_onehot
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                ts.grads(buckets=ts.buckets, remat="level")
                torch.cuda.synchronize()
                if i:
                    walls[variant].append(time.perf_counter() - t0)
                peaks[variant] = max(peaks[variant],
                                     torch.cuda.max_memory_allocated(device))
    finally:
        gather.table_grad_cuda = real
    step_ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    log("table-grad", "the step's gradient pass (remat 'level'), walls in "
        "ms: " + "; ".join(f"{k} median {step_ms[k]:.1f} of "
                          f"{[round(t * 1e3, 1) for t in v]}, peak "
                          f"{peaks[k] / 2**30:.4f} GiB"
                          for k, v in walls.items()))
    # two identical gradient passes of the cell's step, bitwise
    gather.LAUNCHES.update(table_grad=0, table_grad_plain=0)
    first = ts.grads(buckets=ts.buckets, remat="level")
    second = ts.grads(buckets=ts.buckets, remat="level")
    counts = dict(gather.LAUNCHES)
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    log("table-grad", f"two identical train-step gradients (remat "
        f"'level'): differing tables {differ}; launches {counts}")
    if differ or counts["table_grad_plain"] or counts["table_grad"] < 1:
        raise AssertionError("the step's gradients are not reproducible, or "
                             "a gather took the large-table route")
    return {"max_abs_err": worst, "ms": kern_us / 1e3,
            "bound_ms": need_us / 1e3, "bound_by": "bytes",
            "plain_ms": totals["index_add"] / 1e3,
            "library_ms": totals["index_put"] / 1e3,
            "onehot_ms": totals["onehot"] / 1e3,
            "grad_pass_ms": step_ms["kernel"],
            "grad_pass_onehot_ms": step_ms["onehot"],
            "grad_pass_peak_gib": peaks["kernel"] / 2**30,
            "grad_pass_onehot_peak_gib": peaks["onehot"] / 2**30,
            "launches_train_bwd": counts["table_grad"] // 2}


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


# ---------------------------------------------------------------------------
# the GI and mesh gradient slice: the Cornell forward+backward
# ---------------------------------------------------------------------------

# pixels a chunk of the 800x800 Cornell forward+backward: the largest power
# of two whose frame peaks within FB_PEAK_BUDGET of device memory; frames
# of 2^16, 2^17 and 2^18 pixel chunks peaked at 21.426, 33.188 and 48.651
# GiB on an NVIDIA H100 80GB HBM3, 700.00 W (tools/cornell_fwd_bwd_chunks.py;
# PERF.md, section 6)
FB_CHUNK = 1 << 17
FB_PEAK_BUDGET = 40 << 30
# bucket margin over the probed spawn counts (the JAX package's
# bench_extras.fwd_bwd_cornell takes 1.35x, in multiples of 256 lanes)
FB_MARGIN = 1.35
# the held chunks (plain versions, the Adam step): 8192 pixels from row 560
# on, where the spheres and the block sit
FB_HELD = (560 * CW, 8192)


def fb_buckets(counts):
    return [max(256, int(np.ceil(c * FB_MARGIN / 256.0)) * 256)
            for c in counts]


class HostDraws:
    """An RNG node whose draws are made on the CPU and moved to `device`,
    so that the card and the CPU consume the same numbers."""

    def __init__(self, rng, device):
        self.rng, self.device = rng, torch.device(device)

    def fold(self, i):
        return HostDraws(self.rng.fold(i), self.device)

    def split(self, n):
        return [HostDraws(r, self.device) for r in self.rng.split(n)]

    def uniform(self, shape, dtype):
        return self.rng.uniform(shape, dtype).to(self.device)

    def normal(self, shape, dtype):
        return self.rng.normal(shape, dtype).to(self.device)

    def randint(self, shape, low, high):
        return self.rng.randint(shape, low, high).to(self.device)


class CornellGrad:
    """cornell_box(w, h) on `device` set up for its forward+backward: the
    photon pass at SEED (under no_grad, as trace_photons runs; or `maps`,
    moved to the device), the draws from `draws` (an RNG node; the root
    of SEED by default), the GI hook with live photon powers, every float
    table a parameter (split_params: the block's tri_* too), pixel chunks
    of `chunk` in order (the last one shorter), each drawing as
    render_scene's chunk does from the root's fold(chunk). `buckets`
    default to the most that any chunk's spawn-count probe counts, at
    FB_MARGIN. The loss of a chunk is sum((img - 0.5)^2), through
    pixel_colors with remat="level"."""

    def __init__(self, device, chunk=FB_CHUNK, w=CW, h=CH,
                 dtype=torch.float32, photons=None, maps=None, draws=None,
                 buckets=None):
        scene = cornell_box(w, h)
        if photons is not None:
            scene.config = replace(scene.config, photon_count=photons)
        self.cfg = cfg = scene.config
        self.w, self.total, self.chunk = w, w * h, chunk
        self.device, self.dtype = torch.device(device), dtype
        self.ir = compile_scene(scene, dtype=dtype, device=device)
        rt = build_statics(self.ir, cfg)
        self.root = RNG(SEED, device) if draws is None else draws
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if maps is None:
            maps = photon.trace_photons(
                self.ir, rt, self.root.fold(PHOTON_FOLD), dtype,
                caustic=cfg.include_caustics,
                global_=cfg.include_final_gather)
        self.maps = {m: None if pm is None else pm.to(device)
                     for m, pm in maps.items()}
        torch.cuda.synchronize()
        self.photon_s = time.perf_counter() - t0
        self.rt = rt._replace(gi_hook=photon.make_gi_hook(
            self.maps, cfg, live_power=True))
        self.cam_desc = scene.camera
        self.cam = build_camera(scene.camera, dtype=dtype, device=device)
        self.det = torch.as_tensor(cmj_points_static(1, 1)).to(
            device=device, dtype=dtype)
        self.depth = cfg.di_path_length
        self.params, self.static = split_params(self.ir)
        self.n_chunks = -(-self.total // chunk)
        if buckets is None:
            self.chunk_counts = [self.probe(c) for c in range(self.n_chunks)]
            self.counts = [max(v) for v in zip(*self.chunk_counts)]
            buckets = fb_buckets(self.counts)
        self.buckets = list(buckets)

    def args(self, c, span=None):
        """((px, py, uv, ap), trace rng) of chunk c, or of pixels
        [lo, lo + n) for span=(lo, n)."""
        lo, n = span or (c * self.chunk, self.chunk)
        idx = torch.arange(lo, min(lo + n, self.total), device=self.device)
        ck = self.root.fold(c)
        return (render_module.primary_samples(
            self.cam_desc, self.cam, self.det, idx % self.w, idx // self.w,
            ck), ck.fold(1))

    def probe(self, c, span=None):
        (px, py, uv, ap), _ = self.args(c, span)
        counts = spawn_counts(self.ir, self.rt, *rays_for_pixels(
            self.cam, px, py, uv, ap), self.depth)
        return torch.stack(counts).tolist()

    def loss(self, c, params=None, span=None, buckets=None, **kw):
        """(loss, overflow) of chunk c (or of the span) at `params`."""
        params = self.params if params is None else params
        (px, py, uv, ap), rng = self.args(c, span)
        img, ovf = pixel_colors(
            merge_params(params, self.static), self.rt, self.cam, px, py, uv,
            ap, 1, self.depth, remat="level",
            buckets=self.buckets if buckets is None else buckets, rng=rng,
            **kw)
        return ((img - 0.5) ** 2).sum(), ovf

    def grads(self, c, span=None, buckets=None, **kw):
        """{key: gradient} of one chunk's (or span's) loss, and the
        overflow flag."""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self.params.items()}
        loss, ovf = self.loss(c, params, span, buckets, **kw)
        keys = [k for k, v in params.items() if v.numel()]
        gs = torch.autograd.grad(loss, [params[k] for k in keys],
                                 allow_unused=True)
        return {k: torch.zeros_like(params[k]) if g is None else g
                for k, g in zip(keys, gs)}, bool(ovf)


def _launch_counts():
    return {**compact.LAUNCHES, **mesh.LAUNCHES}


def _reset_launches():
    compact.LAUNCHES.update(compact=0, expand=0)
    mesh.LAUNCHES.update(mesh_closest=0, mesh_shadow=0)


def _fb_counts():
    """The launch counts with the gather backward's (a frame's forward
    never counts these)."""
    return {**_launch_counts(), **gather.LAUNCHES}


def fb_frame(cg):
    """One forward+backward of the whole frame, chunk by chunk, the chunk
    gradients accumulating into the parameters' .grad, one host sync at
    the end: (wall s, loss, overflow flags, each kernel's launches in the
    chunks' forwards and in their backwards; the counters are host-side
    and read without a sync)."""
    for p in cg.params.values():
        p.grad = None
    fwd = {k: 0 for k in _fb_counts()}
    bwd = dict(fwd)
    losses, ovfs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(cg.n_chunks):
        _reset_launches()
        gather.LAUNCHES.update(table_grad=0, table_grad_plain=0)
        loss, ovf = cg.loss(c)
        f = _fb_counts()
        loss.backward()
        b = _fb_counts()
        for k in fwd:
            fwd[k] += f[k]
            bwd[k] += b[k] - f[k]
        losses.append(loss.detach())
        ovfs.append(ovf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = float(torch.stack(losses).sum())
    return wall, loss, [bool(x) for x in ovfs], fwd, bwd


def cornell_fwd_bwd(device):
    """The 800x800 Cornell forward+backward (phases 28-29): set-up and the
    photon pass, the live powers of both maps bitwise the stored ones, a
    warm-up chunk, then one counted frame and one timed frame; gates:
    no chunk overflowed, a finite loss and gradient, a positive L1 of the
    mat_Kd and light_intensity gradients, a non-zero tri_p1 gradient, the
    peak within FB_PEAK_BUDGET."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cg = CornellGrad(device)
    setup = time.perf_counter() - t0
    same = {}
    for m, name in ((photon.CAUSTIC, "caustic"), (photon.GLOBAL, "global")):
        pm = cg.maps[m]
        with torch.no_grad():
            same[name] = torch.equal(photon.live_photon_powers(pm, cg.ir),
                                     pm.power)
    log("fwd-bwd", f"{CW}x{CH} depth {cg.depth} float32, seed {SEED}: "
        f"photon pass {cg.photon_s:.4f} s ({cg.maps[photon.CAUSTIC].n} "
        f"caustic, {cg.maps[photon.GLOBAL].n} global photons), set-up "
        f"{setup:.2f} s with the probe of {cg.n_chunks} chunks of "
        f"{cg.chunk} pixels (most spawns {cg.counts}, chunk 0's "
        f"{cg.chunk_counts[0]}; buckets {cg.buckets}); live photon powers "
        f"bitwise the stored: {same}")
    if not all(same.values()):
        raise AssertionError("live photon powers differ from the stored "
                             "ones on the card")
    t0 = time.perf_counter()
    loss, ovf = cg.loss(0)
    loss.backward()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    wall, loss, ovfs, fwd, bwd = fb_frame(cg)
    peak = torch.cuda.max_memory_allocated(device)
    g = {k: p.grad for k, p in cg.params.items() if p.grad is not None}
    finite = all(bool(torch.isfinite(x).all()) for x in g.values())
    l1 = float(g["mat_Kd"].abs().sum() + g["light_intensity"].abs().sum())
    tri = float(g["tri_p1"].abs().max())
    log("fwd-bwd", f"fwd_bwd_ms_cornell_800x800 {wall * 1e3:.1f} "
        f"({cg.n_chunks} chunks of {cg.chunk} pixels, all 640,000 pixels; "
        f"{wall * 1e3 / cg.n_chunks:.1f} ms a chunk); warm-up chunk "
        f"{warm:.3f} s; peak device memory {peak / 2**30:.3f} GiB (budget "
        f"{FB_PEAK_BUDGET / 2**30:.0f} GiB); loss {loss:.6g}; launches "
        f"forward {fwd}, backward {bwd}; overflow {ovfs}; gradients finite "
        f"{finite}; L1 of mat_Kd + light_intensity {l1:.6g}; max |tri_p1| "
        f"{tri:.6g}")
    if any(ovfs) or bool(ovf):
        raise AssertionError("a Cornell forward+backward chunk overflowed "
                             "its buckets")
    if not (finite and np.isfinite(loss)):
        raise AssertionError("non-finite Cornell loss or gradient")
    if not l1 > 0.0 or not tri > 0.0:
        raise AssertionError("zero Kd/intensity or vertex gradient")
    if peak > FB_PEAK_BUDGET:
        raise AssertionError("the Cornell forward+backward peaked past its "
                             "budget")
    if min(fwd[k] for k in (*compact.LAUNCHES, *mesh.LAUNCHES)) < 1 or \
            min(bwd[k] for k in ("compact", "expand", "table_grad")) < 1:
        raise AssertionError(f"a kernel of the forward+backward never ran: "
                             f"forward {fwd}, backward {bwd}")
    return cg, {"ms": wall * 1e3, "chunk_ms": wall * 1e3 / cg.n_chunks,
                "peak": peak, "fwd": fwd, "bwd": bwd, "photon_s": cg.photon_s,
                "chunk": cg.chunk}


def profile_fb_chunk(cg, c=None):
    """One warm chunk's forward+backward (the middle one) under
    torch.profiler, device activity only (reading CPU events of a chunk's
    ~10^5 launches takes minutes): its unprofiled wall, device busy time
    and idle share, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    c = cg.n_chunks // 2 if c is None else c

    def run():
        for p in cg.params.values():
            p.grad = None
        loss, _ = cg.loss(c)
        loss.backward()
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    t0 = time.perf_counter()
    rows = prof.key_averages()
    kernels, copies, busy, _ = profile_summary(prof, rows)
    self_dev = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    top = sorted(rows, key=self_dev, reverse=True)[:8]
    tops = ", ".join(f"{e.key[:60]} {self_dev(e) / 1e3:.2f} ms ({e.count})"
                     for e in top)
    log("fwd-bwd-profile", f"chunk {c} of {cg.n_chunks}: {kernels} kernel "
        f"launches and {copies} copies/memsets; unprofiled wall {wall:.4f} s"
        f", device busy {busy:.4f} s -> device idle share "
        f"{1 - busy / wall:.3f}; top kernels by device time: {tops}; read "
        f"in {time.perf_counter() - t0:.1f} s")
    return {"busy_s": busy, "wall_s": wall}


def check_fb_plain(cg):
    """The held chunk's gradients (kernels) against those with the plain
    compaction and the plain mesh queries, within TRAIN_STRIP_RTOL of
    each field's largest |g|."""
    span = FB_HELD
    buckets = fb_buckets(cg.probe(0, span))
    kern, ovf = cg.grads(0, span, buckets)
    with plain_mesh():
        plain, ovf_p = cg.grads(0, span, buckets, compaction="plain")
    same = all(torch.equal(kern[k], plain[k]) for k in kern)
    diff = _grad_diff(kern, plain)
    worst = max(diff, key=diff.get)
    log("fwd-bwd-equal", f"{span[1]} pixels from pixel {span[0]}, buckets "
        f"{buckets}: kernel vs plain-versions gradients bitwise={same}, "
        f"largest share of a field's max |g| {diff[worst]:.3e} ({worst}); "
        f"bound {TRAIN_STRIP_RTOL}; overflow {ovf or ovf_p}")
    if ovf or ovf_p or diff[worst] > TRAIN_STRIP_RTOL:
        raise AssertionError("Cornell gradients with the kernels differ "
                             "from the plain versions'")


def check_fb_card_vs_cpu(device, w=16, h=16, photons=4000):
    """cornell_box(w, h) with the block in float64: the maps traced once on
    the CPU and moved to the card, the draws made on the CPU for both
    (HostDraws), the CPU's buckets; each field's gradient of the whole
    frame as one chunk on the card within TRAIN_CARD_CPU_RTOL of its
    largest |g| on the CPU."""
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        ref = CornellGrad(cpu, w * h, w, h, torch.float64, photons,
                          draws=HostDraws(RNG(SEED), cpu))
        want, ovf_c = ref.grads(0)
        cpu_s = time.perf_counter() - t0
        card = CornellGrad(device, w * h, w, h, torch.float64, photons,
                           maps=ref.maps, draws=HostDraws(RNG(SEED), device),
                           buckets=ref.buckets)
        got, ovf = card.grads(0)
    finally:
        torch.set_num_threads(threads)
    diff = _grad_diff({k: v.cpu() for k, v in got.items()}, want)
    worst = max(diff, key=diff.get)
    log("fwd-bwd-card-cpu", f"{w}x{h} float64 with the block, {photons} "
        f"photons a map: {len(diff)} fields, largest share of a field's "
        f"max |g| {diff[worst]:.3e} ({worst}); bound {TRAIN_CARD_CPU_RTOL}; "
        f"CPU side {cpu_s:.1f} s; overflow {ovf or ovf_c}")
    if ovf or ovf_c or diff[worst] > TRAIN_CARD_CPU_RTOL:
        raise AssertionError("Cornell card gradients differ from the CPU's")


def check_fb_adam(cg):
    """One Adam step (make_train_step, an RNG node) on the held chunk with
    a grey target: the block's vertices move; on the moved mesh the
    closest kernel equals its plain version bitwise on the chunk's camera
    rays."""
    span = FB_HELD
    buckets = fb_buckets(cg.probe(0, span))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in cg.params.items()}
    init, step = make_train_step(cg.rt, cg.cam, cg.static, 1, cg.depth,
                                 remat="level", buckets=buckets)
    state = init(params)
    (px, py, uv, ap), rng = cg.args(0, span)
    before = params["tri_p1"].detach().clone()
    target = torch.full((px.shape[0], 3), 0.5, dtype=cg.dtype,
                        device=cg.device)
    state, loss, ovf = step(state, px, py, uv, ap, target, rng)
    # the block's tail padding (to whole clusters) holds non-finite rows
    fin = torch.isfinite(before)
    moved = float((params["tri_p1"].detach() - before)[fin].abs().max())
    m = cg.rt.mesh._replace(tris=mesh.pack_tris(
        *(params[k].detach() for k in ("tri_p1", "tri_e1", "tri_e2"))))
    o, d = rays_for_pixels(cg.cam, px, py, uv, ap)
    got = mesh.closest_cuda(m, o.contiguous(), d.contiguous())
    want = mesh.closest_plain(m, o.contiguous(), d.contiguous())
    same, _ = _equal_outputs(got, want)
    hits = int(torch.isfinite(got[0]).sum())
    log("fwd-bwd-adam", f"one Adam step on {span[1]} pixels from pixel "
        f"{span[0]}: loss {float(loss):.6g}, overflow {bool(ovf)}, the "
        f"block's vertices moved by up to {moved:.3g}; on the moved mesh "
        f"closest kernel vs plain on the chunk's camera rays ({hits} mesh "
        f"hits) bitwise={same}")
    if bool(ovf) or not np.isfinite(float(loss)) or not moved > 0.0:
        raise AssertionError("the Adam step overflowed or moved no vertex")
    if not same or not hits:
        raise AssertionError("mesh closest != plain on the moved mesh")


# ---------------------------------------------------------------------------
# the multi-device slice: a world of one over NCCL, two ranks sharing the
# card over gloo, the bucket cache and --profile
# ---------------------------------------------------------------------------

# the ranks of phases 34-37: two processes on cuda:0, joined over gloo
# through a file:// store (NCCL refuses two ranks on one GPU); a rank
# that has not finished within RANK_TIMEOUT_S fails the script
RANKS = 2
RANK_TIMEOUT_S = 420


def world_of_one(device, want, want_launches):
    """33: the flagship through render_scene on a one-rank NCCL mesh, in
    this process: phase 4's canvas bitwise and its compaction launches."""
    with tempfile.TemporaryDirectory(prefix="frt_nccl_") as tmp:
        distributed.init(f"file://{tmp}/store", 1, 0, local_device_ids=[0])
        try:
            pm = distributed.global_mesh()
            compact.LAUNCHES.update(compact=0, expand=0)
            canvas, t = frame(device, pmesh=pm)
            launches = dict(compact.LAUNCHES)
            backend = torch.distributed.get_backend(pm.group)
        finally:
            distributed.shutdown()
    same = np.array_equal(canvas, want)
    log("world-of-one", f"{W}x{H} flagship on a mesh of 1 rank over "
        f"{backend}: {t:.3f} s (probe included), launches {launches} (phase "
        f"4: {want_launches}), bitwise phase 4's canvas={same}")
    if not same or launches != want_launches:
        raise AssertionError("the world of one differs from phase 4")


def photon_maps_hash(device, scene):
    """sha256 over every tensor and field of the scene's photon maps, traced
    as render_scene traces them at SEED."""
    cfg = scene.config
    ir = compile_scene(scene, dtype=torch.float32, device=device)
    maps = photon.trace_photons(
        ir, build_statics(ir, cfg), RNG(SEED, device).fold(PHOTON_FOLD),
        torch.float32, caustic=cfg.include_caustics,
        global_=cfg.include_final_gather)
    h = hashlib.sha256()
    for key in sorted(maps):
        pm = maps[key]
        fields = {} if pm is None else pm._asdict()
        for name, v in fields.items():
            h.update(name.encode())
            h.update(v.cpu().numpy().tobytes() if torch.is_tensor(v)
                     else repr(v).encode())
    return h.hexdigest()


def rank_worker(rank, store, out, reps):
    """One of the RANKS processes of phases 34-37 (chip_smoke.py --rank):
    renders on its shards, steps on its shard, and leaves its canvases,
    gradients and a JSON of its results in `out` for the parent."""
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init(store, RANKS, rank, local_device_ids=[0],
                     backend="gloo")
    pm = distributed.global_mesh()
    res = {}
    try:
        # 34. the flagship
        _reset_launches()
        canvas, cold = frame(device, pmesh=pm)
        res["flagship_launches"] = _launch_counts()
        res["flagship_walls"] = [frame(device, pmesh=pm)[1]
                                 for _ in range(reps)]
        np.save(os.path.join(out, f"flagship_{rank}.npy"), canvas)
        log("ranks-flagship", f"rank {rank}: first call {cold:.3f} s, "
            f"launches {res['flagship_launches']}")
        # 35. the mesh frame
        _reset_launches()
        canvas, cold = frame(device, scene=mesh_torus(MW, MH), pmesh=pm)
        res["mesh_launches"] = _launch_counts()
        res["mesh_walls"] = [frame(device, scene=mesh_torus(MW, MH),
                                   pmesh=pm)[1] for _ in range(reps)]
        np.save(os.path.join(out, f"mesh_{rank}.npy"), canvas)
        # 36. the Cornell GI frame, twice at SEED
        scene = cornell_box(CW, CH)
        res["photon_maps_sha256"] = photon_maps_hash(device, scene)
        _reset_launches()
        stats = {}
        canvas, cold = frame(device, scene=scene, seed=SEED, stats=stats,
                             pmesh=pm)
        res["cornell_launches"] = _launch_counts()
        res["cornell_stats"] = {k: stats[k] for k in
                                ("buckets", "escalations", "exact_chunks")}
        again, wall = frame(device, scene=scene, seed=SEED, pmesh=pm)
        res["cornell_first_s"], res["cornell_wall"] = cold, wall
        res["cornell_same_seed"] = bool(np.array_equal(canvas, again))
        res["cornell_finite"] = bool(np.isfinite(canvas).all())
        np.save(os.path.join(out, f"cornell_{rank}.npy"), canvas)
        del canvas, again
        # 37. phase 19's train step, the batch split over the ranks
        ts = TrainSet(device)
        params = ts.fresh()
        groups = [{"params": [params[k] for k in TRAIN_TABLES]},
                  {"params": [p for k, p in params.items()
                              if k not in TRAIN_TABLES], "lr": 0.0}]
        init, step = make_train_step(ts.rt, ts.cam, ts.static, 1, ts.depth,
                                     remat="level", buckets=ts.buckets,
                                     optimizer=lambda ps: adam(groups),
                                     mesh=pm)
        state = replicate_scene(pm, init(params))
        batch = shard_pixel_batch(pm, *ts.args, ts.target)
        _reset_launches()
        fwd = {}
        state, loss, ovf = step(state, *batch,
                                between=lambda: fwd.update(compact.LAUNCHES))
        torch.cuda.synchronize()
        total = dict(compact.LAUNCHES)
        res["train_fwd"] = fwd
        res["train_bwd"] = {k: total[k] - fwd[k] for k in total}
        res["train_loss"], res["train_overflow"] = float(loss), bool(ovf)
        torch.save({"grads": {k: p.grad.detach().cpu()
                              for k, p in params.items()},
                    "params": {k: p.detach().cpu()
                               for k, p in params.items()}},
                   os.path.join(out, f"train_{rank}.pt"))
        times = []
        for _ in range(reps):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            state, loss, ovf = step(state, *batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res["train_ms"] = [t * 1e3 for t in times]
        # one more step under torch.profiler, after the timed ones: this
        # rank's kernels and device busy time against its step's wall
        from torch.profiler import ProfilerActivity, profile
        torch.distributed.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, *batch)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        kernels, copies, busy, top = profile_summary(prof)
        res["train_profile"] = {"kernels": kernels, "copies": copies,
                                "busy_s": busy, "profiled_s": t, "top": top}
    finally:
        distributed.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def run_ranks(reps):
    """Start the RANKS worker processes and wait for both (each within
    RANK_TIMEOUT_S); a rank that fails or does not finish kills both and
    fails the script. Returns (the results' directory, each rank's JSON),
    the directory removed by the caller."""
    tmp = tempfile.mkdtemp(prefix="frt_ranks_")
    procs = []
    try:
        for r in range(RANKS):
            logf = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 "--store", f"file://{tmp}/store", "--out", tmp, "--reps",
                 str(reps)], stdout=logf, stderr=subprocess.STDOUT), logf,
                time.monotonic() + RANK_TIMEOUT_S))
        failed = []
        for r, (p, logf, deadline) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"no end within {RANK_TIMEOUT_S} s"
            logf.close()
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                for line in f.read().splitlines():
                    print(f"[rank {r}] {line}", flush=True)
            if rc != 0:
                failed.append(f"rank {r}: {rc}")
        if failed:
            raise AssertionError(f"a rank failed: {failed}")
    finally:
        for p, logf, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    results = []
    for r in range(RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return tmp, results


def two_ranks(reps, flagship, mcanvas, train_grads):
    """34-37: the two ranks' results against phases 4, 8 and 19, and
    against each other. Returns each kernel's launches per rank."""
    torch.cuda.empty_cache()
    tmp, res = run_ranks(reps)
    try:
        def canvases(name):
            return [np.load(os.path.join(tmp, f"{name}_{r}.npy"))
                    for r in range(RANKS)]

        def walls(key):
            return [statistics.median(x[key]) for x in res]

        # 34
        same = [np.array_equal(c, flagship) for c in canvases("flagship")]
        fl = [x["flagship_launches"] for x in res]
        log("ranks-flagship", f"{W}x{H} flagship, {RANKS} ranks sharing "
            f"one card over gloo, one chunk: launches per rank {fl}; "
            f"bitwise phase 4's canvas {same}; warm wall per rank "
            f"{walls('flagship_walls')} s (median of {reps}; 2 ranks sharing "
            f"one card, not a scaling figure)")
        if not all(same) or min(min(x["compact"], x["expand"])
                                for x in fl) < 1:
            raise AssertionError("the two-rank flagship differs from phase 4 "
                                 "or a rank launched no compaction")
        # 35
        same = [np.array_equal(c, mcanvas) for c in canvases("mesh")]
        ml = [x["mesh_launches"] for x in res]
        log("ranks-mesh", f"{MW}x{MH} mesh_torus, {RANKS} ranks: launches "
            f"per rank {ml}; bitwise phase 8's canvas {same}; warm wall per "
            f"rank {walls('mesh_walls')} s")
        if not all(same) or min(min(x.values()) for x in ml) < 1:
            raise AssertionError("the two-rank mesh frame differs from "
                                 "phase 8 or a rank skipped a kernel")
        # 36
        cs = canvases("cornell")
        cl = [x["cornell_launches"] for x in res]
        hashes = {x["photon_maps_sha256"] for x in res}
        across = all(np.array_equal(c, cs[0]) for c in cs)
        log("ranks-cornell", f"{CW}x{CH} Cornell GI at seed {SEED}, {RANKS} "
            f"ranks: photon maps' sha256 {sorted(hashes)}; canvases equal "
            f"across ranks {across}; the same seed twice bitwise "
            f"{[x['cornell_same_seed'] for x in res]}; finite "
            f"{[x['cornell_finite'] for x in res]}; stats "
            f"{[x['cornell_stats'] for x in res]}; launches per rank {cl}; "
            f"first call {[round(x['cornell_first_s'], 4) for x in res]} s, "
            f"warm wall {[round(x['cornell_wall'], 4) for x in res]} s")
        if len(hashes) != 1 or not across or not all(
                x["cornell_same_seed"] and x["cornell_finite"]
                and not x["cornell_stats"]["exact_chunks"] for x in res):
            raise AssertionError("the two-rank Cornell frame is not the same "
                                 "on both ranks, finite and deterministic")
        if min(min(x.values()) for x in cl) < 1:
            raise AssertionError(f"a rank skipped a kernel of the GI path: "
                                 f"{cl}")
        # 37
        tr = [torch.load(os.path.join(tmp, f"train_{r}.pt"))
              for r in range(RANKS)]
        same = all(torch.equal(tr[0]["params"][k], t["params"][k])
                   for t in tr for k in tr[0]["params"])
        want = {k: g.cpu() for k, g in train_grads.items()}
        diff = _grad_diff(tr[0]["grads"], want)
        worst = max(diff, key=diff.get)
        ovf = [x["train_overflow"] for x in res]
        log("ranks-train", f"phase 19's step ({W}x{H}, remat='level'), the "
            f"batch split over {RANKS} ranks: launches per rank forward "
            f"{[x['train_fwd'] for x in res]}, backward "
            f"{[x['train_bwd'] for x in res]}; parameters bitwise across "
            f"ranks {same}; all-reduced gradients vs phase 19's first step: "
            f"largest share of a field's max |g| {diff[worst]:.3e} ({worst}); "
            f"loss {[x['train_loss'] for x in res]}, overflow {ovf}; step "
            f"{walls('train_ms')} ms per rank (median of {reps})")
        for r, x in enumerate(res):
            p = x["train_profile"]
            step_s = statistics.median(x["train_ms"]) / 1e3
            log("ranks-train-profile", f"rank {r}, one profiled step: "
                f"{p['kernels']} kernel launches and {p['copies']} "
                f"copies/memsets; profiled wall {p['profiled_s']:.4f} s, "
                f"this rank's device busy {p['busy_s']:.4f} s; unprofiled "
                f"step {step_s:.4f} s -> its idle share "
                f"{1 - p['busy_s'] / step_s:.3f}; top operators by device "
                f"time: {p['top']}")
        if not same or any(ovf) or diff[worst] > TRAIN_STRIP_RTOL:
            raise AssertionError("the two-rank train step differs")
        if min(min(x["train_fwd"].values()) for x in res) < 1 or min(
                min(x["train_bwd"].values()) for x in res) < 1:
            raise AssertionError("a rank's train step skipped a compaction "
                                 "kernel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def per_rank(key, name):
        return [x[key].get(name, 0) for x in res]

    return {name: {"launches_2rank_flagship":
                   per_rank("flagship_launches", name),
                   "launches_2rank_mesh": per_rank("mesh_launches", name),
                   "launches_2rank_cornell": per_rank("cornell_launches", name),
                   "launches_2rank_train_fwd": per_rank("train_fwd", name),
                   "launches_2rank_train_bwd": per_rank("train_bwd", name)}
            for name in ("compact", "expand", "mesh_closest", "mesh_shadow")}


# the dry run's loss over one rank and over two: the same squared errors
# summed in another order in float32 (the two shards' sums all-reduced)
DRYRUN_LOSS_RTOL = 1e-5


def bench_entry_points(device, want):
    """39: the bench's flagship cell, its frame against phase 4's canvas;
    entry()'s forward step; the dry run on one rank and on two."""
    from bench_torch import entry, headline
    t0 = time.perf_counter()
    res = headline.flagship(device, 3)
    m = res["metrics"][headline.METRIC]
    same = np.array_equal(res["image"], want)
    log("bench", f"flagship cell: {m['value']:.4g} rays/s (median of "
        f"{m['n']} rounds of {headline.REPS} frames, {m['min']:.4g} to "
        f"{m['max']:.4g}); launches a round "
        f"{res['info']['launches_per_round']}; its pixel_colors frame "
        f"bitwise phase 4's canvas={same}")
    if not same:
        raise AssertionError("the bench's flagship frame differs from "
                             "phase 4's canvas")
    fn, args = entry.entry(device)
    colors, overflow = fn(*args)
    ok = (tuple(colors.shape) == (64 * 32, 3)
          and bool(torch.isfinite(colors).all()) and not bool(overflow))
    log("bench", f"entry(): forward {tuple(colors.shape)} {colors.dtype} "
        f"on {colors.device}, finite and no overflow={ok}")
    if not ok:
        raise AssertionError("entry()'s forward step failed")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # both dry runs at once: their three rank processes spend most of
    # their time starting up
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        one, two = pool.map(entry.dryrun_multichip, (1, 2))
    same = np.array_equal(one["canvas"], two["canvas"])
    rel = abs(two["loss"] - one["loss"]) / abs(one["loss"])
    log("bench", f"dryrun_multichip: 1 rank over {one['placement']['backend']}"
        f", 2 ranks over {two['placement']['backend']} (sharing the card "
        f"{two['placement']['shared']}); losses {one['loss']:.9g} and "
        f"{two['loss']:.9g} (relative difference {rel:.3e}); canvases "
        f"bitwise {same}; the dry runs took {time.perf_counter() - t1:.1f} "
        f"s, phase 39 {time.perf_counter() - t0:.1f} s")
    if not same or not rel <= DRYRUN_LOSS_RTOL:
        raise AssertionError("the dry run over two ranks differs from one")


def cache_and_profile(device):
    """38: the flagship in a fresh bucket cache, cold (probe, entry
    written) and warm (hit, no probe), bitwise; then the command line's
    --profile on soft_textured.yml: the phase lines and a trace naming
    both kernel sources' kernels."""
    prev = os.environ["FRT_COMPILE_CACHE"]
    runs = []
    with tempfile.TemporaryDirectory(prefix="frt_cache_") as cache:
        os.environ["FRT_COMPILE_CACHE"] = cache
        try:
            for _ in range(2):
                timer = PhaseTimer()
                canvas, t = frame(device, timer=timer)
                runs.append((canvas, t, {p["phase"]: p["seconds"]
                                         for p in timer.phases}))
            written = os.path.exists(os.path.join(cache, "frt_buckets.json"))
        finally:
            os.environ["FRT_COMPILE_CACHE"] = prev
    (cold, cold_t, cold_ph), (warm, warm_t, warm_ph) = runs
    same = np.array_equal(cold, warm)
    log("cache", f"{W}x{H} flagship in a fresh cache: cold {cold_t:.4f} s "
        f"(probe {cold_ph.get('probe_buckets', float('nan')):.4f} s, entry "
        f"written {written}), warm {warm_t:.4f} s (probe run "
        f"{'probe_buckets' in warm_ph}); bitwise {same}; phases cold "
        f"{cold_ph}, warm {warm_ph}")
    if not (same and written and "probe_buckets" in cold_ph) \
            or "probe_buckets" in warm_ph:
        raise AssertionError("the bucket cache did not skip the probe")
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="frt_profile_") as prof:
        t0 = time.perf_counter()
        cli_main([str(SOFT_DIR / "soft_textured.yml"), "-o",
                  os.path.join(OUT_DIR, "soft_profiled"), "--chunk",
                  str(W * H), "--quiet", "--profile", prof])
        secs = time.perf_counter() - t0
        path = os.path.join(prof, TRACE_FILE)
        size = os.path.getsize(path)
        with open(path) as f:
            text = f.read()
    # kernel names, mangled or not: both libraries' kernels, both queries
    names = {k: k in text for k in ("compact_kernel", "expand_kernel",
                                    "pair_kernel", "ClosestQ", "ShadowQ")}
    log("profile-cli", f"--profile on soft_textured.yml: {secs:.2f} s, "
        f"trace {size / 2**20:.1f} MiB, kernels named {names}")
    if not all(names.values()):
        raise AssertionError("the --profile trace misses a kernel")


def profile_summary(prof, rows=None):
    """(kernel launches, copies and memsets, device busy s, the top eight
    aten operators by device time as text) of a torch.profiler run;
    `rows` as in device_us."""
    from torch.autograd import DeviceType
    rows = prof.key_averages() if rows is None else rows
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
            device_us(prof, rows) / 1e6, top)


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
    ap.add_argument("--table-grad", action="store_true",
                    help="build, then run only the gather backward's size "
                    "sweep and phase 21b")
    ap.add_argument("--irradiance", action="store_true",
                    help="build, then run only phase 27b")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)    # phases 34-37's workers
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.rank is not None:
        return rank_worker(args.rank, args.store, args.out, args.reps)
    started = time.perf_counter()
    device = torch.device("cuda", 0)
    # the bucket cache of every render in this run, its own
    cache_dir = tempfile.mkdtemp(prefix="frt_cache_")
    os.environ["FRT_COMPILE_CACHE"] = cache_dir
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
    if not native.available():
        raise AssertionError("the host C++ walks did not build")
    log("build", "host C++ walks (native/) built: compile_scene takes them")
    if args.table_grad:
        sweep = table_grad_sweep(device)
        tg = check_table_grad(device)
        print(smi, flush=True)
        print(json.dumps({"table_grad_sweep": sweep, "table_grad": tg}),
              flush=True)
        shutil.rmtree(cache_dir, ignore_errors=True)
        return 0
    if args.irradiance:
        irr = check_irradiance(device)
        print(smi, flush=True)
        print(json.dumps({"irradiance": irr}), flush=True)
        shutil.rmtree(cache_dir, ignore_errors=True)
        return 0

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
    gather.LAUNCHES.update(table_grad=0, table_grad_plain=0)
    stats = {}
    canvas, cold = frame(device, stats=stats)
    launches = dict(compact.LAUNCHES)
    flag_gather = dict(gather.LAUNCHES)
    log("render", f"800x400 depth 5 float32: launches {launches}, "
        f"buckets {stats['buckets']}, escalations {stats['escalations']}, "
        f"exact chunks {stats['exact_chunks']}, first call {cold:.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if any(flag_gather.values()):
        raise AssertionError(f"a frame without autograd took the gathers' "
                             f"grad path: {flag_gather}")
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
    tgstats = check_table_grad(device)
    log("train", f"phases 19-21b took {time.perf_counter() - t0:.1f} s")

    # 22-27. the stochastic camera path, the photon pass, the GI frame
    # counted and its mesh launches against the plain versions, its
    # equality with the plain compaction, the card against the CPU, and
    # the command line's output
    t0 = time.perf_counter()
    dof_launches, dof_wall = render_dof(device, args.reps)
    photon_pass(device)
    ccanvas, claunches, cornell_wall, _ = render_cornell(device, args.reps)
    cmesh = check_cornell_mesh(device)
    for key, label, name in (
            ("closest", "photon wave closest", "wave_first"),
            ("closest", "photon wave closest, last", "wave_last"),
            ("closest", "gather closest", "gather"),
            ("shadow", "shadow", "shadow_level0")):
        got = dict(cmesh[label])
        mstats[key]["max_abs_err"] = max(mstats[key]["max_abs_err"],
                                         got.pop("max_abs_err"))
        mstats[key].update({f"cornell_{name}_{k}": v for k, v in got.items()})
    check_cornell_equal(device, ccanvas)
    check_cornell_card_vs_cpu(device)
    cornell_output(ccanvas)
    irrstats = check_irradiance(device)
    log("cornell", f"phases 22-27b took {time.perf_counter() - t0:.1f} s")

    # 28-32. the GI and mesh gradient path: the 800x800 Cornell
    # forward+backward counted and timed with its live photon powers, a
    # chunk against the plain versions, the card against the CPU, and an
    # Adam step that moves the block
    t0 = time.perf_counter()
    cg, fb = cornell_fwd_bwd(device)
    check_fb_plain(cg)
    check_fb_card_vs_cpu(device)
    check_fb_adam(cg)
    log("fwd-bwd", f"phases 28-32 took {time.perf_counter() - t0:.1f} s")

    # 33-38. the multi-device path: the flagship on a world of one over
    # NCCL; two ranks sharing the card over gloo (the flagship, the mesh
    # frame, the Cornell frame and phase 19's train step, split over the
    # ranks); the bucket cache cold and warm; the command line's --profile
    t0 = time.perf_counter()
    world_of_one(device, canvas, launches)
    ranked = two_ranks(args.reps, canvas, mcanvas, tstats["level"]["grads"])
    cache_and_profile(device)
    log("multi-device", f"phases 33-38 took {time.perf_counter() - t0:.1f} "
        f"s")


    for key, dev_stats in kernel_device_ms(
            device, W * H, b0,
            {k: kstats[k]["ms"] for k in ("compact", "expand")}).items():
        kstats[key].update(dev_stats)
    profile_showcase(device, show_wall)
    profile_showcase(device, soft_wall, soft_textured(W, H), "soft-profile")
    profile_train_step(device, tstats["level"]["ms"])
    profile_cornell(device)
    profile_fb_chunk(cg)
    if args.profile:
        profile_to(args.profile, device, b0, f"{kind}; {smi}", wall,
                   mesh_wall)

    # 39. the bench's flagship cell and driver entry points, after the
    # profiled sections: run before them, it left the next profile of
    # this process 2 kernel events short of its 20 calls
    bench_entry_points(device, canvas)

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
                     "launches_dof": dof_launches[key],
                     "launches_cornell": claunches[key],
                     "launches_cornell_fwd_bwd_fwd": fb["fwd"][key],
                     "launches_cornell_fwd_bwd_bwd": fb["bwd"][key],
                     **ranked[key], **kstats[key]})
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
                     "launches_dof": dof_launches[f"mesh_{key}"],
                     "launches_cornell": claunches[f"mesh_{key}"],
                     "launches_cornell_fwd_bwd_fwd": fb["fwd"][f"mesh_{key}"],
                     "launches_cornell_fwd_bwd_bwd": fb["bwd"][f"mesh_{key}"],
                     **ranked[f"mesh_{key}"], **mstats[key]})
    rows.append({"name": "take_rows backward (table_grad)", "route": "cuda",
                 "source": GATHER_SRC, "replaces": "none (XLA's scatter-add "
                 "in the JAX package)", "launches": flag_gather["table_grad"],
                 "launches_train_fwd": tstats["level"]["fwd"]["table_grad"],
                 "launches_train_bwd": tstats["level"]["bwd"]["table_grad"],
                 "launches_cornell_fwd_bwd_bwd": fb["bwd"]["table_grad"],
                 "launches_reflect_refract_bwd":
                     tgstats.pop("launches_train_bwd"), **tgstats})
    rows.append({"name": "irradiance estimate (irradiance)", "route": "cuda",
                 "source": PHOTON_SRC, "replaces": "none (jnp code in the "
                 "JAX package)", "launches_cornell": claunches["irradiance"],
                 **irrstats})
    shutil.rmtree(cache_dir, ignore_errors=True)
    log("done", f"the whole script took {time.perf_counter() - started:.1f} "
        f"s")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
