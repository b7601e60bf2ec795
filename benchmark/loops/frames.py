"""`frames`: a closed loop of one client rendering whole frames.

Traffic parameters (benchmark/traffic/<mix>.json): `frame_set`,
`set_root`, `warmup_frames`.

Every run renders the same set of `frame_set` frame seeds (drawn from
`set_root`): a photon-GI frame's work depends on its seed (PERF.md), so
the set is fixed and each run draws only its order from `--seed`. Set-up
loads the scene file through the port's YAML loader, builds the port's
kernels and renders the set's first `warmup_frames` frames (the first
compiles the scene, probes the buckets and writes the bucket cache). The
window then renders whole passes over the set, in the run's order, until
the clock passes `--seconds`: `frame_s` is the window's wall over the
frames it completed, `frame_p95_s` the 95th percentile of their walls. A
frame has failed when its buckets escalated or fell back to the exact
trace, or its canvas is not finite. The configuration's `keep_frames`
canvases, chosen from the seed, are compared with the reference after
the window.

With `--trace 1` the set's first frame runs under the profiler in
passes spread over the window (from the warm frame's time, for the
configuration's `trace_units` frames), the metric readers' spans time
every other frame, and after the window that frame runs once more with
the readers' recorders installed (the shapes and inputs of the kernel calls
that the rooflines need).
"""

from __future__ import annotations

import random
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import generator as g
from benchmark import trace as tr
from benchmark.reference import compare
from benchmark.trace import sync


def run(ctx) -> dict:
    from fast_ray_tracer_tpu_torch import _build
    from fast_ray_tracer_tpu_torch.render import render as R
    from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene

    cfg, traffic = ctx.config, ctx.traffic
    dev = ctx.device
    dtype = getattr(torch, cfg["dtype"])
    chunk = int((ctx.resize or {}).get("chunk_pixels", cfg["chunk_pixels"]))
    if dev.type == "cuda":
        _build.build(*_build.CUDA_SOURCES)
    scene_file = g.stage_scene(ctx)
    scene = load_scene(scene_file)

    def frame(s, stats):
        return R.render_scene(scene, dtype=dtype, chunk_pixels=chunk,
                              device=dev, seed=s, stats=stats)

    trace = tr.Trace() if ctx.trace else None
    spans = tr.Spans(trace, dev) if ctx.trace else None
    undo = g.install(ctx.readers, "spans", spans) if ctx.trace else []
    try:
        # the frames' seeds: one fixed set for every run, each run's order
        # drawn from its seed
        frame_set = [g.unit_seed(int(traffic["set_root"]), k)
                     for k in range(int(traffic["frame_set"]))]
        n_set = len(frame_set)
        rng = random.Random(ctx.seed)
        order = list(range(n_set))
        rng.shuffle(order)
        warm = []
        for i in range(int(traffic["warmup_frames"])):
            a = time.perf_counter()
            frame(frame_set[i % n_set], {})
            warm.append(time.perf_counter() - a)
            if spans is not None:
                spans.cur = {}
        sync(dev)
        setup_peak = g.peak_bytes(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if ctx.trace:
            # the set's first frame, in passes spread over the window
            n_trace = int(cfg["trace_units"]["frames"])
            passes = ctx.seconds / max(n_set * warm[-1], 1e-6)
            trace.every = max(1, int(round(passes / n_trace)))
        kept, walls, failed, profiled = [], [], 0, []
        setup_s = time.perf_counter() - ctx.t_start
        t0 = time.perf_counter()
        i = 0
        while True:
            k, p = order[i % n_set], i // n_set
            s = frame_set[k]
            stats = {}
            a = time.perf_counter()
            on_profile = ctx.trace and k == 0 and len(profiled) < n_trace \
                and p % trace.every == trace.every // 2
            if on_profile:
                with tr.profiled(trace, dev):
                    canvas = frame(s, stats)
                profiled.append(s)
            else:
                canvas = frame(s, stats)
            b = time.perf_counter()
            walls.append(b - a)
            if stats["escalations"] or stats["exact_chunks"] or \
                    not np.isfinite(canvas.sum()):
                failed += 1
            # reservoir sampling of the canvases the reference will judge
            if len(kept) < cfg["keep_frames"]:
                kept.append((i, s, canvas))
            else:
                j = rng.randrange(i + 1)
                if j < len(kept):
                    kept[j] = (i, s, canvas)
            if spans is not None:
                # a profiled frame's host spans carry the profiler's cost
                if on_profile:
                    spans.cur = {}
                spans.end_unit()
            i += 1
            if i % n_set == 0 and b - t0 >= ctx.seconds:
                break
        window = time.perf_counter() - t0
        sync(dev)
        peak = g.peak_bytes(dev)
    finally:
        g.uninstall(undo)

    out = {"attempted": i, "failed": failed,
           "metrics": {"setup_s": setup_s, "frame_s": window / i,
                       "frame_p95_s": g.percentile(walls, 95),
                       "peak_mem_gib": peak / g.GIB},
           "memory_peak_bytes": max(peak, setup_peak),
           "info": {"frames": i, "window_s": window,
                    "frame_median_s": statistics.median(walls),
                    "warmup_s": warm, "frame_s": walls[:40]}}
    if ctx.trace:
        if profiled:
            # the first profiled frame again, with the recorders on
            trace.recorded["seed"] = profiled[0]
            undo = g.install(ctx.readers, "install", trace.recorded)
            try:
                frame(profiled[0], {})
                sync(dev)
            finally:
                g.uninstall(undo)
        out["trace"] = trace

    # the reference, once the window has closed and the peak is read
    del scene
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = []
    refs = {}
    for idx, s, canvas in sorted(kept):
        if s not in refs:
            refs[s] = compare.reference_frame(scene_file, dtype, chunk, s,
                                              device=dev)
        readings.append(compare.frame_numbers(canvas, refs[s]))
        print(f"benchmark: frame {idx} (seed {s}) against the reference: "
              f"{readings[-1]}", file=sys.stderr, flush=True)
    out["numbers"] = compare.worst(readings)
    out["limits"] = cfg["limits"]["frames"]
    return out
