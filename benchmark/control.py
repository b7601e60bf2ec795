"""The control of a cell: the reference put in the program's place,
computed one precision below the configuration's (bfloat16 for its
float32), judged by the cell's own comparison against the reference in
the configuration's precision.

    python3 -m benchmark.control --config FILE --loop frames|train
                                 --seeds N [N ...] [--dtype bfloat16]

`--config`: a configuration's file (benchmark/configs/<name>.json).
`frames`: renders the configuration's scene at its own size and
chunking with the reference (benchmark/reference/frt) for each of the
frames traffic's set of frame seeds that `--seeds` numbers (0 is the
set's first). `train`: the reference's job (loops/train.Job, the
target's factors from the seed) through its first steps. Each once in
the configuration's dtype and once in `--dtype`; one JSON line a seed
and variant with each number of reference/compare.py and its limit. The
benchmark's runs never run it: it is how the limits' upper readings
were taken (PERF.md). On a CUDA card; `--device cpu` with `--resolution
W H --photons N --batch N` for a small run. A frames cell with photon GI in
bfloat16 leaks photons out of the scene and its map's grid asks for
more memory than the host has: `--photon-dtype float32` keeps the photon
pass in float32 and computes the rest in `--dtype`. `--faults` (train)
also reads a training cell's faults, each planted in the reference put
in the program's place, against the same clean reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import generator
from benchmark.loops import train as L
from benchmark.reference import compare


def _first_steps(cfg, first, scene_file, dtype, dev, seed, fault=None,
                 photon_dtype=None):
    """The reference job's first steps; `fault` plants one of a training
    cell's faults in it: "half_left_out" (half of the batch left out, the
    mean taken over the rest), "answer_altered" (every rendered color 2%
    too bright where pixel_colors produces it) or "state_unchanged"
    (Adam never updates)."""
    from benchmark.reference.frt.parallel import train as T
    tc = cfg["train"]
    job = L.Job(generator.reference_modules(), scene_file, dtype, dev, tc,
                seed, first, photon_dtype)
    job.set_target(L.kd_factors(seed, job.n_materials()))
    if fault == "half_left_out":
        whole = job.batch

        def batch(i):
            *xs, rng = whole(i)
            return (*(x[:x.shape[0] // 2] for x in xs), rng)
        job.batch = batch
    orig_pc, orig_adam = T.pixel_colors, job.mods.adam
    if fault == "answer_altered":
        def pixel_colors(*a, **k):
            colors, ovf = orig_pc(*a, **k)
            return colors * 1.02, ovf
        T.pixel_colors = pixel_colors
    if fault == "state_unchanged":
        def adam(groups):
            opt = orig_adam(groups)
            opt.step = lambda *a, **k: None
            return opt
        job.mods.adam = adam
    try:
        return L.first_steps(job, tc["tables"], tc["remat"],
                             int(tc.get("reference_steps", first)))[2]
    finally:
        T.pixel_colors = orig_pc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--config", required=True)
    ap.add_argument("--loop", choices=("frames", "train"), default="frames")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--faults", nargs="*", default=(),
                    choices=("half_left_out", "answer_altered",
                             "state_unchanged"),
                    help="train: also judge the reference with each of "
                    "these faults planted, in the configuration's dtype")
    ap.add_argument("--photon-dtype", default=None,
                    help="trace the control's photons in this precision "
                    "(default: --dtype)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resolution", type=int, nargs=2, default=None)
    ap.add_argument("--photons", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="train: pixels a step (a small run's)")
    args = ap.parse_args(argv)
    root = os.getcwd()
    with open(os.path.join(root, args.config)) as f:
        cfg = json.load(f)
    resize = None
    if args.resolution:
        w, h = args.resolution
        resize = {"scene_set": {"camera": {"width": w, "height": h}},
                  "chunk_pixels": w * h}
        if args.photons:
            resize["scene_set"]["config"] = {"illumination": {
                "global-illumination": {"photon-count": args.photons}}}
    if args.batch and "train" in cfg:
        cfg["train"]["batch_pixels"] = args.batch
    from types import SimpleNamespace
    ctx = SimpleNamespace(root=root, config=cfg, resize=resize)
    scene_file = generator.stage_scene(ctx)
    chunk = (resize or {}).get("chunk_pixels", cfg["chunk_pixels"])
    dev = torch.device(args.device)
    want_dt = getattr(torch, cfg["dtype"])
    low_dt = getattr(torch, args.dtype)
    photon_dt = args.photon_dtype and getattr(torch, args.photon_dtype)
    limits = cfg["limits"][args.loop]
    traffic = {}
    for mix in ("frames", "train"):
        with open(os.path.join(root, "benchmark", "traffic",
                               mix + ".json")) as f:
            traffic[mix] = json.load(f)
    set_root = traffic["frames"]["set_root"]
    first = int(traffic["train"]["first_steps"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.loop == "frames":
            s = generator.unit_seed(set_root, seed)
            want = compare.reference_frame(scene_file, want_dt, chunk, s, dev)
            variants = [(args.dtype, lambda: compare.frame_numbers(
                compare.reference_frame(scene_file, low_dt, chunk, s, dev,
                                        photon_dtype=photon_dt), want))]
        else:
            want = _first_steps(cfg, first, scene_file, want_dt, dev, seed)
            tables = cfg["train"]["tables"]
            variants = [(args.dtype, lambda: compare.train_numbers(
                _first_steps(cfg, first, scene_file, low_dt, dev, seed,
                             photon_dtype=photon_dt), want, tables))]
            variants += [(f, lambda f=f: compare.train_numbers(
                _first_steps(cfg, first, scene_file, want_dt, dev, seed, f),
                want, tables)) for f in args.faults]
        t1 = time.perf_counter()
        for name, numbers in variants:
            t2 = time.perf_counter()
            ok, checks = compare.judge(numbers(), limits)
            print(json.dumps({"config": cfg["name"], "loop": args.loop,
                              "seed": seed, "variant": name,
                              "photon_dtype": args.photon_dtype,
                              "checks": checks, "passes": ok,
                              "reference_s": t1 - t0,
                              "variant_s": time.perf_counter() - t2}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
