"""The port's bench: every cell's metrics by name, with units and spread.

    python3 -m bench_torch [--cell NAME ...] [--reps N] [--seed S]
                           [--profile DIR] [--skip-extras]
                           [--device cuda|cpu]

Runs the headline cell (`flagship`, bench_torch/headline.py) and then the
others (bench_torch/extras.py) in CELLS order, or the cells named by
`--cell`. The cells' sizes are fixed. On the card, both kernel sources
are built first (nvcc, skipped where build/kernels/ holds them). After
each cell it prints one JSON line, {"cell", "device", "metrics": {name:
{"value" (the median), "unit", "min", "max", "n"}}, "info", "cell_s"
(the cell's own wall, set-up included)}; the last line of standard
output is the headline, {"metric": "glass_spheres_whitted_d5_rays_per_s",
"value", "unit", "vs_baseline", "device", "cells", "wall_s", "build_s"}.
A cell whose gate fails, or that raises, stops the run: its traceback
and name go to standard error, no headline is printed, and the command
exits 1.

The whole run keeps its bucket calibrations in a fresh temporary
FRT_COMPILE_CACHE, so a cell's cold call probes and its warm calls read
what the cold one wrote, whatever an earlier run left in the default
cache. Every cell starts with the card's cached memory released and its
peak reset. `--reps` sets the warm calls a cell times (default 3; the
headline's rounds of back-to-back frames). `--seed` replaces each
stochastic cell's own seed. `--profile DIR` profiles one more round of
the headline loop after the timed ones (headline.profile_round). Without
a card the command raises unless `--device cpu` is given; CPU numbers
carry the device "cpu" and are no device metric.

`main(argv, sizes)` is the command; `sizes` ({cell: {argument: value}},
for the tests) passes other sizes to the cells.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

from fast_ray_tracer_tpu_torch import _build

from bench_torch import extras, headline
from bench_torch.common import device_info, resolve

CELLS = {"flagship": headline.flagship, **extras.CELLS}


def main(argv=None, sizes=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m bench_torch",
        description="Time the PyTorch port's cells on the CUDA card.")
    ap.add_argument("--cell", nargs="+", choices=list(CELLS), default=None,
                    help="run these cells only (default: all)")
    ap.add_argument("--reps", type=int, default=3,
                    help="warm calls timed per cell (default 3)")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the stochastic cells (default: each "
                    "cell's own)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile one more round of the headline loop; "
                    "writes DIR/trace.json")
    ap.add_argument("--skip-extras", action="store_true",
                    help="the headline cell only")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default cuda; nothing falls back)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cells = args.cell or list(CELLS)
    if args.skip_extras:
        cells = ["flagship"]
    if args.profile is not None and "flagship" not in cells:
        ap.error("--profile profiles the flagship cell, which is not run")
    sizes = sizes or {}
    dev = device_info(device)
    started = time.perf_counter()
    if device.type == "cuda":
        # both sources at once, so that no cell's cold call holds nvcc
        _build.build(*_build.CUDA_SOURCES)
    build_s = time.perf_counter() - started
    prev = os.environ.get("FRT_COMPILE_CACHE")
    cache = tempfile.mkdtemp(prefix="frt_bench_cache_")
    os.environ["FRT_COMPILE_CACHE"] = cache
    head = None
    try:
        for name in cells:
            kw = dict(sizes.get(name, {}))
            if name == "flagship":
                kw["profile"] = args.profile
            t0 = time.perf_counter()
            try:
                res = CELLS[name](device, args.reps, args.seed, **kw)
            except Exception:
                traceback.print_exc()
                print(f"bench_torch: cell {name} failed", file=sys.stderr,
                      flush=True)
                return 1
            print(json.dumps({"cell": name, "device": dev,
                              "metrics": res["metrics"], "info": res["info"],
                              "cell_s": time.perf_counter() - t0}),
                  flush=True)
            if name == "flagship":
                head = res["metrics"][headline.METRIC]["value"]
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        if prev is None:
            os.environ.pop("FRT_COMPILE_CACHE", None)
        else:
            os.environ["FRT_COMPILE_CACHE"] = prev
    print(json.dumps({"metric": headline.METRIC, "value": head,
                      "unit": "rays/s",
                      "vs_baseline": headline.vs_baseline(head),
                      "device": dev, "cells": cells,
                      "wall_s": time.perf_counter() - started,
                      "build_s": build_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
