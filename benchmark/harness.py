"""One run of one cell of BENCHMARK.json.

    python3 -m benchmark --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell's configuration, traffic mix
and per-layer metrics are found by name: the configuration's file is the
`file` of its entry in BENCHMARK.json, the traffic mix is the data file
benchmark/traffic/<traffic>.json, whose `loop` names the module
benchmark/loops/<loop>.py that drives it, and each per-layer metric is
read by benchmark/metrics/<metric>.py.

The run exits non-zero and prints no result when there is no CUDA card,
or fewer than the cell asks for, and when, after the window, the process
holds jax, jaxlib, flax, the JAX package, bench_torch or chip_smoke. The
program's caches (the kernels' nvcc builds in build/kernels/, the bucket
calibrations in build/benchmark/cache/) are fixed directories of the
checkout, so only a checkout's first run builds and calibrates.

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device` (with `busy_s` and
`window_s` from the profiled units when traced), `breakdown` when
traced, and last `checks`: each number compared, with its limit. The
same numbers end standard error, after a line of what the run saw (its
frames, the window, the card's name and power limit).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "fast_ray_tracer_tpu", "bench_torch",
             "chip_smoke")


def cell_files(root: str, workload: str):
    """(bench, cell entry, configuration, traffic, end-to-end metrics,
    per-layer metrics) of a workload, each found by its name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return bench, cell, config, traffic, e2e, layer


def load_reader(root: str, name: str):
    """benchmark/metrics/<name>.py as a module (names hold dots)."""
    from benchmark.generator import load_module
    return load_module(root, f"benchmark/metrics/{name}.py",
                       "benchmark.metrics." + name.replace(".", "_"))


def load_loop(name: str):
    """benchmark/loops/<name>.py, the loop that a traffic file names."""
    return importlib.import_module("benchmark.loops." + name)


def set_environment(root: str) -> None:
    """Every cache the program or a library keeps, inside the checkout at
    fixed paths; one host thread for torch's and OpenMP's CPU work, and
    the process (the threads it starts after this) on the last two of its
    cores. The frames are host-bound, and a parallel region on a shared
    host waits for its slowest thread. A sandbox may take the affinity and
    not honour it (gVisor reports every thread on core 0): the host's own
    speed, which no setting here fixes, then sets the runs' spread
    (PERF.md section 5)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])
    base = os.path.join(root, "build", "benchmark")
    os.environ["FRT_COMPILE_CACHE"] = os.path.join(base, "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_block(torch, device, out: dict, trace) -> dict:
    cuda = device.type == "cuda"
    block = {"platform": "gpu" if cuda else "cpu",
             "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
             "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace is not None:
        block["busy_s"] = trace.total("busy_s")
        block["window_s"] = trace.total("window_s")
    return block


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    """The command: a CUDA card or no result."""
    args = parse(argv)
    root = os.getcwd()
    cell = cell_files(root, args.workload)[1]
    set_environment(root)
    import torch
    torch.set_num_threads(1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {have}", file=sys.stderr)
        return 2
    result = run(args, root, t_start, torch.device("cuda", 0))
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run(args, root: str, t_start: float, device, resize=None):
    """A run of the cell on `device` -> the result's dict, or None (with
    the reason on standard error) when the process holds a forbidden
    module after the window. `resize` (the tests' small CPU runs only)
    shrinks the staged scene; a CPU run's numbers are no device metric."""
    import torch

    from benchmark import roofline
    from benchmark.reference import compare
    from benchmark.trace import breakdown

    bench, cell, config, traffic, e2e, layer = cell_files(root,
                                                          args.workload)
    readers = [load_reader(root, m["name"]) for m in layer] \
        if args.trace else []
    ctx = SimpleNamespace(root=root, config=config, traffic=traffic,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t_start=t_start,
                          readers=readers, device=device, resize=resize)
    out = load_loop(traffic["loop"]).run(ctx)
    trace = out.get("trace")
    if args.trace:
        metrics = {}
        for m, r in zip(layer, readers):
            v = r.read(trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in e2e}
    correct, checks = compare.judge(out["numbers"], out["limits"])
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window; "
              "no result", file=sys.stderr)
        return None
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_block(torch, device, out, trace)}
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = checks
    info = dict(out.get("info", {}), card=roofline.power_limit()
                if device.type == "cuda" else "cpu")
    print(f"benchmark: info {json.dumps(info)}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    return result
