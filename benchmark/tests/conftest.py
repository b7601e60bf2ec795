"""The benchmark's own tests, on the CPU at small sizes:
`python -m pytest benchmark/tests -q` from the root of the repo. One test
needs a CUDA card and skips inside its fixture without one."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# one thread: torch splits its CPU kernels at 2048 elements over two
torch.set_num_threads(1)


def _camera(w, h):
    return {"camera": {"width": w, "height": h}}


# the tests' small frames: every level's bucket is at least 4,096 lanes,
# so a frame costs seconds on the CPU at any size
SMALL = {"reflect_refract": {"scene_set": _camera(24, 12),
                             "chunk_pixels": 288},
         "cornell_gi": {"scene_set": dict(_camera(16, 16), config={
             "illumination": {"global-illumination": {
                 "photon-count": 1500}}}),
             "chunk_pixels": 256, "batch_pixels": 64}}

# The photon-GI cells, which BENCHMARK.json does not hold (PERF.md, Open
# questions): the tests run them from a checkout whose BENCHMARK.json adds
# them, on the tests' configuration benchmark/tests/cornell_gi.json, with
# the photon-GI readers that only they report.
GI_CELLS = {"cornell_gi.frames": "frames", "cornell_gi.train": "train"}
GI_METRICS = [
    {"name": "mesh_roofline", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "mesh kernels", "moves": "frame_s",
     "workloads": ["cornell_gi.frames"]},
    {"name": "irradiance_estimate_ms.frame", "unit": "ms",
     "better": "lower", "source": "device_trace", "layer": "photon GI",
     "moves": "frame_s", "workloads": ["cornell_gi.frames"]},
    {"name": "photon_pass_ms.frame", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "photon GI", "moves": "frame_s",
     "workloads": ["cornell_gi.frames"]},
]


@pytest.fixture(scope="session")
def root():
    return ROOT


@pytest.fixture(scope="session")
def gi_root(tmp_path_factory):
    """A checkout (the benchmark's files linked) whose BENCHMARK.json adds
    the photon-GI cells beside the Whitted ones of each traffic mix."""
    out = tmp_path_factory.mktemp("gi_checkout")
    os.symlink(os.path.join(ROOT, "benchmark"), out / "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "cornell_gi",
                             "file": "benchmark/tests/cornell_gi.json"})
    for cell, traffic in GI_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "cornell_gi",
                                   "traffic": traffic, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "reflect_refract." + traffic in m.get("workloads", ()):
                m["workloads"].append(cell)
    bench["per_layer"] += GI_METRICS
    with open(out / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(out)


@pytest.fixture(autouse=True)
def bucket_cache(tmp_path, monkeypatch):
    """Each test's own bucket calibrations."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "frt_cache"))


def small_run(workload, trace=0, seed=3000000123, seconds=0.01, root=ROOT):
    """One run of a cell of `root`'s BENCHMARK.json on the CPU at its
    small size -> the result."""
    import time

    from benchmark import harness
    args = harness.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    config = workload.split(".")[0]
    return harness.run(args, root, time.perf_counter(), torch.device("cpu"),
                       resize=SMALL[config])
