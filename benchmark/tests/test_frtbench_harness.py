"""The harness: every cell resolves by name, a run's last line has the
contract's keys, a traced run adds the per-layer metrics, and nothing a
run imports is JAX, the JAX package, bench_torch or chip_smoke."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

from conftest import ROOT, small_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_resolves_by_name(cell):
    bench, entry, config, traffic, e2e, layer = harness.cell_files(ROOT, cell)
    assert os.path.exists(os.path.join(ROOT, config["scene"]))
    assert callable(harness.load_loop(traffic["loop"]).run)
    assert config["name"] == entry["config"]
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in e2e}
    assert layer, "a cell reports at least one per-layer metric"
    for m in layer:
        reader = harness.load_reader(ROOT, m["name"])
        assert callable(reader.read)
        assert m["moves"] in {x["name"] for x in e2e}
    from benchmark.reference import compare
    numbers = {"frames": compare.FRAME_NUMBERS,
               "train": compare.TRAIN_NUMBERS}[traffic["loop"]]
    assert set(config["limits"][traffic["loop"]]) == set(numbers)


def test_trace0_line_has_the_contract_keys():
    r = small_run("reflect_refract.frames", trace=0)
    keys = list(r)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"checks"}
    names = {m["name"] for m in _bench()["end_to_end"]
             if "workloads" not in m
             or "reflect_refract.frames" in m["workloads"]}
    assert set(r["metrics"]) == names
    per_layer = {m["name"] for m in _bench()["per_layer"]}
    assert not set(r["metrics"]) & per_layer
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    # the program's frame against the reference, on the CPU: the same
    assert r["checks"]["mean_abs_err"]["value"] == 0.0
    json.dumps(r)


def test_trace1_adds_the_per_layer_metrics(gi_root):
    r = small_run("cornell_gi.frames", trace=1, root=gi_root)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert "breakdown" in r
    e2e = {m["name"] for m in _bench()["end_to_end"]}
    assert not set(r["metrics"]) & e2e
    # on the CPU the profiler sees no device: the spans alone read
    assert {"photon_pass_ms.frame", "compile_scene_ms.frame"} <= \
        set(r["metrics"])
    assert "busy_s" in r["device"] and "window_s" in r["device"]


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_imports_no_jax():
    found = _modules_after(
        "import sys, torch; torch.set_num_threads(1)\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import small_run\n"
        "small_run('reflect_refract.frames', trace=1)\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not found & set(harness.FORBIDDEN)
    assert "fast_ray_tracer_tpu_torch" in found


def test_the_reference_imports_nothing_of_the_port():
    found = _modules_after(
        "import sys, json, torch, types\n"
        "from benchmark import generator\n"
        "from benchmark.reference import compare\n"
        "import benchmark.reference.frt.parallel.train\n"
        "cfg = json.load(open('benchmark/configs/reflect_refract.json'))\n"
        "ctx = types.SimpleNamespace(root='.', config=cfg, resize={\n"
        "    'scene_set': {'camera': {'width': 16, 'height': 8}}})\n"
        "f = compare.reference_frame(generator.stage_scene(ctx),"
        " torch.float32, 128, 1, device='cpu')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "fast_ray_tracer_tpu_torch" not in found
    assert not found & set(harness.FORBIDDEN)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_command_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload",
         "reflect_refract.frames", "--seed", "3000000777", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and line["correct"] is True


def test_step_s_bound_in_range():
    """step_s's bound: five times the spread of the final harness's runs,
    never under 5% nor over the 25% cap (PERF.md section 2)."""
    bound = {m["name"]: m["bound"] for m in _bench()["end_to_end"]}["step_s"]
    assert 0.05 <= bound <= 0.25


def test_host_readings_span_the_window():
    import gc
    import time

    from benchmark import host
    with host.Collections() as gcs:
        a = host.snapshot()
        t = time.thread_time()
        while time.thread_time() - t < 0.05:  # a few clock ticks of CPU
            junk = [[k] for k in range(1000)]
        gc.collect()
        b = host.snapshot()
    del junk
    s = gcs.summary()
    assert s["gc_count"][2] >= 1 and s["gc_pause_s"][2] > 0
    d = host.delta(a, b)
    assert d["wall_to"] >= d["wall_from"]
    assert {"voluntary_ctxt_switches", "nonvoluntary_ctxt_switches",
            "threads"} <= set(d)
    # this thread ran: its row carries its user and system CPU seconds
    assert any(r[2] + r[3] > 0 for r in d["threads"])


def test_train_info_has_each_step_and_the_collections(capsys):
    r = small_run("reflect_refract.train", trace=0, seconds=0.5)
    line = next(x for x in capsys.readouterr().err.splitlines()
                if x.startswith("benchmark: info "))
    info = json.loads(line[len("benchmark: info "):])
    assert len(info["step_s"]) == info["steps"] == r["attempted"]
    assert abs(sum(info["step_s"]) - info["window_s"]) < 0.05
    assert len(info["gc_count"]) == len(info["gc_pause_s"]) == 3
    assert info["threads"]
