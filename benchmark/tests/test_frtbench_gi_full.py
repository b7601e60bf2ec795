"""The photon-GI cell `cornell_gi_full.frames` at the tests' small size on
the CPU: its configuration stages the upstream's settings, its
reference's map equals the frozen dense one, a small run is correct and,
traced, reads the new program-span metrics (the device readers on
traces made by hand), its comparison fails the frames cells' planted
faults, and the estimate's least work is counted by hand on small maps,
one of them with more photons within reach than a query sums."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu_torch.render import render as R
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene

from benchmark import generator, gi_roofline, harness, roofline, trace
from benchmark.reference import gi
from benchmark.reference.frt.render import photon as FP

from conftest import ROOT

CELL = "cornell_gi_full.frames"
CONFIG = "benchmark/configs/cornell_gi_full.json"
# the tests' frame: 12x12 at 2x2 samples, a 2x2 light, 1,500 photons, a
# 2x2 gather, cut into 3 chunks of 48 pixels
SMALL = {"scene_set": {
    "camera": {"width": 12, "height": 12, "usteps": 2, "vsteps": 2},
    "light": {"usteps": 2, "vsteps": 2},
    "config": {"illumination": {"global-illumination": {
        "photon-count": 1500, "usteps": 2, "vsteps": 2}}}},
    "chunk_pixels": 48}


def small_run(trace=0, seed=3000000123):
    args = harness.parse(["--workload", CELL, "--seed", str(seed),
                          "--seconds", "0.01", "--trace", str(trace)])
    return harness.run(args, ROOT, time.perf_counter(), torch.device("cpu"),
                       resize=SMALL)


def test_configuration_stages_the_upstream_settings():
    with open(f"{ROOT}/{CONFIG}") as f:
        cfg = json.load(f)
    scene = load_scene(generator.stage_scene(SimpleNamespace(
        root=ROOT, config=cfg)))
    c, cam = scene.config, scene.camera
    assert (cam.width, cam.height, cam.usteps, cam.vsteps) == (112, 112, 4, 4)
    assert c.photon_count == 1_000_000
    assert (c.gi_usteps, c.gi_vsteps) == (8, 8)
    assert c.gi_path_length == 5 and c.di_path_length == 5
    assert c.include_caustics and c.include_final_gather
    light, = scene.lights
    assert (light.usteps, light.vsteps, light.jitter) == (10, 10, True)
    assert cfg["dtype"] == "float32" and list(cfg["reduced"]) == ["resolution"]
    assert cfg["reduced"]["resolution"]["source"] == [800, 800]
    # one chunk, under the program's shadow-ray cap
    assert cfg["chunk_pixels"] == 112 * 112 <= 2**25 // (16 * (100 + 64))
    with open(f"{ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    entry, = [e for e in bench["configs"] if e["name"] == "cornell_gi_full"]
    assert "scenes/cornell_box/cornell_box.yml" in entry["source"]
    assert entry["reduced"] == ["resolution"]


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_map_equals_the_frozen_dense_map(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (3000, 3))
    pos[:20] *= rng.uniform(5, 25, (20, 1))
    power = rng.uniform(0, 1, (3000, 3))
    dirs = rng.normal(size=(3000, 3))
    want = FP.build_photon_map(pos, power, dirs, 0.2, torch.float64, "cpu")
    got = gi.build_photon_map(pos, power, dirs, 0.2, torch.float64, "cpu")
    assert got.dims == want.dims and got.grid_origin == want.grid_origin
    assert got.max_neighbors == want.max_neighbors
    for f in ("pos", "power", "dirs"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (500, 3)))
    pts[0] = 1e30
    for a, b in zip(gi.neighbor_extents(got, pts),
                    FP._neighbor_extents(want, pts)):
        assert torch.equal(a, b)


def test_small_run_is_correct_with_the_reference_maps(monkeypatch):
    """The reference frame builds its two maps with reference/gi.py."""
    built = []
    orig = gi.build_photon_map

    def build_photon_map(*a, **k):
        built.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(gi, "build_photon_map", build_photon_map)
    r = small_run()
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert len(built) == 2


def test_traced_small_run_reads_the_program_span_metrics():
    """The CPU has no device rows: the span readers read numbers, the
    device readers nothing (their arithmetic is checked below)."""
    r = small_run(trace=1)
    assert r["correct"] is True, r["checks"]
    for name in ("photon_trace_ms.frame", "photon_map_build_ms.frame",
                 "host_syncs_per_frame"):
        v = r["metrics"][name]["value"]
        assert isinstance(v, (int, float)) and v > 0, (name, v)


def _unit(in_range, kernels=None):
    return trace.UnitTrace(window_s=1.0, busy_s=1.0, kernels=kernels or {},
                           in_range=in_range, launches=0, gaps=[],
                           device_events=0)


def test_device_readers_read_their_ranges():
    fg = harness.load_reader(ROOT, "final_gather_device_ms.frame")
    t = trace.Trace(units=[_unit({"gi.final_gather": 0.5}),
                           _unit({"gi.final_gather": 1.5})])
    assert fg.read(t) == 1000.0
    assert fg.read(trace.Trace(units=[_unit({})])) is None
    ir = harness.load_reader(ROOT, "irradiance_roofline")
    t = trace.Trace(units=[_unit({"irradiance_estimate": 0.2})],
                    recorded={ir.KEY: 0.05})
    assert ir.read(t) == pytest.approx(25.0)
    t.recorded[ir.KEY] = 0.0
    assert ir.read(t) is None


def test_irradiance_roofline_records_each_call():
    """The reader's hook counts each estimate call's least time from the
    call's own points and map, and passes the call on unchanged."""
    from fast_ray_tracer_tpu_torch.render import photon
    ir = harness.load_reader(ROOT, "irradiance_roofline")
    pos = np.array([[0.0, 0, 0], [0.05, 0, 0], [0.3, 0, 0]])
    pm = photon.build_photon_map(pos, np.ones((3, 3)), pos, 0.1,
                                 torch.float64, "cpu")
    pts = torch.tensor([[0.02, 0, 0], [0.27, 0, 0], [5.0, 0, 0]],
                       dtype=torch.float64)
    want = photon.irradiance_estimate(pm, pts, -pts, 10, 0.1, 1.0)
    rec = {}
    undo = ir.install(rec)
    try:
        got = photon.irradiance_estimate(pm, pts, -pts, 10, 0.1, 1.0)
        photon.irradiance_estimate(pm, pts, -pts, 10, 0.1, 1.0)
    finally:
        undo()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = gi_roofline.estimate_bound(3, 3, 3, 8)[0]
    assert rec[ir.KEY] == pytest.approx(2 * one)


def _scaled(factor):
    orig = R.pixel_colors

    def pixel_colors(*a, **k):
        colors, ovf = orig(*a, **k)
        return colors * factor, ovf
    return pixel_colors


def _half_left_out(*a, **k):
    colors, ovf = _half_left_out.orig(*a, **k)
    keep = torch.arange(colors.shape[0], device=colors.device) % 2 == 0
    return torch.where(keep[:, None], colors, 0.0), ovf


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_fault_fails(fault, monkeypatch):
    if fault == "answer_altered":
        monkeypatch.setattr(R, "pixel_colors", _scaled(1.02))
    else:
        _half_left_out.orig = R.pixel_colors
        monkeypatch.setattr(R, "pixel_colors", _half_left_out)
    r = small_run()
    assert r["correct"] is False, r["checks"]


def test_a_dense_grid_program_fails_at_set_up(monkeypatch):
    """A program whose map is a dense grid over its photons' box cannot run
    the configuration: the run stops before its first frame."""
    from fast_ray_tracer_tpu_torch.render import photon

    def dense(pos, *a, **k):
        n = 1
        for lo, hi in zip(pos.min(0), pos.max(0)):
            n *= int((hi - lo) / a[2]) + 2
        return np.zeros(n + 1, np.int64)
    monkeypatch.setattr(photon, "build_photon_map", dense)
    rendered = []
    monkeypatch.setattr(R, "render_scene",
                        lambda *a, **k: rendered.append(1))
    with pytest.raises(SystemExit, match="10\\^18"):
        small_run()
    assert not rendered


def test_estimate_least_work_by_hand():
    # photons at x = 0, 0.05, 0.3 (radius 0.1); queries at x = 0.02 (two
    # photons within reach), 0.27 (one) and 5.0 (none)
    pos = np.array([[0.0, 0, 0], [0.05, 0, 0], [0.3, 0, 0]])
    grid = gi.build_photon_map(pos, pos, pos, 0.1, torch.float64, "cpu")
    pts = torch.tensor([[0.02, 0, 0], [0.27, 0, 0], [5.0, 0, 0]],
                       dtype=torch.float64)
    assert gi_roofline.pairs_within(grid, pts, 0.1, 10) == (3, 3)
    t, by = gi_roofline.estimate_bound(3, 3, 3, 4)
    nbytes = 3 * 9 * 4 + 3 * 8 + 3 * 9 * 4
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, by = gi_roofline.estimate_bound(10**9, 3, 3, 4)
    assert by == "operations"
    assert t == pytest.approx(8e9 / roofline.FP32_OPS_PER_S)


@pytest.mark.parametrize("num,want", [(2, (5, 3)), (10, (9, 5))])
def test_estimate_least_work_sums_the_nearest(num, want):
    # photons at x = 0, 0.01, 0.02, 0.03 and 0.5 (radius 0.1); queries at
    # x = 0 and 0.004 (the first four within reach), 0.45 (one), 5 (none).
    # With num = 2 the first two queries each sum only photons 0 and 0.01:
    # 2 + 2 + 1 pairs over 3 photons; with num = 10 every photon within
    # reach: 4 + 4 + 1 pairs over all 5.
    pos = np.array([[x, 0.0, 0.0] for x in (0.0, 0.01, 0.02, 0.03, 0.5)])
    grid = gi.build_photon_map(pos, pos, pos, 0.1, torch.float64, "cpu")
    pts = torch.tensor([[0.0, 0, 0], [0.004, 0, 0], [0.45, 0, 0],
                        [5.0, 0, 0]], dtype=torch.float64)
    assert gi_roofline.pairs_within(grid, pts, 0.1, num) == want
