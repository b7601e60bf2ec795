"""The port's tracer (utils/profiling.py) on the CPU.

- Off (no sink attached), `span`, `unit`, `count` and `host_sync` record
  nothing, allocate no span and open no profiler range, and a whole
  render neither makes a span nor syncs for tracing.
- On, a span records its parent, its unit and its start and end; unit
  counters sum per unit; two sinks both receive everything; under
  torch.profiler each span is a range of the same name on the same
  clock.
- The render driver's span tree and its `host_syncs` count on an 8x4
  `glass_spheres` frame, cold (the probe) and warm; a train step's
  phases in order; the phase timer's four phases, GI included;
  `trace_context`'s spans file; the launch counters.
"""

import dataclasses
import json
import pathlib

import pytest
import torch

from fast_ray_tracer_tpu_torch.ops import compact, mesh
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "fast_ray_tracer_tpu_torch"


@pytest.fixture
def recorder():
    rec = P.Recorder()
    remove = P.add_sink(rec)
    yield rec
    remove()


@pytest.fixture(autouse=True)
def bucket_cache(tmp_path, monkeypatch):
    """Each test's own bucket calibrations, so a render probes when cold."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "frt_cache"))


def _no_range(*a, **k):
    raise AssertionError("a profiler range was opened")


def _no_span(*a, **k):
    raise AssertionError("a span was made")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    assert not P._sinks and not torch.autograd._profiler_enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(P, "Span", _no_span)
    seen = []
    monkeypatch.setattr(P, "Count", lambda *a: seen.append(a))
    # one shared null context, whatever the name
    assert P.span("a") is P.span("b", x=1) is P.unit("c") \
        is P.host_sync("d", 3)
    with P.unit("u"), P.span("s"):
        P.count("n", 2)
    assert seen == []
    before = dict(compact.LAUNCHES)
    compact.LAUNCHES.add("compact")
    assert compact.LAUNCHES["compact"] == before["compact"] + 1


def test_off_render_makes_no_span_and_never_syncs(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(P, "Span", _no_span)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_range)
    c = trender.render_scene(tdemo.glass_spheres(8, 4), dtype=torch.float32,
                             device="cpu")
    assert c.shape == (4, 8, 3)


def test_nested_span_records_parent_unit_and_times(recorder):
    with P.unit("frame") as u:
        with P.span("outer", k=1) as outer:
            with P.span("inner") as inner:
                pass
        after = P.span("after")
        with after:
            pass
    with P.unit("frame") as u2:
        pass
    assert [s.name for s in recorder.spans] == ["inner", "outer", "after",
                                               "frame", "frame"]
    assert inner.parent is outer and outer.parent is u and u.parent is None
    assert after.parent is u and outer.attrs == {"k": 1}
    assert inner.unit == outer.unit == after.unit == u.unit
    assert u2.unit == u.unit + 1
    assert u.start_ns <= outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= outer.end_ns <= after.start_ns <= after.end_ns <= u.end_ns
    assert outer.seconds == (outer.end_ns - outer.start_ns) / 1e9
    # the stack is empty again, so a span now belongs to no unit
    with P.span("loose") as loose:
        pass
    assert loose.parent is None and loose.unit is None


def test_counters_sum_per_unit(recorder):
    units = []
    for k in range(2):
        with P.unit("step") as u:
            P.count("a")
            with P.span("inner"):
                P.count("a", 2)
                with P.host_sync("site", 5):
                    pass
            P.count("b", k + 1)
        units.append(u)
    P.count("a", 7)
    for k, u in enumerate(units):
        want = {"a": 3, "b": k + 1, "host_syncs": 5, "host_syncs.site": 5}
        assert u.counts == want and recorder.counts[u.unit] == want
    assert recorder.counts[None] == {"a": 7}
    assert [s.name for s in recorder.spans].count("sync.site") == 2


def test_two_sinks_receive_every_record(recorder):
    second = []
    remove = P.add_sink(second.append)
    with P.unit("u"):
        with P.span("s"):
            P.count("c", 4)
    remove()
    with P.span("after"):
        pass
    names = [r.name for r in second]
    assert names == ["c", "s", "u"]
    assert [s.name for s in recorder.spans] == ["s", "u", "after"]
    assert second[0] == P.Count("c", 4, recorder.spans[1].unit)


def test_spans_are_profiler_ranges_on_the_same_clock(recorder):
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first range pays its set-up
        with torch.profiler.record_function("warm"):
            x.sum()
        with P.unit("tunit"):
            for k in range(3):
                with P.span(f"tspan{k}"):
                    (x * k).sum()
    ours = {s.name: s for s in recorder.spans}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ours}
    assert set(events) == set(ours) == {"tunit", "tspan0", "tspan1",
                                        "tspan2"}
    for name, s in ours.items():
        e = events[name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000


def _tree(spans, unit):
    return [(s.name, s.parent.name if s.parent else None) for s in spans
            if s.unit == unit]


def test_render_scene_span_tree_and_host_syncs(recorder):
    sc = tdemo.glass_spheres(8, 4)
    for _ in range(2):
        trender.render_scene(sc, dtype=torch.float32, device="cpu")
    ir = tcomp.compile_scene(sc, dtype=torch.float32, device="cpu")
    tables = sum(t.numel() > 0 for t in ir.tables().values())
    cold, warm = sorted({s.unit for s in recorder.spans
                         if s.name == "render_scene"})
    common = [("sync.upload", "render.compile_scene")] * 3 + [
        ("render.compile_scene", "render_scene"),
        ("sync.upload", "render_scene"),
        ("sync.bucket_cache_key", "render.bucket_cache"),
        ("render.bucket_cache", "render_scene")]
    chunks = [("render.enqueue", "render.chunks"),
              ("sync.overflow", "render.chunks"),
              ("sync.canvas", "render.chunks"),
              ("render.chunks", "render_scene"), ("render_scene", None)]
    probe = [("sync.probe_counts", "render.probe"),
             ("render.probe", "render.probe_buckets"),
             ("render.probe_buckets", "render_scene"),
             ("render.bucket_cache", "render_scene")]
    assert _tree(recorder.spans, cold) == common + probe + chunks
    assert _tree(recorder.spans, warm) == common + chunks
    # the sites each frame passes: every non-empty table uploaded and
    # copied back for the cache key, the camera, the slot table and the
    # subpixel table uploaded, the probe's counts (cold only), the
    # overflow flag, the canvas
    sites = {"upload": tables + 3, "bucket_cache_key": tables,
             "overflow": 1, "canvas": 1}
    for unit, extra in ((cold, {"probe_counts": 1}), (warm, {})):
        want = {**sites, **extra}
        counts = recorder.counts[unit]
        assert {k[len("host_syncs."):]: v for k, v in counts.items()
                if k.startswith("host_syncs.")} == want
        assert counts["host_syncs"] == sum(want.values())


def test_train_step_phases_in_order():
    sc = tdemo.glass_spheres(4, 2)
    ir = tcomp.compile_scene(sc, dtype=torch.float64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    cam_rt = tcam.build_camera(sc.camera, dtype=torch.float64, device="cpu")
    params, static = ttrain.split_params(ir)
    init, step = ttrain.make_train_step(rt, cam_rt, static, 1, 2)
    state = init(params)
    n = sc.camera.width * sc.camera.height
    idx = torch.arange(n)
    det = torch.as_tensor(trender.cmj_points_static(1, 1),
                          dtype=torch.float64)
    px, py, uv, ap = trender.primary_samples(sc.camera, cam_rt, det,
                                             idx % sc.camera.width,
                                             idx // sc.camera.width, None)
    marks = []
    recorder = P.Recorder()
    remove = P.add_sink(recorder)
    try:
        step(state, px, py, uv, ap, torch.zeros(n, 3, dtype=torch.float64),
             between=lambda: marks.append(len(recorder.spans)))
    finally:
        remove()
    names = [s.name for s in recorder.spans]
    assert names == ["train.forward", "train.backward", "train.optimizer",
                     "train.step"]
    u = recorder.spans[-1]
    assert all(s.parent is u and s.unit == u.unit
               for s in recorder.spans[:3])
    # `between` runs after the forward has closed, before the backward
    assert marks == [1]


def test_phase_timer_keeps_the_four_phases():
    sc = tdemo.cornell_box(8, 8, mesh=False)
    sc.lights = [dataclasses.replace(sc.lights[0], usteps=2, vsteps=2)]
    sc.config = dataclasses.replace(sc.config, photon_count=500,
                                    gi_usteps=1, gi_vsteps=1)
    timer = P.PhaseTimer()
    stats = {}
    trender.render_scene(sc, dtype=torch.float32, device="cpu", seed=3,
                         stats=stats, timer=timer)
    assert [p["phase"] for p in timer.phases] == [
        "compile_scene", "trace_photons", "probe_buckets", "render_chunks"]
    assert timer.phases[1]["count"] == 500 and timer.phases[3]["n"] == 1
    assert all(p["seconds"] > 0 for p in timer.phases)
    assert not P._sinks
    # the photon pass's wall is its span's, the tracer on or off
    assert stats["photon_seconds"] == timer.phases[1]["seconds"]
    trender.render_scene(sc, dtype=torch.float32, device="cpu", seed=3,
                         stats=stats)
    assert stats["photon_seconds"] > 0


def test_trace_context_writes_the_spans(tmp_path):
    with P.trace_context(str(tmp_path)):
        assert P._sinks
        trender.render_scene(tdemo.glass_spheres(8, 4), dtype=torch.float32,
                             device="cpu")
    assert not P._sinks
    got = json.loads((tmp_path / P.SPANS_FILE).read_text())
    spans = got["spans"]
    top = spans[-1]
    assert top["name"] == "render_scene" and top["parent"] is None
    assert {spans[s["parent"]]["name"] for s in spans
            if s["name"] == "render.enqueue"} == {"render.chunks"}
    (unit, counts), = got["counts"].items()
    assert int(unit) == top["unit"] and counts["host_syncs"] > 0
    trace = json.loads((tmp_path / P.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"render_scene", "render.enqueue", "sync.canvas"} <= names


def test_launch_counters_are_counter_groups(recorder):
    assert isinstance(compact.LAUNCHES, P.CounterGroup)
    assert set(compact.LAUNCHES) == {"compact", "expand"}
    assert set(mesh.LAUNCHES) == {"mesh_closest", "mesh_shadow"}
    before = dict(mesh.LAUNCHES)
    with P.unit("u") as u:
        mesh.LAUNCHES.add("mesh_shadow", 2)
    assert mesh.LAUNCHES["mesh_shadow"] == before["mesh_shadow"] + 2
    assert u.counts == {"launches.mesh_shadow": 2}
    assert {**compact.LAUNCHES, **mesh.LAUNCHES}.keys() == {
        "compact", "expand", "mesh_closest", "mesh_shadow"}


def test_only_the_tracer_opens_profiler_ranges():
    found = [p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")
             if "record_function" in p.read_text()]
    assert found == ["fast_ray_tracer_tpu_torch/utils/profiling.py"]
