"""The readers of the program's own spans and counters: a small traced
frames run on the CPU reads the four render-driver metrics as numbers,
and the train reader reads the device time inside `train.forward`."""

import pytest

from benchmark import harness, trace

from conftest import ROOT, small_run

FRAME_METRICS = ["enqueue_ms.frame", "sync_wait_ms.frame",
                 "host_syncs_per_frame", "bucket_cache_ms.frame"]


def test_trace1_reads_the_render_driver_metrics():
    r = small_run("reflect_refract.frames", trace=1)
    assert r["correct"] is True, r["checks"]
    for name in FRAME_METRICS:
        v = r["metrics"][name]["value"]
        assert isinstance(v, (int, float)) and v > 0, (name, v)
    # every window frame passes the same sync sites: the cache key's 36
    # table copies, the 39 uploads (36 tables, the camera, the slot
    # table, the subpixel table), the overflow flag and the canvas
    assert r["metrics"]["host_syncs_per_frame"]["value"] == 77
    # a frame's enqueue is one part of it; its syncs another
    assert r["metrics"]["enqueue_ms.frame"]["value"] > \
        r["metrics"]["bucket_cache_ms.frame"]["value"]


@pytest.mark.parametrize("in_range,expect", [
    ([{"train.forward": 0.25}, {"train.forward": 0.75}], 500.0),
    ([{}, {}], None),
    ([{"train.forward": 0.0}], None),
])
def test_forward_device_ms_reads_the_forward_range(in_range, expect):
    reader = harness.load_reader(ROOT, "forward_device_ms.step")
    t = trace.Trace(units=[trace.UnitTrace(
        window_s=1.0, busy_s=1.0, kernels={}, in_range=r, launches=0,
        gaps=[], device_events=0) for r in in_range])
    assert reader.read(t) == expect
