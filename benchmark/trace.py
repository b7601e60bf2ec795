"""The traced run's readings: torch.profiler over a sample of the window's
frames or steps, reduced in memory, and the benchmark's own spans.

A profiled unit (one frame or one step) runs under its own
`torch.profiler.profile`; its raw events (the profiler's kineto results,
not its Python event tree, which is slow to build) are reduced at once to
a `UnitTrace` and dropped, so no trace is written to disk. From each unit:

- `window_s`: the unit's wall on the host clock, inside the profiler;
- `busy_s`: the union of the device's kernel, copy and memset intervals
  (two streams that overlap count once; a profiler range's own device
  row, `is_user_annotation`, is not work and is left out);
- `kernels`: device seconds by kernel name;
- `in_range`: device seconds of the kernels inside each of the program's
  profiler ranges, by range name (from the range's device row where the
  profiler gives one, else by the launches made inside its host span);
- `launches`: host-side launch calls (`cudaLaunchKernel*`,
  `cuLaunchKernel*`, one for each `cudaGraphLaunch`);
- `gaps`: the device's idle intervals within the unit, each with the
  innermost host event that was running at its middle.

`Spans` times the benchmark's own spans on the host clock, ending each
in a device sync, on every unit of the traced window; each span is also
a profiler range, so idle gaps can name it.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
# the CUDA runtime's and driver's host calls: their correlation ids are
# the runtime's, not an operator's
_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")
# host events that are the profiler's or the runtime's, never what the
# host was doing for the program
_NOT_HOST_WORK = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class UnitTrace:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]
    in_range: Dict[str, float]
    launches: int
    gaps: List[Tuple[str, float]]
    device_events: int
    # device seconds of the work enqueued after the unit's mark (None: no
    # mark was set)
    after_mark: float = None


@dataclass
class Trace:
    """What a traced run read: the profiled units, the spans of the
    others, and what the recording pass after the window gathered for the
    metric readers."""
    units: List[UnitTrace] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    every: int = 1
    recorded: dict = field(default_factory=dict)

    def total(self, attr: str) -> float:
        return sum(getattr(u, attr) for u in self.units)


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(merged, starts, s, e) -> int:
    """Length of [s, e) covered by the merged intervals (`starts`: their
    starts, for the search)."""
    i = max(0, bisect.bisect_right(starts, s) - 1)
    tot = 0
    while i < len(merged) and merged[i][0] < e:
        lo, hi = max(s, merged[i][0]), min(e, merged[i][1])
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def reduce_events(events, t0_ns: int, t1_ns: int, n_gaps: int = 10,
                  mark_ns: int = None) -> UnitTrace:
    """A profiled unit's raw events -> UnitTrace. [t0_ns, t1_ns) is the
    unit's window on the profiler's clock. With `mark_ns`, `after_mark`
    is the device time of the kernels, copies and memsets whose launching
    operator (any thread's: autograd runs the backward on its own) began
    at or after the mark; one with no operator counts by its own start."""
    work, kernels, dev_ranges, host = [], {}, {}, []
    host_ranges, launches = {}, 0
    for e in events:
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if _is_device(e):
            if e.is_user_annotation():
                dev_ranges.setdefault(name, []).append((s, s + d))
                continue
            work.append((s, s + d, name, e.linked_correlation_id()))
            kernels[name] = kernels.get(name, 0.0) + d / 1e9
        else:
            if name.startswith(LAUNCH_PREFIXES):
                launches += 1
            if e.is_user_annotation():
                host_ranges.setdefault(name, []).append((s, s + d))
            host.append((s, s + d, name, e.correlation_id()))
    merged = _union([(s, e) for s, e, _, _ in work])
    busy = sum(e - s for s, e in merged)

    in_range = {}
    for name, spans in dev_ranges.items():
        rng = _union(spans)
        starts = [m[0] for m in rng]
        in_range[name] = sum(_overlap(rng, starts, s, e)
                             for s, e, _, _ in work) / 1e9
    for name, spans in host_ranges.items():
        if name in in_range:
            continue
        # no device row for this range: the kernels whose launching host
        # event (by correlation) lies inside one of its host spans
        rng = _union(spans)
        starts = [m[0] for m in rng]
        ids = {c for s, e, n, c in host if c and not _RUNTIME.match(n)
               and _overlap(rng, starts, s, e) == e - s}
        in_range[name] = sum(e - s for s, e, _, c in work if c in ids) / 1e9

    edges = [t0_ns] + [x for m in merged for x in m] + [t1_ns]
    gaps = []
    for i in range(0, len(edges), 2):
        lo, hi = edges[i], edges[i + 1]
        lo, hi = max(lo, t0_ns), min(hi, t1_ns)
        if hi > lo:
            gaps.append((hi - lo, lo, hi))
    gaps.sort(reverse=True)
    named = []
    for length, lo, hi in gaps[:n_gaps]:
        mid = (lo + hi) // 2
        best = None
        for s, e, name, _ in host:
            if s <= mid < e and not name.startswith(_NOT_HOST_WORK) and (
                    best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        named.append(("host: " + (best[2] if best else "python"),
                      length / 1e9))
    after = None
    if mark_ns is not None:
        op_start = {c: s for s, e, n, c in host
                    if c and not _RUNTIME.match(n)}
        after = sum(e - s for s, e, _, c in work
                    if op_start.get(c, s) >= mark_ns) / 1e9
    return UnitTrace(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
                     kernels=kernels, in_range=in_range, launches=launches,
                     gaps=named, device_events=len(work), after_mark=after)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profiled(trace: Trace, dev, mark=None):
    """Profile the body as one unit on device `dev` and append its
    UnitTrace to `trace`. `mark`: a list into which the body may append
    the time.time_ns() of a moment that splits the unit's work."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    # the profiler stamps its events on the wall clock, in ns
    t0_ns = time.time_ns()
    try:
        yield
    finally:
        sync(dev)
        t1_ns = time.time_ns()
        prof.stop()
    events = prof.profiler.kineto_results.events()
    if events:
        first = min(e.start_ns() for e in events)
        last = max(e.start_ns() + e.duration_ns() for e in events)
        if first < t0_ns - 10**8 or last > t1_ns + 10**8:
            # the events' clock is not this one: take their own extent
            t0_ns, t1_ns = first, last
    trace.units.append(reduce_events(events, t0_ns, t1_ns,
                                     mark_ns=mark[0] if mark else None))


class Spans:
    """The benchmark's spans: each `span(name)` is timed on the host clock,
    ended by a device sync, and is a profiler range too. `per_unit()`
    closes the unit's sums."""

    def __init__(self, trace: Trace, dev):
        self.trace = trace
        self.dev = dev
        self.cur: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function("bench." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                sync(self.dev)
                self.cur[name] = self.cur.get(name, 0.0) + \
                    time.perf_counter() - t0

    def end_unit(self):
        for k, v in self.cur.items():
            self.trace.spans.setdefault(k, []).append(v)
        self.cur = {}


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time over the profiled units,
    and the longest idle gaps by what the host was doing."""
    ops: Dict[str, float] = {}
    for u in trace.units:
        for k, s in u.kernels.items():
            ops[k] = ops.get(k, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted((g for u in trace.units for g in u.gaps),
                  key=lambda g: -g[1])[:10]
    return {"device_ops": [[k[:160], s] for k, s in top],
            "idle_gaps": [[k[:160], s] for k, s in gaps]}
