"""The port's tracer: spans and counters at its layer boundaries, the
render's phase timer, and torch.profiler traces.

- `span(name, **attrs)` is a context manager around one step of a layer;
  `unit(name)` is a span that opens a unit of work (one `render_scene`
  call, one train step), numbered from the start of the process. A
  closed span (`Span`) holds its name, its start and end in ns on the
  clock the profiler stamps its events on (`time.time_ns()`), its parent
  (the enclosing span on the same thread) and its unit's number.
- `count(name, n)` adds to a counter of the current unit. `host_sync(site,
  n)` is the span `sync.<site>` around a call that blocks the host on the
  device, counted `n` times in `host_syncs` and `host_syncs.<site>`.
- `add_sink(fn)` attaches a consumer, which receives each closed `Span`
  and each `Count`; it returns the call that detaches it. The tracer is
  on while a sink is attached and keeps nothing itself, so spans stay in
  memory only as long as a sink keeps them. Off (the default), `span`
  and `count` record nothing, allocate nothing and never sync.
- Whenever a torch.profiler is recording, each span is also a
  `record_function` range of the same name, on or off, so a device trace
  shows it above its kernels.
- `PhaseTimer` is the sink behind `render_scene(timer=)` and the command
  line's `--profile` phase lines; `trace_context(dir)` records a
  profiler trace of its body, with the tracer on, and writes the spans
  and counters beside it.
- `CounterGroup`: counts that never switch off (the kernel wrappers'
  `LAUNCHES`), and feed the tracer's counters while it is on.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"

_sinks: List[Callable] = []
_local = threading.local()
_units = itertools.count(1)
_NULL = contextlib.nullcontext()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Count(NamedTuple):
    """One counter increment, as sinks receive it; `unit` is None outside
    any unit."""
    name: str
    n: int
    unit: Optional[int]


class Span:
    """A span; sinks receive it closed. `counts` (unit spans only) sums the
    unit's counters by name."""

    __slots__ = ("name", "attrs", "parent", "unit", "counts", "start_ns",
                 "end_ns", "_unit_span", "_range")

    def __init__(self, name: str, attrs: dict, opens_unit: bool):
        self.name = name
        self.attrs = attrs
        self.counts: Optional[Dict[str, int]] = {} if opens_unit else None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.counts is not None:
            self.unit, self._unit_span = next(_units), self
        else:
            self._unit_span = getattr(self.parent, "_unit_span", None)
            self.unit = getattr(self._unit_span, "unit", None)
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        for fn in tuple(_sinks):
            fn(self)
        return False


def _open(name: str, attrs: dict, opens_unit: bool):
    if _sinks:
        return Span(name, attrs, opens_unit)
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def span(name: str, **attrs):
    """A span of the current unit (see the module docstring)."""
    return _open(name, attrs, False)


def unit(name: str, **attrs):
    """A span that opens a new unit; the spans and counts inside it are
    that unit's."""
    return _open(name, attrs, True)


def timed_span(name: str, **attrs) -> Span:
    """A span that is timed with the tracer on or off, for a duration its
    caller reports itself (`.seconds` once closed); off, it reaches no
    sink."""
    return Span(name, attrs, False)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the current unit (tracer on only);
    a count on a thread with no span open (autograd's backward thread)
    belongs to no unit."""
    if not _sinks:
        return
    stack = _stack()
    u = stack[-1]._unit_span if stack else None
    if u is not None:
        u.counts[name] = u.counts.get(name, 0) + n
    rec = Count(name, n, None if u is None else u.unit)
    for fn in tuple(_sinks):
        fn(rec)


def host_sync(site: str, n: int = 1):
    """The span `sync.<site>` around a call that blocks the host until the
    device has done its queued work, counted `n` times in `host_syncs`
    and in `host_syncs.<site>`."""
    if _sinks:
        count("host_syncs", n)
        count("host_syncs." + site, n)
    return span("sync." + site)


def add_sink(fn: Callable) -> Callable[[], None]:
    """Attach `fn`, called with each closed Span and each Count while it is
    attached (a sink attached twice receives each record twice) -> the
    call that detaches it."""
    _sinks.append(fn)

    def remove() -> None:
        if fn in _sinks:
            _sinks.remove(fn)
    return remove


class CounterGroup(dict):
    """Named counts that count with the tracer on or off (a plain dict to
    its readers); while the tracer is on, each `add` is also the counter
    `<prefix><key>` of the current unit."""

    def __init__(self, prefix: str, *keys: str):
        super().__init__(dict.fromkeys(keys, 0))
        self.prefix = prefix

    def add(self, key: str, n: int = 1) -> None:
        self[key] += n
        if _sinks:
            count(self.prefix + key, n)


class Recorder:
    """A sink that keeps every span and every unit's counter sums."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[Optional[int], Dict[str, int]] = {}

    def __call__(self, rec) -> None:
        if isinstance(rec, Span):
            self.spans.append(rec)
        else:
            c = self.counts.setdefault(rec.unit, {})
            c[rec.name] = c.get(rec.name, 0) + rec.n

    def as_json(self) -> dict:
        """The spans in the order they closed, each parent by its index in
        that list (None: outside any span), and the counters by unit."""
        index = {id(s): i for i, s in enumerate(self.spans)}
        return {"spans": [{"name": s.name, "start_ns": s.start_ns,
                           "end_ns": s.end_ns, "unit": s.unit,
                           "parent": index.get(id(s.parent)),
                           "attrs": s.attrs} for s in self.spans],
                "counts": {str(k): v for k, v in self.counts.items()}}


class PhaseTimer:
    """The render's phases with a JSON-line report: a sink that keeps the
    spans of `render_scene`'s four phases (`PHASES`, span name -> phase)
    in `phases`, each as {"phase", "seconds", **the span's attrs}.

    >>> t = PhaseTimer()
    >>> render_scene(scene, timer=t)     # attaches t for the call
    >>> t.report()                       # one JSON line per phase
    """

    PHASES = {"render.compile_scene": "compile_scene",
              "render.trace_photons": "trace_photons",
              "render.probe_buckets": "probe_buckets",
              "render.chunks": "render_chunks"}

    def __init__(self):
        self.phases: List[Dict] = []

    def __call__(self, rec) -> None:
        phase = self.PHASES.get(rec.name) if isinstance(rec, Span) else None
        if phase is not None:
            self.phases.append({"phase": phase, "seconds": rec.seconds,
                                **rec.attrs})

    def report(self, out=None) -> None:
        for p in self.phases:
            line = json.dumps(p)
            if out is None:
                print(line, flush=True)
            else:
                out.write(line + "\n")


def rays_per_second(n_pixels: int, samples_per_pixel: int,
                    rays_per_sample: int, seconds: float) -> float:
    """Nominal throughput: pixels x camera samples x rays per sample over
    the wall."""
    return n_pixels * samples_per_pixel * rays_per_sample / max(seconds, 1e-12)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Record a torch.profiler trace of the body (every activity the build
    supports: the host's operators, and the card's kernels and copies
    with CUDA) and write it as a Chrome trace, `log_dir`/TRACE_FILE
    (chrome://tracing or Perfetto read it), where the program's spans
    are ranges above their kernels. The tracer is on for the body: its
    spans and each unit's counters go to `log_dir`/SPANS_FILE. A no-op
    for None, so call sites can leave it wired in."""
    if log_dir is None:
        yield
        return
    from torch.profiler import profile, supported_activities
    os.makedirs(log_dir, exist_ok=True)
    rec = Recorder()
    remove = add_sink(rec)
    prof = profile(activities=supported_activities())
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        remove()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
            json.dump(rec.as_json(), f)
