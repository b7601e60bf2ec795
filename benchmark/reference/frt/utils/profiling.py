"""Per-phase wall-clock timers, the CLI's nominal rays/s, profiler traces.

The port's counterpart of the JAX package's utils/profiling.py: the
phase timer, rays/s, and `trace_context`, which records a torch.profiler
trace (host operators and, with a card, its kernels) where the JAX
package records a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Wall-clock phase timing with a JSON-line report.

    >>> t = PhaseTimer()
    >>> with t.phase("render"): ...
    >>> t.report()                       # one JSON line per phase
    """

    def __init__(self):
        self.phases: List[Dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append({"phase": name,
                                "seconds": time.perf_counter() - t0, **extra})

    def total(self) -> float:
        return sum(p["seconds"] for p in self.phases)

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
    (chrome://tracing or Perfetto read it). A no-op for None, so call
    sites can leave it wired in."""
    if log_dir is None:
        yield
        return
    from torch.profiler import profile, supported_activities
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=supported_activities())
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
