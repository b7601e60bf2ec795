"""Per-phase wall-clock timers and the CLI's nominal rays/s.

The port's copy of the part of the JAX package's utils/profiling.py that
the command line uses; device traces are torch.profiler's business.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List


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
