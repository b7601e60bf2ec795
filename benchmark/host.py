"""What the host did in a run's window, for the run's `info`: Python's
garbage collections, the process's context switches, and each thread's
user and system CPU seconds (read only, at the window's two ends; a
reading the system does not offer is left out).

    with Collections() as gcs:
        a = snapshot()
        ...  # the window
        b = snapshot()
    info = dict(gcs.summary(), **delta(a, b))
"""

from __future__ import annotations

import gc
import os
import resource
import time

TICK = os.sysconf("SC_CLK_TCK")


class Collections:
    """Python's collections while the block runs: count and total pause
    by generation, from gc.callbacks."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.pause_s = [0.0, 0.0, 0.0]
        self._t = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.pause_s[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def summary(self) -> dict:
        return {"gc_count": list(self.count), "gc_pause_s": list(self.pause_s)}


def snapshot() -> dict:
    """The process's context switches and each thread's CPU time, now."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    snap = {"wall": time.time(), "voluntary_ctxt_switches": use.ru_nvcsw,
            "nonvoluntary_ctxt_switches": use.ru_nivcsw, "threads": {}}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        tids = []
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                st = fh.read()
        except OSError:  # the thread has ended
            continue
        # after "pid (comm) ": utime, stime in ticks; the core it last ran on
        name, f = st[st.index("(") + 1:st.rindex(")")], \
            st[st.rindex(")") + 2:].split()
        snap["threads"][tid] = (name, int(f[11]) / TICK, int(f[12]) / TICK,
                                int(f[36]))
    return snap


def delta(a: dict, b: dict) -> dict:
    """What happened between two snapshots: the process's context switches
    and each thread that ran, [name, tid, user s, system s, the core it
    last ran on], the busiest first."""
    out = {"wall_from": a["wall"], "wall_to": b["wall"]}
    for k in ("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches"):
        out[k] = b[k] - a[k]
    threads = []
    for tid, (name, user, system, core) in b["threads"].items():
        _, user0, system0, _ = a["threads"].get(tid, (name, 0.0, 0.0, core))
        if user + system > user0 + system0:
            threads.append([name, int(tid), user - user0, system - system0,
                            core])
    out["threads"] = sorted(threads, key=lambda r: -(r[2] + r[3]))
    return out
