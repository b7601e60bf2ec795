"""What every cell of the bench shares: the device, its name, clocks that
stop after the card is done, memory peaks, the kernels' launch counters,
the gates and the metric records.

A cell runs on the CUDA card unless its caller passes `device="cpu"`;
without a card it raises, and nothing falls back to the CPU. On the CPU
the kernel wrappers take their plain versions, so no launch is counted
there and the launch gates apply on the card alone; a CPU cell reports no
peak device memory (null).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.ops import compact, gather, mesh

COMPACTION = ("compact", "expand")
MESH = ("mesh_closest", "mesh_shadow")
ALL_KERNELS = COMPACTION + MESH


class GateFailed(RuntimeError):
    """A cell's output failed one of its gates."""


def resolve(device) -> torch.device:
    """`device` (None: the CUDA card) as a torch.device; raises when the
    card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; the CPU runs only "
                           "when asked for (device='cpu', --device cpu)")
    return device


def device_info(device) -> dict:
    """The device a line's numbers come from: the card's name, count and
    nvidia-smi's name and power limit, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"type": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = device.index or 0
    return {"type": "cuda", "name": torch.cuda.get_device_name(index),
            "nvidia_smi": smi[index], "count": torch.cuda.device_count()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fresh_memory(device) -> None:
    """Release the cached blocks and restart the peak, so that a cell's
    peak is its own."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device):
    """Peak device memory since the last reset, GiB; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def timed(device, fn):
    """(fn(), wall seconds), the clock stopped after the card is done."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def call_ms(device, fn, n: int) -> list:
    """The time of each of n calls of fn() in ms, after one call to warm
    up: CUDA events around each call on the card, the host clock on the
    CPU."""
    fn()
    sync(device)
    times = []
    for _ in range(n):
        if torch.device(device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            times.append(timed(device, fn)[1] * 1e3)
    return times


def reset_launches() -> None:
    for counts in (compact.LAUNCHES, mesh.LAUNCHES, gather.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    return {**compact.LAUNCHES, **mesh.LAUNCHES, **gather.LAUNCHES}


def require_launched(device, counts: dict, names, what: str) -> None:
    """On the card, every kernel of `names` must have launched (CPU tensors
    take the plain versions, which count nothing)."""
    if torch.device(device).type != "cuda":
        return
    missing = [k for k in names if counts.get(k, 0) < 1]
    if missing:
        raise GateFailed(f"{what}: kernels never launched {missing} "
                         f"(launches {counts})")


def require_finite(array, what: str) -> None:
    a = array.detach().cpu().numpy() if torch.is_tensor(array) else \
        np.asarray(array)
    if not np.isfinite(a).all():
        raise GateFailed(f"{what} is not finite")


def require_no_overflow(stats: dict, what: str) -> None:
    """render_scene's stats: no chunk escalated its buckets or fell back to
    the unrolled trace."""
    if stats["escalations"] or stats["exact_chunks"]:
        raise GateFailed(f"{what}: bucket overflow after calibration "
                         f"({stats['escalations']} escalations, "
                         f"{stats['exact_chunks']} exact chunks)")


def metric(values, unit: str) -> dict:
    """A metric's record: the median of `values`, their min, max and
    count; a lone value is a list of one; None (not measured) has n = 0."""
    if values is None:
        return {"value": None, "unit": unit, "min": None, "max": None, "n": 0}
    values = list(values) if isinstance(values, (list, tuple)) else [values]
    if all(isinstance(v, bool) for v in values):
        return {"value": all(values), "unit": unit, "min": min(values),
                "max": max(values), "n": len(values)}
    values = [float(v) for v in values]
    return {"value": statistics.median(values), "unit": unit,
            "min": min(values), "max": max(values), "n": len(values)}


def rates(work: float, walls) -> list:
    """work / wall for each wall."""
    return [work / w for w in walls]
