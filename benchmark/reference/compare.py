"""The comparison that decides a run's `correct`: what the timed path
produced against the plain reference, each number beside its limit.

A frame is judged by two numbers over its pixels, against the reference
renderer (`frt/`) run on the same scene file, at the same size, chunking,
dtype and seed:
- `mean_abs_err`: the mean over every pixel and channel of |program -
  reference|, in linear color;
- `p999_px_err`: the 99.9th percentile over the pixels of each pixel's
  largest channel difference.
Both hold a frame to the whole picture; neither is moved by the handful
of pixels that float32 rounding can flip at a silhouette, which a
changed order of operations is free to do. A number that is not finite
fails. The limits are the configuration's (`limits` in its file), set
from the readings PERF.md gives.
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_NUMBERS = ("mean_abs_err", "p999_px_err")


def frame_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers of one frame (H, W, 3) against its reference."""
    if got.shape != want.shape:
        return {k: float("inf") for k in FRAME_NUMBERS}
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    px = d.max(axis=-1).reshape(-1)
    if not np.isfinite(d).all():
        return {k: float("nan") for k in FRAME_NUMBERS}
    return {"mean_abs_err": float(d.mean()),
            "p999_px_err": float(np.quantile(px, 0.999))}


def worst(readings) -> dict:
    """The largest of each number over several frames (NaN wins)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k not in out or not v <= out[k]:
                out[k] = v
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit, and
    {name: {"value", "limit"}} in a fixed order."""
    checks = {k: {"value": numbers.get(k), "limit": limits.get(k)}
              for k in limits}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def reference_frame(scene_file: str, dtype, chunk_pixels: int, seed: int,
                    device="cuda", photon_dtype=None) -> np.ndarray:
    """The reference's canvas of the scene file (a path to its YAML) at
    its own size: the frozen copy's loader and render_scene, with the
    plain compaction and mesh queries and its own bucket probe
    (`photon_dtype`: the photon pass's precision, the control's)."""
    from benchmark.reference.frt.render.render import render_scene
    from benchmark.reference.frt.scene.yaml_loader import load_scene
    scene = load_scene(scene_file)
    with torch.no_grad():
        return render_scene(scene, dtype=dtype, chunk_pixels=chunk_pixels,
                            device=device, seed=seed,
                            photon_dtype=photon_dtype)


TRAIN_NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap")
# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding: Adam moves it by round-off alone
NOUGHT = 1e-3


def _leaf_gap(mine: dict, ref: dict, keys) -> float:
    """The worst leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger (the median over the leaves with a norm above 0)."""
    m = {k: float(torch.linalg.vector_norm(mine[k].double())) for k in keys}
    r = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    live = [v for v in r.values() if v > 0]
    if not live:
        return float("nan")
    med = float(np.median(live))
    return max(abs(m[k] - r[k]) / max(r[k], med) for k in keys)


def train_numbers(mine: dict, ref: dict, tables) -> dict:
    """The numbers of a training cell: the program's first steps against
    the reference's, from the same scene file, factors and seed (the
    reference may follow fewer steps: those it follows are compared).
    - `loss_gap`: each step's loss, the largest |program - reference| /
      reference;
    - `grad_norm_gap`: the first gradient as Adam holds it after one
      step, by the worst leaf (`_leaf_gap`), over every float table;
    - `change_norm_gap`: each parameter's change over the steps the
      reference follows, by the worst leaf, over the tables Adam moves
      whose reference gradient is not nought to rounding (NOUGHT of the
      median leaf's).
    A first step that overflowed its buckets reads infinite."""
    if any(mine["overflow"]) or any(ref["overflow"]):
        return {k: float("inf") for k in TRAIN_NUMBERS}
    n = len(ref["losses"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"],
                                                   ref["losses"]))
    keys = sorted(ref["grads"])
    gnorm = {k: float(torch.linalg.vector_norm(ref["grads"][k].double()))
             for k in keys}
    med = float(np.median([v for v in gnorm.values() if v > 0]))
    moved = [k for k in tables if gnorm[k] >= NOUGHT * med]
    return {"loss_gap": float(loss),
            "grad_norm_gap": _leaf_gap(mine["grads"], ref["grads"], keys),
            "change_norm_gap": _leaf_gap(mine["change"][n - 1],
                                         ref["change"][n - 1], moved)}
