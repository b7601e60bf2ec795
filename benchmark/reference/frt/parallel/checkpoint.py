"""Checkpoint/resume for renders and inverse-rendering runs.

The reference has no checkpointing: the canvas lives in memory and is
written once at the end, so a killed render loses everything. Here both
long-running loops resume:

  * training (parallel/train.py): the parameters, the optimizer's state
    (Adam's moments and step count) and the step number, one `torch.save`
    file per saved step, the latest `max_to_keep` kept;
  * rendering (render/render.py): the chunk loop is deterministic in the
    chunk index, so a render snapshot is the canvas and the number of
    finished chunks.

Every file is written to a temporary name first and then moved over its
final name (`os.replace`), so a kill mid-write leaves the previous file.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def saved_steps(directory: str):
    """The steps saved in `directory`, in increasing order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                os.listdir(directory)) if m)


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def save_train_state(directory: str, step: int, state,
                     max_to_keep: int = 3) -> None:
    """Save a TrainState (its parameters and its optimizer's state) at
    `step`, then delete all but the latest `max_to_keep` saved steps."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "params": {k: v.detach() for k, v in state.params.items()},
        "optimizer": state.optimizer.state_dict(),
    }
    _atomic_write(_step_path(directory, step),
                  lambda f: torch.save(payload, f))
    for old in saved_steps(directory)[:-max_to_keep]:
        os.remove(_step_path(directory, old))


def restore_train_state(directory: str, state):
    """Load the latest saved step into `state` (a TrainState built as the
    saved one was: the same parameter names, the same trainable subset,
    the same optimizer) and return (step, state); None if nothing was
    saved there. The parameters are overwritten in place, so the
    optimizer keeps holding them."""
    steps = saved_steps(directory)
    if not steps:
        return None
    payload = torch.load(_step_path(directory, steps[-1]),
                         map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(payload["params"][k])
    state.optimizer.load_state_dict(payload["optimizer"])
    return payload["step"], state


def save_render_progress(path: str, canvas: np.ndarray, chunks_done: int,
                         total_chunks: int) -> None:
    """Snapshot of a partly rendered (pixels, 3) canvas."""
    _atomic_write(path, lambda f: np.savez(
        f, canvas=np.asarray(canvas), chunks_done=int(chunks_done),
        total_chunks=int(total_chunks)))


def load_render_progress(path: str) -> Optional[dict]:
    """-> {"canvas", "chunks_done", "total_chunks"}, or None when there is
    no snapshot at `path`."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {"canvas": z["canvas"].copy(),
                "chunks_done": int(z["chunks_done"]),
                "total_chunks": int(z["total_chunks"])}
