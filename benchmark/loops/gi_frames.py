"""`gi_frames`: the `frames` loop (loops/frames.py, reused whole) for
photon-GI frames at a million photons a map.

Traffic parameters: those of `frames`. The reference frame is the frozen
reference's whole frame, with its photon maps built by reference/gi.py,
whose tables follow the photons: the frozen dense grid over the photons'
box can ask for more memory than the host has.

The configuration's photon maps need such tables in the program too:
photons that leave the open box land up to thousands of units out on its
infinite planes, and a dense grid over their box can ask for tens of
billions of cells (PERF.md section 5). Such a program would run minutes
into the window before the frame whose grid it cannot hold, and then
touch hundreds of GB of host memory. Set-up therefore first builds a map
of two photons a million cells apart on each axis, through the map
build's contract (`build_photon_map(pos, power, dirs, radius, dtype,
device)`), and a program that cannot build it fails the run before any
frame.

    python3 -m benchmark.loops.gi_frames --config FILE --seeds N [N ...]
                                         [--dtype bfloat16] ...

runs benchmark.control (its arguments) with the same reference maps:
the control of a `gi_frames` cell.
"""

from __future__ import annotations

import sys

from benchmark.loops import frames
from benchmark.reference import gi


def _map_follows_photons(dev) -> None:
    """Fail the run unless the program builds a photon map of two photons
    whose dense grid would hold 10^18 cells."""
    import numpy as np
    import torch

    from fast_ray_tracer_tpu_torch.render import photon
    pos = np.array([[0.0, 0.0, 0.0], [1e5, 1e5, 1e5]])
    try:
        photon.build_photon_map(pos, pos, pos, 0.1, torch.float32, dev)
    except (MemoryError, ValueError, RuntimeError) as e:
        raise SystemExit("benchmark: the program cannot build a photon map "
                         "whose photons lie far apart (a dense grid of "
                         f"10^18 cells): {type(e).__name__}: {e}")


def run(ctx) -> dict:
    _map_follows_photons(ctx.device)
    with gi.installed():
        return frames.run(ctx)


def control(argv=None) -> int:
    """benchmark.control's frames, with the reference maps of this
    module's cells."""
    from benchmark import control as C
    args = sys.argv[1:] if argv is None else argv
    with gi.installed():
        return C.main(list(args) + ["--loop", "frames"])


if __name__ == "__main__":
    sys.exit(control())
