"""final_gather_device_ms.frame: the device time of the kernels inside the
program's profiler range `gi.final_gather` (render/photon.final_gather:
the gather rays' intersection and irradiance estimate), per profiled
frame, in ms. A program without the range reads nothing. Moves
frame_s."""

RANGE = "gi.final_gather"


def read(t):
    v = [u.in_range[RANGE] for u in t.units if RANGE in u.in_range]
    if not v or not sum(v):
        return None
    return sum(v) / len(v) * 1e3
