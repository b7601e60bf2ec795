"""irradiance_estimate_ms.frame: the device time of the kernels inside
the program's profiler range "irradiance_estimate" (render/photon.py),
per profiled frame, in ms. Moves frame_s."""

RANGE = "irradiance_estimate"


def read(t):
    if not t.units or not any(RANGE in u.in_range for u in t.units):
        return None
    v = sum(u.in_range.get(RANGE, 0.0) for u in t.units) / len(t.units)
    return v * 1e3 if v > 0 else None
