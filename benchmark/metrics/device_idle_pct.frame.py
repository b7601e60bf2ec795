"""device_idle_pct.frame: the share of the profiled frames' wall in which
no kernel, copy or memset ran on the card, in %: 100 x (1 - the union of
the device's intervals / the frames' wall). Moves frame_s."""


def read(t):
    window = t.total("window_s")
    if not t.units or window <= 0 or not t.total("device_events"):
        return None
    return 100.0 * (1.0 - t.total("busy_s") / window)
