"""device_idle_pct.step: the share of the profiled steps' wall in which
no kernel, copy or memset ran on the card, in %: 100 x (1 - the union of
the device's intervals / the steps' wall). Moves step_s."""


def read(t):
    window = t.total("window_s")
    if not t.units or window <= 0 or not t.total("device_events"):
        return None
    return 100.0 * (1.0 - t.total("busy_s") / window)
