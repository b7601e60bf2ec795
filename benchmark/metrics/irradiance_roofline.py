"""irradiance_roofline: the irradiance estimates' share of their roofline
in %, whatever implements them (render/photon.irradiance_estimate): the
least time of every estimate call of a frame (benchmark/gi_roofline.py:
a squared distance for each photon a query sums, its `num` nearest within
the search radius, at the float32 peak, or the queries, the estimates and
the photons summed at the HBM peak, where they take longer), over the
device time inside the program's range `irradiance_estimate` in the
first profiled frame. The pairs are counted on each call's points and
map when that frame is rendered again after the window, with the
benchmark's own map of the call's photons. Moves frame_s."""

from benchmark import gi_roofline

RANGE = "irradiance_estimate"
KEY = "irradiance_bound_s"


def install(rec):
    from fast_ray_tracer_tpu_torch.render import photon

    from benchmark.reference import gi
    rec[KEY] = 0.0
    orig = photon.irradiance_estimate
    grids = {}

    def irradiance_estimate(pm, points, eyev, num, max_dist, cone_k):
        # one map of each distinct photon set, kept while the frame runs
        key = id(pm.pos)
        if key not in grids:
            pos = pm.pos.detach().cpu().numpy()
            grids[key] = (pm.pos, gi.build_photon_map(
                pos, pos, pos, max_dist, pm.pos.dtype, points.device))
        grid = grids[key][1]
        pairs, photons = gi_roofline.pairs_within(grid, points.detach(),
                                                  max_dist, num)
        rec[KEY] += gi_roofline.estimate_bound(
            pairs, points.shape[0], photons, points.element_size())[0]
        return orig(pm, points, eyev, num, max_dist, cone_k)
    photon.irradiance_estimate = irradiance_estimate

    def undo():
        photon.irradiance_estimate = orig
        grids.clear()
    return undo


def read(t):
    bound = t.recorded.get(KEY)
    if not t.units or not bound or RANGE not in t.units[0].in_range:
        return None
    dev = t.units[0].in_range[RANGE]
    return 100.0 * bound / dev if dev > 0 else None
