"""photon_map_build_ms.frame: the host wall of the program's
`photon.build_map` spans (render/photon.py: one map's build,
photon.build_photon_map, which ends in a host sync), summed per frame of
the traced window, in ms. A sink on the program's tracer
(utils/profiling.add_sink) adds each closed span's wall; it syncs
nothing. A program without the span reads nothing. Moves frame_s."""

import statistics

SPAN = "photon.build_map"


def spans(sp):
    from fast_ray_tracer_tpu_torch.utils import profiling as P
    if not hasattr(P, "add_sink"):
        return None

    def sink(rec):
        if isinstance(rec, P.Span) and rec.name == SPAN:
            sp.cur[SPAN] = sp.cur.get(SPAN, 0.0) + rec.seconds
    return P.add_sink(sink)


def read(t):
    v = t.spans.get(SPAN)
    return statistics.mean(v) * 1e3 if v else None
