"""host_syncs_per_frame: the program's counter `host_syncs`
(utils/profiling.host_sync: the calls that block the host until the
device has done its queued work, each table copy one), per frame of the
traced window. A sink on the program's tracer
(utils/profiling.add_sink) sums the counter's increments; it syncs
nothing. A program without the tracer reads nothing. Moves frame_s."""

import statistics

COUNTER = "host_syncs"


def spans(sp):
    from fast_ray_tracer_tpu_torch.utils import profiling as P
    if not hasattr(P, "add_sink"):
        return None

    def sink(rec):
        if isinstance(rec, P.Count) and rec.name == COUNTER:
            sp.cur[COUNTER] = sp.cur.get(COUNTER, 0) + rec.n
    return P.add_sink(sink)


def read(t):
    v = t.spans.get(COUNTER)
    return statistics.mean(v) if v else None
