"""bucket_cache_ms.frame: the host wall of the program's
`render.bucket_cache` spans (render/render.py: the bucket calibration's
cache key, which copies every scene table to the host, and the cache
file's lookup and writes), per frame of the traced window, in ms. A sink
on the program's tracer (utils/profiling.add_sink) adds each closed
span's wall; it syncs nothing. A program without the tracer reads
nothing. Moves frame_s."""

import statistics

SPAN = "render.bucket_cache"


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
