"""sync_wait_ms.frame: the host wall of the program's `sync.<site>` spans
(utils/profiling.host_sync: each call that blocks the host until the
device has done its queued work, and the copy it makes), per frame of
the traced window, in ms; a sync span inside another counts once. A
sink on the program's tracer (utils/profiling.add_sink) adds each closed
span's wall; it syncs nothing. A program without the tracer reads
nothing. Moves frame_s."""

import statistics

KEY = "sync_wait"


def _is_sync(s) -> bool:
    return s is not None and s.name.startswith("sync.")


def spans(sp):
    from fast_ray_tracer_tpu_torch.utils import profiling as P
    if not hasattr(P, "add_sink"):
        return None

    def sink(rec):
        if isinstance(rec, P.Span) and _is_sync(rec) \
                and not _is_sync(rec.parent):
            sp.cur[KEY] = sp.cur.get(KEY, 0.0) + rec.seconds
    return P.add_sink(sink)


def read(t):
    v = t.spans.get(KEY)
    return statistics.mean(v) * 1e3 if v else None
