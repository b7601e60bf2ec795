"""compaction_roofline: the compaction kernels' share of their roofline
in % (ops/compact.py, csrc/compact.cu: compact_kernel, fill_kernel,
expand_kernel): the least time of every compact_rows and expand_rows
launch of a frame, by the bytes it must move (benchmark/roofline.py:
each input read once, each output written once, at the HBM peak), over
the device time of those kernels in the same frame. The launches'
shapes are recorded when the first profiled frame is rendered again
after the window. Moves frame_s."""

import re

from benchmark import roofline

KERNELS = re.compile(r"\b(compact|fill|expand)_kernel<")
KEY = "compaction_bound_s"


def install(rec):
    from fast_ray_tracer_tpu_torch.ops import compact
    rec[KEY] = 0.0
    c0, e0 = compact.compact_rows_cuda, compact.expand_rows_cuda

    def compact_rows_cuda(src, act, B, fill_row):
        n, c = src.shape
        rec[KEY] += roofline.bytes_seconds(roofline.compact_bytes(
            n, c, int(B), src.element_size()))
        return c0(src, act, B, fill_row)

    def expand_rows_cuda(child, act):
        b, c = child.shape
        rec[KEY] += roofline.bytes_seconds(roofline.expand_bytes(
            act.shape[0], c, b, child.element_size()))
        return e0(child, act)
    compact.compact_rows_cuda = compact_rows_cuda
    compact.expand_rows_cuda = expand_rows_cuda

    def undo():
        compact.compact_rows_cuda, compact.expand_rows_cuda = c0, e0
    return undo


def read(t):
    bound = t.recorded.get(KEY)
    if not t.units or not bound:
        return None
    dev = sum(s for k, s in t.units[0].kernels.items() if KERNELS.search(k))
    return 100.0 * bound / dev if dev > 0 else None
