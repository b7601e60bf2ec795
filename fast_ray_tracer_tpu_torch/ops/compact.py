"""Stream compaction for the static-bucket wavefront.

`compact_rows(src, act, B, fill_row)` moves the active rows of src (N, C),
in order, to the first rows of a (B, C) bucket; rows past the active count
become `fill_row`, and active rows past B are dropped (the caller's
overflow flag reports that). `expand_rows(child, act)` is its transpose:
out[i] = act[i] ? child[cumsum(act)[i] - 1] : 0, giving (N, C) from
(B, C). Each is the other's VJP, through `torch.autograd.Function`.

On a CUDA tensor both launch the hand-written kernels of
`csrc/compact.cu` (replacing the TPU kernels `_compact_kernel` and
`_expand_kernel` of fast_ray_tracer_tpu/ops/compact_pallas.py), built on
first use with nvcc into build/kernels/ (`_build.py`) and loaded with
ctypes; a kernel that cannot be built or launched raises. Both are one
single-pass scan with decoupled look-back over the flags: compaction
moves the tile's rows in that launch and fills the bucket's tail in a
second, which also clears the per-stream scratch; expansion is that one
launch, and its last tile clears the scratch. On a CPU tensor they take
the plain torch versions below, which are also the reference the kernels
are held to. `LAUNCHES` counts the calls that launched each operation's
kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch.utils.profiling import CounterGroup

# kernel launches per operation since the last reset (a plain int each);
# the tracer's counters launches.compact and launches.expand
LAUNCHES = CounterGroup("launches.", "compact", "expand")

_lib = None


# ---------------------------------------------------------------------------
# plain torch versions (CPU path and reference)
# ---------------------------------------------------------------------------

def compact_rows_plain(src, act, B: int, fill_row):
    """Plain torch compact_rows; no host sync."""
    n, c = src.shape
    pos = torch.cumsum(act, 0) - 1
    idx = torch.where(act & (pos < B), pos, B)
    out = torch.empty((B + 1, c), dtype=src.dtype, device=src.device)
    for k, v in enumerate(fill_row):
        out[:, k] = v
    # every dropped row lands on the extra last row, which is cut off
    out.index_copy_(0, idx, src)
    return out[:B]


def expand_rows_plain(child, act):
    """Plain torch expand_rows; no host sync."""
    pos = (torch.cumsum(act, 0) - 1).clamp(0, child.shape[0] - 1)
    return torch.where(act[:, None], child[pos], 0.0)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        lib = _build.load("compact")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("frt_compact_f32", "frt_compact_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, i64, i64, i32, i64,
                           ctypes.POINTER(ctypes.c_double), i32, vp]
            fn.restype = i32
        for name in ("frt_expand_f32", "frt_expand_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, i64, i64, i32, i64, i32, vp]
            fn.restype = i32
        lib.frt_max_c.argtypes = []
        lib.frt_max_c.restype = i32
        lib.frt_tile_rows.argtypes = [i32, i32]
        lib.frt_tile_rows.restype = i32
        lib.frt_scratch_words.argtypes = [i64]
        lib.frt_scratch_words.restype = i64
        lib.max_c = lib.frt_max_c()
        _lib = lib
    return _lib


def tile_rows(c: int, dtype) -> int:
    """Rows per tile of either kernel for rows of c elements."""
    return _load().frt_tile_rows(c, torch.empty((), dtype=dtype)
                                 .element_size())


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(rows, act, what: str):
    if rows.dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 rows, got {rows.dtype}")
    if rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"{what}: rows must be a contiguous (N, C) tensor")
    if act.dtype != torch.bool or act.dim() != 1 or not act.is_contiguous():
        raise ValueError(f"{what}: act must be a contiguous 1-D bool tensor")
    if act.device != rows.device:
        raise ValueError(f"{what}: act on {act.device}, rows on {rows.device}")


# the kernels' scratch per (device, stream): ticket, total, tiles done and
# one status word per tile, shared by both operations. Zeroed once when
# made; every call of either leaves it clean for the next call on its
# stream. The lock keeps two threads from interleaving their launches on
# one stream's scratch (ctypes releases the GIL during the call).
_compact_scratch = {}
_compact_lock = threading.Lock()


def _stream_scratch(device, stream: int, words: int):
    key = (device.index, stream)
    buf = _compact_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _compact_scratch[key] = buf
    return buf


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _launch(op: str, rows, act, out, n: int, c: int, b: int, *extra):
    """frt_<op>_<dtype> on the current stream of rows' device, with that
    stream's scratch; counts the call and raises on a launch error. Host
    work here is most of a call's time at the wavefront's sizes: the raw
    stream handle, and the device switched inside the library."""
    lib = _load()
    dev = rows.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with _compact_lock:
        scratch = _stream_scratch(dev, stream, lib.frt_scratch_words(n))
        err = getattr(lib, f"frt_{op}_{_SUFFIX[rows.dtype]}")(
            rows.data_ptr(), act.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), n, c, b, *extra, dev.index,
            stream)
        if err != 0:
            # a call that failed part way may leave its scratch dirty
            _compact_scratch.pop((dev.index, stream), None)
    LAUNCHES.add(op)
    _raise_on(err, f"{op}_rows")


def compact_rows_cuda(src, act, B: int, fill_row):
    """compact_rows through the CUDA kernel (csrc/compact.cu)."""
    _check(src, act, "compact_rows")
    n, c = src.shape
    max_c = _load().max_c
    if act.shape[0] != n or len(fill_row) != c or not 1 <= c <= max_c:
        raise ValueError(f"compact_rows: act {tuple(act.shape)}, fill row of "
                         f"{len(fill_row)} for src {tuple(src.shape)} "
                         f"(C <= {max_c})")
    if not 1 <= B < 2**31 or n >= 2**31:
        raise ValueError(f"compact_rows: B={B}, N={n} out of range")
    out = torch.empty((B, c), dtype=src.dtype, device=src.device)
    _launch("compact", src, act, out, n, c, B,
            (ctypes.c_double * c)(*fill_row))
    return out


def expand_rows_cuda(child, act):
    """expand_rows through the CUDA kernel (csrc/compact.cu); allocates
    only its output."""
    _check(child, act, "expand_rows")
    b, c = child.shape
    n = act.shape[0]
    max_c = _load().max_c
    if not 1 <= c <= max_c:
        raise ValueError(f"expand_rows: child {tuple(child.shape)} "
                         f"(C <= {max_c})")
    if not 1 <= b < 2**31 or n >= 2**31:
        raise ValueError(f"expand_rows: B={b}, N={n} out of range")
    out = torch.empty((n, c), dtype=child.dtype, device=child.device)
    _launch("expand", child, act, out, n, c, b)
    return out


# ---------------------------------------------------------------------------
# public, differentiable entry points
# ---------------------------------------------------------------------------

def _on(x, cpu_fn, cuda_fn, *args):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return cpu_fn(x, *args)
    if x.device.type == "cuda":
        return cuda_fn(x, *args)
    raise ValueError(f"no compaction for tensors on {x.device}")


class _CompactRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, act, B, fill_row):
        ctx.save_for_backward(act)
        return _on(src, compact_rows_plain, compact_rows_cuda, act, B,
                   fill_row)

    @staticmethod
    def backward(ctx, g):
        (act,) = ctx.saved_tensors
        return expand_rows(g.contiguous(), act), None, None, None


class _ExpandRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, child, act):
        ctx.save_for_backward(act)
        ctx.bucket = child.shape[0]
        return _on(child, expand_rows_plain, expand_rows_cuda, act)

    @staticmethod
    def backward(ctx, g):
        (act,) = ctx.saved_tensors
        zero = (0.0,) * g.shape[1]
        return compact_rows(g.contiguous(), act, ctx.bucket, zero), None


def compact_rows(src, act, B: int, fill_row):
    """Active rows of src (N, C) compacted, in order, to the front of a
    (B, C) output; rows past the active count become `fill_row`. Its VJP
    is expand_rows of the cotangent."""
    return _CompactRows.apply(src, act, int(B), tuple(fill_row))


def expand_rows(child, act):
    """(N, C): act[i] ? child[cumsum(act)[i]-1] : 0 — the transpose of
    compact_rows. Its VJP is compact_rows with a zero fill."""
    return _ExpandRows.apply(child, act)
