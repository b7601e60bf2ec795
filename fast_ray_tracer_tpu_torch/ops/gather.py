"""Row gathers from the scene's float tables, with a deterministic backward.

`take_rows(table, idx)` is `table[idx]`: rows of a (K, ...) table at a
1-D int64 index. Every wavefront level gathers the material, primitive
and pattern tables this way with one index per lane, so in a train step
each backward piles a few hundred thousand cotangent rows onto a handful
of table rows. ATen's backward of `table[idx]` (`index_put_` with
accumulate) sorts the indices and walks each row's run of duplicates on
one warp, which took most of a train step on the card.

- With autograd off, or a table that does not require grad, `take_rows`
  is `table[idx]` itself: the same operation, launches and bits.
- On the grad path a table of at most MAX_TABLE_BYTES (K x W elements,
  W the product of its trailing dims) goes through `_TakeRows`: the same
  gather forward, bitwise, saving only the caller's `idx`; its backward
  is the segmented sum `table_grad`. On a CUDA tensor that is the
  hand-written kernel of `csrc/gather.cu` (built on first use with nvcc
  into build/kernels/, loaded with ctypes; it replaces no TPU kernel, the
  JAX package leaves this scatter-add to XLA): no float atomics, every
  sum's order fixed by the launch geometry, so two runs give bitwise-equal
  gradients. It runs or raises. On a CPU tensor it is `table_grad_ref`,
  `index_add_` into zeros, which is also the kernel's reference.
- A larger table (a mesh's triangles, a texture atlas) keeps `table[idx]`
  and ATen's backward: with many rows the lanes spread and contend
  little, and the kernel's private copies (a column of the table a
  thread) no longer fit its shared memory. Only the table's size decides.

`LAUNCHES` counts the kernel's calls (`table_grad`) and the grad-path
gathers that took the large-table route (`table_grad_plain`: plain
`table[idx]` with ATen's backward; not `table_grad_ref`, which is the
small tables' CPU path).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch.utils.profiling import CounterGroup

# since the last reset (a plain int each): the kernel's calls, and the
# grad-path gathers that took the large-table route (plain table[idx],
# ATen's backward); the tracer's counters launches.table_grad and
# launches.table_grad_plain
LAUNCHES = CounterGroup("launches.", "table_grad", "table_grad_plain")

# the largest table (K x W x element size, in bytes) whose gather takes the
# kernel's backward, and the widest row (W elements, one block's threads):
# the kernel's own limits (csrc/gather.cu, kMaxTableBytes and
# kMaxThreads; chip_smoke.py checks both against the library). On an H100
# the kernel beats ATen's backward of table[idx] at every size up to them
# (PERF.md, section 6, has the sweep that set the first).
MAX_TABLE_BYTES = 3584
MAX_ROW = 256

_lib = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _fits(table) -> bool:
    return (table.numel() * table.element_size() <= MAX_TABLE_BYTES
            and math.prod(table.shape[1:]) <= MAX_ROW)


def table_grad_ref(g, idx, shape):
    """The (K, ...) gradient of `table[idx]` for a table of `shape` from
    its cotangent g (N, ...): g's rows summed into their table rows, in
    lane order; no host sync. The CPU path and the kernel's reference."""
    k, w = shape[0], math.prod(shape[1:])
    out = torch.zeros((k, w), dtype=g.dtype, device=g.device)
    out.index_add_(0, torch.where(idx < 0, idx + k, idx),
                   g.reshape(g.shape[0], w))
    return out.view(shape)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("gather")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("frt_table_grad_f32", "frt_table_grad_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, i64, i64, i32, i32, vp, i64, vp, i32, vp]
            fn.restype = i32
        lib.frt_table_grad_blocks.argtypes = [i64, i32, i32, i32, i32]
        lib.frt_table_grad_blocks.restype = i32
        for name in ("frt_table_grad_max_bytes", "frt_table_grad_max_row"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        _lib = lib
    return _lib


def table_grad_cuda(g, idx, shape):
    """table_grad_ref through the CUDA kernel (csrc/gather.cu): one or
    two launches; allocates the gradient and, past one block, the blocks'
    partial sums."""
    if g.dtype not in _SUFFIX:
        raise TypeError(f"table_grad: float32 or float64, got {g.dtype}")
    if idx.dim() != 1 or idx.device != g.device:
        raise ValueError(f"table_grad: a 1-D index on {g.device}, got "
                         f"{tuple(idx.shape)} on {idx.device}")
    idx = idx.long()
    k, n = shape[0], idx.shape[0]
    w = math.prod(shape[1:])
    if k * w * g.element_size() > MAX_TABLE_BYTES or w > MAX_ROW:
        raise ValueError(f"table_grad: a table of {tuple(shape)} exceeds "
                         f"{MAX_TABLE_BYTES} bytes or rows of {MAX_ROW}")
    out = torch.empty((k, w), dtype=g.dtype, device=g.device)
    if n == 0 or k * w == 0:
        return out.zero_().view(shape)
    g = g.reshape(n, w).contiguous()
    lib = _load()
    dev = g.device
    blocks = lib.frt_table_grad_blocks(n, k, w, g.element_size(), dev.index)
    if blocks < 1:
        raise RuntimeError(f"table_grad: no launch plan for N={n}, K={k}, "
                           f"W={w}")
    partial = out if blocks == 1 else torch.empty(
        blocks * k * w, dtype=g.dtype, device=dev)
    err = getattr(lib, f"frt_table_grad_{_SUFFIX[g.dtype]}")(
        g.data_ptr(), idx.data_ptr(), idx.stride(0), n, k, w,
        partial.data_ptr(), partial.numel(), out.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES.add("table_grad")
    if err != 0:
        raise RuntimeError(f"table_grad: CUDA error {err} at launch")
    return out.view(shape)


def table_grad(g, idx, shape):
    """The reference (table_grad_ref) for a CPU tensor, the kernel for a
    CUDA tensor."""
    if g.device.type == "cpu":
        return table_grad_ref(g, idx, shape)
    if g.device.type == "cuda":
        return table_grad_cuda(g, idx, shape)
    raise ValueError(f"no table_grad for tensors on {g.device}")


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return table_grad(g, idx, ctx.shape), None


def take_rows(table, idx):
    """`table[idx]` for a (K, ...) float table and a 1-D int64 index, whose
    backward is the segmented sum `table_grad` for a small table (see the
    module docstring)."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[idx]
    if not _fits(table):
        LAUNCHES.add("table_grad_plain")
        return table[idx]
    if idx.dim() != 1:
        raise ValueError(f"take_rows: a 1-D index, got {tuple(idx.shape)}")
    return _TakeRows.apply(table, idx)
