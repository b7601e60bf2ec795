"""Stream compaction for the static-bucket wavefront: the plain torch
versions alone (the port's ops/compact.py without its CUDA kernels).

`compact_rows(src, act, B, fill_row)` moves the active rows of src (N, C),
in order, to the first rows of a (B, C) bucket; rows past the active count
become `fill_row`, and active rows past B are dropped (the caller's
overflow flag reports that). `expand_rows(child, act)` is its transpose:
out[i] = act[i] ? child[cumsum(act)[i] - 1] : 0, giving (N, C) from
(B, C). Each is the other's VJP, through `torch.autograd.Function`.
`LAUNCHES` stays at 0: nothing here launches a hand-written kernel.
"""

from __future__ import annotations

import torch

# kernel launches per operation since the last reset (a plain int each)
LAUNCHES = {"compact": 0, "expand": 0}

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
# public, differentiable entry points
# ---------------------------------------------------------------------------

class _CompactRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, act, B, fill_row):
        ctx.save_for_backward(act)
        return compact_rows_plain(src, act, B, fill_row)

    @staticmethod
    def backward(ctx, g):
        (act,) = ctx.saved_tensors
        return expand_rows(g.contiguous(), act), None, None, None


class _ExpandRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, child, act):
        ctx.save_for_backward(act)
        ctx.bucket = child.shape[0]
        return expand_rows_plain(child, act)

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
