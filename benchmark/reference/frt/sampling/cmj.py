"""Correlated multi-jittered (CMJ) 2D sampling.

The reference keeps a mutable sample table regenerated via `reset()`
(src/libs/sampler/sampler.c:414-469): a canonical CMJ arrangement

    arr[j*m+i].x = (i + (j + xi)/n) / m      (n = usteps, m = vsteps)
    arr[j*m+i].y = (j + (i + xi)/m) / n

followed by an in-place truncation-indexed swap pass ("shuffle") over rows
for x and columns for y, and indexed reads `get_point((u,v)) ->
arr[v*usteps + u]`. With jitter off, xi = 0.5 everywhere and the table is
a constant, computed here on the host exactly as in the JAX package.
Jittered tables (`cmj_points`, `cmj_points_batched`) take their uniforms
as arguments: the canonical jitter and one swap uniform per row and per
column, which the shuffle turns into a row index by truncating
j + u * (n - j) to an integer. `draw_cmj` and `draw_cmj_batched` draw
them from an RNG node as the JAX package draws them from a key.
"""

from __future__ import annotations

import numpy as np
import torch


def cmj_points_static(usteps: int, vsteps: int) -> np.ndarray:
    """Deterministic (jitter=False) CMJ table; returns (usteps*vsteps, 2).

    Row s corresponds to sample index s = v*usteps + u, matching the C
    `get_point` read order. Computed in float64 on host.
    """
    count = usteps * vsteps
    x = np.zeros(count)
    y = np.zeros(count)
    n, m = usteps, vsteps
    xi = 0.5
    for j in range(n):
        for i in range(m):
            idx = j * m + i
            x[idx] = (i + (j + xi) / n) / m
            y[idx] = (j + (i + xi) / m) / n
    # shuffle: note swapped roles (m=usteps, n=vsteps), as in the C source.
    m2, n2 = usteps, vsteps
    for j in range(n2):
        k = int(j + xi * (n2 - j))
        for i in range(m2):
            a, b = j * m2 + i, k * m2 + i
            x[a], x[b] = x[b], x[a]
    for i in range(m2):
        k = int(i + xi * (m2 - i))
        for j in range(n2):
            a, b = j * m2 + i, j * m2 + k
            y[a], y[b] = y[b], y[a]
    return np.stack([x, y], axis=-1)


def _canonical(xi, usteps: int, vsteps: int):
    """The canonical arrangement with jitter xi (..., count, 2)."""
    n, m = usteps, vsteps
    idx = torch.arange(usteps * vsteps, dtype=xi.dtype, device=xi.device)
    j_idx = idx // m
    i_idx = idx % m
    x = (i_idx + (j_idx + xi[..., 0]) / n) / m
    y = (j_idx + (i_idx + xi[..., 1]) / m) / n
    return x, y


def cmj_points(xi, ks_x, ks_y, usteps: int, vsteps: int):
    """One jittered CMJ table (count, 2) from its uniforms: xi (count, 2),
    ks_x (vsteps,) and ks_y (usteps,) — the swap pass over rows for x and
    over columns for y, each swap index a truncated j + u * (n - j)."""
    x, y = _canonical(xi, usteps, vsteps)
    m2, n2 = usteps, vsteps
    x = x.reshape(n2, m2).clone()
    for j in range(n2):
        k = int((j + ks_x[j] * (n2 - j)).to(torch.int64))
        x[[j, k]] = x[[k, j]]
    y = y.reshape(n2, m2).clone()
    for i in range(m2):
        k = int((i + ks_y[i] * (m2 - i)).to(torch.int64))
        y[:, [i, k]] = y[:, [k, i]]
    return torch.stack([x.reshape(-1), y.reshape(-1)], -1)


def cmj_points_batched(xi, ks_x, ks_y, usteps: int, vsteps: int):
    """R independent jittered CMJ tables (R, count, 2) from their uniforms:
    xi (R, count, 2), ks_x (R, vsteps), ks_y (R, usteps). Each swap is a
    masked select over the small row or column axis (the JAX package's
    batch-first form), never a per-lane scatter."""
    R = xi.shape[0]
    x, y = _canonical(xi, usteps, vsteps)
    m2, n2 = usteps, vsteps
    x = x.reshape(R, n2, m2)
    rows = torch.arange(n2, device=xi.device)
    for j in range(n2):
        k = (j + ks_x[:, j] * (n2 - j)).to(torch.int64)     # (R,) in [j, n2)
        is_k = (rows[None] == k[:, None])[:, :, None]       # (R, n2, 1)
        row_j = x[:, j, :]
        row_k = torch.where(is_k, x, 0.0).sum(1)
        x = torch.where(is_k, row_j[:, None, :], x)
        x = torch.cat([x[:, :j], row_k[:, None], x[:, j + 1:]], 1)
    y = y.reshape(R, n2, m2)
    cols = torch.arange(m2, device=xi.device)
    for i in range(m2):
        k = (i + ks_y[:, i] * (m2 - i)).to(torch.int64)
        is_k = (cols[None] == k[:, None])[:, None, :]       # (R, 1, m2)
        col_i = y[:, :, i]
        col_k = torch.where(is_k, y, 0.0).sum(2)
        y = torch.where(is_k, col_i[:, :, None], y)
        y = torch.cat([y[:, :, :i], col_k[:, :, None], y[:, :, i + 1:]], 2)
    return torch.stack([x.reshape(R, -1), y.reshape(R, -1)], -1)


def draw_cmj(rng, usteps: int, vsteps: int, dtype):
    """cmj_points' uniforms from an RNG node, split as the JAX package
    splits its key: (xi, ks_x, ks_y)."""
    k_can, k_x, k_y = rng.split(3)
    return (k_can.uniform((usteps * vsteps, 2), dtype),
            k_x.uniform((vsteps,), dtype), k_y.uniform((usteps,), dtype))


def draw_cmj_batched(rng, R: int, usteps: int, vsteps: int, dtype):
    """cmj_points_batched's uniforms from an RNG node: (xi, ks_x, ks_y)."""
    k_can, k_x, k_y = rng.split(3)
    return (k_can.uniform((R, usteps * vsteps, 2), dtype),
            k_x.uniform((R, vsteps), dtype), k_y.uniform((R, usteps), dtype))
