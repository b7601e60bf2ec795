"""Correlated multi-jittered (CMJ) 2D sampling: the deterministic table.

The reference keeps a mutable sample table regenerated via `reset()`
(src/libs/sampler/sampler.c:414-469): a canonical CMJ arrangement

    arr[j*m+i].x = (i + (j + xi)/n) / m      (n = usteps, m = vsteps)
    arr[j*m+i].y = (j + (i + xi)/m) / n

followed by an in-place truncation-indexed swap pass ("shuffle") over rows
for x and columns for y, and indexed reads `get_point((u,v)) ->
arr[v*usteps + u]`. With jitter off, xi = 0.5 everywhere and the table is
a constant, computed here on the host exactly as in the JAX package.
Jittered tables belong to the stochastic slice.
"""

from __future__ import annotations

import numpy as np


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
