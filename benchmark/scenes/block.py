"""The Cornell frame's block: a frozen copy of the port's
scene/demo.write_block_obj, so that later changes to the demo cannot move
the benchmark's input.

`write(path, size, cuts)` writes an axis-aligned box of edges `size`
centred on the origin as an OBJ file of flat triangles, each face cut
into cuts x cuts quads of two triangles (12 cuts^2 in all). The Cornell
frame's block is BLOCK_SIZE at BLOCK_CUTS: 10,092 triangles. A scene's
`objects` name this file as the generator of its block.obj.
Deterministic: the same arguments always give the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

BLOCK_SIZE = (0.5, 1.2, 0.5)
BLOCK_CUTS = 29


def write(path, size=BLOCK_SIZE, cuts: int = BLOCK_CUTS) -> str:
    half = np.asarray(size, np.float64) / 2.0
    t = np.linspace(-1.0, 1.0, cuts + 1)
    verts, faces = [], []
    for axis in range(3):
        a, b = [k for k in range(3) if k != axis]
        for sign in (-1.0, 1.0):
            base = len(verts)
            for i in range(cuts + 1):
                for j in range(cuts + 1):
                    p = np.zeros(3)
                    p[axis], p[a], p[b] = sign, t[i], t[j]
                    verts.append(p * half)
            for i in range(cuts):
                for j in range(cuts):
                    q = [base + i * (cuts + 1) + j + 1,
                         base + (i + 1) * (cuts + 1) + j + 1,
                         base + (i + 1) * (cuts + 1) + j + 2,
                         base + i * (cuts + 1) + j + 2]
                    faces += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
    lines = [f"# box {tuple(size)}, {cuts} x {cuts} cuts a face"]
    lines += ["v %.17g %.17g %.17g" % tuple(v) for v in verts]
    lines += ["f %d %d %d" % f for f in faces]
    # through a temporary name, so that a reader never sees a partial file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return str(path)
