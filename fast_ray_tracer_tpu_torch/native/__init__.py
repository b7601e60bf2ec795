"""Host C++ for the large walks of the scene compiler (ctypes).

The port's copy of the JAX package's `native/`: the OBJ line scan
(`obj_core.cpp`) and the BVH-divide simulation that yields the shadow-walk
ranks (`divide_core.cpp`); and the PNG reader's scanline reconstruction
(`png_core.cpp`), whose Average and Paeth filters are sequential along a
row. A 141k-triangle mesh makes the Python divide walk take many seconds,
and it runs inside every `compile_scene`, so the compiler takes the C++
walks whenever they build. `_build.py` builds them with g++ into
build/native/ at first use.

Where they cannot be built (no g++, or a failing one), `available()` is
False, one warning names the compiler's first line, and the compiler
takes the Python walks, as the JAX package does:
`scene/obj_loader._scan_obj_python` and `scene/divide.shadow_ranks_python`,
the reference the C++ is held to bit for bit. The PNG unfilter has no
Python version: without the build, `png_unfilter` (and so `read_png`)
raises a RuntimeError that names it.
"""

from __future__ import annotations

import ctypes
import sys
import threading
import warnings

import numpy as np

from fast_ray_tracer_tpu_torch import _build

_lib = None
_tried = False
_failure = ""
_lock = threading.Lock()


def _load():
    """The library, built and loaded at the first call; None, after one
    warning, when the build fails."""
    global _lib, _tried, _failure
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _build.load("native")
        except (RuntimeError, OSError) as e:
            # _build's message is a header line, then the compiler's output
            lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
            _failure = ": ".join(lines[:2]) or type(e).__name__
            warnings.warn(f"the host C++ walks (native/) did not build "
                          f"({_failure}); compile_scene takes the Python "
                          f"OBJ scan and divide walk, and PNG files cannot "
                          f"be read", RuntimeWarning, stacklevel=3)
            return None
        lib.frt_obj_load.restype = ctypes.c_void_p
        lib.frt_obj_load.argtypes = [ctypes.c_char_p]
        lib.frt_obj_counts.restype = None
        lib.frt_obj_counts.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.frt_obj_fill.restype = None
        lib.frt_obj_free.argtypes = [ctypes.c_void_p]
        lib.frt_shadow_ranks.restype = ctypes.c_int64
        lib.frt_png_unfilter.restype = ctypes.c_int64
        lib.frt_png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ walks built (tried once, at the first call)."""
    return _load() is not None


def _require(what: str):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"{what} needs the host C++ build of "
                           f"fast_ray_tracer_tpu_torch/native/ (g++), which "
                           f"failed: {_failure}")
    return lib


class ObjGeometry:
    """Raw OBJ parse result (indices are 1-based, 0 = absent); the layout
    of scene/obj_loader._Geometry."""

    def __init__(self, v, vt, vn, tri, flags, group, event,
                 group_names, events):
        self.v = v                    # (nv, 3) float64
        self.vt = vt                  # (nvt, 3)
        self.vn = vn                  # (nvn, 3)
        self.tri = tri                # (ntri, 3, 3) int32: [corner][v,t,n]
        self.use_n = flags[:, 0].astype(bool)
        self.use_t = flags[:, 1].astype(bool)
        self.group = group            # (ntri,) group index
        self.event = event            # (ntri,) events-seen count
        self.group_names = group_names  # list[str], [0] = default group
        self.events = events          # list[("m"|"u", arg)] in file order


def parse_obj(path: str) -> ObjGeometry:
    """Scan an OBJ file with the C++ core."""
    lib = _require("the C++ OBJ scan")
    h = lib.frt_obj_load(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        counts = (ctypes.c_int64 * 6)()
        lib.frt_obj_counts(h, counts)
        nv, nvt, nvn, ntri, glen, elen = (int(c) for c in counts)
        v = np.empty((nv, 3), np.float64)
        vt = np.empty((nvt, 3), np.float64)
        vn = np.empty((nvn, 3), np.float64)
        tri = np.empty((ntri, 3, 3), np.int32)
        flags = np.empty((ntri, 2), np.int32)
        group = np.empty((ntri,), np.int32)
        event = np.empty((ntri,), np.int32)
        gbuf = ctypes.create_string_buffer(glen)
        ebuf = ctypes.create_string_buffer(elen)

        def ptr(a, ty):
            if a.size == 0:
                return ty()          # null pointer of the right type
            return a.ctypes.data_as(ty)

        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.frt_obj_fill(ctypes.c_void_p(h), ptr(v, dp), ptr(vt, dp),
                         ptr(vn, dp), ptr(tri, ip), ptr(flags, ip),
                         ptr(group, ip), ptr(event, ip), gbuf, ebuf)
        group_names = gbuf.raw[:glen].decode().split("\n") if glen else \
            ["##default_group"]
        events = []
        if elen:
            for line in ebuf.raw[:elen].decode().split("\n"):
                events.append((line[0], line[2:]))
        return ObjGeometry(v, vt, vn, tri, flags, group, event,
                           group_names, events)
    finally:
        lib.frt_obj_free(h)


def shadow_ranks(root, threshold: int, n_leaves: int):
    """frt_shadow_ranks over a serialized divide-sim Node tree
    (scene/divide.py): rank[leaf_id] = post-divide DFS visit position.
    Raises on an inconsistent tree (the Python walk's assert)."""
    lib = _require("the C++ divide walk")

    INF = float("inf")
    IDENT = np.asarray([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1])
    NOBOX = np.asarray([INF, INF, INF, -INF, -INF, -INF])

    # chunked columns: scalar nodes buffer into lists, leafblocks append
    # whole numpy chunks — no per-triangle Python work for big meshes
    kind_ch, tf_ch, leaf_ch, box_ch, nch_ch, ci_ch = [], [], [], [], [], []
    buf = {"kind": [], "tf": [], "leaf": [], "box": [], "nch": []}
    count = 0

    def flush():
        if not buf["kind"]:
            return
        kind_ch.append(np.asarray(buf["kind"], np.int8))
        tf_ch.append(np.concatenate(buf["tf"]))
        leaf_ch.append(np.asarray(buf["leaf"], np.int32))
        box_ch.append(np.concatenate(buf["box"]))
        nch_ch.append(np.asarray(buf["nch"], np.int32))
        for v in buf.values():
            v.clear()

    def alloc_scalar(k, tf, leaf, box, nch) -> int:
        nonlocal count
        buf["kind"].append(k)
        buf["tf"].append(np.asarray(tf, np.float64))
        buf["leaf"].append(leaf)
        buf["box"].append(box)
        buf["nch"].append(nch)
        count += 1
        return count - 1

    def emit(node) -> int:
        nonlocal count
        if node.kind == "group":
            ch = []
            for c in node.children:
                if c.kind == "leafblock":
                    nb = len(c.block_ids)
                    # expand the block as nb leaf nodes in one chunk
                    flush()
                    base = count
                    kind_ch.append(np.full(nb, 2, np.int8))
                    tf_ch.append(np.tile(IDENT, nb))
                    leaf_ch.append(np.asarray(c.block_ids, np.int32))
                    box_ch.append(np.asarray(c.block_boxes,
                                             np.float64).reshape(-1))
                    nch_ch.append(np.zeros(nb, np.int32))
                    count += nb
                    ch.append(np.arange(base, base + nb, dtype=np.int32))
                else:
                    ch.append(np.asarray([emit(c)], np.int32))
            idx = alloc_scalar(0, node.transform, node.leaf_id, NOBOX,
                               sum(len(e) for e in ch))
            ci_ch.append((idx, np.concatenate(ch) if ch
                          else np.zeros(0, np.int32)))
            return idx
        if node.kind == "csg":
            ch = np.asarray([emit(node.left), emit(node.right)], np.int32)
            idx = alloc_scalar(1, node.transform, node.leaf_id, NOBOX, 2)
            ci_ch.append((idx, ch))
            return idx
        box = NOBOX if node.obj_box is None else np.asarray(
            list(node.obj_box.min) + list(node.obj_box.max), np.float64)
        return alloc_scalar(2, node.transform, node.leaf_id, box, 0)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        root_idx = emit(root)
    finally:
        sys.setrecursionlimit(old_limit)
    flush()

    kind_a = np.ascontiguousarray(np.concatenate(kind_ch))
    tf_a = np.ascontiguousarray(np.concatenate(tf_ch))
    leaf_a = np.ascontiguousarray(np.concatenate(leaf_ch))
    box_a = np.ascontiguousarray(np.concatenate(box_ch))
    nch_a = np.ascontiguousarray(np.concatenate(nch_ch))
    # child lists must be laid out in node-index order
    ci_ch.sort(key=lambda e: e[0])
    ci_a = np.ascontiguousarray(np.concatenate(
        [e[1] for e in ci_ch])) if ci_ch else np.zeros(1, np.int32)
    out = np.empty(n_leaves, np.int32)
    rc = lib.frt_shadow_ranks(
        ctypes.c_int64(count), ctypes.c_int64(root_idx),
        kind_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        tf_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        leaf_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        box_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nch_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ci_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(threshold), ctypes.c_int64(n_leaves),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise AssertionError("leaf ids inconsistent (native divide)")
    return [int(x) for x in out]


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) bytes of a non-interlaced PNG image from its `h`
    filtered scanlines of 1 + stride bytes each (`raw` holds at least
    that much). Raises ValueError naming the first scanline whose filter
    type is unknown."""
    lib = _require("reading a PNG file")
    out = np.empty((h, stride), np.uint8)
    rc = lib.frt_png_unfilter(raw, h, stride, bpp, out.ctypes.data)
    if rc != 0:
        y = rc - 1
        raise ValueError(f"unknown PNG filter type {raw[y * (stride + 1)]} "
                         f"on scanline {y}")
    return out
