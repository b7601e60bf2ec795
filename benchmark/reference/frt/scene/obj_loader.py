"""Wavefront OBJ/MTL loader -> flat triangle rows + divide-sim nodes.

Semantics mirror the reference loader (src/libs/obj_loader/obj_loader.c):
  * faces fan-triangulate; the FIRST vertex token of a face decides whether
    the face uses normals/texcoords (obj_loader.c:237-259)
  * `vn` present on the first token -> smooth triangles (interpolated
    normals); else flat triangles with a precomputed cross-product normal
  * `g NAME` switches to (or creates) a named group; triangles before any
    `g` land in a default group; the result group's children are
    [default group (if non-empty), named groups in first-use order]
    (obj_loader.c:445-546)
  * `mtllib`/`usemtl`: MTL materials with Ka/Kd decoded through the scene
    color space, Ks raw, Tf stored as 1-Tf, `d` stored as Tr=1-d,
    Tr<->Tf linking and the reflective flag via set_material_flags
    (obj_loader.c:39-53,139-213)
  * a YAML material on the obj entry overrides every triangle's material
    afterwards (shape_set_material_recursive in the generated main,
    yaml_parser/obj_parser.py:46-48)

The port's copy of the JAX package's scene/obj_loader.py, numpy only. The
scan takes the C++ core (native/obj_core.cpp); `_scan_obj_python` is the
reference it is held to. An MTL file's map_Ka, map_Kd and map_bump bind
`uv_image` patterns through the triangle uv map (sRGB-decoded but for
map_bump).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.frt import native
from benchmark.reference.frt.scene import divide as div
from benchmark.reference.frt.scene.model import MaterialDesc, PatternDesc


def _resolve(file_name: str, root_dir: str) -> Optional[str]:
    """Reference paths are relative to the repo root the binary runs from
    (README.md usage); ours is the scene file's dir — walk up a few levels."""
    if os.path.exists(file_name):
        return file_name
    d = root_dir
    for _ in range(4):
        p = os.path.join(d, file_name)
        if os.path.exists(p):
            return p
        d = os.path.dirname(d) or "/"
    return None


def _mtl_path(file_name: str, root_dir: str) -> Optional[str]:
    return _resolve(file_name, root_dir)


def parse_mtl(path: str, decode, root_dir: str) -> Dict[str, MaterialDesc]:
    """MTL file -> name -> MaterialDesc (obj_loader.c:139-213)."""
    mats: Dict[str, MaterialDesc] = {}
    cur: Optional[dict] = None

    def finish(c):
        """set_material_flags (obj_loader.c:39-53): reflective flag +
        Tr<->Tf linking."""
        if c is None:
            return
        Tf = np.asarray(c["Tf"])
        if c["Tr"] > 0 and np.all(np.abs(Tf) < 1e-5):
            c["Tf"] = (c["Tr"],) * 3
        elif abs(c["Tr"]) < 1e-5 and np.any(Tf > 0):
            c["Tr"] = float(Tf.sum() / 3.0)
        patterns = {}
        for slot in ("map_Ka", "map_Kd", "map_bump"):
            if c[slot] is not None:
                patterns[slot] = PatternDesc(
                    kind="map", mapping="triangle",
                    faces=[PatternDesc(kind="uv_image", file=c[slot],
                                       decode_to_linear=(slot != "map_bump"))])
        mats[c["name"]] = MaterialDesc(
            Ka=tuple(c["Ka"]), Kd=tuple(c["Kd"]), Ks=tuple(c["Ks"]),
            Tf=tuple(c["Tf"]), refl_color=(0.0, 0.0, 0.0),
            shininess=c["Ns"], refractive_index=c["Ni"],
            transparency=c["Tr"], casts_shadow=c["casts_shadow"],
            patterns=patterns)

    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                finish(cur)
                cur = {"name": parts[1], "Ka": (1.0,) * 3, "Kd": (1.0,) * 3,
                       "Ks": (1.0,) * 3, "Tf": (0.0,) * 3, "Ns": 200.0,
                       "Ni": 1.0, "Tr": 0.0, "casts_shadow": True,
                       "map_Ka": None, "map_Kd": None, "map_bump": None}
            elif cur is None:
                continue
            elif key == "illum":
                pass                          # parsed but unused (material.h)
            elif key == "Tr":
                cur["Tr"] = float(parts[1])
            elif key == "d":
                cur["Tr"] = 1.0 - float(parts[1])
            elif key == "Ni":
                cur["Ni"] = float(parts[1])
            elif key == "Ns":
                cur["Ns"] = float(parts[1])
            elif key == "Ka":
                cur["Ka"] = tuple(np.atleast_1d(
                    decode(np.asarray([float(x) for x in parts[1:4]]))))
            elif key == "Kd":
                cur["Kd"] = tuple(np.atleast_1d(
                    decode(np.asarray([float(x) for x in parts[1:4]]))))
            elif key == "Ks":
                cur["Ks"] = tuple(float(x) for x in parts[1:4])  # raw
            elif key == "Tf":
                cur["Tf"] = tuple(1.0 - float(x) for x in parts[1:4])
            elif key == "Ke":
                pass                          # Ke parsed, unused in shading
            elif key == "noshadow":
                cur["casts_shadow"] = False
            elif key in ("map_Ka", "map_Kd", "map_bump"):
                fn = parts[-1]
                p = _mtl_path(fn, root_dir)
                if p is not None:
                    cur[key] = p
    finish(cur)
    return mats


def _face_token(tok: str) -> Tuple[int, int, int]:
    """'v', 'v/t', 'v//n', 'v/t/n' -> (v, t, n), 0 = absent."""
    if "/" not in tok:
        return int(tok), 0, 0
    ps = tok.split("/")
    v = int(ps[0])
    t = int(ps[1]) if len(ps) > 1 and ps[1] else 0
    n = int(ps[2]) if len(ps) > 2 and ps[2] else 0
    return v, t, n


_GEO_CACHE: Dict[Tuple[str, float], object] = {}


class _Geometry:
    """Raw OBJ scan result; same layout as native.ObjGeometry."""

    def __init__(self):
        self.v = self.vt = self.vn = None
        self.tri = None          # (ntri, 3, 3) int32 [corner][v, t, n]
        self.use_n = self.use_t = None
        self.group = None        # (ntri,) group index
        self.event = None        # (ntri,) #mtl events seen at emission
        self.group_names: List[str] = []
        self.events: List[Tuple[str, str]] = []   # ("m"|"u", arg)


def _scan_obj_python(path: str) -> _Geometry:
    """Pure-Python line scanner, the reference for native.parse_obj; emits
    the identical geometry/event stream (obj_loader.c:339-440 semantics)."""
    g = _Geometry()
    verts, texs, norms = [], [], []
    tri, flags, tgroup, tevent = [], [], [], []
    group_ids = {"##default_group": 0}
    g.group_names = ["##default_group"]
    current = 0

    with open(path) as f:
        for raw in f:
            if raw.startswith("v "):
                p = raw.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif raw.startswith("vt "):
                p = raw.split()
                texs.append((float(p[1]), float(p[2]),
                             float(p[3]) if len(p) > 3 else 0.0))
            elif raw.startswith("vn "):
                p = raw.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif raw.startswith("f "):
                toks = raw.split()[1:]
                if len(toks) < 3:
                    continue
                a = _face_token(toks[0])
                use_n = a[2] > 0
                use_t = a[1] > 0
                for i in range(1, len(toks) - 1):
                    b = _face_token(toks[i])
                    c = _face_token(toks[i + 1])
                    tri.append((a, b, c))
                    flags.append((use_n, use_t))
                    tgroup.append(current)
                    tevent.append(len(g.events))
            elif raw.startswith("g "):
                name = raw.split()[1] if len(raw.split()) > 1 else ""
                if name not in group_ids:
                    group_ids[name] = len(group_ids)
                    g.group_names.append(name)
                current = group_ids[name]
            elif raw.startswith("usemtl"):
                g.events.append(("u", raw.split()[1]))
            elif raw.startswith("mtllib"):
                g.events.append(("m", raw.split()[1]))

    g.v = np.asarray(verts, np.float64) if verts else np.zeros((0, 3))
    g.vt = np.asarray(texs, np.float64) if texs else np.zeros((0, 3))
    g.vn = np.asarray(norms, np.float64) if norms else np.zeros((0, 3))
    nt = len(tri)
    g.tri = (np.asarray(tri, np.int32).reshape(nt, 3, 3) if nt
             else np.zeros((0, 3, 3), np.int32))
    fl = np.asarray(flags, bool) if nt else np.zeros((0, 2), bool)
    g.use_n, g.use_t = fl[:, 0], fl[:, 1]
    g.group = np.asarray(tgroup, np.int32) if nt else np.zeros(0, np.int32)
    g.event = np.asarray(tevent, np.int32) if nt else np.zeros(0, np.int32)
    return g


def load_obj_into(shape, m_world: np.ndarray, tables, csg_id: int,
                  csg_side: int, nodes: List, m_flat: List[float],
                  csg_anc: int = 0, csg_doc: Optional[int] = None,
                  inherited_mat: Optional[int] = None) -> None:
    """Parse shape.file and append a triangle block + divide-sim nodes.

    Geometry scanning runs in the C++ core (native/obj_core.cpp — the
    analog of the reference's native obj_loader.c), or in
    `_scan_obj_python` where that did not build; assembly is vectorized
    numpy.

    csg_doc set = this mesh is a CSG child (src/shapes/csg.c accepts any
    shape): every triangle shares the tree's shadow-walk document leaf,
    carries the (tree, ancestor mask, side mask) tags, and the leafblock
    nodes get per-leaf tags so the filter program can name them."""
    path = _resolve(shape.file, tables.root_dir)
    if path is None:
        raise FileNotFoundError(f"obj not found: {shape.file}")

    # parse-result dedup for repeated `add: obj` of the same file (the
    # reference reuses the first parse via shape_copy,
    # yaml_parser/obj_parser.py:31-32): the raw geometry scan is cached
    # per (path, mtime) and used read-only — transforms/materials are
    # applied per instance below
    ckey = (path, os.path.getmtime(path))
    geo = _GEO_CACHE.get(ckey)
    if geo is None:
        geo = (native.parse_obj(path) if native.available()
               else _scan_obj_python(path))
        _GEO_CACHE[ckey] = geo

    # replay the mtllib/usemtl event stream exactly as the inline scan
    # did: mtllib extends the material dict; usemtl switches only when the
    # name is known at that point (obj_loader.c:413-422)
    mtl_mats: Dict[str, MaterialDesc] = {}
    states: List[Optional[MaterialDesc]] = [None]
    cur_mat: Optional[MaterialDesc] = None
    for typ, arg in geo.events:
        if typ == "m":
            # resolve relative to the scene root (reference CWD
            # semantics), falling back to the OBJ's own directory — the
            # reference resolves mtllib ONLY against its CWD
            # (obj_loader.c:139-213), which leaves e.g.
            # CornellBox-Water.mtl unfindable from any directory the
            # scene itself loads from; the obj-dir fallback is the
            # documented intentional fix
            mp = _mtl_path(arg, tables.root_dir)
            if mp is None:
                mp = _mtl_path(arg, os.path.dirname(path))
            if mp is not None:
                mtl_mats.update(parse_mtl(mp, tables.decode,
                                          tables.root_dir))
        else:
            if arg in mtl_mats:
                cur_mat = mtl_mats[arg]
        states.append(cur_mat)

    yaml_mat_id = (tables.add_material(shape.material)
                   if shape.material is not None else inherited_mat)
    # raw-C default material (material.c:6-31): Ka=Kd=Ks=white, Ns=200
    default_mat_id: Optional[int] = None
    mtl_ids: Dict[int, int] = {}

    def mat_id_for(m: Optional[MaterialDesc]) -> int:
        nonlocal default_mat_id
        if yaml_mat_id is not None:
            return yaml_mat_id           # YAML override wins (recursive set)
        if m is None:
            if default_mat_id is None:
                default_mat_id = tables.add_material(MaterialDesc(
                    Ka=(1.0,) * 3, Kd=(1.0,) * 3, Ks=(1.0,) * 3,
                    Tf=(0.0,) * 3, refl_color=(0.0,) * 3))
            return default_mat_id
        if id(m) not in mtl_ids:
            mtl_ids[id(m)] = tables.add_material(m)
        return mtl_ids[id(m)]

    state_mat_ids = np.asarray([mat_id_for(s) for s in states], np.int64)

    lin = m_world[:3, :3]
    trans = m_world[:3, 3]
    nrm_m = np.linalg.inv(m_world)[:3, :3].T
    va, na, ta = geo.v, geo.vn, geo.vt

    result_node = div.Node(kind="group", transform=list(m_flat))
    nodes.append(result_node)

    nt = geo.tri.shape[0]
    if nt == 0:
        return

    # group-major, file-order-within-group (the reference builds each
    # named group's triangle list then groups them under the result)
    order = np.argsort(geo.group, kind="stable")

    def xform_points(m, p, t=None):
        """Rows of m applied with the scalar op order of `m @ p (+ t)`:
        ((m0*x + m1*y) + m2*z) (+ t)."""
        out = [m[r, 0] * p[:, 0] + m[r, 1] * p[:, 1] + m[r, 2] * p[:, 2]
               for r in range(3)]
        if t is not None:
            out = [out[r] + t[r] for r in range(3)]
        return np.stack(out, axis=1)

    vi = geo.tri[order, :, 0].astype(np.int64) - 1   # (nt, 3)
    ti = geo.tri[order, :, 1].astype(np.int64) - 1
    ni = geo.tri[order, :, 2].astype(np.int64) - 1
    use_n = geo.use_n[order]
    use_t = geo.use_t[order]

    p1o, p2o, p3o = va[vi[:, 0]], va[vi[:, 1]], va[vi[:, 2]]
    p1 = xform_points(lin, p1o, trans)
    p2 = xform_points(lin, p2o, trans)
    p3 = xform_points(lin, p3o, trans)

    # flat normal = normalize(cross(p3o-p1o, p2o-p1o)) (triangle.c:84-91)
    n_obj = np.cross(p3o - p1o, p2o - p1o)
    ln = np.sqrt((n_obj * n_obj).sum(axis=1, keepdims=True))
    n_flat = n_obj / np.where(ln > 0, ln, 1.0)
    nf = xform_points(nrm_m, n_flat)
    un = use_n[:, None]
    if len(na):
        ni_c = np.clip(ni, 0, len(na) - 1)
        n1 = np.where(un, xform_points(nrm_m, na[ni_c[:, 0]]), nf)
        n2 = np.where(un, xform_points(nrm_m, na[ni_c[:, 1]]), nf)
        n3 = np.where(un, xform_points(nrm_m, na[ni_c[:, 2]]), nf)
    else:
        n1 = n2 = n3 = nf

    ut = use_t[:, None]
    if len(ta):
        ti_c = np.clip(ti, 0, len(ta) - 1)
        t1 = np.where(ut, ta[ti_c[:, 0]][:, :2], 0.0)
        t2 = np.where(ut, ta[ti_c[:, 1]][:, :2], 0.0)
        t3 = np.where(ut, ta[ti_c[:, 2]][:, :2], 0.0)
    else:
        t1 = t2 = t3 = np.zeros((nt, 2))

    mat_ids = state_mat_ids[geo.event[order]]
    if csg_doc is None:
        doc_ids = tables.next_leaf + np.arange(nt, dtype=np.int64)
        tables.next_leaf += nt
    else:
        doc_ids = np.full(nt, csg_doc, np.int64)   # one doc per csg tree
    block_index = len(tables.t_blocks)

    tables.t_blocks.append({
        "p1": p1, "e1": p2 - p1, "e2": p3 - p1,
        "n1": n1, "n2": n2, "n3": n3, "t1": t1, "t2": t2, "t3": t3,
        "use_tex": use_t.copy(), "mat": mat_ids,
        # one (tree, side, anc) per block, as Python ints
        "csg": int(csg_id), "side": int(csg_side), "anc": int(csg_anc),
        "doc": doc_ids,
    })

    # object-space leaf boxes for the divide sim: per-axis min/max of the
    # three object-space vertices (leaf_box 'triangle')
    bmin = np.minimum(np.minimum(p1o, p2o), p3o)
    bmax = np.maximum(np.maximum(p1o, p2o), p3o)
    boxes = np.concatenate([bmin, bmax], axis=1)   # (nt, 6)

    grp_sorted = geo.group[order]
    for gid in range(len(geo.group_names)):
        sel = np.nonzero(grp_sorted == gid)[0]
        if len(sel) == 0:
            continue
        gnode = div.Node(kind="group", transform=list(div.IDENTITY))
        result_node.children.append(gnode)
        tags = ([("b", block_index, int(i)) for i in sel]
                if csg_doc is not None else None)
        gnode.children.append(div.Node(
            kind="leafblock", transform=list(div.IDENTITY),
            block_boxes=boxes[sel], block_ids=doc_ids[sel],
            block_tags=tags))
