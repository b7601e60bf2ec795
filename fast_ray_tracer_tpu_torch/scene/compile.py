"""Scene compiler: SceneDesc -> SceneIR tensors.

The numpy table construction of the JAX package's `compile_scene`, for the
scenes the port renders: the six analytic shapes under any nesting of
groups and CSG trees, triangles and smooth triangles, OBJ meshes
(scene/obj_loader.py), large meshes Morton-ordered into 64-triangle
clusters (never those inside a CSG tree), materials, procedural patterns
and uv maps with their children, texture images (PPM and PNG, other
formats through Pillow; read once per path into a flat atlas), and
point, area, circle and hemisphere lights, the deterministic sample
points of area and circle lights computed on the host in float64. Transform chains are
composed and inverted on the host, group hierarchies dissolve into
per-leaf world->object inverses, triangles are pre-transformed to world
space, and the post-divide shadow-walk rank of every leaf is recovered by
simulating the reference's BVH build (scene/divide.py, through its C++
copy in native/). Each CSG tree becomes one shadow-walk leaf, its leaves
tagged with (tree, ancestor mask, side mask) and the tree with a
postorder filter program (`_csg_prog`). The tables are byte-identical to
the JAX package's; only the final wrap differs:
`SceneIR(...).to(device, dtype)`.

Input colors decode through `colors.INPUT_DECODE` in float64. A texture
in another format than PPM or PNG, with no PNG beside it, raises
ValueError (the JAX package converts it through Pillow).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.colors import INPUT_DECODE, identity
from fast_ray_tracer_tpu_torch.io.ppm import read_image, read_png, read_ppm
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene import divide as div
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import (
    SceneIR, SceneMeta, default_device,
)
from fast_ray_tracer_tpu_torch.scene.obj_loader import _resolve, load_obj_into
from fast_ray_tracer_tpu_torch.scene.model import (
    MaterialDesc, PatternDesc, SceneDesc, ShapeDesc,
)

_KIND_TO_TYPE = {
    "sphere": IR.SPHERE, "plane": IR.PLANE, "cube": IR.CUBE,
    "cylinder": IR.CYLINDER, "cone": IR.CONE, "toroid": IR.TOROID,
}

_PAT_KIND = {
    "checker": IR.PAT_CHECKER, "gradient": IR.PAT_GRADIENT,
    "radial_gradient": IR.PAT_RADIAL_GRADIENT, "ring": IR.PAT_RING,
    "stripe": IR.PAT_STRIPE, "blended": IR.PAT_BLENDED,
    "nested": IR.PAT_NESTED, "perturbed": IR.PAT_PERTURBED,
    "map": IR.PAT_MAP, "uv_checker": IR.PAT_UV_CHECKER,
    "uv_align_check": IR.PAT_UV_ALIGN_CHECK, "uv_image": IR.PAT_UV_TEXTURE,
    "uv_gradient": IR.PAT_UV_GRADIENT,
    "uv_radial_gradient": IR.PAT_UV_RADIAL_GRADIENT,
}

_LIGHT_KIND = {
    "point": IR.LIGHT_POINT, "area": IR.LIGHT_AREA,
    "circle": IR.LIGHT_CIRCLE, "hemisphere": IR.LIGHT_HEMISPHERE,
}

_MAP_KIND = {
    "cube": IR.MAP_CUBE, "cylinder": IR.MAP_CYLINDER, "plane": IR.MAP_PLANE,
    "sphere": IR.MAP_SPHERE, "toroid": IR.MAP_TOROID,
    "triangle": IR.MAP_TRIANGLE,
}


def transform_matrix(item) -> np.ndarray:
    """One YAML transform entry -> 4x4 (host float64)."""
    op = item[0]
    m = np.eye(4)
    if op == "translate":
        m[:3, 3] = item[1:4]
    elif op == "scale":
        m[0, 0], m[1, 1], m[2, 2] = item[1:4]
    elif op == "rotate-x":
        c, s = math.cos(item[1]), math.sin(item[1])
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif op == "rotate-y":
        c, s = math.cos(item[1]), math.sin(item[1])
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    elif op == "rotate-z":
        c, s = math.cos(item[1]), math.sin(item[1])
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    elif op == "shear":
        (m[0, 1], m[0, 2], m[1, 0], m[1, 2], m[2, 0], m[2, 1]) = item[1:7]
    else:
        raise ValueError(f"Unknown transform: {op}")
    return m


def compose_chain(chain) -> np.ndarray:
    """YAML transform list -> matrix; later entries apply last
    (reference transform_chain semantics, yaml_parser/transform.py:26-40)."""
    m = np.eye(4)
    for item in chain or []:
        m = transform_matrix(item) @ m
    return m


class _Tables:
    """Mutable accumulators during the compile walk."""

    def __init__(self, decode, root_dir):
        self.decode = decode           # input color decode fn (numpy)
        self.root_dir = root_dir       # base dir of relative OBJ paths
        self.a_type: List[int] = []
        self.a_inv: List[np.ndarray] = []
        self.a_params: List[List[float]] = []
        self.a_mat: List[int] = []
        self.a_csg: List[Tuple[int, int, int]] = []   # (tree, anc, side)
        self.a_doc: List[int] = []        # document-order leaf id per prim
        # triangles: per-triangle rows (`triangle` shapes) of
        # (p1, e1, e2, n1, n2, n3, t1, t2, t3, use_tex, mat, csg tree,
        # side, anc), and bulk blocks of column arrays (OBJ meshes,
        # scene/obj_loader.py)
        self.t_rows: List[Tuple] = []
        self.t_doc: List[int] = []
        self.t_blocks: List[dict] = []
        self.next_leaf = 0
        # csg trees: internal nodes (nid, depth, op), the pre-divide
        # simulation subtree and nid -> op, per tree
        self.csg_trees: List[Tuple] = []
        self.csg_div_roots: List[div.Node] = []
        self.csg_node_ops: List[Dict[int, int]] = []
        self.m_rows: List[dict] = []
        self.p_rows: List[dict] = []
        self.tex_imgs: List[np.ndarray] = []
        self.tex_by_file: Dict[str, int] = {}

    def texture_id(self, file: str, decode_to_linear: bool) -> int:
        """Load a texture once per path; as the reference dedups its
        resources, the first use's decode choice sticks
        (yaml_parser/pattern.py:262-282). Paths resolve against the scene
        root; a file in another format reads the PNG beside it, as the
        reference's converted copy (yaml_parser/pattern.py:255-261), and
        without one the file itself through Pillow (`read_image`)."""
        if file in self.tex_by_file:
            return self.tex_by_file[file]
        lookup = file
        if not file.endswith((".png", ".ppm")):
            lookup = file[:-3] + "png"
        path = _resolve(lookup, self.root_dir)
        read = read_ppm if lookup.endswith(".ppm") else read_png
        if path is None and lookup != file:
            path = _resolve(file, self.root_dir)
            read = read_image
        if path is None:
            raise FileNotFoundError(f"texture not found: {file}")
        decode = self.decode if decode_to_linear else None
        self.tex_imgs.append(np.asarray(read(path, decode=decode),
                                        dtype=np.float64))
        self.tex_by_file[file] = len(self.tex_imgs) - 1
        return self.tex_by_file[file]

    def add_pattern(self, p: Optional[PatternDesc]) -> int:
        if p is None:
            return -1
        row = {
            "type": _PAT_KIND[p.kind],
            "inv": np.linalg.inv(compose_chain(p.transform)),
            "colors": np.zeros((5, 3)),
            "params": np.zeros(6),
            "children": -np.ones(6, dtype=np.int64),
            "map_kind": 0,
            "tex": -1,
        }
        if p.kind in ("checker", "gradient", "radial_gradient", "ring",
                      "stripe", "uv_checker", "uv_align_check",
                      "uv_gradient", "uv_radial_gradient"):
            cs = np.asarray(self.decode(np.asarray(p.colors,
                                                   dtype=np.float64)))
            row["colors"][: len(p.colors)] = cs
            if p.kind == "uv_checker":
                row["params"][0] = p.width
                row["params"][1] = p.height
        elif p.kind == "uv_image":
            row["tex"] = self.texture_id(p.file, p.decode_to_linear)
        elif p.kind in ("blended", "nested", "perturbed"):
            kids = [self.add_pattern(c) for c in p.children]
            row["children"][: len(kids)] = kids
            if p.kind == "perturbed":
                row["params"][:5] = [p.frequency, p.scale_factor,
                                     p.persistence, p.octaves, p.seed]
        elif p.kind == "map":
            row["map_kind"] = _MAP_KIND[p.mapping]
            faces = [self.add_pattern(f) for f in p.faces]
            row["children"][: len(faces)] = faces
        self.p_rows.append(row)
        return len(self.p_rows) - 1

    def add_material(self, m: Optional[MaterialDesc]) -> int:
        if m is None:
            m = MaterialDesc()
        base = np.asarray(self.decode(np.asarray(m.color, dtype=np.float64)))
        row = {
            # explicit MTL-style overrides win over legacy fields
            "Ka": np.asarray(m.Ka) if m.Ka is not None else base * m.ambient,
            "Kd": np.asarray(m.Kd) if m.Kd is not None else base * m.diffuse,
            "Ks": np.asarray(m.Ks) if m.Ks is not None else base * m.specular,
            "Tf": (np.asarray(m.Tf) if m.Tf is not None
                   else np.full(3, m.transparency)),
            "refl": (np.asarray(m.refl_color) if m.refl_color is not None
                     else np.full(3, m.reflective)),
            "Ns": m.shininess,
            "Ni": m.refractive_index,
            "Tr": m.transparency,
            "casts_shadow": bool(m.casts_shadow),
            "map": [-1] * 8,
        }
        row["reflective"] = bool((row["refl"] > 0.0).any())
        for i, slot in enumerate(IR.MAP_SLOTS):
            if slot in m.patterns:
                row["map"][i] = self.add_pattern(m.patterns[slot])
        self.m_rows.append(row)
        return len(self.m_rows) - 1


def _walk(shape: ShapeDesc, parent_m: np.ndarray, tables: _Tables,
          inherited_mat: Optional[int], nodes: List[div.Node],
          csg_id: int = -1, csg_side: int = 0) -> None:
    """Dissolve the shape tree into flat leaf rows. `nodes` is the parent's
    children list in the divide-simulation tree (local transforms only),
    used to recover the post-divide shadow-walk leaf ordering."""
    m_local = compose_chain(shape.transform)
    m_world = parent_m @ m_local
    m_flat = m_local.ravel().tolist()

    if shape.kind == "group":
        node = div.Node(kind="group", transform=m_flat)
        nodes.append(node)
        for child in shape.children:
            _walk(child, m_world, tables, inherited_mat, node.children,
                  csg_id, csg_side)
        return
    if shape.kind == "csg":
        # one csg tree = ONE shadow-walk leaf; leaf prims carry the tree id
        # and their root-to-leaf path bits for the truth-table filter
        tree_id = len(tables.csg_trees)
        tree_nodes: List[Tuple[int, int, int]] = []
        doc = tables.next_leaf
        tables.next_leaf += 1
        node = _walk_csg_child(shape, parent_m, tables, tree_id, 0, 0,
                               [0], 0, inherited_mat, tree_nodes, doc)
        nodes.append(node)
        tables.csg_trees.append(tuple(tree_nodes))
        tables.csg_div_roots.append(node)
        tables.csg_node_ops.append({nid: op for nid, _, op in tree_nodes})
        return
    if shape.kind == "obj":
        load_obj_into(shape, m_world, tables, csg_id, csg_side, nodes, m_flat)
        return
    doc = tables.next_leaf
    tables.next_leaf += 1
    nodes.append(_add_leaf(shape, m_world, m_flat, tables, csg_id, 0,
                           csg_side, inherited_mat, doc))


def _add_leaf(shape: ShapeDesc, m_world: np.ndarray, m_flat: List[float],
              tables: _Tables, tree_id: int, anc: int, side: int,
              inherited_mat: Optional[int], doc: int) -> div.Node:
    """Append one primitive or triangle row (document leaf `doc`, csg tags
    (tree_id, anc, side)) and return its divide-simulation leaf, tagged
    with its row ('a' analytic / 't' triangle: the leaf tags of the csg
    filter programs)."""
    if shape.kind not in _KIND_TO_TYPE and shape.kind not in (
            "triangle", "smooth_triangle"):
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    mat_id = (tables.add_material(shape.material)
              if shape.material is not None else
              (inherited_mat if inherited_mat is not None
               else tables.add_material(None)))

    if shape.kind in ("triangle", "smooth_triangle"):
        lin = m_world[:3, :3]
        nrm_m = np.linalg.inv(m_world)[:3, :3].T
        p1 = lin @ shape.p1 + m_world[:3, 3]
        p2 = lin @ shape.p2 + m_world[:3, 3]
        p3 = lin @ shape.p3 + m_world[:3, 3]
        if shape.kind == "triangle":
            # flat normal = normalize(cross(e2, e1)) in object space
            # (src/shapes/triangle.c:84-91), mapped through inv^T
            e1o = np.asarray(shape.p2) - np.asarray(shape.p1)
            e2o = np.asarray(shape.p3) - np.asarray(shape.p1)
            n_obj = np.cross(e2o, e1o)
            n_obj = n_obj / np.linalg.norm(n_obj)
            n1 = n2 = n3 = nrm_m @ n_obj
        else:
            n1 = nrm_m @ shape.n1
            n2 = nrm_m @ shape.n2
            n3 = nrm_m @ shape.n3
        use_tex = shape.t1 is not None
        t1 = shape.t1[:2] if use_tex else (0.0, 0.0)
        t2 = shape.t2[:2] if use_tex else (0.0, 0.0)
        t3 = shape.t3[:2] if use_tex else (0.0, 0.0)
        tables.t_rows.append((p1, p2 - p1, p3 - p1, n1, n2, n3,
                              t1, t2, t3, use_tex, mat_id, tree_id, side,
                              anc))
        tables.t_doc.append(doc)
        return div.Node(
            kind="triangle", transform=m_flat, leaf_id=doc,
            tag=("t", len(tables.t_rows) - 1),
            obj_box=div.leaf_box("triangle",
                                 points=[shape.p1, shape.p2, shape.p3]))
    params = [0.0, 0.0, 0.0, 0.0]
    if shape.kind in ("cylinder", "cone"):
        params = [shape.minimum, shape.maximum,
                  1.0 if shape.closed else 0.0, 0.0]
    elif shape.kind == "toroid":
        params = [shape.r1, shape.r2, 0.0, 0.0]
    tables.a_type.append(_KIND_TO_TYPE[shape.kind])
    tables.a_inv.append(np.linalg.inv(m_world))
    tables.a_params.append(params)
    tables.a_mat.append(mat_id)
    tables.a_csg.append((tree_id, anc, side))
    tables.a_doc.append(doc)
    return div.Node(
        kind=shape.kind, transform=m_flat, leaf_id=doc,
        tag=("a", len(tables.a_csg) - 1),
        obj_box=div.leaf_box(shape.kind, minimum=shape.minimum,
                             maximum=shape.maximum, r1=shape.r1, r2=shape.r2))


_CSG_OPS = {"union": 0, "intersection": 1, "difference": 2}


def _walk_csg_child(sub: ShapeDesc, parent_m: np.ndarray, tables: _Tables,
                    tree_id: int, anc: int, side: int, nid_alloc: List[int],
                    depth: int, inherited_mat: Optional[int],
                    tree_nodes: List, doc: int) -> div.Node:
    """Walk a node of a csg tree. Internal csg nodes get unique ids from
    `nid_alloc`; leaves are tagged (tree_id, ancestor bitmask, side
    bitmask: bit nid set = right child of node nid), so sibling subtrees
    under a group child stay distinct (the reference filters each nested
    csg's own hits before the group merge — csg_local_intersect,
    src/shapes/csg.c:73-125). All leaves share ONE document leaf id `doc`
    (the whole tree is a single shadow-walk leaf)."""
    m_local = compose_chain(sub.transform)
    m_world = parent_m @ m_local
    m_flat = m_local.ravel().tolist()

    if sub.kind == "csg":
        # node ids are unbounded: the masks are Python ints end to end
        # (csg_static_tables resolves them to static bool tables)
        nid = nid_alloc[0]
        nid_alloc[0] += 1
        tree_nodes.append((nid, depth, _CSG_OPS[sub.op]))
        mat = (tables.add_material(sub.material)
               if sub.material is not None else inherited_mat)
        node = div.Node(kind="csg", transform=m_flat, leaf_id=doc, tag=nid)
        node.left = _walk_csg_child(sub.left, m_world, tables, tree_id,
                                    anc | (1 << nid), side, nid_alloc,
                                    depth + 1, mat, tree_nodes, doc)
        node.right = _walk_csg_child(sub.right, m_world, tables, tree_id,
                                     anc | (1 << nid), side | (1 << nid),
                                     nid_alloc, depth + 1, mat, tree_nodes,
                                     doc)
        return node

    if sub.kind == "group":
        node = div.Node(kind="group", transform=m_flat, leaf_id=doc)
        for child in sub.children:
            node.children.append(_walk_csg_child(
                child, m_world, tables, tree_id, anc, side, nid_alloc,
                depth, inherited_mat, tree_nodes, doc))
        return node

    if sub.kind == "obj":
        # the reference's csg() takes any shape, OBJ groups too
        # (src/shapes/csg.c:166-206): the mesh's triangles become leaves of
        # this tree. The csg filter runs over dense candidate slots, so
        # compile_scene keeps csg meshes unclustered.
        tmp: List[div.Node] = []
        load_obj_into(sub, m_world, tables, tree_id, side, tmp, m_flat,
                      csg_anc=anc, csg_doc=doc, inherited_mat=inherited_mat)
        node = tmp[0]
        node.leaf_id = doc
        return node

    return _add_leaf(sub, m_world, m_flat, tables, tree_id, anc, side,
                     inherited_mat, doc)


def _leaf_tags(node: div.Node, out: List) -> None:
    """Collect leaf tags: ('a', analytic row), ('t', triangle row) or
    ('b', block, local) — resolved to final global prim ids at the end of
    compile_scene (analytic rows are type-sorted; triangle and block rows
    follow the analytic block)."""
    if node.kind == "csg":
        _leaf_tags(node.left, out)
        _leaf_tags(node.right, out)
    elif node.kind == "group":
        for c in node.children:
            _leaf_tags(c, out)
    elif node.kind == "leafblock":
        out.extend(node.block_tags)
    else:
        out.append(node.tag)


def _csg_prog(root: div.Node, nid_ops: Dict[int, int], threshold: int):
    """Post-divide filter program for one csg tree, POSTORDER entries

      ("c", nid, op)   - truth-table filter at csg node `nid`
      ("g", branches)  - shadow-ray truncation point: `branches` is a
                         tuple of per-child-subtree leaf-tag tuples in
                         post-divide child order. With stop_after_first_hit
                         the reference's group walk stops after the first
                         child subtree that returned a t > 0 hit
                         (src/shapes/group.c:104-123), so later branches
                         contribute nothing to the csg filter on shadow
                         rays (and everything on primary rays).

    The divide pass reorders and nests groups inside the tree as the
    reference does (csg_divide recurses into children,
    src/shapes/csg.c:141-146), so the truncation points match its
    post-divide tree."""
    node = copy.deepcopy(root)
    div.expand_leafblocks(node)     # csg obj meshes: per-triangle leaves
    div.divide(node, threshold)
    prog: List[Tuple] = []

    def walk(n: div.Node):
        if n.kind == "csg":
            walk(n.left)
            walk(n.right)
            prog.append(("c", n.tag, nid_ops[n.tag]))
        elif n.kind == "group":
            branches = []
            for c in n.children:
                walk(c)
                tags: List = []
                _leaf_tags(c, tags)
                branches.append(tuple(tags))
            prog.append(("g", tuple(branches)))

    walk(node)
    return tuple(prog)


def compile_scene(scene: SceneDesc, dtype=torch.float32,
                  device=None) -> SceneIR:
    """The scene's tables on `device` (default: the CUDA card), float
    tables in `dtype`."""
    device = default_device(device)
    decode = _np_decode(scene.config.color_space)
    tables = _Tables(decode, scene.root_dir)

    root = div.Node(kind="group", transform=list(div.IDENTITY))
    for shape in scene.world:
        _walk(shape, np.eye(4), tables, inherited_mat=None,
              nodes=root.children)

    # csg filter programs from the pre-divide tree copies
    csg_progs = [_csg_prog(r, ops, scene.config.divide_threshold)
                 for r, ops in zip(tables.csg_div_roots, tables.csg_node_ops)]

    # post-divide DFS leaf order -> shadow-walk rank per document leaf
    doc_rank = np.asarray(
        div.shadow_ranks(root, scene.config.divide_threshold,
                         tables.next_leaf),
        dtype=np.int64) if tables.next_leaf else np.zeros(0, np.int64)

    # ---- analytic block, grouped by type ----
    n_analytic = len(tables.a_type)
    if n_analytic:
        order = np.argsort(np.asarray(tables.a_type, dtype=np.int64),
                           kind="stable")
        a_type = np.asarray(tables.a_type, dtype=np.int64)[order]
        inv = np.stack(tables.a_inv)[order]
        params = np.asarray(tables.a_params)[order]
        a_mat = np.asarray(tables.a_mat, dtype=np.int64)[order]
        a_rank = doc_rank[np.asarray(tables.a_doc, dtype=np.int64)][order]
    else:
        order = np.zeros(0, np.int64)
        a_type = np.zeros(0, np.int64)
        inv = np.zeros((0, 4, 4))
        params = np.zeros((0, 4))
        a_mat = np.zeros(0, np.int64)
        a_rank = np.zeros(0, np.int64)

    type_ranges = []
    for t in range(6):
        idx = np.nonzero(a_type == t)[0]
        if len(idx):
            type_ranges.append((t, int(idx[0]), int(len(idx))))

    # csg tags stay Python ints (arbitrary-precision masks; no node cap)
    a_csg = [tables.a_csg[int(i)] for i in order]
    tri = _triangle_block(tables, doc_rank)
    nt = len(tri["p1"])
    if csg_progs:
        csg_progs = _resolve_csg_tags(csg_progs, order, len(tables.t_rows),
                                      tables.t_blocks)

    # ---- materials ----
    if not tables.m_rows:
        tables.add_material(None)
    M = len(tables.m_rows)
    mat = {k: np.stack([np.asarray(r[k], dtype=np.float64)
                        for r in tables.m_rows])
           for k in ("Ka", "Kd", "Ks", "Tf", "refl")}
    mat_Ns = np.asarray([r["Ns"] for r in tables.m_rows])
    mat_Ni = np.asarray([r["Ni"] for r in tables.m_rows])
    mat_Tr = np.asarray([r["Tr"] for r in tables.m_rows])
    mat_reflective = np.asarray([r["reflective"] for r in tables.m_rows], bool)
    mat_shadow = np.asarray([r["casts_shadow"] for r in tables.m_rows], bool)
    mat_map = np.asarray([r["map"] for r in tables.m_rows], dtype=np.int64)

    # ---- patterns ----
    P = len(tables.p_rows)
    if P:
        pat_type = np.asarray([r["type"] for r in tables.p_rows], np.int64)
        pat_inv = np.stack([r["inv"] for r in tables.p_rows])
        pat_colors = np.stack([r["colors"] for r in tables.p_rows])
        pat_params = np.stack([r["params"] for r in tables.p_rows])
        pat_children = np.stack([r["children"] for r in tables.p_rows])
        pat_map_kind = np.asarray([r["map_kind"] for r in tables.p_rows],
                                  np.int64)
        pat_tex = np.asarray([r["tex"] for r in tables.p_rows], np.int64)
    else:
        pat_type = np.zeros(0, np.int64)
        pat_inv = np.zeros((0, 4, 4))
        pat_colors = np.zeros((0, 5, 3))
        pat_params = np.zeros((0, 6))
        pat_children = np.zeros((0, 6), np.int64)
        pat_map_kind = np.zeros(0, np.int64)
        pat_tex = np.zeros(0, np.int64)

    # ---- texture atlas: every image's texels, row-major, one flat table
    if tables.tex_imgs:
        tex_data = np.concatenate([i.reshape(-1, 3) for i in tables.tex_imgs])
        sizes = np.asarray([i.shape[0] * i.shape[1] for i in tables.tex_imgs])
        tex_offset = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        tex_width = np.asarray([i.shape[1] for i in tables.tex_imgs])
        tex_height = np.asarray([i.shape[0] for i in tables.tex_imgs])
    else:
        # no textures: the JAX package's one-texel placeholder atlas
        tex_data = np.zeros((1, 3))
        tex_offset, tex_width, tex_height = np.zeros(1), np.ones(1), np.ones(1)

    # ---- lights ----
    L = len(scene.lights)
    light_info = []
    li_int = np.zeros((L, 3))
    li_pos = np.zeros((L, 3))
    li_uvec = np.zeros((L, 3))
    li_vvec = np.zeros((L, 3))
    li_normal = np.zeros((L, 3))
    li_radius = np.zeros(L)
    pts_list = []
    for i, ld in enumerate(scene.lights):
        num = ld.usteps * ld.vsteps if ld.kind in ("area", "circle") else 1
        light_info.append((_LIGHT_KIND[ld.kind], ld.usteps, ld.vsteps,
                           bool(ld.jitter), num))
        li_int[i] = ld.intensity
        if ld.kind in ("point", "hemisphere"):
            li_pos[i] = ld.at
            pts_list.append(np.asarray(ld.at, dtype=np.float64)[None])
            if ld.kind == "hemisphere":
                n = np.asarray(ld.to) - np.asarray(ld.at)
                li_normal[i] = n / np.linalg.norm(n)
        elif ld.kind == "area":
            # the stored edges are the full edge / steps (light.c:303-309)
            li_pos[i] = ld.corner
            li_uvec[i] = np.asarray(ld.uvec) / ld.usteps
            li_vvec[i] = np.asarray(ld.vvec) / ld.vsteps
            pts_list.append(_area_light_points(
                np.asarray(ld.corner), li_uvec[i], li_vvec[i],
                ld.usteps, ld.vsteps))
        elif ld.kind == "circle":
            li_pos[i] = ld.at
            n = np.asarray(ld.to) - np.asarray(ld.at)
            li_normal[i] = n / np.linalg.norm(n)
            li_radius[i] = ld.radius
            pts_list.append(_circle_light_points(
                np.asarray(ld.at), li_normal[i], ld.radius,
                ld.usteps, ld.vsteps))
    s_max = max([len(p) for p in pts_list], default=1)
    li_points = np.zeros((L, s_max, 3))
    li_mask = np.zeros((L, s_max), bool)
    for i, p in enumerate(pts_list):
        li_points[i, : len(p)] = p
        li_mask[i, : len(p)] = True

    cfg = scene.config
    has_refl = bool(mat_reflective.any()) and cfg.include_specular
    has_refr = bool((mat_Tr > 0).any() or (mat_map[:, IR.SLOT_D] >= 0).any()) \
        and cfg.include_specular
    # the containers walk only matters when some Ni != 1 (renderer.c:406-447)
    needs_sort = has_refr and bool((np.abs(mat_Ni - 1.0) > 1e-12).any())
    n_hit_slots = int(sum(IR.TYPE_MAX_HITS[t] * c
                          for t, _, c in type_ranges)) + nt

    # static pattern structure for evaluator pruning
    combinators = {IR.PAT_BLENDED, IR.PAT_NESTED, IR.PAT_PERTURBED}

    def _depth(pid):
        row = tables.p_rows[pid]
        if row["type"] not in combinators:
            return 0
        kids = [k for k in row["children"] if k >= 0]
        return 1 + max((_depth(int(k)) for k in kids), default=0)

    meta = SceneMeta(
        n_analytic=n_analytic, n_triangles=nt, n_materials=M, n_patterns=P,
        n_lights=L, type_ranges=tuple(type_ranges),
        light_info=tuple(light_info), max_light_samples=s_max,
        has_reflective=has_refl, has_refractive=has_refr,
        needs_hit_sort=needs_sort,
        use_clusters=tri["use_clusters"], n_clusters=tri["n_clusters"],
        cluster_size=CLUSTER_SIZE,
        # the containers walk needs every intersection (negative t
        # included), so only huge scenes are capped
        max_hits=min(64, max(2, n_hit_slots)),
        any_patterns=bool((mat_map >= 0).any()),
        any_bump=bool((mat_map[:, IR.SLOT_BUMP] >= 0).any()),
        pattern_slots=tuple(int(s) for s in range(mat_map.shape[1])
                            if bool((mat_map[:, s] >= 0).any())),
        pattern_kinds=tuple(sorted({int(t) for t in pat_type})),
        map_kinds=tuple(sorted({int(r["map_kind"]) for r in tables.p_rows
                                if r["type"] == IR.PAT_MAP})),
        pattern_depth=max((_depth(i) for i in range(P)
                           if tables.p_rows[i]["type"] in combinators),
                          default=0),
        max_perlin_octaves=int(max((r["params"][3] for r in tables.p_rows
                                    if r["type"] == IR.PAT_PERTURBED),
                                   default=0)),
        csg_trees=tuple(csg_progs), has_csg=bool(tables.csg_trees),
        csg_prim_leaf=tuple(c[0] for c in a_csg) + tri["csg"],
        csg_prim_anc=tuple(c[1] for c in a_csg) + tri["anc"],
        csg_prim_side=tuple(c[2] for c in a_csg) + tri["side"],
    )

    f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    i64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64))
    b = lambda x: torch.as_tensor(np.asarray(x, dtype=bool))
    return SceneIR(
        meta=meta,
        inv_tf=f(inv), prim_params=f(params), material_id=i64(a_mat),
        prim_shadow_rank=i64(np.concatenate([a_rank, tri["rank"]])),
        **{f"tri_{k}": f(tri[k]) for k in ("p1", "e1", "e2", "n1", "n2",
                                            "n3", "t1", "t2", "t3")},
        tri_use_tex=b(tri["use_tex"]), tri_material_id=i64(tri["mat"]),
        cluster_min=f(tri["cluster_min"]), cluster_max=f(tri["cluster_max"]),
        mat_Ka=f(mat["Ka"]), mat_Kd=f(mat["Kd"]), mat_Ks=f(mat["Ks"]),
        mat_Tf=f(mat["Tf"]), mat_refl=f(mat["refl"]),
        mat_Ns=f(mat_Ns), mat_Ni=f(mat_Ni), mat_Tr=f(mat_Tr),
        mat_reflective=b(mat_reflective),
        mat_casts_shadow=b(mat_shadow), mat_map=i64(mat_map),
        pat_type=i64(pat_type), pat_inv_tf=f(pat_inv),
        pat_colors=f(pat_colors), pat_params=f(pat_params),
        pat_children=i64(pat_children), pat_map_kind=i64(pat_map_kind),
        pat_tex=i64(pat_tex),
        tex_data=f(tex_data), tex_offset=i64(tex_offset),
        tex_width=i64(tex_width), tex_height=i64(tex_height),
        light_intensity=f(li_int), light_pos=f(li_pos),
        light_uvec=f(li_uvec), light_vvec=f(li_vvec),
        light_normal=f(li_normal), light_radius=f(li_radius),
        light_points=f(li_points), light_mask=b(li_mask),
    ).to(device, dtype)


CLUSTER_SIZE = 64
CLUSTER_MIN_TRIANGLES = 2048


def _triangle_block(tables: _Tables, doc_rank: np.ndarray) -> dict:
    """The triangle columns: per-row triangles first, then each OBJ block,
    with each triangle's shadow-walk rank. Meshes of 2048 triangles or
    more are Morton-ordered by centroid and grouped into 64-triangle
    clusters with AABBs (the tail padded with degenerate triangles at
    p1 = inf, rank 1 << 30); the clustered queries stream them instead of
    materialising a (rays x triangles) table. The reference gets the same
    effect from its per-ray BVH walk (group.c:91-147)."""
    cols = ("p1", "e1", "e2", "n1", "n2", "n3", "t1", "t2", "t3")
    width = (3,) * 6 + (2,) * 3
    out = {}
    for i, (k, w) in enumerate(zip(cols, width)):
        rows = (np.asarray([np.asarray(r[i], dtype=np.float64)
                            for r in tables.t_rows])
                if tables.t_rows else np.zeros((0, w)))
        out[k] = np.concatenate([rows] + [b[k] for b in tables.t_blocks])
    out["use_tex"] = np.concatenate(
        [np.asarray([r[9] for r in tables.t_rows], dtype=bool)]
        + [b["use_tex"] for b in tables.t_blocks])
    out["mat"] = np.concatenate(
        [np.asarray([r[10] for r in tables.t_rows], dtype=np.int64)]
        + [b["mat"] for b in tables.t_blocks])
    doc = np.concatenate([np.asarray(tables.t_doc, dtype=np.int64)]
                         + [b["doc"] for b in tables.t_blocks])
    nt = len(out["p1"])
    out["rank"] = doc_rank[doc] if nt else np.zeros(0, np.int64)
    # per-triangle csg tags as Python ints (a block shares one tag set)
    tags = {k: [r[i] for r in tables.t_rows]
            for k, i in (("csg", 11), ("side", 12), ("anc", 13))}
    for b in tables.t_blocks:
        for k in tags:
            tags[k].extend([b[k]] * len(b["p1"]))

    # csg triangle leaves need dense candidate slots (the csg filter and
    # the containers walk run over the dense table), so meshes inside csg
    # trees stay unclustered whatever their size
    out["use_clusters"] = (nt >= CLUSTER_MIN_TRIANGLES
                           and all(c < 0 for c in tags["csg"]))
    if nt >= 8192 and not out["use_clusters"]:
        print(f"warning: {nt} triangles stay UNCLUSTERED because an OBJ "
              "mesh is a CSG child; dense candidate tables scale "
              "O(rays*triangles)", flush=True)
    pad = (-nt) % CLUSTER_SIZE if out["use_clusters"] else 0
    out["csg"] = tuple(tags["csg"]) + (-1,) * pad
    out["side"] = tuple(tags["side"]) + (0,) * pad
    out["anc"] = tuple(tags["anc"]) + (0,) * pad
    if not out["use_clusters"]:
        out["n_clusters"] = 0
        out["cluster_min"] = np.zeros((1, 3))
        out["cluster_max"] = np.zeros((1, 3))
        return out
    order = _morton_order(out["p1"] + (out["e1"] + out["e2"]) / 3.0)
    for k in cols + ("use_tex", "mat", "rank"):
        out[k] = out[k][order]
    if pad:
        fill = {"p1": np.inf, "rank": 1 << 30}
        for k in cols + ("use_tex", "mat", "rank"):
            a = out[k]
            out[k] = np.concatenate([a, np.full((pad,) + a.shape[1:],
                                                fill.get(k, 0), a.dtype)])
    nc = (nt + pad) // CLUSTER_SIZE
    verts = np.stack([out["p1"], out["p1"] + out["e1"],
                      out["p1"] + out["e2"]], 1)
    with np.errstate(invalid="ignore"):
        vc = verts.reshape(nc, CLUSTER_SIZE * 3, 3)
        finite = np.isfinite(vc).all(-1, keepdims=True)
        out["cluster_min"] = np.where(finite, vc, np.inf).min(axis=1)
        out["cluster_max"] = np.where(finite, vc, -np.inf).max(axis=1)
    out["n_clusters"] = nc
    return out


def _resolve_csg_tags(csg_progs, order: np.ndarray, n_rows: int,
                      t_blocks: List[dict]):
    """The programs' leaf tags as final global prim ids: analytic rows went
    through the type sort; triangle rows follow the analytic block
    (per-row triangles first, then each OBJ block)."""
    inv_order = np.empty(len(order), np.int64)
    inv_order[order] = np.arange(len(order))
    block_base = [n_rows]
    for b in t_blocks:
        block_base.append(block_base[-1] + len(b["p1"]))
    na = len(order)

    def resolve(tag):
        if tag[0] == "a":
            return int(inv_order[tag[1]])
        if tag[0] == "t":
            return na + tag[1]
        return na + block_base[tag[1]] + tag[2]      # ("b", block, i)

    return [tuple(e if e[0] == "c" else
                  ("g", tuple(tuple(resolve(t) for t in br) for br in e[1]))
                  for e in prog)
            for prog in csg_progs]


def _morton_order(centroid: np.ndarray) -> np.ndarray:
    """Sort order by 30-bit Morton code of quantized centroids — spatially
    coherent clusters for AABB culling."""
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    q = ((centroid - lo) / np.where(hi - lo > 0, hi - lo, 1.0)
         * 1023.0).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _np_decode(color_space: str):
    """Input color decode on host numpy, float64 (colors.INPUT_DECODE)."""
    return INPUT_DECODE.get(color_space, identity)


def _area_light_points(corner, uvec, vvec, usteps, vsteps):
    """Deterministic area-light samples (light.c:154-191, jitter off): the
    CMJ point scaled by (usteps, vsteps), then corner + u*uvec + v*vvec."""
    pts = cmj_points_static(usteps, vsteps)   # (S, 2), get_point order
    u = pts[:, 0] * usteps
    v = pts[:, 1] * vsteps
    return corner[None] + u[:, None] * uvec[None] + v[:, None] * vvec[None]


def _circle_light_points(origin, normal, radius, usteps, vsteps):
    """Deterministic circle-light samples (light.c:100-135): the CMJ
    point as a uniform disc sample in the plane normal to `normal`."""
    pts = cmj_points_static(usteps, vsteps)
    return origin[None] + _points_on_circle(pts, normal, radius)


def _points_on_circle(pts, normal, radius):
    """sampler_circle (sampler.c:8-20, 116-139): theta = 2 pi r1,
    r = sqrt(r2) R, the point (r cos, 0, r sin) mapped as x nb + z nt."""
    theta = 2.0 * math.pi * pts[:, 0]
    r = radius * np.sqrt(pts[:, 1])
    nt, nb = _coordinate_system(normal)
    return (r * np.cos(theta))[:, None] * nb[None] \
        + (r * np.sin(theta))[:, None] * nt[None]


def _coordinate_system(n):
    """create_coordinate_system (sampler.c:66-85): the C code multiplies by
    the sqrt factor and then normalizes (the scale cancels), and negates
    nt; nb = cross(n, nt)."""
    if abs(n[0]) > abs(n[1]):
        nt = -np.asarray([n[2], 0.0, -n[0]]) / math.sqrt(n[0] ** 2 + n[2] ** 2)
    else:
        nt = -np.asarray([0.0, -n[2], n[1]]) / math.sqrt(n[1] ** 2 + n[2] ** 2)
    return nt, np.cross(n, nt)
