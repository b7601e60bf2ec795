"""SceneIR — the flat, SoA, device-resident scene representation.

The same tables as `fast_ray_tracer_tpu.scene.ir`: one block of analytic
primitives grouped by type, the triangle block (world-space triangles,
Morton-ordered and padded to whole 64-triangle clusters with their AABBs
when the mesh is clustered), and the material, pattern, texture and light
tables, with the static structure in `SceneMeta`. Here `SceneIR` is a
dataclass of torch tensors; `.to(device, dtype)` moves it and casts the
float tables, keeping index and flag tables as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.utils.profiling import host_sync

# analytic primitive type ids (block-contiguous in the tables)
SPHERE, PLANE, CUBE, CYLINDER, CONE, TOROID = range(6)
ANALYTIC_TYPE_NAMES = ["sphere", "plane", "cube", "cylinder", "cone", "toroid"]
# per-type max intersection count (src/shapes/*: xs scratch sizes)
TYPE_MAX_HITS = {SPHERE: 2, PLANE: 1, CUBE: 2, CYLINDER: 4, CONE: 4, TOROID: 4}

# pattern type ids
(PAT_CHECKER, PAT_GRADIENT, PAT_RADIAL_GRADIENT, PAT_RING, PAT_STRIPE,
 PAT_BLENDED, PAT_NESTED, PAT_PERTURBED, PAT_MAP,
 PAT_UV_CHECKER, PAT_UV_ALIGN_CHECK, PAT_UV_TEXTURE,
 PAT_UV_GRADIENT, PAT_UV_RADIAL_GRADIENT) = range(14)

# uv map kinds (reference: enum uv_map_type usage in pattern.c:309-488)
(MAP_CUBE, MAP_CYLINDER, MAP_PLANE, MAP_SPHERE, MAP_TOROID, MAP_TRIANGLE) = range(6)

# light type ids
LIGHT_POINT, LIGHT_AREA, LIGHT_CIRCLE, LIGHT_HEMISPHERE = range(4)

# material map slots (order of mat_map columns)
MAP_SLOTS = ["map_Ka", "map_Kd", "map_Ks", "map_Ns", "map_d",
             "map_bump", "map_disp", "map_refl"]
SLOT_KA, SLOT_KD, SLOT_KS, SLOT_NS, SLOT_D, SLOT_BUMP, SLOT_DISP, SLOT_REFL = range(8)


def default_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None: the port's entry points
    run on the card unless the caller asks for another device. Nothing
    falls back to the CPU: without a card, the first tensor sent to CUDA
    raises."""
    return torch.device("cuda") if device is None else torch.device(device)


@dataclass(frozen=True)
class SceneMeta:
    """Static scene structure; field for field the JAX package's SceneMeta."""
    n_analytic: int = 0
    n_triangles: int = 0
    n_materials: int = 0
    n_patterns: int = 0
    n_lights: int = 0
    # per-type (start, count) into the analytic block
    type_ranges: Tuple[Tuple[int, int, int], ...] = ()   # (type_id, start, count)
    # per-light static info: (type_id, usteps, vsteps, jitter, num_samples)
    light_info: Tuple[Tuple[int, int, int, bool, int], ...] = ()
    max_light_samples: int = 1
    # shading flags (from config + material scan)
    has_reflective: bool = False
    has_refractive: bool = False
    needs_hit_sort: bool = False      # refraction containers need sorted hits
    max_hits: int = 8                 # K for the sorted hit list
    # triangle clustering (large meshes)
    use_clusters: bool = False
    n_clusters: int = 0
    cluster_size: int = 64
    # pattern slots present anywhere (skip pattern machinery when unused)
    any_patterns: bool = False
    any_bump: bool = False
    # material-map columns with ANY pattern bound
    pattern_slots: Tuple[int, ...] = ()
    # pattern type ids present in the scene
    pattern_kinds: Tuple[int, ...] = ()
    map_kinds: Tuple[int, ...] = ()  # uv-map projections present
    pattern_depth: int = 0          # max combinator nesting depth present
    max_perlin_octaves: int = 0
    # csg: per tree, internal nodes as (nid, depth, op)
    csg_trees: Tuple[Tuple[Tuple[int, int, int], ...], ...] = ()
    has_csg: bool = False
    # per-global-prim csg tags as Python ints
    csg_prim_leaf: Tuple[int, ...] = ()
    csg_prim_anc: Tuple[int, ...] = ()
    csg_prim_side: Tuple[int, ...] = ()


# tables holding indices: int64 on the torch side (the JAX package keeps
# them as i32); every other non-bool table is a float table
INDEX_FIELDS = frozenset({
    "material_id", "prim_shadow_rank", "tri_material_id", "mat_map",
    "pat_type", "pat_children", "pat_map_kind", "pat_tex",
    "tex_offset", "tex_width", "tex_height",
})


@dataclass
class SceneIR:
    meta: SceneMeta

    # --- analytic primitives (Na) ---
    inv_tf: Any = None          # (Na,4,4) world->object
    prim_params: Any = None     # (Na,4): cyl/cone [min,max,closed,_], toroid [r1,r2,_,_]
    material_id: Any = None     # (Na,) int64
    prim_shadow_rank: Any = None  # (Na+Nt,) int64 post-divide DFS walk order

    # --- triangles (Nt), world space ---
    tri_p1: Any = None          # (Nt,3)
    tri_e1: Any = None
    tri_e2: Any = None
    tri_n1: Any = None
    tri_n2: Any = None
    tri_n3: Any = None
    tri_t1: Any = None          # (Nt,2)
    tri_t2: Any = None
    tri_t3: Any = None
    tri_use_tex: Any = None     # (Nt,) bool
    tri_material_id: Any = None # (Nt,) int64
    cluster_min: Any = None     # (Nc,3)
    cluster_max: Any = None

    # --- materials (M) ---
    mat_Ka: Any = None          # (M,3) linear
    mat_Kd: Any = None
    mat_Ks: Any = None
    mat_Tf: Any = None
    mat_refl: Any = None
    mat_Ns: Any = None          # (M,)
    mat_Ni: Any = None
    mat_Tr: Any = None
    mat_reflective: Any = None  # (M,) bool
    mat_casts_shadow: Any = None
    mat_map: Any = None         # (M,8) int64 pattern ids, -1 = none

    # --- patterns (P) ---
    pat_type: Any = None        # (P,) int64
    pat_inv_tf: Any = None      # (P,4,4)
    pat_colors: Any = None      # (P,5,3)
    pat_params: Any = None      # (P,6)
    pat_children: Any = None    # (P,6) int64
    pat_map_kind: Any = None    # (P,) int64
    pat_tex: Any = None         # (P,) int64

    # --- texture atlas ---
    tex_data: Any = None        # (sum(w*h), 3)
    tex_offset: Any = None      # (T,) int64
    tex_width: Any = None
    tex_height: Any = None

    # --- lights (L) ---
    light_intensity: Any = None  # (L,3)
    light_pos: Any = None        # (L,3)
    light_uvec: Any = None       # (L,3)
    light_vvec: Any = None
    light_normal: Any = None     # (L,3)
    light_radius: Any = None     # (L,)
    light_points: Any = None     # (L,S_max,3) deterministic surface points
    light_mask: Any = None       # (L,S_max)

    @classmethod
    def table_names(cls):
        return [f.name for f in fields(cls) if f.name != "meta"]

    def tables(self) -> Dict[str, torch.Tensor]:
        """Every table, keyed by field name."""
        return {name: getattr(self, name) for name in self.table_names()}

    def to(self, device, dtype) -> "SceneIR":
        """Move every table to `device`; float tables become `dtype`."""
        out = {}
        tables = self.tables()
        # a copy of each non-empty table in host memory, each a sync on a
        # card
        with host_sync("upload", sum(t.numel() > 0 and t.device.type == "cpu"
                                     for t in tables.values())):
            for name, t in tables.items():
                if t.is_floating_point():
                    out[name] = t.to(device=device, dtype=dtype)
                else:
                    out[name] = t.to(device=device)
        return SceneIR(self.meta, **out)


def scene_ir_from_numpy(arrays: Dict[str, np.ndarray], meta: SceneMeta,
                        device, dtype) -> SceneIR:
    """SceneIR from numpy tables keyed by field name — e.g. the leaves of
    the JAX package's SceneIR taken as numpy arrays. Index tables become
    int64, boolean tables stay bool, the rest become `dtype`."""
    out = {}
    for name in SceneIR.table_names():
        a = np.array(arrays[name])       # a writable copy
        if name in INDEX_FIELDS:
            t = torch.as_tensor(a.astype(np.int64))
        elif a.dtype == np.bool_:
            t = torch.as_tensor(a)
        else:
            t = torch.as_tensor(a.astype(np.float64))
        out[name] = t
    return SceneIR(meta, **out).to(device, dtype)
