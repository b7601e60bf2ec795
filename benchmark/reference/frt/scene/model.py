"""User-facing scene description objects.

The reference's Python frontend *generates C source* that rebuilds the scene
with constructor calls (yaml_parser/yaml_parser.py:138-234). Here the same
YAML schema loads into plain dataclasses which the scene compiler flattens
directly into SceneIR tensors — no codegen, no compile step, and every
numeric field stays a leaf a gradient can reach.

Defaults follow the reference exactly:
  * material defaults: yaml_parser/material.py:11-19
  * camera/aperture defaults: yaml_parser/renderer.py:6-66
  * config defaults: yaml_parser/config.py
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


Vec3 = Tuple[float, float, float]


@dataclass
class PatternDesc:
    """One node of a pattern tree (concrete, uv, combinator, or uv-map)."""
    kind: str                    # checker|gradient|radial_gradient|ring|stripe|
                                 # blended|nested|perturbed|map|
                                 # uv_checker|uv_align_check|uv_texture|uv_image
    transform: List[Any] = field(default_factory=list)   # YAML transform list
    colors: List[Vec3] = field(default_factory=list)     # raw (pre-decode)
    width: int = 0               # uv_checker
    height: int = 0
    children: List["PatternDesc"] = field(default_factory=list)
    mapping: str = ""            # map: spherical|planar|cylindrical|cube|toroidal|triangular
    faces: List["PatternDesc"] = field(default_factory=list)  # map faces in C face order
    # perturbed params (yaml_parser/pattern.py:64-79 defaults)
    frequency: float = 1.0
    scale_factor: float = 0.01
    persistence: float = 0.7
    octaves: int = 1
    seed: int = 0
    # uv_image
    file: str = ""
    decode_to_linear: bool = False   # true for Ka/Kd slots (pattern.py:264-266)


@dataclass
class MaterialDesc:
    """MTL-style material (reference src/material/material.h:196-220).

    YAML legacy fields map as: Ka=color*ambient, Kd=color*diffuse,
    Ks=color*specular (after input color decode), refl=(reflective,)*3,
    Tf=(transparency,)*3, Tr=transparency, Ns=shininess, Ni=refractive-index
    (yaml_parser/material.py:77-116).
    """
    color: Vec3 = (1.0, 1.0, 1.0)
    ambient: float = 0.1
    diffuse: float = 0.9
    specular: float = 0.9
    shininess: float = 200.0
    reflective: float = 0.0
    transparency: float = 0.0
    refractive_index: float = 1.0
    casts_shadow: bool = True
    patterns: Dict[str, PatternDesc] = field(default_factory=dict)  # slot -> pattern
    # obj_loader MTL extensions: explicit Ka/Kd/Ks/Tf/Ke color overrides
    Ka: Optional[Vec3] = None
    Kd: Optional[Vec3] = None
    Ks: Optional[Vec3] = None
    Tf: Optional[Vec3] = None
    refl_color: Optional[Vec3] = None


@dataclass
class ShapeDesc:
    kind: str                    # sphere|plane|cube|cone|cylinder|toroid|
                                 # triangle|smooth_triangle|group|csg|obj
    transform: List[Any] = field(default_factory=list)
    material: Optional[MaterialDesc] = None
    children: List["ShapeDesc"] = field(default_factory=list)  # group
    # csg
    op: str = ""                 # union|intersection|difference
    left: Optional["ShapeDesc"] = None
    right: Optional["ShapeDesc"] = None
    # cone/cylinder
    minimum: float = float("-inf")
    maximum: float = float("inf")
    closed: bool = False
    # toroid (yaml_parser/shapes.py:200-203 defaults)
    r1: float = 0.75
    r2: float = 0.25
    # triangles
    p1: Optional[Vec3] = None
    p2: Optional[Vec3] = None
    p3: Optional[Vec3] = None
    n1: Optional[Vec3] = None
    n2: Optional[Vec3] = None
    n3: Optional[Vec3] = None
    t1: Optional[Vec3] = None
    t2: Optional[Vec3] = None
    t3: Optional[Vec3] = None
    # obj include
    file: str = ""


@dataclass
class LightDesc:
    kind: str                    # point|area|circle|hemisphere
    intensity: Vec3 = (1.0, 1.0, 1.0)
    at: Vec3 = (0.0, 0.0, 0.0)          # point/circle/hemisphere position
    to: Vec3 = (0.0, 0.0, 0.0)          # circle/hemisphere aim
    corner: Vec3 = (0.0, 0.0, 0.0)      # area
    uvec: Vec3 = (1.0, 0.0, 0.0)        # area: FULL u edge (pre-division)
    vvec: Vec3 = (0.0, 1.0, 0.0)
    radius: float = 1.0                  # circle
    usteps: int = 1
    vsteps: int = 1
    jitter: bool = False
    cache_size: int = 65536


@dataclass
class ApertureDesc:
    kind: str = "POINT_APERTURE"
    size: float = 0.0
    jitter: bool = False
    params: Tuple[float, ...] = ()


@dataclass
class CameraDesc:
    width: int = 100
    height: int = 100
    field_of_view: float = 1.0
    frm: Vec3 = (0.0, 0.0, 0.0)
    to: Vec3 = (0.0, 0.0, -1.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    focal_length: float = 1.0    # canvas_distance
    usteps: int = 1
    vsteps: int = 1
    aperture: ApertureDesc = field(default_factory=ApertureDesc)


@dataclass
class ConfigDesc:
    """Global config (reference src/renderer/config.h:56-62 + yaml defaults)."""
    include_direct: bool = True
    include_global: bool = False
    visualize_photon_map: bool = False
    visualize_soft_indirect: bool = False
    include_ambient: bool = True
    include_diffuse: bool = True
    include_specular_highlight: bool = True
    include_specular: bool = True
    di_path_length: int = 5
    include_caustics: bool = False
    include_final_gather: bool = False
    gi_usteps: int = 1
    gi_vsteps: int = 1
    irradiance_estimate_num: int = 200
    irradiance_estimate_radius: float = 0.1
    irradiance_estimate_cone_filter_k: float = 1.0
    photon_count: int = 0
    gi_path_length: int = 5
    thread_count: int = 4
    divide_threshold: int = 1
    output_file: str = "/tmp/ray_tracer_out"
    color_space: str = "SRGB"


@dataclass
class SceneDesc:
    camera: Optional[CameraDesc] = None
    lights: List[LightDesc] = field(default_factory=list)
    world: List[ShapeDesc] = field(default_factory=list)
    config: ConfigDesc = field(default_factory=ConfigDesc)
    root_dir: str = "."          # base dir for obj/texture relative paths


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
