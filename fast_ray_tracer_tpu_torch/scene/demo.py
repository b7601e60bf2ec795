"""Built-in demo scenes (no input files).

`glass_spheres` mirrors the structure of the reference's reflect_refract
gallery scene (scenes/reflect_refract/reflect_refract.yml): a striped room,
checkered reflective floor, and reflective+refractive glass spheres — it
exercises the full Whitted path (patterns, shadows, schlick blending,
refraction containers) and is the flagship benchmark workload.

`mesh_torus` is the mesh workload: a bumped torus of smooth triangles,
written as an OBJ file by `write_torus_obj` and loaded through the OBJ
path, over a reflective checkered floor.

`primitives_showcase` is the scene-language workload: every analytic
shape, every procedural pattern and uv map, Perlin noise, a bump map and
a CSG difference, each pattern bound to a real material map slot.

`soft_textured` is the frontend workload: a YAML scene with area, circle
and hemisphere lights and image textures (PNG through an MTL file on the
mesh, a 16-bit PPM on the floor), its assets written at first use.

`cornell_box` is the photon-mapped GI workload: the JAX package's GI
bench configuration (100,000 photons, a 3x3 final gather, caustics, a
jittered 10x10 area light) in a stand-in box, with a clustered mesh block.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np

from fast_ray_tracer_tpu_torch.io.ppm import encode_png
from fast_ray_tracer_tpu_torch.scene.model import (
    ApertureDesc, CameraDesc, ConfigDesc, LightDesc, MaterialDesc,
    PatternDesc, SceneDesc, ShapeDesc,
)
from fast_ray_tracer_tpu_torch.scene.yaml_loader import scene_from_tree


def glass_spheres(width: int = 400, height: int = 200,
                  usteps: int = 1, vsteps: int = 1) -> SceneDesc:
    wall_mat = MaterialDesc(
        ambient=0.0, diffuse=0.4, specular=0.0, reflective=0.3,
        patterns={"pattern": PatternDesc(
            kind="stripe",
            colors=[(0.45, 0.45, 0.45), (0.55, 0.55, 0.55)],
            transform=[["scale", 0.25, 0.25, 0.25], ["rotate-y", 1.5708]])})

    def wall(tf):
        return ShapeDesc(kind="plane", transform=tf, material=wall_mat)

    glass = MaterialDesc(color=(0.0, 0.0, 0.2), ambient=0.0, diffuse=0.4,
                         specular=0.9, shininess=300.0, reflective=0.9,
                         transparency=0.9, refractive_index=1.5)

    world = [
        ShapeDesc(kind="plane", transform=[["rotate-y", 0.31415]],
                  material=MaterialDesc(
                      specular=0.0, reflective=0.4,
                      patterns={"pattern": PatternDesc(
                          kind="checker",
                          colors=[(0.35, 0.35, 0.35), (0.65, 0.65, 0.65)])})),
        ShapeDesc(kind="plane", transform=[["translate", 0, 5, 0]],
                  material=MaterialDesc(color=(0.8, 0.8, 0.8), ambient=0.3,
                                        specular=0.0)),
        wall([["rotate-y", 1.5708], ["rotate-z", 1.5708],
              ["translate", -5, 0, 0]]),
        wall([["rotate-y", 1.5708], ["rotate-z", 1.5708],
              ["translate", 5, 0, 0]]),
        wall([["rotate-x", 1.5708], ["translate", 0, 0, 5]]),
        wall([["rotate-x", 1.5708], ["translate", 0, 0, -5]]),
        ShapeDesc(kind="sphere",
                  transform=[["scale", 0.4, 0.4, 0.4],
                             ["translate", 4.6, 0.4, 1]],
                  material=MaterialDesc(color=(0.8, 0.5, 0.3),
                                        shininess=50.0)),
        ShapeDesc(kind="sphere",
                  transform=[["translate", -0.6, 1, 0.6]],
                  material=MaterialDesc(color=(1.0, 0.3, 0.2), specular=0.4,
                                        shininess=5.0)),
        ShapeDesc(kind="sphere",
                  transform=[["scale", 0.7, 0.7, 0.7],
                             ["translate", 0.6, 0.7, -0.6]],
                  material=glass),
        ShapeDesc(kind="sphere",
                  transform=[["scale", 0.5, 0.5, 0.5],
                             ["translate", -0.7, 0.5, -0.8]],
                  material=MaterialDesc(color=(0.0, 0.2, 0.0), ambient=0.0,
                                        diffuse=0.4, specular=0.9,
                                        shininess=300.0, reflective=0.9,
                                        transparency=0.9,
                                        refractive_index=1.5)),
    ]
    return SceneDesc(
        camera=CameraDesc(width=width, height=height, field_of_view=1.152,
                          frm=(-2.6, 1.5, -3.9), to=(-0.6, 1.0, -0.8),
                          up=(0.0, 1.0, 0.0), usteps=usteps, vsteps=vsteps,
                          aperture=ApertureDesc()),
        lights=[LightDesc(kind="point", at=(-4.9, 4.9, -1.0),
                          intensity=(1.0, 1.0, 1.0))],
        world=world,
        config=ConfigDesc(divide_threshold=1))


SCENE_DIR = Path(__file__).resolve().parents[2] / "build" / "scenes"


def _write_atomic(path, data) -> None:
    """Write bytes or text through a temporary file, so that a concurrent
    reader never sees a partial file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    os.replace(tmp, path)


def write_torus_obj(path, nu: int, nv: int, uv: bool = False,
                    mtl: Optional[str] = None) -> str:
    """Write a bumped torus as an OBJ file of `v`, `vn` and `f v//vn` quads
    (nu around the ring x nv around the tube; each quad fan-triangulates
    into two smooth triangles, 2*nu*nv in all). With `uv` the faces also
    name texture coordinates, `f v/vt/vn`: u runs 0..4 around the ring, v
    0..1 around the tube (the texture tiles 4 times, seams included). With
    `mtl` the file loads that MTL file and uses the material named as its
    stem. Deterministic: the same arguments always give the same bytes.
    Returns the path."""
    path = str(path)
    u = 2.0 * np.pi * np.arange(nu) / nu
    v = 2.0 * np.pi * np.arange(nv) / nv
    u, v = np.meshgrid(u, v, indexing="ij")          # (nu, nv)
    big, r0, amp, ku, kv = 1.0, 0.35, 0.12, 9, 6
    # tube radius with bumps, and its partial derivatives
    r = r0 * (1.0 + amp * np.sin(ku * u) * np.cos(kv * v))
    r_u = r0 * amp * ku * np.cos(ku * u) * np.cos(kv * v)
    r_v = -r0 * amp * kv * np.sin(ku * u) * np.sin(kv * v)
    ring = big + r * np.cos(v)
    pos = np.stack([ring * np.cos(u), r * np.sin(v), ring * np.sin(u)], -1)
    ring_u = r_u * np.cos(v)
    ring_v = r_v * np.cos(v) - r * np.sin(v)
    p_u = np.stack([ring_u * np.cos(u) - ring * np.sin(u), r_u * np.sin(v),
                    ring_u * np.sin(u) + ring * np.cos(u)], -1)
    p_v = np.stack([ring_v * np.cos(u), r_v * np.sin(v) + r * np.cos(v),
                    ring_v * np.sin(u)], -1)
    nrm = np.cross(p_v, p_u)                          # outward
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    vid = lambda a, b: (a % nu) * nv + (b % nv) + 1   # 1-based OBJ ids
    quads = np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                      vid(i, j + 1)], -1).reshape(-1, 4)
    lines = [f"# bumped torus, {nu} x {nv} quads"]
    if mtl:
        lines += [f"mtllib {mtl}", f"usemtl {Path(mtl).stem}"]
    lines += ["v %.17g %.17g %.17g" % tuple(p) for p in pos.reshape(-1, 3)]
    lines += ["vn %.17g %.17g %.17g" % tuple(n) for n in nrm.reshape(-1, 3)]
    if uv:
        # a vt grid of (nu + 1) x (nv + 1): the seam quads take u = 4 and
        # v = 1 where their vertices wrap to index 0
        tu, tv = np.meshgrid(4.0 * np.arange(nu + 1) / nu,
                             np.arange(nv + 1) / nv, indexing="ij")
        lines += ["vt %.17g %.17g" % t for t in zip(tu.ravel(), tv.ravel())]
        tid = lambda a, b: a * (nv + 1) + b + 1
        tq = np.stack([tid(i, j), tid(i + 1, j), tid(i + 1, j + 1),
                       tid(i, j + 1)], -1).reshape(-1, 4)
        lines += ["f " + " ".join(f"{k}/{t}/{k}" for k, t in zip(q, w))
                  for q, w in zip(quads, tq)]
    else:
        lines += ["f " + " ".join(f"{k}//{k}" for k in q) for q in quads]
    _write_atomic(path, "\n".join(lines) + "\n")
    return path


def mesh_torus(width: int = 600, height: int = 240, glass: bool = False,
               segments=(384, 184)) -> SceneDesc:
    """A reflective bumped torus of 2 * segments[0] * segments[1] smooth
    triangles (141,312 by default) over a reflective checkered plane, one
    point light, Whitted depth 5, a point aperture, one sample per pixel.
    With `glass` the torus is transparent (0.9) with refractive index 1.5,
    so the refraction containers walk runs over the mesh. The OBJ file is
    written to build/scenes/ on first use."""
    nu, nv = segments
    path = SCENE_DIR / f"torus_{nu}x{nv}.obj"
    if not path.exists():
        SCENE_DIR.mkdir(parents=True, exist_ok=True)
        write_torus_obj(path, nu, nv)
    if glass:
        torus_mat = MaterialDesc(color=(0.1, 0.15, 0.2), ambient=0.0,
                                 diffuse=0.3, specular=0.9, shininess=300.0,
                                 reflective=0.9, transparency=0.9,
                                 refractive_index=1.5)
    else:
        torus_mat = MaterialDesc(color=(0.8, 0.35, 0.2), diffuse=0.7,
                                 specular=0.6, shininess=100.0,
                                 reflective=0.3)
    floor = MaterialDesc(
        color=(0.6, 0.6, 0.6), specular=0.0, reflective=0.4,
        patterns={"map_Kd": PatternDesc(
            kind="checker", colors=[(0.35, 0.35, 0.35), (0.65, 0.65, 0.65)],
            transform=[["scale", 0.5, 0.5, 0.5]])})
    world = [
        ShapeDesc(kind="plane", material=floor),
        ShapeDesc(kind="obj", file=str(path), material=torus_mat,
                  transform=[["rotate-x", 1.1], ["rotate-y", 0.4],
                             ["translate", 0.0, 1.25, 0.0]]),
    ]
    return SceneDesc(
        camera=CameraDesc(width=width, height=height, field_of_view=0.9,
                          frm=(0.0, 3.0, -7.0), to=(0.0, 0.9, 0.0),
                          up=(0.0, 1.0, 0.0), aperture=ApertureDesc()),
        lights=[LightDesc(kind="point", at=(-4.0, 6.0, -5.0),
                          intensity=(1.0, 1.0, 1.0))],
        world=world,
        config=ConfigDesc(divide_threshold=1),
        root_dir=str(SCENE_DIR))


def primitives_showcase(width: int = 800, height: int = 400) -> SceneDesc:
    """Every analytic shape (plane, sphere, cube, closed glass cylinder,
    closed cone, toroid), every procedural pattern (checker, gradient,
    radial gradient, ring, stripe; blended, nested, perturbed with 4
    octaves of Perlin noise) and uv map (planar, spherical, cubic,
    cylindrical, toroidal with the uv checker, align-check, gradient and
    radial gradient), a map_bump slot, and a CSG difference of a cube and a
    sphere, lit by one point light; Whitted depth 5, a point aperture, one
    sample per pixel. Deterministic: it draws no random numbers."""
    P = PatternDesc

    def align(main):
        return P(kind="uv_align_check",
                 colors=[main, (1.0, 0.1, 0.1), (1.0, 1.0, 0.2),
                         (0.2, 0.9, 0.2), (0.1, 0.4, 1.0)])

    floor = MaterialDesc(
        specular=0.0, reflective=0.15, patterns={"map_Kd": P(
            kind="map", mapping="plane", transform=[["scale", 3, 3, 3]],
            faces=[P(kind="uv_gradient",
                     colors=[(0.25, 0.3, 0.35), (0.75, 0.7, 0.6)])])})
    # nested(checker, stripe, ring): the checker's two colors come from
    # the stripe and the ring
    wall = MaterialDesc(
        ambient=0.2, diffuse=0.7, specular=0.0, patterns={"map_Kd": P(
            kind="nested", children=[
                P(kind="checker", colors=[(0, 0, 0), (1, 1, 1)]),
                P(kind="stripe", colors=[(0.8, 0.8, 0.75), (0.45, 0.5, 0.6)],
                  transform=[["scale", 0.5, 0.5, 0.5], ["rotate-y", 0.6]]),
                P(kind="ring", colors=[(0.9, 0.9, 0.3), (0.2, 0.6, 0.3)],
                  transform=[["scale", 0.7, 0.7, 0.7]])])})
    globe = MaterialDesc(
        diffuse=0.7, specular=0.6, shininess=80.0, reflective=0.5,
        patterns={"map_Kd": P(
            kind="map", mapping="sphere",
            faces=[P(kind="uv_checker", width=16, height=8,
                     colors=[(0.1, 0.25, 0.6), (0.9, 0.9, 0.9)])])})
    box = MaterialDesc(
        specular=0.3, patterns={"map_Kd": P(
            kind="map", mapping="cube", faces=[
                align(c) for c in ((1, 1, 1), (0.8, 0.8, 0.8), (1, 0.9, 0.7),
                                   (0.7, 0.9, 1), (0.9, 0.7, 0.9),
                                   (0.7, 1, 0.8))])})
    glass = MaterialDesc(
        color=(0.1, 0.1, 0.15), ambient=0.0, diffuse=0.2, specular=0.9,
        shininess=300.0, reflective=0.9, transparency=0.9,
        refractive_index=1.5, patterns={"map_Kd": P(
            kind="map", mapping="cylinder", faces=[
                P(kind="uv_checker", width=8, height=2,
                  colors=[(0.1, 0.1, 0.2), (0.2, 0.2, 0.3)]),
                align((0.2, 0.2, 0.2)),
                P(kind="uv_gradient", colors=[(0.1, 0.1, 0.1),
                                              (0.3, 0.3, 0.3)])])})
    cone = MaterialDesc(
        specular=0.5, shininess=50.0, patterns={"map_Kd": P(
            kind="ring", colors=[(0.9, 0.5, 0.1), (0.3, 0.1, 0.05)],
            transform=[["scale", 0.15, 0.15, 0.15]])})
    torus = MaterialDesc(
        specular=0.7, shininess=120.0, reflective=0.2, patterns={
            "map_Kd": P(kind="map", mapping="toroid", faces=[P(
                kind="uv_radial_gradient",
                colors=[(0.9, 0.2, 0.5), (0.2, 0.8, 0.9)])])})
    bumpy = MaterialDesc(
        specular=0.6, shininess=60.0, patterns={
            "map_Kd": P(kind="gradient", colors=[(0.2, 0.6, 0.2),
                                                 (0.9, 0.9, 0.2)],
                        transform=[["scale", 2, 2, 2], ["rotate-z", 0.7]]),
            "map_bump": P(kind="perturbed", frequency=2.0, scale_factor=0.3,
                          persistence=0.7, octaves=4, seed=7, children=[
                              P(kind="stripe", colors=[(0.4, 0.4, 0.4),
                                                       (0.6, 0.6, 0.6)],
                                transform=[["scale", 0.1, 0.1, 0.1]])])})
    # blended(radial gradient, checker)
    radial = MaterialDesc(
        specular=0.2, patterns={"map_Kd": P(kind="blended", children=[
            P(kind="radial_gradient", colors=[(0.9, 0.9, 0.9),
                                              (0.5, 0.1, 0.1)],
              transform=[["scale", 0.3, 0.3, 0.3]]),
            P(kind="checker", colors=[(0.2, 0.2, 0.2), (0.8, 0.8, 0.8)],
              transform=[["scale", 0.25, 0.25, 0.25]])])})
    world = [
        ShapeDesc(kind="plane", material=floor),
        ShapeDesc(kind="plane", material=wall,
                  transform=[["rotate-x", 1.5708], ["translate", 0, 0, 8]]),
        ShapeDesc(kind="sphere", material=globe,
                  transform=[["translate", -3.3, 1.0, 0.6]]),
        ShapeDesc(kind="cube", material=box,
                  transform=[["scale", 0.7, 0.7, 0.7], ["rotate-y", 0.6],
                             ["translate", -1.2, 0.7, 2.2]]),
        ShapeDesc(kind="cylinder", material=glass, minimum=0.0, maximum=1.6,
                  closed=True, transform=[["scale", 0.6, 1.0, 0.6],
                                          ["translate", 0.5, 0.0, -1.2]]),
        ShapeDesc(kind="cone", material=cone, minimum=-1.0, maximum=0.0,
                  closed=True, transform=[["scale", 0.7, 1.5, 0.7],
                                          ["translate", 2.4, 1.5, 1.6]]),
        ShapeDesc(kind="toroid", material=torus, r1=0.75, r2=0.25,
                  transform=[["rotate-x", -0.9],
                             ["translate", 3.7, 0.95, -0.4]]),
        # gradient and radial gradient on children of a group
        ShapeDesc(kind="group", transform=[["translate", -1.8, 0.0, -1.9]],
                  children=[
                      ShapeDesc(kind="sphere", material=bumpy,
                                transform=[["scale", 0.55, 0.55, 0.55],
                                           ["translate", 0.0, 0.55, 0.0]]),
                      ShapeDesc(kind="cube", material=radial,
                                transform=[["scale", 0.3, 0.3, 0.3],
                                           ["translate", 0.9, 0.3, -0.5]])]),
        ShapeDesc(kind="csg", op="difference",
                  transform=[["rotate-y", 0.5], ["translate", 1.9, 0.6, -2.6]],
                  left=ShapeDesc(kind="cube", transform=[
                      ["scale", 0.6, 0.6, 0.6]], material=MaterialDesc(
                          color=(0.9, 0.3, 0.2), specular=0.4,
                          shininess=30.0)),
                  right=ShapeDesc(kind="sphere", transform=[
                      ["scale", 0.8, 0.8, 0.8]], material=MaterialDesc(
                          color=(0.9, 0.9, 0.3), specular=0.4,
                          shininess=30.0))),
    ]
    return SceneDesc(
        camera=CameraDesc(width=width, height=height, field_of_view=1.1,
                          frm=(0.0, 2.6, -8.0), to=(0.2, 0.9, 0.0),
                          up=(0.0, 1.0, 0.0), aperture=ApertureDesc()),
        lights=[LightDesc(kind="point", at=(-6.0, 9.0, -8.0),
                          intensity=(1.0, 1.0, 1.0))],
        world=world,
        config=ConfigDesc(divide_threshold=1))


SOFT_DIR = SCENE_DIR / "soft_textured"
SOFT_SEGMENTS = (384, 184)


def _soft_images() -> dict:
    """The soft_textured frame's texture images from fixed seeds, as file
    name -> bytes: a 256x256 8-bit RGB stone PNG, its 8-bit grey bump PNG
    (values about 0.5, so the normals tilt a little), and a 16-bit P6 PPM
    of a veined floor."""
    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:256, 0:256] / 256.0
    # stone: three random plane waves per channel, a warm tint, grain
    waves = sum(np.sin(2 * np.pi * (rng.integers(1, 6) * x
                                    + rng.integers(1, 6) * y)
                       + rng.uniform(0, 2 * np.pi, 3)[:, None, None])
                for _ in range(3))
    stone = (0.55 + 0.12 * waves.transpose(1, 2, 0)
             * np.array([1.0, 0.85, 0.7])
             + rng.normal(0.0, 0.04, (256, 256, 3)))
    stone8 = np.clip(np.round(stone * 255), 0, 255).astype(np.uint8)
    bump = 0.5 + 0.06 * np.sin(2 * np.pi * 8 * x) * np.sin(2 * np.pi * 6 * y) \
        + rng.normal(0.0, 0.01, (256, 256))
    bump8 = np.clip(np.round(bump * 255), 0, 255).astype(np.uint8)
    # floor: veins of a warped sine over a cool grey
    fy, fx = np.mgrid[0:192, 0:192] / 192.0
    warp = fx + 0.15 * np.sin(2 * np.pi * 2 * fy) + rng.normal(0, 0.01,
                                                               fx.shape)
    vein = np.abs(np.sin(2 * np.pi * 1.5 * warp)) ** 6
    floor = (0.62 - 0.4 * vein)[..., None] * np.array([0.95, 0.97, 1.0])
    floor16 = np.clip(np.round(floor * 65535), 0, 65535).astype(">u2")
    ppm = b"P6\n192 192\n65535\n" + floor16.tobytes()
    # each PNG row filtered as libpng would choose (Average for most rows
    # here), so that reading them takes the reader's sequential
    # reconstruction, as users' files do
    return {"stone.png": encode_png(stone8, adaptive=True),
            "stone_bump.png": encode_png(bump8, adaptive=True),
            "floor.ppm": ppm}


SOFT_MTL = """# soft_textured's mesh material: a stone texture and its bump map
newmtl stone
Ns 60.0
Ni 1.0
d 1.0
Ka 0.25 0.25 0.25
Kd 0.9 0.9 0.9
Ks 0.35 0.35 0.35
map_Kd stone.png
map_bump stone_bump.png
"""


def _soft_tree(width: int, height: int, obj: str) -> list:
    """The soft_textured scene as a YAML document (entries of the
    reference schema)."""
    glass = {"color": [0.1, 0.12, 0.15], "ambient": 0.0, "diffuse": 0.2,
             "specular": 0.9, "shininess": 300.0, "reflective": 0.9,
             "transparency": 0.9, "refractive-index": 1.5}
    return [
        {"add": "config",
         "illumination": {"include-direct": True,
                          "direct-illumination": {"path-length": 5}},
         "scene": {"divide-threshold": 1},
         "output": {"color-space": "SRGB"}},
        {"add": "camera", "width": width, "height": height,
         "field-of-view": 0.95, "from": [0.0, 3.0, -7.2],
         "to": [0.0, 0.9, 0.0], "up": [0.0, 1.0, 0.0],
         "aperture": {"type": ["POINT_APERTURE"], "size": 0.0,
                      "jitter": False}},
        {"add": "light", "corner": [-3.5, 6.0, -4.5], "uvec": [2.0, 0.0, 0.0],
         "vvec": [0.0, 0.0, 2.0], "usteps": 4, "vsteps": 4, "jitter": False,
         "intensity": [0.75, 0.75, 0.7]},
        {"add": "light", "at": [4.5, 4.0, -3.0], "to": [0.0, 0.5, 0.0],
         "radius": 0.8, "usteps": 2, "vsteps": 2, "jitter": False,
         "intensity": [0.35, 0.4, 0.5]},
        {"add": "light", "at": [0.0, 9.0, 2.0], "to": [0.0, 0.0, 0.0],
         "intensity": [0.2, 0.2, 0.2]},
        {"add": "plane",
         "material": {"specular": 0.0, "reflective": 0.25, "patterns": {
             "Kd": {"type": "map", "mapping": "planar",
                    "transform": [["scale", 4.0, 4.0, 4.0]],
                    "uv_pattern": {"type": "image", "file": "floor.ppm"}}}}},
        {"add": "obj", "file": obj,
         "transform": [["rotate-x", 1.1], ["rotate-y", 0.4],
                       ["translate", 0.5, 1.25, 0.3]]},
        {"add": "sphere", "material": glass,
         "transform": [["scale", 0.65, 0.65, 0.65],
                       ["translate", -1.9, 0.65, -1.3]]},
    ]


def soft_textured(width: int = 800, height: int = 400,
                  segments=SOFT_SEGMENTS) -> SceneDesc:
    """The scene frontend's frame: the 2 * segments[0] * segments[1]
    smooth-triangle bumped torus of mesh_torus (141,312 by default, so
    clustered), stone-textured through an MTL file (map_Kd and map_bump,
    PNGs) over its vt coordinates; a glass sphere (reflection and
    refraction through the containers walk); a floor whose Kd is a planar
    map of a 16-bit PPM; a 4x4 area light, a 2x2 circle light and a
    hemisphere light, none jittered; sRGB input colors, Whitted depth 5, a
    point aperture, one sample per pixel.

    The images, the MTL file, the OBJ file and the scene as YAML
    (`soft_textured.yml`, at 800x400 with the default torus; it equals
    `soft_textured()` once loaded) are written to
    build/scenes/soft_textured/ on first use, from fixed seeds. The scene
    is built from the same YAML document, without PyYAML."""
    nu, nv = segments
    obj = f"torus_uv_{nu}x{nv}.obj"
    SOFT_DIR.mkdir(parents=True, exist_ok=True)
    if not (SOFT_DIR / "soft_textured.yml").exists():
        for name, data in _soft_images().items():
            _write_atomic(SOFT_DIR / name, data)
        _write_atomic(SOFT_DIR / "stone.mtl", SOFT_MTL)
        default = _soft_tree(800, 400, "torus_uv_%dx%d.obj" % SOFT_SEGMENTS)
        _write_atomic(SOFT_DIR / "soft_textured.yml",
                      "# scene/demo.soft_textured(800, 400), written by it\n"
                      + json.dumps(default, indent=1) + "\n")
    for n in ((nu, nv), SOFT_SEGMENTS):
        path = SOFT_DIR / ("torus_uv_%dx%d.obj" % n)
        if not path.exists():
            write_torus_obj(path, *n, uv=True, mtl="stone.mtl")
    return scene_from_tree(_soft_tree(width, height, obj), str(SOFT_DIR))


CORNELL_DIR = SCENE_DIR / "cornell_box"
# the tall block's faces are cut into n x n quads: 12 n^2 triangles
CORNELL_BLOCK_CUTS = 29


def write_block_obj(path, size, cuts: int) -> str:
    """Write an axis-aligned box of edges `size` centred on the origin as an
    OBJ file of flat triangles, each face cut into cuts x cuts quads of two
    triangles (12 cuts^2 in all). The winding is not oriented: shading
    faces every normal toward the ray. Deterministic. Returns the path."""
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
    _write_atomic(path, "\n".join(lines) + "\n")
    return str(path)


def _cornell_tree(width: int, height: int, obj) -> list:
    """The Cornell box as a YAML document (entries of the reference
    schema): a 2 x 2 x 2 box open toward the camera, white floor, ceiling
    and back wall, a red left and a green right wall, a jittered 10x10
    area light just under the ceiling, a mirror and a glass sphere, and,
    with `obj`, a tall block from that OBJ file."""
    def wall(color, transform):
        return {"add": "plane", "transform": transform,
                "material": {"color": color, "ambient": 0.05,
                             "diffuse": 0.7, "specular": 0.0}}
    white, red, green = [0.73, 0.73, 0.73], [0.65, 0.06, 0.05], \
        [0.12, 0.45, 0.15]
    half_pi = math.pi / 2.0
    tree = [
        {"add": "config",
         "illumination": {
             "include-direct": True, "include-global": True,
             "direct-illumination": {"path-length": 5},
             "global-illumination": {
                 "photon-count": 100000, "path-length": 5,
                 "include-caustics": True, "include-final-gather": True,
                 "usteps": 3, "vsteps": 3,
                 "irradiance-estimate-num": 100,
                 "irradiance-estimate-radius": 0.1,
                 "irradiance-estimate-cone-filter-k": 1.0}},
         "scene": {"divide-threshold": 1},
         "output": {"color-space": "RGB"}},
        {"add": "camera", "width": width, "height": height,
         "field-of-view": 0.75, "from": [0.0, 1.0, -3.4],
         "to": [0.0, 1.0, 0.0], "up": [0.0, 1.0, 0.0],
         "aperture": {"type": ["POINT_APERTURE"], "size": 0.0,
                      "jitter": False}},
        {"add": "light", "corner": [-0.3, 1.99, -0.3],
         "uvec": [0.6, 0.0, 0.0], "vvec": [0.0, 0.0, 0.6], "usteps": 10,
         "vsteps": 10, "jitter": True, "intensity": [1.2, 1.2, 1.2]},
        wall(white, []),
        wall(white, [["translate", 0.0, 2.0, 0.0]]),
        wall(white, [["rotate-x", half_pi], ["translate", 0.0, 0.0, 1.0]]),
        wall(red, [["rotate-z", half_pi], ["translate", -1.0, 0.0, 0.0]]),
        wall(green, [["rotate-z", half_pi], ["translate", 1.0, 0.0, 0.0]]),
        {"add": "sphere", "transform": [["scale", 0.33, 0.33, 0.33],
                                        ["translate", -0.5, 0.33, -0.25]],
         "material": {"color": [0.9, 0.9, 0.9], "ambient": 0.0,
                      "diffuse": 0.0, "specular": 0.9, "shininess": 300.0,
                      "reflective": 0.95}},
        {"add": "sphere", "transform": [["scale", 0.3, 0.3, 0.3],
                                        ["translate", 0.15, 0.3, -0.55]],
         "material": {"color": [0.9, 0.9, 0.9], "ambient": 0.0,
                      "diffuse": 0.05, "specular": 0.9, "shininess": 300.0,
                      "reflective": 0.1, "transparency": 0.9,
                      "refractive-index": 1.5}},
    ]
    if obj is not None:
        tree.append({"add": "obj", "file": obj,
                     "transform": [["rotate-y", 0.3],
                                   ["translate", 0.5, 0.6, 0.4]],
                     "material": {"color": white, "ambient": 0.05,
                                  "diffuse": 0.7, "specular": 0.1}})
    return tree


def cornell_box(width: int = 800, height: int = 800,
                mesh: bool = True) -> SceneDesc:
    """The photon-GI frame, a stand-in for the reference's
    scenes/cornell_box/cornell_box.yml (not in the repo) after SURVEY.md
    and tools/make_reduced_scenes.py's cornell_small: one sample per
    pixel, Whitted depth 5, GI path length 5, 100,000 photons, global
    illumination with a 3x3 final gather and caustics, an irradiance
    estimate of 100 photons within 0.1 (a twentieth of the box's edge). With `mesh`
    the box holds a tall block of 12 * 29^2 = 10,092 flat triangles (so
    clustered) beside the spheres.

    The block's OBJ file and the scene as YAML (`cornell_box.yml`, at
    800x800 with the block) are written to build/scenes/cornell_box/ on
    first use. The scene is built from the same YAML document, without
    PyYAML."""
    CORNELL_DIR.mkdir(parents=True, exist_ok=True)
    obj = "block.obj"
    if not (CORNELL_DIR / obj).exists():
        write_block_obj(CORNELL_DIR / obj, (0.5, 1.2, 0.5), CORNELL_BLOCK_CUTS)
    if not (CORNELL_DIR / "cornell_box.yml").exists():
        _write_atomic(CORNELL_DIR / "cornell_box.yml",
                      "# scene/demo.cornell_box(800, 800), written by it\n"
                      + json.dumps(_cornell_tree(800, 800, obj), indent=1)
                      + "\n")
    return scene_from_tree(_cornell_tree(width, height, obj if mesh else None),
                           str(CORNELL_DIR))
