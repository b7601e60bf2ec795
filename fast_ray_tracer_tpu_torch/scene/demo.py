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
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from fast_ray_tracer_tpu_torch.scene.model import (
    ApertureDesc, CameraDesc, ConfigDesc, LightDesc, MaterialDesc,
    PatternDesc, SceneDesc, ShapeDesc,
)


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


def write_torus_obj(path, nu: int, nv: int) -> str:
    """Write a bumped torus as an OBJ file of `v`, `vn` and `f v//vn` quads
    (nu around the ring x nv around the tube; each quad fan-triangulates
    into two smooth triangles, 2*nu*nv in all). Deterministic: the same
    arguments always give the same bytes. Returns the path."""
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
    lines += ["v %.17g %.17g %.17g" % tuple(p) for p in pos.reshape(-1, 3)]
    lines += ["vn %.17g %.17g %.17g" % tuple(n) for n in nrm.reshape(-1, 3)]
    lines += ["f " + " ".join(f"{k}//{k}" for k in q) for q in quads]
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
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
