"""Built-in demo scenes (no file dependencies).

`glass_spheres` mirrors the structure of the reference's reflect_refract
gallery scene (scenes/reflect_refract/reflect_refract.yml): a striped room,
checkered reflective floor, and reflective+refractive glass spheres — it
exercises the full Whitted path (patterns, shadows, schlick blending,
refraction containers) and is the flagship benchmark workload.
"""

from __future__ import annotations

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
