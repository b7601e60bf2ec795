"""The frozen scene files load, through the port's YAML loader, into the
very tables the port's demo scenes compile to (the Whitted frame with
the demo's patterns in the slots that the YAML's `pattern` key fills),
and each configuration's file states the sizes its scene file loads."""

import json
import shutil

import pytest
import torch

from fast_ray_tracer_tpu_torch.scene import demo
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene

from benchmark.scenes import block


def _tables(scene):
    ir = compile_scene(scene, dtype=torch.float64, device="cpu")
    return ir.meta, ir.tables()


def _same(a, b):
    (ma, ta), (mb, tb) = a, b
    assert ma == mb
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _glass_spheres_patterned():
    """demo.glass_spheres(800, 400), its stripe and checker moved from the
    key "pattern", which is no slot, to the ambient and diffuse slots."""
    scene = demo.glass_spheres(800, 400)
    for shape in scene.world:
        p = shape.material.patterns.get("pattern")
        if p is not None:
            shape.material.patterns = {"map_Ka": p, "map_Kd": p}
    return scene


def _stage(root, tmp_path, name):
    shutil.copy(f"{root}/benchmark/scenes/{name}.yml",
                tmp_path / f"{name}.yml")
    if name == "cornell_gi":
        block.write(tmp_path / "block.obj")
    return load_scene(str(tmp_path / f"{name}.yml"))


@pytest.mark.parametrize("name,build", [
    ("reflect_refract", _glass_spheres_patterned),
    ("cornell_gi", lambda: demo.cornell_box(800, 800)),
])
def test_scene_file_is_the_demo_scene(root, tmp_path, name, build):
    scene = _stage(root, tmp_path, name)
    want = build()
    assert scene.camera == want.camera
    assert scene.config == want.config
    assert scene.lights == want.lights
    _same(_tables(scene), _tables(want))


def test_whitted_frame_has_its_patterns(root, tmp_path):
    """Five planes carry a pattern: the four striped walls and the
    checkered floor."""
    scene = _stage(root, tmp_path, "reflect_refract")
    kinds = sorted(s.material.patterns["map_Kd"].kind for s in scene.world
                   if s.material.patterns)
    assert kinds == ["checker"] + ["stripe"] * 4


@pytest.mark.parametrize("config", ["reflect_refract"])
def test_config_states_what_the_scene_loads(root, tmp_path, config):
    with open(f"{root}/benchmark/configs/{config}.json") as f:
        cfg = json.load(f)
    scene = _stage(root, tmp_path, config)
    cam = scene.camera
    assert cfg["resolution"] == [cam.width, cam.height]
    assert cfg["spp"] == [cam.usteps, cam.vsteps]
    assert cfg["depth"] == scene.config.di_path_length
    assert cfg["scene"] == f"benchmark/scenes/{config}.yml"


def test_block_is_the_demo_block(tmp_path):
    block.write(tmp_path / "a.obj")
    demo.write_block_obj(tmp_path / "b.obj", (0.5, 1.2, 0.5),
                         demo.CORNELL_BLOCK_CUTS)
    assert (tmp_path / "a.obj").read_bytes() == \
        (tmp_path / "b.obj").read_bytes()
    assert sum(1 for ln in open(tmp_path / "a.obj")
               if ln.startswith("f ")) == 10092
