"""Test-side bridges between the JAX package and its PyTorch port.

The two packages' scene/model.py files are field-for-field copies, so a
scene description crosses over dataclass to dataclass by name, either way
(`convert`). A compiled JAX SceneIR crosses over as numpy tables plus its
SceneMeta, which the port's SceneMeta copies field for field
(`ir_from_jax`)."""

import dataclasses

import numpy as np

from fast_ray_tracer_tpu.scene.ir import SceneIR as JSceneIR
from fast_ray_tracer_tpu_torch.scene.ir import SceneMeta, scene_ir_from_numpy


def convert(obj, target):
    """A tree of scene/model.py dataclasses as the same tree of `target`'s
    (a model module of either package)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(target, type(obj).__name__)
        return cls(**{f.name: convert(getattr(obj, f.name), target)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(convert(x, target) for x in obj)
    if isinstance(obj, dict):
        return {k: convert(v, target) for k, v in obj.items()}
    return obj


def jax_tables(jir):
    """The JAX SceneIR's tables as numpy arrays, keyed by field name."""
    return {f.name: np.asarray(getattr(jir, f.name))
            for f in dataclasses.fields(JSceneIR) if f.name != "meta"}


def ir_from_jax(jir, device, dtype):
    """The port's SceneIR holding the JAX SceneIR's tables and meta (csg
    programs, pattern and map tables included)."""
    meta = SceneMeta(**{f.name: getattr(jir.meta, f.name)
                        for f in dataclasses.fields(SceneMeta)})
    return scene_ir_from_numpy(jax_tables(jir), meta, device, dtype)
