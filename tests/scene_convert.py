"""Test-side bridges between the JAX package and its PyTorch port.

The two packages' scene/model.py files are field-for-field copies, so a
scene description crosses over dataclass to dataclass by name, either way
(`convert`): every light kind, every pattern (`uv_image` with its file and
decode flag included) and the scene's `root_dir`, against which OBJ, MTL
and texture paths resolve. A compiled JAX SceneIR crosses over as numpy
tables plus its SceneMeta, which the port's SceneMeta copies field for
field (`ir_from_jax`): the light tables (sample points, masks, edges,
normals, radii) and the texture atlas included. `jax_canvas` renders a
scene's frame through the JAX package's bucketed wavefront. `JaxKeys`
stands in for the port's RNG node and draws with jax keys, so a port
sampler consumes exactly the numbers its JAX counterpart draws."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
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
    programs, pattern, texture and light tables included)."""
    meta = SceneMeta(**{f.name: getattr(jir.meta, f.name)
                        for f in dataclasses.fields(SceneMeta)})
    return scene_ir_from_numpy(jax_tables(jir), meta, device, dtype)


def jax_canvas(scene, buckets):
    """The (H, W, 3) float64 canvas of a port scene description (one
    sample per pixel, a point aperture) through the JAX package's
    trace_bucketed in one jit, with `buckets` (the port's calibration:
    the JAX side skips its own probe) and its XLA compaction; raises on a
    bucket overflow."""
    sc = convert(scene, jmodel)
    cam = sc.camera
    w, h = cam.width, cam.height
    n = w * h
    jir = jcomp.compile_scene(sc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, sc.config)
    crt = jcam.build_camera(cam, dtype=jnp.float64)
    depth = sc.config.di_path_length

    @jax.jit
    def run(px, py):
        uv = jnp.broadcast_to(jnp.asarray(cmj_points_static(1, 1)), (n, 2))
        o, d = jcam.rays_for_pixels(crt, px, py, uv, jnp.zeros((n, 2)))
        tr, ovf = jintg.trace_bucketed(jir, jrt, o, d, depth, None,
                                       list(buckets))
        return (tr.a + tr.d + tr.s) / 3.0, ovf

    with compact_pallas.override_mode("off"):
        img, ovf = run(jnp.asarray(np.tile(np.arange(w), h)),
                       jnp.asarray(np.repeat(np.arange(h), w)))
    assert not bool(ovf), "JAX trace_bucketed overflowed"
    return np.asarray(img).reshape(h, w, 3)


_JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


class JaxKeys:
    """The port's RNG interface (sampling/rng.py) over a jax key: fold and
    split as jax.random.fold_in and split, draws as jax.random.uniform,
    normal and randint (default dtypes), returned as CPU tensors."""

    device = torch.device("cpu")

    def __init__(self, key):
        self.key = key

    def fold(self, i):
        return JaxKeys(jax.random.fold_in(self.key, i))

    def split(self, n):
        return [JaxKeys(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape, dtype):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, tuple(shape), _JNP[dtype])))

    def normal(self, shape, dtype):
        return torch.from_numpy(np.array(jax.random.normal(
            self.key, tuple(shape), _JNP[dtype])))

    def randint(self, shape, low, high):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, tuple(shape), low, high))).to(torch.int64)
