"""fast_ray_tracer_tpu_torch — the Whitted ray tracer in PyTorch and CUDA.

A port of `fast_ray_tracer_tpu` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The module layout and function names follow the JAX package,
so each counterpart sits at the same path. The JAX package is the
reference the port is tested against; this package never imports it, nor
jax, nor yaml.

The port covers the deterministic Whitted render: the six analytic shapes
(the toroid through the float64 quartic), triangles, smooth triangles
and OBJ meshes, CSG trees, every procedural pattern and uv map with
Perlin noise and bump maps, point lights, reflective and refractive
materials, a point aperture, and the static-bucket wavefront. Its stream
compaction and the clustered meshes' closest-hit and shadow queries run
in hand-written CUDA kernels (`ops/compact.py` + `csrc/compact.cu`,
`ops/mesh.py` + `csrc/mesh.cu`). Texture images, sampled lights and
apertures, and photon GI raise NotImplementedError.

Importing the package loads nothing heavy: import the submodules you use,
e.g. `fast_ray_tracer_tpu_torch.render.render.render_scene`.
"""

__version__ = "0.1.0"
