"""fast_ray_tracer_tpu_torch — the Whitted ray tracer in PyTorch and CUDA.

A port of `fast_ray_tracer_tpu` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The module layout and function names follow the JAX package,
so each counterpart sits at the same path. The JAX package is the
reference the port is tested against; this package never imports it, nor
jax, nor yaml.

This first slice covers the flagship render: analytic spheres and planes,
stripe and checker patterns, point lights, reflective and refractive
glass, a point aperture, and the static-bucket wavefront whose stream
compaction runs in hand-written CUDA kernels (`ops/compact.py`,
`csrc/compact.cu`).

Importing the package loads nothing heavy: import the submodules you use,
e.g. `fast_ray_tracer_tpu_torch.render.render.render_scene`.
"""

__version__ = "0.1.0"
