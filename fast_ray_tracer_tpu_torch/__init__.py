"""fast_ray_tracer_tpu_torch — the Whitted ray tracer in PyTorch and CUDA.

A port of `fast_ray_tracer_tpu` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The module layout and function names follow the JAX package,
so each counterpart sits at the same path. The JAX package is the
reference the port is tested against; this package never imports it, nor
jax; PyYAML only inside `scene.yaml_loader.load_scene`, Pillow only inside
`io.ppm.read_image` (textures in formats other than PPM and PNG).

The port covers the deterministic Whitted render: the YAML scene
frontend and its command line (`python -m fast_ray_tracer_tpu_torch
scene.yml -o stem`, a 16-bit PPM and a 48-bit PNG), the six analytic
shapes (the toroid through the float64 quartic), triangles, smooth
triangles and OBJ/MTL meshes, CSG trees, every procedural pattern and uv
map with Perlin noise and bump maps, image textures (PPM, PNG, others
through Pillow), point and hemisphere lights and unjittered area and
circle lights, every input color space, reflective and refractive
materials, a point aperture, and the static-bucket wavefront. Its stream compaction and the
clustered meshes' closest-hit and shadow queries run in hand-written
CUDA kernels (`ops/compact.py` + `csrc/compact.cu`, `ops/mesh.py` +
`csrc/mesh.cu`).

Gradients: `render.render.pixel_colors` is differentiable through the
unrolled and the bucketed wavefront (the compaction kernels are each
other's backward), with per-level checkpointing (`remat`);
`parallel/train.py` splits a SceneIR into parameters and takes Adam
steps, `parallel/checkpoint.py` saves and resumes training and renders.

Still raising NotImplementedError: jittered lights and cameras, shaped
apertures, photon GI, gradients through clustered meshes; there is no
multi-device render yet.

Importing the package loads nothing heavy: import the submodules you use,
e.g. `fast_ray_tracer_tpu_torch.render.render.render_scene`.
"""

__version__ = "0.1.0"
