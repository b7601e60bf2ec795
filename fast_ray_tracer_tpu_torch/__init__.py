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
materials, a point aperture, and the static-bucket wavefront; and the
stochastic render: jittered lights and cameras, shaped apertures and
photon-mapped GI, drawn from one RNG tree (`sampling/rng.py`). Its
stream compaction and the
clustered meshes' closest-hit and shadow queries run in hand-written
CUDA kernels (`ops/compact.py` + `csrc/compact.cu`, `ops/mesh.py` +
`csrc/mesh.cu`).

Gradients: `render.render.pixel_colors` is differentiable through the
unrolled and the bucketed wavefront (the compaction kernels are each
other's backward), with per-level checkpointing (`remat`);
through clustered meshes (the mesh hit's t) and through photon-mapped
GI (live photon powers, `render/photon.make_gi_hook(live_power=True)`);
`parallel/train.py` splits a SceneIR into parameters and takes Adam
steps, `parallel/checkpoint.py` saves and resumes training and renders.

Many devices: one process per device over torch.distributed
(`parallel/distributed.init`, under `torchrun` or with an explicit store;
NCCL by default, gloo through host memory). `render_scene(mesh=...)`
splits each chunk's pixels over the ranks, each tracing its shard with
its own kernel launches, and every rank gets the whole canvas;
`make_train_step(mesh=...)` sums the gradients over the ranks before the
same Adam step on each (`parallel/mesh.py`: `make_mesh`,
`shard_pixel_batch`, `replicate_scene`). A single-device render caches
its bucket calibration on disk ($FRT_COMPILE_CACHE, default
~/.cache/frt_torch).

Tracing (`utils/profiling.py`): the render driver and the train step
open spans (`render_scene` and `train.step` are the units; inside them
`render.compile_scene`, `render.bucket_cache`, `render.probe_buckets`,
`render.probe`, `render.chunks`, `render.enqueue`, `train.forward`,
`train.backward`, `train.optimizer`) and wrap each call that waits for
the device in a `sync.<site>` span counted in `host_syncs`. The tracer
is off until a sink is attached: `remove = profiling.add_sink(fn)` hands
`fn` every closed `Span` and every `Count` until `remove()`;
`profiling.Recorder` is a sink that keeps them. Under any torch.profiler
the spans are ranges above their kernels, on or off. `with
profiling.trace_context(DIR):` records a profiler trace of its body
(DIR/trace.json) with the tracer on, and writes the spans and each
unit's counters to DIR/spans.json; the command line's `--profile DIR`
renders under it and prints the render's phases (`PhaseTimer`) and its
whole wall as JSON lines.

Importing the package loads nothing heavy: import the submodules you use,
e.g. `fast_ray_tracer_tpu_torch.render.render.render_scene`.
"""

__version__ = "0.1.0"
