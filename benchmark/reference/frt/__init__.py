"""A frozen copy of the PyTorch port's plain torch path, the benchmark's
reference renderer.

Copied from the port (`fast_ray_tracer_tpu_torch`, the tree of commit
505bff5) with its imports renamed, and cut to what `render_scene`,
`load_scene` and the train step need. Three things differ from the port:
the stream compaction and the clustered-mesh queries take their plain
torch versions on every device (ops/compact.py, ops/mesh.py: the versions
the port's CUDA kernels are held to bit for bit), the host C++ walks are
absent so the scene compiler takes its Python OBJ scan and divide walk
(native/), and a render probes its buckets every time instead of reading
a calibration cache on disk (render/render.py). It imports nothing of
the port and builds nothing: it works out the tables, the photon maps
and the buckets again from the scene file and the seed the benchmark
hands to both sides. Later changes to the port do not move it.
"""
