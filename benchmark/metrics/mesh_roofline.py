"""mesh_roofline: the clustered-mesh kernels' share of their roofline in
% (ops/mesh.py, csrc/mesh.cu: pair_kernel, keys_kernel): the least time
of every closest and shadow launch of a frame, by the (ray,
supercluster) pairs that pass the slab test on its inputs, each a
Moller-Trumbore against 128 triangles at the float32 peak, or by its
bytes where they take longer (benchmark/roofline.mesh_bound), over the
device time of those kernels in the same frame. The bound of each launch
is computed from its inputs when the first profiled frame is rendered
again after the window, with the reference's slab test. Moves
frame_s."""

import re

from benchmark import roofline

KERNELS = re.compile(r"\b(pair|keys)_kernel<")
KEY = "mesh_bound_s"


def install(rec):
    from fast_ray_tracer_tpu_torch.ops import mesh

    from benchmark.reference.frt.ops.mesh import cluster_mask
    rec[KEY] = 0.0
    c0, s0 = mesh.closest_cuda, mesh.shadow_cuda

    def bound(m, orig, dirs, aux):
        passed = roofline.passed_pairs(cluster_mask, m.box_min, m.box_max,
                                       orig, dirs)
        rec[KEY] += roofline.mesh_bound(
            passed, orig.shape[0], m.box_min.shape[0], m.tris.numel(), aux,
            orig.element_size())[0]

    def closest_cuda(m, orig, dirs, keep=None):
        bound(m, orig, dirs, 0)
        return c0(m, orig, dirs, keep)

    def shadow_cuda(m, orig, dirs):
        bound(m, orig, dirs, 5)
        return s0(m, orig, dirs)
    mesh.closest_cuda, mesh.shadow_cuda = closest_cuda, shadow_cuda

    def undo():
        mesh.closest_cuda, mesh.shadow_cuda = c0, s0
    return undo


def read(t):
    bound = t.recorded.get(KEY)
    if not t.units or not bound:
        return None
    dev = sum(s for k, s in t.units[0].kernels.items() if KERNELS.search(k))
    return 100.0 * bound / dev if dev > 0 else None
