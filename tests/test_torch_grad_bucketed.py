"""The port's gradients through the static-bucket wavefront on the CPU:
glass_spheres at 12x6, depth 5, float64, `default_buckets`, the MSE of
`pixel_colors` against the frame at 0.9x plus 0.01, in every remat mode.

- Against the port's unrolled gradients, to 1e-9 of the field's largest
  |g| plus 1e-12, with the JAX package's one documented exception
  (tests/test_grad.py): the spawn value gates prune subtrees whose Tf or
  refl is exactly zero, so those rows carry subgradient 0 where the
  unrolled trace reports the one-sided derivative.
- Against the JAX package's bucketed gradients with remat="level" (its
  XLA gather compaction: the Pallas kernels are float32 only), to the
  same tolerance on every key, pruned rows included.
- Every remat mode gives bitwise the gradients of "none": a checkpointed
  level recomputes the same operations on the same inputs.
- In float32 the gradients stay finite where the JAX package's have NaN
  (fault C11: a fill row's overflowed quadratic), a difference by design.
"""

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu_torch.ops import intersect
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import ir as IR
from tests.grad_fixture import PARAM_KEYS, Frame, assert_grad_close

torch.set_num_threads(1)

W, H = 12, 6
MODES = ["none", "level", "nested", "dots"]


@pytest.fixture(scope="module")
def bucketed():
    frame = Frame(tdemo.glass_spheres(W, H))
    target = frame.target()
    buckets = tintg.default_buckets(frame.n, frame.depth)
    jax_b = frame.jax_grads(target, remat="level", buckets=buckets)
    unrolled = frame.port_grads(target)
    port = {}

    def port_grads(mode):
        if mode not in port:
            port[mode] = frame.port_grads(target, remat=mode,
                                          buckets=buckets)
        return port[mode]

    return frame, buckets, jax_b, unrolled, port_grads


def _pruned_rows(ir):
    """Materials whose Tf / refl is zero in every channel."""
    return (~np.any(ir.mat_Tf.numpy() != 0.0, axis=-1),
            ~np.any(ir.mat_refl.numpy() != 0.0, axis=-1))


@pytest.mark.parametrize("mode", MODES)
def test_bucketed_gradients_match_unrolled(bucketed, mode):
    frame, buckets, _, (uloss, ugrads), port_grads = bucketed
    loss, grads = port_grads(mode)
    _, ovf = frame.colors(buckets=buckets)
    assert not bool(ovf)
    assert abs(loss - uloss) <= 1e-12 * uloss
    zero_tf, zero_rf = _pruned_rows(frame.ir)
    assert zero_tf.any() and (~zero_tf).any(), "fixture needs both kinds"
    for k in PARAM_KEYS:
        a, b = ugrads[k], grads[k]
        if k == "mat_Tf":
            assert_grad_close(b[~zero_tf], a[~zero_tf], k)
            # pruned rows: the documented subgradient-0 behaviour
            assert np.all(b[zero_tf] == 0.0)
            assert np.any(a[zero_tf] != 0.0)
        elif k == "mat_refl":
            assert_grad_close(b[~zero_rf], a[~zero_rf], k)
        else:
            assert_grad_close(b, a, k)


@pytest.mark.parametrize("mode", MODES)
def test_bucketed_gradients_match_jax(bucketed, mode):
    _, _, (jloss, jgrads), _, port_grads = bucketed
    loss, grads = port_grads(mode)
    assert abs(loss - jloss) <= 1e-12 * jloss
    for k in PARAM_KEYS:
        assert np.all(np.isfinite(grads[k])), k
        assert_grad_close(grads[k], jgrads[k], k)


@pytest.mark.parametrize("mode", ["level", "nested", "dots"])
def test_remat_modes_are_bitwise(bucketed, mode):
    port_grads = bucketed[4]
    base = port_grads("none")[1]
    grads = port_grads(mode)[1]
    for k in PARAM_KEYS:
        assert np.array_equal(grads[k], base[k]), k


@pytest.mark.parametrize("mode", [True, "level", "nested", "dots"])
def test_remat_unrolled_is_bitwise(bucketed, mode):
    """The unrolled trace takes remat too, with the same gradients."""
    frame, _, _, (_, ugrads), _ = bucketed
    target = frame.target()
    _, grads = frame.port_grads(target, remat=mode)
    for k in PARAM_KEYS:
        assert np.array_equal(grads[k], ugrads[k]), k


def test_remat_rejects_unknown_mode(bucketed):
    frame = bucketed[0]
    with pytest.raises(ValueError, match="remat"):
        frame.colors(remat="everything")


@pytest.mark.parametrize("typ", [IR.SPHERE, IR.CYLINDER, IR.CONE])
def test_overflowed_quadratics_keep_gradients_finite(typ):
    """Fault C11: a fill row (origin 1e30) overflows a quadratic's c in
    float32. The lane stays rootless, and the backward stays finite where
    the JAX package's makes NaN (0 * inf in the product a * c)."""
    f32 = torch.float32
    o = torch.tensor([[[1e30, 1e30, 1e30]], [[0.1, 0.5, -4.0]]], dtype=f32,
                     requires_grad=True)
    d = torch.tensor([[[1.0, 1.0, 1.0]], [[0.0, 0.01, 1.0]]], dtype=f32,
                     requires_grad=True)
    params = torch.tensor([[[-1.0, 1.0, 1.0, 0.0]]], dtype=f32)
    t = intersect._LOCAL_T[typ](o, d, params)
    def hits(x):
        return torch.isfinite(x) & (x > 0)
    assert not bool(hits(t[0]).any()) and bool(hits(t[1]).any())
    torch.where(torch.isfinite(t), t, 0.0).sum().backward()
    assert bool(torch.isfinite(o.grad).all() & torch.isfinite(d.grad).all())
    assert float(d.grad[1].abs().max()) > 0.0


def test_float32_bucketed_gradients_are_finite():
    """The whole float32 frame through the bucketed trace: every
    parameter's gradient finite (fault C11)."""
    scene = tdemo.glass_spheres(W, H)
    ir = tcomp.compile_scene(scene, dtype=torch.float32, device="cpu")
    rt = tintg.build_statics(ir, scene.config)
    cam = tcam.build_camera(scene.camera, dtype=torch.float32, device="cpu")
    n = W * H
    args = (torch.arange(W).repeat(H), torch.arange(H).repeat_interleave(W),
            torch.full((n, 2), 0.5), torch.zeros((n, 2)))
    params, static = ttrain.split_params(ir)
    img, ovf = trender.pixel_colors(
        ttrain.merge_params(params, static), rt, cam, *args, 1, 5,
        buckets=tintg.default_buckets(n, 5), remat="level")
    assert not bool(ovf)
    (img ** 2).mean().backward()
    for k, p in params.items():
        if p.grad is not None:
            assert bool(torch.isfinite(p.grad).all()), k
    assert float(params["inv_tf"].grad.abs().max()) > 0.0


def test_dots_policy_saves_matrix_products():
    """"dots" keeps matrix-product outputs and recomputes the rest; the
    policy sees operator overloads."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        assert tintg._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.mul.Tensor, aten.sqrt.default, aten.where.self):
        assert tintg._dots_policy(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE
