"""The port's gradient path against the JAX package on the CPU, through
the unrolled trace: glass_spheres at 12x6, depth 5, float64, the MSE of
`pixel_colors` against the frame at 0.9x plus 0.01.

Tolerances: every key of `split_params` agrees with `jax.grad` to 1e-9 of
the field's largest |g| plus 1e-12 (the largest difference seen is
~1e-17: the two packages run the same per-lane arithmetic, and the
frameworks round a pow or a sqrt one ulp apart). The finite differences
keep the JAX package's own eps and rtol (tests/test_grad.py). One Adam
step from a converted optax state agrees with optax's to 1e-10.

Gradients that differ from the JAX package's by design, none of which
this frame reaches: `uv_radial_gradient` takes |u| where the JAX package
takes sqrt(u*u), so at u = 0 the port's gradient is finite where JAX's is
NaN (ROADMAP C3, tests/test_torch_patterns.py); CSG orders its hits by
one stable sort, the float64 quartic takes `_cbrt`, and the port's
`read_png` is no part of any gradient. As in the JAX package,
`build_statics` runs once on the starting scene, so no gradient flows
through the refractive index table of the containers walk (`prim_ni`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from tests.grad_fixture import PARAM_KEYS, Frame, assert_grad_close

torch.set_num_threads(1)

W, H = 12, 6


@pytest.fixture(scope="module")
def unrolled():
    frame = Frame(tdemo.glass_spheres(W, H))
    target = frame.target()
    jloss, jgrads = frame.jax_grads(target)
    tloss, tgrads = frame.port_grads(target)
    return frame, target, (jloss, jgrads), (tloss, tgrads)


def test_split_params_keys_match_jax(unrolled):
    frame = unrolled[0]
    assert tuple(sorted(frame.params)) == PARAM_KEYS
    assert tuple(sorted(frame.jparams)) == PARAM_KEYS
    assert set(frame.static["fields"]) == set(frame.jstatic["fields"])
    for k, p in frame.params.items():
        assert p.requires_grad and p.is_leaf, k
        assert torch.equal(p.detach(), getattr(frame.ir, k)), k
        assert p.data_ptr() != getattr(frame.ir, k).data_ptr() or \
            p.numel() == 0, k
    merged = ttrain.merge_params(frame.params, frame.static)
    assert merged.meta == frame.ir.meta
    assert merged.mat_Kd is frame.params["mat_Kd"]


def test_loss_matches_jax(unrolled):
    _, _, (jloss, _), (tloss, _) = unrolled
    assert tloss > 0.0
    assert abs(tloss - jloss) <= 1e-12 * jloss


@pytest.mark.parametrize("key", PARAM_KEYS)
def test_unrolled_gradients_match_jax(unrolled, key):
    _, _, (_, jgrads), (_, tgrads) = unrolled
    assert np.all(np.isfinite(tgrads[key]))
    assert_grad_close(tgrads[key], jgrads[key], key)


def test_gradients_reach_every_kind_of_parameter(unrolled):
    """Material, light and transform tables all get a nonzero gradient on
    this frame (it evaluates no pattern, ROADMAP C5)."""
    tgrads = unrolled[3][1]
    for k in ("mat_Ka", "mat_Kd", "mat_Ks", "mat_Tf", "mat_refl", "mat_Ns",
              "mat_Tr", "light_intensity", "light_points", "inv_tf"):
        assert np.abs(tgrads[k]).max() > 0.0, k


def _fd_check(frame, target, name, idx, eps, rtol):
    """Central finite difference on one entry of params[name], through
    the port alone (tests/test_grad.py's _fd_check)."""
    params = frame.params
    loss, _ = frame.port_loss(params, target)
    (g,) = torch.autograd.grad(loss, [params[name]], allow_unused=True)
    if g is None:           # light_pos: a point light reads light_points
        g = torch.zeros_like(params[name])
    base = params[name].detach()

    def at(v):
        p2 = dict(params)
        arr = base.clone()
        arr[idx] = v
        p2[name] = arr
        with torch.no_grad():
            return float(frame.port_loss(p2, target)[0])

    fd = (at(base[idx] + eps) - at(base[idx] - eps)) / (2 * eps)
    an = float(g[idx])
    assert np.isclose(an, fd, rtol=rtol, atol=1e-9), (name, idx, an, fd)
    return an


@pytest.mark.parametrize("name,idx", [
    ("mat_Kd", (1, 0)), ("mat_Ks", (1, 1)), ("mat_refl", (2, 0)),
    ("mat_Ns", (1,)), ("light_intensity", (0, 1)), ("light_pos", (0, 0))])
def test_gradients_match_fd(unrolled, name, idx):
    frame, target = unrolled[:2]
    an = _fd_check(frame, target, name, idx, 3e-5, 2e-3)
    if name in ("mat_Kd", "light_intensity"):
        assert an != 0.0, f"{name} gradient unexpectedly zero"


def test_transform_gradients_match_fd(unrolled):
    """Through a primitive's inverse transform: the translation column of
    the second primitive (tests/test_grad.py)."""
    frame = unrolled[0]
    an = _fd_check(frame, frame.target(0.9, 0.0), "inv_tf", (1, 0, 3),
                   3e-5, 5e-3)
    assert an != 0.0


def test_overflow_flag(unrolled):
    """Fault C2: pixel_colors and the train step return the bucketed
    trace's overflow flag. Buckets too small set it; buckets calibrated
    by one spawn-count probe at 1.2x do not."""
    frame, target = unrolled[:2]
    small = (8,) * frame.depth
    counts = tintg.spawn_counts(frame.ir, frame.rt, *trender.rays_for_pixels(
        frame.cam, *frame.args), frame.depth)
    calibrated = trender.quantize_buckets([int(c) for c in counts], 1.2)
    assert max(int(c) for c in counts) > 8
    for buckets, want in ((small, True), (calibrated, False)):
        with torch.no_grad():
            _, ovf = frame.colors(buckets=buckets)
        assert ovf.dtype == torch.bool and ovf.shape == ()
        assert bool(ovf) is want
        params = {k: v.detach().clone().requires_grad_(k == "mat_Kd")
                  for k, v in frame.params.items()}
        init, step = ttrain.make_train_step(
            frame.rt, frame.cam, frame.static, 1, frame.depth,
            buckets=buckets)
        _, loss, ovf = step(init(params), *frame.args,
                            torch.as_tensor(target))
        assert bool(ovf) is want and bool(torch.isfinite(loss))
    _, ovf = frame.colors()
    assert not bool(ovf)


def test_adam_step_matches_optax(unrolled):
    """Four optax.adam(1e-2) updates on the JAX gradients; the optax state
    after the third, converted by train_state_from_numpy, takes the port's
    fourth torch.optim.Adam step to optax's fourth within 1e-10."""
    frame, _, (_, jgrads), _ = unrolled
    params = {k: jnp.asarray(v) for k, v in frame.jparams.items()}
    grads = {k: jnp.asarray(v) for k, v in jgrads.items()}
    opt = optax.adam(1e-2)
    st = opt.init(params)
    for i in range(4):
        if i == 3:
            adam_st = st[0]
            state = ttrain.train_state_from_numpy(
                {k: np.asarray(v) for k, v in params.items()},
                {k: np.asarray(v) for k, v in adam_st.mu.items()},
                {k: np.asarray(v) for k, v in adam_st.nu.items()},
                int(adam_st.count), "cpu", torch.float64)
        upd, st = opt.update(grads, st, params)
        params = optax.apply_updates(params, upd)
    assert int(st[0].count) == 4
    for k, p in state.params.items():
        p.grad = torch.as_tensor(jgrads[k])
    state.optimizer.step()
    moved = 0
    for k in PARAM_KEYS:
        got = state.params[k].detach().numpy()
        want = np.asarray(params[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                   err_msg=k)
        moved += int(np.any(want != np.asarray(frame.jparams[k])))
    assert moved >= 10


def test_train_step_recovers_material(unrolled):
    """Inverse rendering through the port alone: optimizing only mat_Kd
    against a target rendered with mat_Kd scaled by 0.6 cuts the loss more
    than 10x in 40 Adam steps (tests/test_grad.py)."""
    frame = unrolled[0]
    p2 = dict(frame.params)
    p2["mat_Kd"] = frame.params["mat_Kd"].detach() * 0.6
    target = torch.as_tensor(frame.target(1.0, 0.0, params=p2))
    params = {k: v.detach().clone().requires_grad_(k == "mat_Kd")
              for k, v in frame.params.items()}
    init, step = ttrain.make_train_step(frame.rt, frame.cam, frame.static,
                                        1, frame.depth)
    state = init(params)
    assert len(state.optimizer.param_groups[0]["params"]) == 1
    losses = []
    for _ in range(40):
        state, loss, ovf = step(state, *frame.args, target)
        assert not bool(ovf)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    for k, v in state.params.items():
        if k != "mat_Kd":
            assert torch.equal(v, frame.params[k].detach()), k
