"""The port's gradients through photon-mapped GI against the JAX package on
the CPU, in float64 with one torch thread:

- live_photon_powers on the JAX package's traced maps (trace_photons, fed
  to the port's build_photon_map with their provenance), on the Cornell
  box and on the box with a Kd-patterned floor (EV_MAPPED events): with
  the channel mean rounded as JAX's jit rounds it (the sum times 1/3;
  torch divides the sum by 3 on the CPU, and so does the port's bounce
  wave), every stored power bit for bit; with torch's mean, bit for bit
  on every photon whose chain holds no specular or transmitted event and
  within two ulps on the others. On the port's own traced maps, in float64
  and float32, live equals stored bit for bit (the contract: the replay
  runs the bounce wave's operations in its order);
- with_live_power and make_gi_hook's live_power: a map without
  provenance comes back as it is, the bound hook (live powers computed
  once per pixel_colors call) gives the unbound hook's numbers;
- a light_intensity gradient flows through the estimate from the stored
  power alone (the counterpart of test_grad_gi.py's), and the photon pass
  records no autograd graph;
- the estimate's gradient in the query points matches the JAX package's
  on a map whose queries fill their heaps (r^2 = the kth-nearest d^2,
  which carries no gradient in either package);
- the 8x8 Cornell GI frame (no mesh block; 2,000 photons a map, a 2x2
  final gather, an estimate of 50, caustics, the jittered 10x10 light,
  depth 2) through the bucketed wavefront with live photon powers, fed
  the same maps and JAX's draws (scene_convert.JaxKeys): the forwards
  within 1e-9, then every key of split_params within 1e-9 of the field's
  largest |g| plus 1e-12. Depth 2 keeps the JAX side's one jit of the
  gradient at ~30 s (depth 5 takes ~65 s on this host), compiled with
  XLA's cheap optimization level (~40% less compile time, the same
  numbers to 1e-15). A ray along the seam of two walls ties two planes
  exactly; both packages split its t's cotangent between them
  (ops/intersect.closest_hit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.parallel import train as jtrain
from fast_ray_tracer_tpu.render import photon as jph
from fast_ray_tracer_tpu.render import render as jrender
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import photon as tph
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel

from scene_convert import JaxKeys, convert
from tests.grad_fixture import PARAM_KEYS, Frame, assert_grad_close

torch.set_num_threads(1)

F64 = torch.float64
W = H = 8
PHOTONS = 2000
DEPTH = 2
# XLA's cheap optimization level for the JAX side's one gradient jit
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def gi_scene(w=W, h=H, patterned=False, **cfg):
    """cornell_box without the mesh block: PHOTONS photons a map, a 2x2
    final gather, an estimate of 50 (test_grad_gi.py's settings), depth
    DEPTH; with `patterned` a checker in the floor's Kd slot."""
    sc = tdemo.cornell_box(w, h, mesh=False)
    sc.config = dataclasses.replace(sc.config, **{
        "photon_count": PHOTONS, "gi_usteps": 2, "gi_vsteps": 2,
        "irradiance_estimate_num": 50, "di_path_length": DEPTH, **cfg})
    if patterned:
        floor = sc.world[0]
        sc.world[0] = dataclasses.replace(
            floor, material=dataclasses.replace(floor.material, patterns={
                "map_Kd": tmodel.PatternDesc(
                    kind="checker", colors=[(0.5, 0.5, 0.5),
                                            (0.8, 0.8, 0.8)],
                    transform=[["scale", 0.25, 0.25, 0.25]])}))
    return sc


def port_map(jpm):
    """The port's PhotonMap of a JAX PhotonMap's photons and provenance:
    each photon's record read back from its packed row or overflow slot
    (slot_photon / ovf_photon), in the JAX map's photon order."""
    n, P = jpm.n, jph.P_PACK
    pk = np.asarray(jpm.packed)
    sp = np.asarray(jpm.slot_photon)
    live = sp < n
    out = [np.zeros((n, 3)) for _ in range(3)]
    for j, a in enumerate(out):
        for c in range(3):
            a[sp[live], c] = pk[:, (3 * j + c) * P:(3 * j + c + 1) * P][live]
    op = np.asarray(jpm.ovf_photon)
    ol = op < n
    for a, src in zip(out, (jpm.ovf_pos, jpm.ovf_power, jpm.ovf_dir)):
        a[op[ol]] = np.asarray(src)[ol]
    prov = {"light": np.asarray(jpm.prov_light),
            "mat": np.asarray(jpm.prov_mat),
            "code": np.asarray(jpm.prov_code),
            "samp": None if jpm.prov_samp is None
            else np.asarray(jpm.prov_samp)}
    return tph.build_photon_map(*out, jpm.cell_size, F64, "cpu", prov=prov,
                                power_div=jpm.power_div)


def jax_maps(frame, caustic=True):
    """The JAX package's trace_photons maps of a Frame's scene at key 7."""
    return jph.trace_photons(frame.jir, frame.jrt, jax.random.PRNGKey(7),
                             jnp.float64, caustic=caustic, global_=True)


@pytest.fixture(scope="module")
def cornell():
    """The GI frame in both packages with the JAX maps (caustic and
    global) and their port copies."""
    frame = Frame(gi_scene())
    jmaps = jax_maps(frame)
    tmaps = {m: port_map(pm) for m, pm in jmaps.items()}
    return frame, jmaps, tmaps


@pytest.fixture(scope="module")
def patterned():
    """The Kd-patterned box's global map in both packages."""
    frame = Frame(gi_scene(patterned=True))
    jpm = jax_maps(frame, caustic=False)[jph.GLOBAL]
    return frame, port_map(jpm)


def _jax_rounded_mean(self, dim):
    return self.sum(dim) * (1.0 / 3.0)


@pytest.mark.parametrize("case", ["caustic", "global", "patterned"])
def test_live_powers_match_jax_maps(cornell, patterned, case, monkeypatch):
    if case == "patterned":
        frame, pm = patterned
        assert bool((pm.prov_code >= tph.EV_MAPPED).any())
    else:
        frame, _, tmaps = cornell
        pm = tmaps[tph.CAUSTIC if case == "caustic" else tph.GLOBAL]
    assert pm.n == PHOTONS
    live = tph.live_photon_powers(pm, frame.ir)
    base = pm.prov_code % tph.EV_MAPPED
    div = ((base == tph.EV_SPEC) | (base == tph.EV_TRANS)).any(-1)
    same = (live == pm.power).all(-1)
    assert bool(same[~div].all())
    ulp = np.spacing(np.abs(pm.power.numpy()))
    assert np.all(np.abs((live - pm.power).numpy()) <= 2 * ulp)
    if case == "caustic":
        assert bool(div.all())               # every caustic photon has one
    monkeypatch.setattr(torch.Tensor, "mean", _jax_rounded_mean)
    assert torch.equal(tph.live_photon_powers(pm, frame.ir), pm.power)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_live_powers_match_port_maps(dtype):
    """The port's own photon pass (both maps, the patterned floor): live
    powers bitwise the stored ones; the chains hold every event kind."""
    sc = gi_scene(patterned=True, photon_count=1500)
    ir = tcomp.compile_scene(sc, dtype=dtype, device="cpu")
    maps = tph.trace_photons(ir, tintg.build_statics(ir, sc.config),
                             RNG(4), dtype, caustic=True, global_=True,
                             batch=4096)
    codes = set()
    for pm in maps.values():
        assert pm.power.dtype == dtype
        assert torch.equal(tph.live_photon_powers(pm, ir), pm.power)
        codes |= set(torch.unique(pm.prov_code).tolist())
    assert {tph.EV_KD, tph.EV_KD + tph.EV_MAPPED, tph.EV_SPEC,
            tph.EV_TRANS} <= codes


def test_live_power_hook(cornell):
    frame, _, tmaps = cornell
    pm = tmaps[tph.GLOBAL]
    bare = pm._replace(prov_mat=None)
    assert tph.with_live_power(bare, frame.ir) is bare
    assert tph.with_live_power(None, frame.ir) is None
    params, static = ttrain.split_params(frame.ir)
    ir = ttrain.merge_params(params, static)
    live = tph.with_live_power(pm, ir)
    assert live.power.requires_grad and torch.equal(live.power.detach(),
                                                    pm.power)
    assert live.pos is pm.pos and live.row_start is pm.row_start
    cfg = frame.rt.cfg
    assert not hasattr(tph.make_gi_hook(tmaps, cfg), "bind")
    hook = tph.make_gi_hook(tmaps, cfg, live_power=True)
    comps = tintg.prepare_computations(ir, frame.rt, *_rays(frame))
    a = hook(ir, frame.rt, comps, RNG(1))
    b = hook.bind(ir)(ir, frame.rt, comps, RNG(1))
    assert torch.equal(a, b) and a.requires_grad
    assert float(a.detach().abs().max()) > 0.0
    assert not hasattr(hook.bind(ir), "bind")


def _rays(frame):
    from fast_ray_tracer_tpu_torch.render import camera as tcam
    return tcam.rays_for_pixels(frame.cam, *frame.args)


def test_gi_gradient_flows_from_stored_power_alone(cornell):
    """The tracing side alone: queries at the map's photons, facing
    them; d(sum of the estimate)/d(light_intensity) through the live
    powers is nonzero."""
    frame, _, tmaps = cornell
    pm = tmaps[tph.GLOBAL]
    pts, eye = pm.pos, -pm.dirs
    cfg = frame.rt.cfg
    inten = frame.ir.light_intensity.clone().requires_grad_(True)
    ir = dataclasses.replace(frame.ir, light_intensity=inten)
    irr, found = tph.irradiance_estimate(
        tph.with_live_power(pm, ir), pts, eye,
        cfg.irradiance_estimate_num, cfg.irradiance_estimate_radius,
        cfg.irradiance_estimate_cone_filter_k)
    assert int((found >= 8).sum()) > 0
    g, = torch.autograd.grad(irr.sum(), [inten])
    assert float(g.abs().sum()) > 0.0


def test_photon_pass_records_no_graph():
    sc = gi_scene(photon_count=500)
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    params, static = ttrain.split_params(ir)
    ir = ttrain.merge_params(params, static)
    maps = tph.trace_photons(ir, tintg.build_statics(ir, sc.config), RNG(2),
                             F64, caustic=True, global_=True, batch=4096)
    for pm in maps.values():
        for name in ("pos", "power", "dirs", "prov_samp"):
            x = getattr(pm, name)
            assert x is None or not x.requires_grad, name


def test_estimate_point_gradient_matches_jax():
    """d(sum of the estimate)/d(query points) on an oversubscribed map
    (most queries fill their heap, so r^2 is the kth-nearest d^2): the
    JAX package's bisected r^2 carries no gradient, nor does the port's
    kthvalue; within 1e-9 of the largest |g|."""
    rng = np.random.default_rng(5)
    N, Q = 3000, 64
    pos = rng.uniform(-1, 1, (N, 3))
    pos[:, 2] *= 0.05
    power = rng.uniform(0, 1, (N, 3))
    dirs = rng.normal(size=(N, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = rng.uniform(-0.8, 0.8, (Q, 3))
    pts[:, 2] *= 0.05
    eye = rng.normal(size=(Q, 3))
    eye /= np.linalg.norm(eye, axis=1, keepdims=True)
    radius, num, cone_k = 0.25, 64, 1.0
    jpm = jph.build_photon_map(pos, power, dirs, radius, jnp.float64)
    grad = jax.jit(jax.grad(lambda p: jph.irradiance_estimate(
        jpm, p, jnp.asarray(eye), num, radius, cone_k)[0].sum())).lower(
            jnp.asarray(pts)).compile()
    want = np.asarray(grad(jnp.asarray(pts)))
    tpm = tph.build_photon_map(pos, power, dirs, radius, F64, "cpu")
    p = torch.from_numpy(pts).requires_grad_(True)
    irr, found = tph.irradiance_estimate(tpm, p, torch.from_numpy(eye), num,
                                         radius, cone_k)
    assert int((found == num).sum()) > Q // 2
    got, = torch.autograd.grad(irr.sum(), [p])
    assert_grad_close(got.numpy(), want, "points")
    assert float(np.abs(want).max()) > 0.0


@pytest.fixture(scope="module")
def frame_grads(cornell):
    """Both packages' loss, frame and gradients of the GI frame, the
    same maps and draws, live photon powers, bucketed."""
    frame, jmaps, tmaps = cornell
    jcfg = convert(frame.rt.cfg, jmodel)
    frame.jrt = frame.jrt._replace(gi_hook=jph.make_gi_hook(
        jmaps, jcfg, live_power=True))
    frame.rt = frame.rt._replace(gi_hook=tph.make_gi_hook(
        tmaps, frame.rt.cfg, live_power=True))
    key = jax.random.PRNGKey(3)
    buckets = tintg.default_buckets(frame.n, frame.depth)
    target = frame.target(rng=JaxKeys(key), buckets=buckets)
    jt = jnp.asarray(target)

    def loss(p):
        img = jrender.pixel_colors(
            jtrain.merge_params(p, frame.jstatic), frame.jrt, frame.jcam,
            *frame.np_args, 1, frame.depth, key, buckets=buckets)
        return jnp.mean((img - jt) ** 2), img

    run = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        frame.jparams).compile(compiler_options=FAST_XLA)
    (jloss, jimg), jgrads = run(frame.jparams)
    with torch.no_grad():
        img, ovf = frame.colors(rng=JaxKeys(key), buckets=buckets)
    assert not bool(ovf)
    tloss, tgrads = frame.port_grads(target, rng=JaxKeys(key),
                                     buckets=buckets)
    return (float(jloss), np.asarray(jimg), {k: np.asarray(v) for k, v in
                                              jgrads.items()},
            tloss, img.numpy(), tgrads)


def test_gi_frame_matches_jax(frame_grads):
    jloss, jimg, _, tloss, img, _ = frame_grads
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-9)
    assert abs(tloss - jloss) <= 1e-9 * jloss and tloss > 0.0


@pytest.mark.parametrize("key", PARAM_KEYS)
def test_gi_frame_gradients_match_jax(frame_grads, key):
    jgrads, tgrads = frame_grads[2], frame_grads[5]
    assert np.all(np.isfinite(tgrads[key]))
    assert_grad_close(tgrads[key], jgrads[key], key)


def test_gi_frame_gradients_reach_the_map(frame_grads):
    """The frame's gradients reach the tables the photon map replays and
    the geometry its queries sit on."""
    tgrads = frame_grads[5]
    for k in ("mat_Kd", "mat_refl", "mat_Tf", "light_intensity", "inv_tf"):
        assert np.abs(tgrads[k]).max() > 0.0, k
