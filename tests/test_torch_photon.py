"""The port's photon-mapped GI against the JAX package on the CPU, in
float64, with the JAX side's draws fed to the port (scene_convert.JaxKeys)
where a module draws:

- the CIE-Lab lightness and the photon apportioning, to 1e-12 / exactly;
- emit_photons for point, area, circle and hemisphere lights, to 1e-12;
- photon_bounce_wave on a 2,000-photon batch of the Cornell box (a Kd
  pattern on the floor, so the chains record samples) in both maps: the
  store masks and provenance chains exactly, positions, powers and
  directions to 1e-12 relative (positions reach |x| ~ 10 in the box's
  open tunnel after five bounces; absolute 1e-12 past that); in float32 every output stays finite (parked
  photons sit on the compaction's fill row);
- build_photon_map fed the JAX map's own arrays, and irradiance_estimate
  against the JAX package's and the brute-force oracle of
  tests/test_photon_map.py within 1e-9, for sparse and oversubscribed
  maps, also when the query budget cuts many blocks;
- lighting_gi (also in visualize mode), lighting_caustics and
  final_gather on the same comps and map, within 1e-9;
- a 32x32 Cornell frame with the JAX maps, caustics and visualization
  and an unjittered light, within 1e-9;
- statistically: trace_photons stores exactly each light's target, and
  each map's mean stored power agrees with the JAX package's within five
  standard errors (sample variances of both maps' stored powers); the
  final-gather frame on the same maps has the JAX frame's mean within
  five standard errors of the per-pixel differences (given the maps the
  pixels' draws are independent);
- the Cornell box's YAML loads field for field as the JAX loader loads
  it, and the command line renders it at 16x16 on the CPU from --seed,
  the same bytes for the same seed.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu import colors as jcolors
from fast_ray_tracer_tpu.ops import compact_pallas
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.render import photon as jph
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
from fast_ray_tracer_tpu.scene import yaml_loader as jyaml

from fast_ray_tracer_tpu_torch import colors as tcolors
from fast_ray_tracer_tpu_torch.__main__ import main as cli_main
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import photon as tph
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene import yaml_loader as tyaml

from scene_convert import JaxKeys, convert

torch.set_num_threads(1)

F64 = torch.float64
N_BATCH = 2000        # photons per bounce batch
N_BATCHES = 8         # batches stored into the fixture's maps


def test_lab_and_targets_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.0, 2.0, (50, 3))
    rgb[:5] *= 1e-3                      # the linear branch of the lightness
    np.testing.assert_allclose(tcolors.rgb_to_lab(rgb),
                               np.asarray(jcolors.rgb_to_lab(rgb)), rtol=0,
                               atol=1e-12)
    sc = tmodel.SceneDesc(
        camera=tmodel.CameraDesc(width=4, height=4, field_of_view=1.0),
        lights=[tmodel.LightDesc(kind="point", at=(0.0, 5.0, 0.0),
                                 intensity=tuple(c)) for c in rgb[:4]],
        world=[tmodel.ShapeDesc(kind="plane")],
        config=tmodel.ConfigDesc(photon_count=99991))
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    lv = [float(np.asarray(jcolors.rgb_to_lab(np.asarray(c)))[0])
          for c in rgb[:4]]
    assert tph.photon_targets(ir, 99991) == \
        [int(99991 * v / sum(lv)) for v in lv]


LIGHTS = [
    tmodel.LightDesc(kind="point", at=(-5.0, 3.0, -6.0),
                     intensity=(0.15, 0.12, 0.1)),
    tmodel.LightDesc(kind="area", corner=(-3.0, 5.0, -4.0),
                     uvec=(2.0, 0.0, 0.5), vvec=(0.0, 0.4, 1.5), usteps=3,
                     vsteps=2, intensity=(0.6, 0.6, 0.55)),
    tmodel.LightDesc(kind="circle", at=(4.0, 4.0, -2.0), to=(0.0, 0.5, 0.0),
                     radius=0.7, usteps=2, vsteps=3,
                     intensity=(0.3, 0.35, 0.45)),
    tmodel.LightDesc(kind="hemisphere", at=(0.5, 7.0, 1.0),
                     to=(0.0, 0.0, 0.0), intensity=(0.2, 0.2, 0.2)),
]


@pytest.mark.parametrize("li", range(4), ids=["point", "area", "circle",
                                             "hemisphere"])
def test_emit_photons_match_jax(li):
    sc = tmodel.SceneDesc(
        camera=tmodel.CameraDesc(width=4, height=4, field_of_view=1.0),
        lights=list(LIGHTS), world=[tmodel.ShapeDesc(kind="plane")],
        config=tmodel.ConfigDesc())
    jir = jcomp.compile_scene(convert(sc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    key = jax.random.PRNGKey(100 + li)
    n = 3000
    jo, jd = jph.emit_photons(jir, li, key, n, jnp.float64)
    to, td = tph.emit_photons(tir, li, *tph.draw_emission(
        tir, li, JaxKeys(key), n, F64))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=1), 1.0,
                               rtol=0, atol=1e-12)


def _gi_scene(w, h, mesh=False, **cfg):
    """The Cornell box (without the mesh block by default) with a checker
    pattern on the floor's Kd, its light cut to 4x4 samples, and config
    overrides."""
    sc = tdemo.cornell_box(w, h, mesh=mesh)
    sc.lights = [dataclasses.replace(sc.lights[0], usteps=4, vsteps=4)]
    floor = sc.world[0]
    sc.world[0] = dataclasses.replace(floor, material=dataclasses.replace(
        floor.material, patterns={"map_Kd": tmodel.PatternDesc(
            kind="checker", colors=[(0.5, 0.5, 0.5), (0.8, 0.8, 0.8)],
            transform=[["scale", 0.25, 0.25, 0.25]])}))
    sc.config = dataclasses.replace(sc.config, photon_count=N_BATCH
                                    * N_BATCHES, **cfg)
    return sc


def _stored_arrays(bounces, num):
    """(pos, power / num, dirs, store) of one bounce wave as numpy."""
    pos, pw, dr, st = (np.asarray(x) for x in bounces[:4])
    return pos[st], pw[st] / float(num), dr[st]


@pytest.fixture(scope="module")
def gi():
    """Both packages' IR of the Cornell box and, per map, the JAX bounce
    wave of N_BATCHES batches of N_BATCH photons (the first one kept
    whole), with the stored photons of all of them."""
    tsc = _gi_scene(16, 16)
    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    tir = tcomp.compile_scene(tsc, dtype=F64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    power = jnp.broadcast_to(jir.light_intensity[0][None], (N_BATCH, 3))
    out = {}
    for map_type in (jph.CAUSTIC, jph.GLOBAL):
        wave = jax.jit(lambda k, m=map_type: jph.photon_bounce_wave(
            jir, jrt, m, *jph.emit_photons(jir, 0, k, N_BATCH, jnp.float64),
            power, jax.random.fold_in(k, 1)))
        batches, stored = [], []
        for b in range(N_BATCHES):
            k = jax.random.PRNGKey(1000 * map_type + b)
            res = wave(k)
            if b == 0:
                batches.append((k, res))
            stored.append(_stored_arrays(res, tsc.config.photon_count))
        out[map_type] = {"first": batches[0], "stored": [
            np.concatenate([s[i] for s in stored]) for i in range(3)]}
    return {"tsc": tsc, "jsc": jsc, "jir": jir, "jrt": jrt, "tir": tir,
            "trt": trt, "maps": out}


@pytest.mark.parametrize("map_type", [jph.CAUSTIC, jph.GLOBAL],
                         ids=["caustic", "global"])
def test_bounce_wave_matches_jax(gi, map_type):
    tir, trt = gi["tir"], gi["trt"]
    k, want = gi["maps"][map_type]["first"]
    L = gi["tsc"].config.gi_path_length
    kk = JaxKeys(k)
    o, d = tph.emit_photons(tir, 0, *tph.draw_emission(tir, 0, kk, N_BATCH,
                                                       F64))
    power = tir.light_intensity[0][None].expand(N_BATCH, 3)
    got = tph.photon_bounce_wave(tir, trt, map_type, o, d, power,
                                 *tph.draw_bounces(kk.fold(1), N_BATCH, L,
                                                   F64))
    st = np.asarray(want[3])
    assert np.array_equal(got.store.numpy(), st)
    assert st.sum() > (10 if map_type == jph.CAUSTIC else 1000)
    for name, g, w in zip(("pos", "power", "dirs"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert np.array_equal(got.chain_mat.numpy(), np.asarray(want[4]))
    assert np.array_equal(got.chain_code.numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(got.chain_samp.numpy(), np.asarray(want[6]),
                               rtol=0, atol=1e-12)
    # the chains hold every event kind of the map's path
    codes = set(np.unique(got.chain_code.numpy()[st]))
    want_codes = {tph.EV_KD, tph.EV_KD + tph.EV_MAPPED, tph.EV_SPEC}
    if map_type == jph.CAUSTIC:
        want_codes.add(tph.EV_TRANS)
    assert want_codes <= codes


def test_bounce_wave_float32_stays_finite(gi):
    """Parked photons (1e30, the fill row) run through every intersector
    in float32: each output row stays finite."""
    tsc = gi["tsc"]
    tir = tcomp.compile_scene(tsc, dtype=torch.float32, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    L = tsc.config.gi_path_length
    rng = RNG(3)
    for map_type in (tph.CAUSTIC, tph.GLOBAL):
        o, d = tph.emit_photons(tir, 0, *tph.draw_emission(
            tir, 0, rng.fold(map_type), N_BATCH, torch.float32))
        got = tph.photon_bounce_wave(
            tir, trt, map_type, o, d,
            tir.light_intensity[0][None].expand(N_BATCH, 3),
            *tph.draw_bounces(rng.fold(9), N_BATCH, L, torch.float32))
        for name in ("pos", "power", "dirs", "chain_samp"):
            assert bool(torch.isfinite(getattr(got, name)).all()), name
        parked = (got.pos[N_BATCH:] > 1e29).all(-1)
        assert bool(parked.any())          # some photons did die


def jax_map_arrays(pm):
    """The stored photons of a JAX PhotonMap: (pos, power, dirs) from its
    packed rows and its overflow block (dead lanes dropped)."""
    P = jph.P_PACK
    pk = np.asarray(pm.packed)
    f = [pk[:, i * P:(i + 1) * P].reshape(-1) for i in range(9)]
    live = f[0] < 1e29
    ovf = np.asarray(pm.ovf_pos)[:, 0] < 1e29
    return tuple(np.concatenate([np.stack(f[3 * i:3 * i + 3], -1)[live],
                                 np.asarray(a)[ovf]])
                 for i, a in enumerate((pm.ovf_pos, pm.ovf_power,
                                        pm.ovf_dir)))


def _oracle(pos, power, dirs, pts, eye, radius, num, cone_k):
    """tests/test_photon_map.py's brute-force pm_irradiance_estimate."""
    md2 = radius * radius
    out, founds = [], []
    for q in range(len(pts)):
        d2 = ((pos - pts[q]) ** 2).sum(1)
        inr = d2 < md2
        n = int(inr.sum())
        sel = sorted(np.nonzero(inr)[0], key=lambda i: d2[i])[:num]
        r2 = d2[sel[-1]] if n >= num else md2
        s = np.zeros(3)
        for i in sel:
            if dirs[i] @ eye[q] < 0:
                s += power[i] * (1 - np.sqrt(d2[i]) / (cone_k * radius))
        s /= (1 - 2 / (3 * cone_k)) * np.pi * r2
        out.append(s if min(n, num) >= 8 else np.zeros(3))
        founds.append(min(n, num))
    return np.asarray(out), np.asarray(founds)


@pytest.mark.parametrize("layout", ["flat", "capped"])
@pytest.mark.parametrize("concentrate", [False, True],
                         ids=["sparse", "oversubscribed"])
def test_irradiance_estimate_matches_jax_and_oracle(concentrate, layout,
                                                    monkeypatch):
    rng = np.random.default_rng(3)
    N = 5000
    pos = rng.uniform(-1, 1, (N, 3))
    if concentrate:
        pos[:, 2] *= 0.05
    power = rng.uniform(0, 1, (N, 3))
    dirs = rng.normal(size=(N, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius, num, cone_k = 0.25, 64, 1.0
    jpm = jph.build_photon_map(pos, power, dirs, radius, jnp.float64,
                               layout=layout)
    # the port's map from the JAX map's own arrays
    tpm = tph.build_photon_map(*jax_map_arrays(jpm), radius, F64, "cpu")
    assert tpm.n == N
    Q = 200
    pts = rng.uniform(-1, 1, (Q, 3))
    if concentrate:
        pts[:, 2] *= 0.05
    pts[:3] = [[5.0, 5.0, 5.0], [1e30, 1e30, 1e30], [-1.2, 0.0, 0.0]]
    eye = rng.normal(size=(Q, 3))
    eye /= np.linalg.norm(eye, axis=1, keepdims=True)
    jirr, jfound = jph.irradiance_estimate(jpm, jnp.asarray(pts),
                                           jnp.asarray(eye), num, radius,
                                           cone_k)
    irr, found = tph.irradiance_estimate(tpm, torch.from_numpy(pts),
                                         torch.from_numpy(eye), num, radius,
                                         cone_k)
    # a query parked at 1e30 meets the JAX map's dead packed lanes, which
    # sit at 1e30 with zero power: they count in its `found` (ROADMAP C),
    # never in its estimate; the port and the oracle find nothing there
    live = pts[:, 0] < 1e29
    assert np.array_equal(found.numpy()[live], np.asarray(jfound)[live])
    np.testing.assert_allclose(irr.numpy(), np.asarray(jirr), rtol=1e-9,
                               atol=1e-12)
    want, wfound = _oracle(pos, power, dirs, pts, eye, radius, num, cone_k)
    assert np.array_equal(found.numpy(), wfound)
    np.testing.assert_allclose(irr.numpy(), want, rtol=1e-9, atol=1e-12)
    if concentrate:
        assert (wfound >= num).sum() > Q // 2   # the heap fills: r2 = kth
    # a budget of a few queries per block: the same estimates
    monkeypatch.setattr(tph, "QUERY_BUDGET_BYTES", 1 << 16)
    irr2, found2 = tph.irradiance_estimate(tpm, torch.from_numpy(pts),
                                           torch.from_numpy(eye), num,
                                           radius, cone_k)
    assert np.array_equal(found2.numpy(), found.numpy())
    np.testing.assert_allclose(irr2.numpy(), irr.numpy(), rtol=1e-12,
                               atol=1e-15)


def _maps(gi, map_types=(jph.CAUSTIC, jph.GLOBAL)):
    """Each package's maps of the fixture's stored photons."""
    radius = gi["tsc"].config.irradiance_estimate_radius
    jmaps, tmaps = {}, {}
    for m in map_types:
        pos, pw, dr = gi["maps"][m]["stored"]
        jmaps[m] = jph.build_photon_map(pos, pw, dr, radius, jnp.float64)
        tmaps[m] = tph.build_photon_map(pos, pw, dr, radius, F64, "cpu")
    return jmaps, tmaps


def _camera_rays(sc, dtype=F64):
    cam = sc.camera
    crt = tcam.build_camera(cam, dtype=dtype, device="cpu")
    n = cam.width * cam.height
    return tcam.rays_for_pixels(
        crt, torch.arange(cam.width).repeat(cam.height),
        torch.arange(cam.height).repeat_interleave(cam.width),
        torch.full((n, 2), 0.5, dtype=dtype), torch.zeros((n, 2),
                                                          dtype=dtype))


def test_gi_terms_match_jax(gi, monkeypatch):
    jmaps, tmaps = _maps(gi)
    o, d = _camera_rays(gi["tsc"])
    jir, jrt, tir, trt = gi["jir"], gi["jrt"], gi["tir"], gi["trt"]
    cfg = gi["tsc"].config
    jcfg = gi["jsc"].config
    key = jax.random.PRNGKey(77)

    # the shading points and final_gather op by op (final_gather around a
    # jit of its color_at_gi): under a jit over either, XLA's CPU fusion
    # moves the shading points by an ulp and one gather ray of this frame
    # across a hit decision (0.084 on one pixel against the op-by-op
    # result, which the port matches to 1e-15)
    gather_color = jax.jit(lambda o, d: color_at_gi(
        jir, jrt, jmaps[jph.GLOBAL], o, d, jcfg))
    color_at_gi = jph.color_at_gi
    monkeypatch.setattr(jph, "color_at_gi",
                        lambda ir, rt, pm, o, d, cfg: gather_color(o, d))

    @jax.jit
    def terms(c):
        vis = jph.lighting_gi(jir, jrt, jmaps[jph.GLOBAL], c,
                              dataclasses.replace(jcfg,
                                                  visualize_photon_map=True))
        return (jph.lighting_gi(jir, jrt, jmaps[jph.GLOBAL], c, jcfg), vis,
                jph.lighting_caustics(jir, jrt, jmaps[jph.CAUSTIC], c, jcfg))

    def jax_side(o, d, key):
        c = jintg.prepare_computations(jir, jrt, o, d)
        return terms(c) + (jph.final_gather(jir, jrt, jmaps[jph.GLOBAL], c,
                                            key, jcfg),)

    want = jax_side(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key)
    c = tintg.prepare_computations(tir, trt, o, d)
    S = cfg.gi_usteps * cfg.gi_vsteps
    got = (tph.lighting_gi(tir, trt, tmaps[tph.GLOBAL], c, cfg),
           tph.lighting_gi(tir, trt, tmaps[tph.GLOBAL], c,
                           dataclasses.replace(cfg,
                                               visualize_photon_map=True)),
           tph.lighting_caustics(tir, trt, tmaps[tph.CAUSTIC], c, cfg),
           tph.final_gather(tir, trt, tmaps[tph.GLOBAL], c,
                            tph.draw_gather(JaxKeys(key), S, o.shape[0],
                                            F64), cfg))
    for name, g, w in zip(("gi", "visualize", "caustics", "gather"), got,
                          want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9,
                                   err_msg=name)
        assert np.abs(w).max() > 1e-3, name      # the term is not all zero


def _jax_frame(gi, jsc, maps, buckets, key):
    """The JAX package's trace_bucketed frame of jsc with the GI hook of
    `maps` (one jit)."""
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    jrt = jrt._replace(gi_hook=jph.make_gi_hook(maps, jsc.config))
    o, d = _camera_rays(convert(jsc, tmodel))
    depth = jsc.config.di_path_length

    @jax.jit
    def run(o, d, k):
        t, ovf = jintg.trace_bucketed(jir, jrt, o, d, depth, k,
                                      list(buckets))
        return (t.a + t.d + t.s) / 3.0, ovf

    with compact_pallas.override_mode("off"):
        img, ovf = run(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key)
    assert not bool(ovf)
    return np.asarray(img)


def _port_frame(tsc, maps, rng):
    """The port's trace_bucketed frame of tsc with the GI hook of `maps`,
    and its buckets."""
    tir = tcomp.compile_scene(tsc, dtype=F64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    o, d = _camera_rays(tsc)
    depth = tsc.config.di_path_length
    # the spawn counts with 1.2x margin in multiples of 256 lanes (the
    # renderer's 4096-lane quantum would multiply a 16x16 frame's work)
    buckets = [max(256, math.ceil(c * 1.2 / 256) * 256) for c in
               torch.stack(tintg.spawn_counts(tir, trt, o, d,
                                              depth)).tolist()]
    trt = trt._replace(gi_hook=tph.make_gi_hook(maps, tsc.config))
    tr, ovf = tintg.trace_bucketed(tir, trt, o, d, depth, buckets, rng=rng)
    assert not bool(ovf)
    return ((tr.a + tr.d + tr.s) / 3.0).numpy(), buckets


def test_cornell_frame_matches_jax(gi):
    """32x32, caustics and the global map's visualization, the area light
    unjittered: deterministic given the maps; within 1e-9."""
    jmaps, tmaps = _maps(gi)
    tsc = _gi_scene(32, 32, include_final_gather=False,
                    visualize_photon_map=True)
    tsc.lights = [dataclasses.replace(tsc.lights[0], jitter=False)]
    got, buckets = _port_frame(tsc, tmaps, None)
    want = _jax_frame(gi, convert(tsc, jmodel), jmaps, buckets, None)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the GI terms show: the frame differs from the direct-only one
    direct, _ = _port_frame(tsc, {}, None)
    assert np.abs(got - direct).max() > 1e-2


def test_final_gather_frame_mean_matches_jax(gi):
    """16x16 depth 2 with the 3x3 final gather, caustics and the jittered
    light, on the same maps: the frame means agree within five standard
    errors of the per-pixel differences."""
    jmaps, tmaps = _maps(gi)
    tsc = dataclasses.replace(gi["tsc"], config=dataclasses.replace(
        gi["tsc"].config, di_path_length=2))
    got, buckets = _port_frame(tsc, tmaps, RNG(5, "cpu"))
    want = _jax_frame(gi, convert(tsc, jmodel), jmaps, buckets,
                      jax.random.PRNGKey(5))
    diff = (got - want).reshape(-1)
    se = diff.std(ddof=1) / math.sqrt(diff.size)
    assert abs(diff.mean()) <= 5.0 * se, (diff.mean(), se)
    assert diff.std() > 0.0                  # the draws differ
    assert abs(diff.mean()) < 0.05 * abs(want.mean())


def test_trace_photons_statistics(gi):
    """photon_count 1,500, batches of 4,096 in both packages: the port
    stores exactly each map's target, and each map's mean stored power per
    channel is the JAX package's within five standard errors."""
    tsc = dataclasses.replace(gi["tsc"], config=dataclasses.replace(
        gi["tsc"].config, photon_count=1500))
    jsc = convert(tsc, jmodel)
    jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
    jrt = jintg.build_statics(jir, jsc.config)
    jmaps = jph.trace_photons(jir, jrt, jax.random.PRNGKey(3), jnp.float64,
                              True, True, batch=4096)
    tir = tcomp.compile_scene(tsc, dtype=F64, device="cpu")
    trt = tintg.build_statics(tir, tsc.config)
    stats = {}
    tmaps = tph.trace_photons(tir, trt, RNG(3), F64, True, True, batch=4096,
                              stats=stats)
    for m in (tph.CAUSTIC, tph.GLOBAL):
        assert stats[m]["stored"] == stats[m]["targets"] == [1500]
        assert not stats[m]["stalled"]
        assert stats[m]["syncs"] == stats[m]["batches"] + 1
        tp = tmaps[m].power.numpy()
        jp = jax_map_arrays(jmaps[m])[1]
        assert len(tp) == len(jp) == 1500
        se = np.sqrt(tp.var(0, ddof=1) / len(tp) + jp.var(0, ddof=1)
                     / len(jp))
        assert (np.abs(tp.mean(0) - jp.mean(0)) <= 5.0 * se).all(), \
            (m, tp.mean(0), jp.mean(0), se)
        assert tmaps[m].prov_light.shape == (1500,)
        assert tmaps[m].prov_code.shape == (1500, tsc.config.gi_path_length)


def test_cornell_yaml_loads_as_jax():
    tdemo.cornell_box(8, 8)
    path = str(tdemo.CORNELL_DIR / "cornell_box.yml")
    got = tyaml.load_scene(path)
    assert got == convert(jyaml.load_scene(path), tmodel)
    assert got == tdemo.cornell_box(800, 800)
    assert got.config.photon_count == 100000 and got.lights[0].jitter


def test_cli_renders_gi_from_seed(tmp_path):
    """The Cornell box's YAML without the mesh block, with a 2x2 light and
    1,000 photons, at 16x16."""
    tree = tdemo._cornell_tree(16, 16, None)
    tree[2].update(usteps=2, vsteps=2)
    assert "corner" in tree[2]
    tree[0]["illumination"]["global-illumination"]["photon-count"] = 1000
    yml = tmp_path / "cornell.yml"
    yml.write_text(json.dumps(tree))

    def run(stem, seed):
        argv = [str(yml), "-o", str(tmp_path / stem), "--device", "cpu",
                "--seed", str(seed), "--quiet", "--ppm-only"]
        stats = {}
        assert cli_main(argv, stats=stats) == 0
        assert stats["photons"][tph.GLOBAL]["stored"] == [1000]
        return (tmp_path / f"{stem}.ppm").read_bytes()
    a = run("a", 4)
    assert a == run("b", 4)
    assert a != run("c", 5)
