"""The port's gradients through clustered meshes on the CPU, in float64
with one torch thread.

The mesh query (the CUDA kernel on the card, its plain version here) runs
without autograd; the hit's t carries the gradient of Möller–Trumbore on
the winning triangle with the live tables (integrator.mesh_hit_t), the
same route on both devices. The JAX package differentiates its plain
mesh path, whose `min` over the per-triangle t sends the cotangent to the
winning triangle (split evenly on an exact tie, where the port gives it
all to the lowest index: no primary ray of these frames ties two
triangles, which the tests count).

- mesh_torus (3,072 triangles, clustered) at 16x8, depth 3, the MSE of
  pixel_colors against the frame at 0.9x plus 0.01: the opaque torus
  through the unrolled trace and the glass torus through the bucketed
  one, every key of split_params (tri_* and mat_Ni included) against
  the JAX package's gradient to 1e-9 of the field's largest |g| plus
  1e-12 (the JAX side's one jit each, compiled at XLA's cheap
  optimization level; depth 3 keeps the two at ~35 s where depth 5 took
  ~55 s); each torus also bucketed against unrolled on the
  port, to the same tolerance but for the rows the spawn value gates
  prune;
- mesh_hit_t: the forward bit for bit the query's t, the gradient the
  dense per-triangle min's on rays through the torus;
- a vertex table that requires grad is packed anew for the queries on
  each pixel_colors call;
- the port's own central differences on cornell_box with its clustered
  block at 8x8, GI with live photon powers (1,500 photons a map, a 2x2
  gather, an estimate of 50, depth 2): mat_Kd, light_intensity and one
  tri_p1 entry, rtol 5e-4 (tests/test_grad_gi.py's).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from fast_ray_tracer_tpu_torch.ops import intersect as tint
from fast_ray_tracer_tpu_torch.ops import mesh as tmesh
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import photon as tph
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from tests.grad_fixture import PARAM_KEYS, Frame, assert_grad_close

torch.set_num_threads(1)

F64 = torch.float64
SEGMENTS = (48, 32)          # 3,072 triangles: the smallest meshes cluster
W, H = 16, 8
DEPTH = 3
# XLA's cheap optimization level for the JAX side's one gradient jit
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
CASES = {"opaque-unrolled": (False, False), "glass-bucketed": (True, True)}


def _buckets(frame):
    return tintg.default_buckets(frame.n, frame.depth)


@pytest.fixture(scope="module")
def torus():
    """Per case: the frame, its target, the JAX and the port gradients
    (in the case's trace), and the port's in the other trace."""
    out = {}
    for case, (glass, bucketed) in CASES.items():
        sc = tdemo.mesh_torus(W, H, glass=glass, segments=SEGMENTS)
        sc.config = dataclasses.replace(sc.config, di_path_length=DEPTH)
        frame = Frame(sc)
        assert frame.ir.meta.use_clusters
        target = frame.target()
        kw = {"buckets": _buckets(frame)} if bucketed else {}
        other = {} if bucketed else {"buckets": _buckets(frame)}
        run = jax.jit(jax.value_and_grad(frame.jax_loss(target, **kw))) \
            .lower(frame.jparams).compile(compiler_options=FAST_XLA)
        jloss, jgrads = run(frame.jparams)
        out[case] = (frame, (float(jloss), {k: np.asarray(v) for k, v in
                                             jgrads.items()}),
                     frame.port_grads(target, **kw),
                     frame.port_grads(target, **other))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("key", PARAM_KEYS)
def test_mesh_gradients_match_jax(torus, case, key):
    _, (jloss, jgrads), (tloss, tgrads), _ = torus[case]
    assert abs(tloss - jloss) <= 1e-12 * jloss
    assert np.all(np.isfinite(tgrads[key]))
    assert_grad_close(tgrads[key], jgrads[key], key)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_gradients_reach_the_vertices(torus, case):
    frame, _, (_, tgrads), _ = torus[case]
    for k in ("tri_p1", "tri_e1", "tri_e2", "tri_n1", "mat_Kd", "inv_tf"):
        assert np.abs(tgrads[k]).max() > 0.0, k
    # the containers walk's Ni is the step-constant packed plane, as the
    # JAX package's rt.tri_ni: no gradient reaches mat_Ni in either
    assert np.all(tgrads["mat_Ni"] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_bucketed_matches_unrolled(torus, case):
    frame, _, (tloss, tgrads), (oloss, ograds) = torus[case]
    assert abs(tloss - oloss) <= 1e-12 * tloss
    ir = frame.ir
    pruned = {"mat_Tf": ~(ir.mat_Tf != 0.0).any(-1).numpy(),
              "mat_refl": ~(ir.mat_refl != 0.0).any(-1).numpy()}
    for k in PARAM_KEYS:
        a, b = tgrads[k], ograds[k]
        if k in pruned:
            a, b = a[~pruned[k]], b[~pruned[k]]
        assert_grad_close(a, b, k)


@pytest.mark.parametrize("case", list(CASES))
def test_primary_rays_tie_no_triangles(torus, case):
    """Where two triangles give a ray the same least positive t, the JAX
    package's min splits the cotangent and the port's mesh_hit_t gives it
    to the lowest index; these frames' primary rays have no such tie."""
    frame = torus[case][0]
    o, d = tcam.rays_for_pixels(frame.cam, *frame.args)
    ir = frame.ir
    t = tint._triangle_t(o, d, ir.tri_p1, ir.tri_e1, ir.tri_e2)
    t = torch.where(t > 0.0, t, torch.inf)
    tmin = t.amin(-1, keepdim=True)
    hits = torch.isfinite(tmin[:, 0])
    ties = ((t == tmin).sum(-1) > 1) & hits
    assert int(hits.sum()) > W * H // 8
    assert int(ties.sum()) == 0


def test_mesh_hit_t_matches_dense_min():
    """Rays from around the torus toward its centre: mesh_hit_t's t is the
    query's bit for bit, and its gradient in the vertex tables and the
    rays is the dense per-triangle min's."""
    sc = tdemo.mesh_torus(8, 4, segments=SEGMENTS)
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    g = np.random.default_rng(2)
    o = torch.from_numpy(g.normal(size=(256, 3)) * 3.0 + [0.0, 1.25, 0.0])
    d = torch.from_numpy(g.normal(size=(256, 3)) * 0.3
                         + [0.0, 1.25, 0.0]) - o
    d = d / d.norm(dim=-1, keepdim=True)
    t_q, idx = tmesh.closest(rt.mesh, o, d)
    assert int(torch.isfinite(t_q).sum()) > 64
    names = ("tri_p1", "tri_e1", "tri_e2")
    tabs = [getattr(ir, k).clone().requires_grad_(True) for k in names]
    oo, dd = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    ir2 = dataclasses.replace(ir, **dict(zip(names, tabs)))
    t = tintg.mesh_hit_t(ir2, t_q, idx, oo, dd)
    assert torch.equal(t.detach(), t_q)
    w = torch.from_numpy(g.uniform(0.5, 1.5, 256))
    hit = torch.isfinite(t_q)
    got = torch.autograd.grad((torch.where(hit, t, 0.0) * w).sum(),
                              tabs + [oo, dd])
    td = tint._triangle_t(oo, dd, *tabs)
    tmin = torch.where(td > 0.0, td, torch.inf).amin(-1)
    assert torch.equal(tmin.detach(), t_q)
    want = torch.autograd.grad((torch.where(hit, tmin, 0.0) * w).sum(),
                               tabs + [oo, dd])
    for name, a, b in zip(names + ("orig", "dirs"), got, want):
        assert float(b.abs().max()) > 0.0, name
        assert_grad_close(a.numpy(), b.numpy(), name)


def test_vertex_tables_packed_per_call(monkeypatch):
    """A vertex table that requires grad: the queries take the planes
    packed from its current values; frozen tables take rt's."""
    sc = tdemo.mesh_torus(8, 4, segments=SEGMENTS)
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    cam = tcam.build_camera(sc.camera, dtype=F64, device="cpu")
    n = 32
    args = (torch.arange(8).repeat(4), torch.arange(4).repeat_interleave(8),
            torch.full((n, 2), 0.5, dtype=F64), torch.zeros((n, 2),
                                                              dtype=F64))
    seen = []
    real = tmesh.closest

    def spy(m, *a, **kw):
        seen.append(m.tris)
        return real(m, *a, **kw)
    monkeypatch.setattr(tmesh, "closest", spy)
    params, static = ttrain.split_params(ir)
    with torch.no_grad():
        params["tri_p1"] += 1e-3
    trender.pixel_colors(ttrain.merge_params(params, static), rt, cam, *args,
                         1, 5)
    moved = tmesh.pack_tris(params["tri_p1"].detach(), ir.tri_e1, ir.tri_e2)
    assert seen and all(torch.equal(x, moved) for x in seen)
    seen.clear()
    with torch.no_grad():
        trender.pixel_colors(ir, rt, cam, *args, 1, 5)
    assert seen and all(x is rt.mesh.tris for x in seen)


def test_meshed_cornell_finite_differences():
    """cornell_box with its block at 8x8, GI with live photon powers:
    d mean(pixel_colors) / d(mat_Kd, light_intensity, tri_p1) at each
    table's largest |g| against central differences (the photon
    structure frozen, the draws fixed), rtol 5e-4."""
    sc = tdemo.cornell_box(8, 8)
    sc.config = dataclasses.replace(
        sc.config, photon_count=1500, gi_usteps=2, gi_vsteps=2,
        irradiance_estimate_num=50, di_path_length=2)
    ir = tcomp.compile_scene(sc, dtype=F64, device="cpu")
    assert ir.meta.use_clusters
    rt = tintg.build_statics(ir, sc.config)
    maps = tph.trace_photons(ir, rt, RNG(7), F64, caustic=True, global_=True,
                             batch=4096)
    rt = rt._replace(gi_hook=tph.make_gi_hook(maps, sc.config,
                                              live_power=True))
    cam = tcam.build_camera(sc.camera, dtype=F64, device="cpu")
    n = 64
    args = (torch.arange(8).repeat(8), torch.arange(8).repeat_interleave(8),
            torch.full((n, 2), 0.5, dtype=F64), torch.zeros((n, 2),
                                                              dtype=F64))
    buckets = tintg.default_buckets(n, 2)
    params, static = ttrain.split_params(ir)

    def loss(p):
        img, ovf = trender.pixel_colors(ttrain.merge_params(p, static), rt,
                                        cam, *args, 1, 2, buckets=buckets,
                                        rng=RNG(3))
        assert not bool(ovf)
        return img.mean()

    names = ("mat_Kd", "light_intensity", "tri_p1")
    grads = dict(zip(names, torch.autograd.grad(
        loss(params), [params[k] for k in names])))
    for name in names:
        g = grads[name].numpy()
        assert np.abs(g).sum() > 0.0, name
        idx = np.unravel_index(np.abs(g).argmax(), g.shape)
        eps = 1e-4 if name != "tri_p1" else 1e-6

        def at(v):
            # the tables keep requires_grad, so a moved vertex is packed
            # anew for the queries
            p2 = {k: x.detach().clone().requires_grad_(True)
                  for k, x in params.items()}
            with torch.no_grad():
                p2[name][idx] = v
                return float(loss(p2))
        base = float(params[name].detach()[idx])
        fd = (at(base + eps) - at(base - eps)) / (2 * eps)
        assert np.isclose(float(g[idx]), fd, rtol=5e-4, atol=1e-10), \
            (name, float(g[idx]), fd)
