"""The port's patterns against the JAX package, in float64 on the CPU:
Perlin noise, every procedural pattern kind and uv-map kind, the
blended/nested/perturbed combinators nested two and three deep, bump maps
in normal_at, and the uv radial gradient's |u| (ROADMAP C3). The inputs
are made with numpy from fixed seeds and go through both packages; the
JAX side runs op by op (no jit), which keeps its compile time small.

Tolerances: the Perlin lattice noise (`_noise3d`: the int32 hash with its
wraparound, the float32-rounded hash value) is bitwise equal over the
whole int32 range. The interpolated noise (`_smooth3d`, `pnoise3d`) is
not: XLA's float64 cos on the CPU is glibc's, torch's vectorized CPU cos
(SLEEF) differs from it by one ulp on about 0.2% of arguments, and the
cosine interpolation carries that through (2.2e-16 the largest
difference on these coordinates, in 0.2-0.4% of the values); it agrees
to 1e-15, coordinates past the int32 range (saturated) included. Pattern
colors and bumped normals agree to
1e-12: the two frameworks may round atan2, acos, cos or a sqrt one ulp
apart, and the world -> pattern transforms sum in another order (the JAX
package uses einsum, the port writes the terms out). Uniform random
points fall within an ulp of a stripe, ring or checker boundary, where
one ulp would flip a discrete choice, with negligible probability.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import patterns as jpat
from fast_ray_tracer_tpu.ops import perlin as jperlin
from fast_ray_tracer_tpu.render import normals as jnorm
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.ops import patterns as tpat
from fast_ray_tracer_tpu_torch.ops import perlin as tperlin
from fast_ray_tracer_tpu_torch.render import normals as tnorm
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene import model as tmodel

from scene_convert import convert

torch.set_num_threads(1)

ATOL = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _coords(rng, n):
    """Noise coordinates: small, moderate (the int32 hash wraps), past the
    int32 range (the conversion saturates), negative, and exact
    integers."""
    c = rng.uniform(-5, 5, (3, n))
    c[:, : n // 4] *= 10.0 ** rng.integers(2, 7, (3, n // 4))
    c[:, n // 4: n // 3] = rng.uniform(-4e9, 4e9, (3, n // 3 - n // 4))
    c[:, n // 3: n // 3 + 100] = np.round(c[:, n // 3: n // 3 + 100])
    return c


@pytest.mark.parametrize("octave", [0, 1, 3])
def test_noise3d_lattice_bitwise(octave):
    """The hash over lattice points across the whole int32 range (every
    product and sum wraps) and every seed: bitwise."""
    rng = np.random.default_rng(octave)
    ijk = rng.integers(-2**31, 2**31, (3, 40_000))
    ijk[:, :1000] = rng.integers(-3, 4, (3, 1000))
    ijk[:, 1000:1010] = 2**31 - 1
    seed = rng.integers(-2**31, 2**31, 40_000)
    want = jperlin._noise3d(*(jnp.asarray(a, jnp.int32) for a in ijk),
                            jnp.int32(octave), jnp.asarray(seed, jnp.int32))
    got = tperlin._noise3d(*map(_t, ijk), octave, _t(seed), torch.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smooth3d():
    rng = np.random.default_rng(0)
    x, y, z = _coords(rng, 40_000)
    seed = rng.integers(-2**31, 2**31, 40_000)
    for octave in (0, 1, 3):
        want = jperlin._smooth3d(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(z), jnp.int32(octave),
                                 jnp.asarray(seed, jnp.int32))
        got = tperlin._smooth3d(_t(x), _t(y), _t(z), octave, _t(seed))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("octaves,seed", [(1, 0), (4, 7), (3, -12345)])
def test_pnoise3d(octaves, seed):
    rng = np.random.default_rng(octaves)
    x, y, z = _coords(rng, 20_000)
    want = jperlin.pnoise3d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                            0.7, 2.0, octaves, seed)
    got = tperlin.pnoise3d(_t(x), _t(y), _t(z), 0.7, 2.0, octaves, seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


def test_int_conversion_saturates_as_xla():
    x = np.asarray([3e9, -3e9, 1e300, -1e300, np.nan, np.inf, -np.inf,
                    2147483647.5, -2147483648.9, -0.5, 1.99])
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(
        tperlin.to_int32_saturated(_t(x)).numpy(), want)


def _pattern_scene(m):
    """Materials whose slots cover every procedural kind, every uv-map
    kind with every ported uv pattern, and combinators nested two deep;
    one prim of each analytic type plus two textured triangles (the
    triangle map)."""
    P = m.PatternDesc
    c2 = [(0.9, 0.2, 0.1), (0.1, 0.3, 0.8)]
    tf = [["scale", 0.7, 0.7, 0.7], ["rotate-y", 0.3]]

    def concrete(kind):
        return P(kind=kind, colors=c2, transform=tf)

    uv = [P(kind="uv_checker", width=6, height=4, colors=c2),
          P(kind="uv_align_check",
            colors=[(1, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0)]),
          P(kind="uv_gradient", colors=c2),
          P(kind="uv_radial_gradient", colors=c2)]
    maps = [P(kind="map", mapping="cube", faces=[uv[i % 4] for i in range(6)]),
            P(kind="map", mapping="cylinder", faces=uv[:3]),
            P(kind="map", mapping="plane", faces=[uv[0]]),
            P(kind="map", mapping="sphere", faces=[uv[1]]),
            P(kind="map", mapping="toroid", faces=[uv[3]]),
            P(kind="map", mapping="triangle", faces=[uv[2]])]
    # blended(nested(checker, ring, gradient), perturbed(stripe)): depth 2
    deep = P(kind="blended", children=[
        P(kind="nested", children=[concrete("checker"), concrete("ring"),
                                   concrete("gradient")]),
        P(kind="perturbed", frequency=1.5, scale_factor=0.4,
          persistence=0.6, octaves=4, seed=3,
          children=[concrete("stripe")])])
    pats = [concrete(k) for k in ("checker", "gradient", "radial_gradient",
                                  "ring", "stripe")] + maps + [deep]
    mats = [m.MaterialDesc(patterns={"map_Kd": p,
                                     "map_bump": pats[(i * 5) % len(pats)]})
            for i, p in enumerate(pats)]
    S = m.ShapeDesc
    world = [S(kind="sphere", material=mats[0]),
             S(kind="plane", material=mats[1], transform=[["rotate-x", 0.3]]),
             S(kind="cube", material=mats[2], transform=[["rotate-y", 0.4]]),
             S(kind="cylinder", minimum=-1.0, maximum=1.5, closed=True,
               material=mats[3]),
             S(kind="cone", minimum=-1.0, maximum=0.5, closed=True,
               material=mats[4]),
             S(kind="toroid", r1=0.8, r2=0.3, material=mats[5])]
    world += [S(kind="sphere", material=mt,
                transform=[["translate", i, 0, 2]])
              for i, mt in enumerate(mats[6:])]
    world += [S(kind="smooth_triangle", material=mats[10],
                p1=(0, 0, 0), p2=(1, 0, 0), p3=(0, 1, 0.5),
                n1=(0, 0, 1), n2=(0, 0.1, 1), n3=(0.1, 0, 1),
                t1=(0.1, 0.2, 0), t2=(0.9, 0.1, 0), t3=(0.3, 1.7, 0)),
              S(kind="triangle", material=mats[10], p1=(0, 0, 1),
                p2=(1, 1, 1), p3=(-1, 1, 2))]
    return m.SceneDesc(camera=m.CameraDesc(width=8, height=4),
                       lights=[m.LightDesc(kind="point", at=(-3, 4, -5))],
                       world=world, config=m.ConfigDesc(divide_threshold=1))


def _deep_scene(m):
    """Combinators three deep over a few concrete kinds:
    perturbed(blended(nested(checker, stripe, ring), perturbed(stripe)))."""
    P = m.PatternDesc
    c2 = [(0.9, 0.2, 0.1), (0.1, 0.3, 0.8)]
    deep = P(kind="perturbed", octaves=3, seed=5, scale_factor=0.3,
             children=[P(kind="blended", children=[
                 P(kind="nested", children=[
                     P(kind="checker", colors=c2,
                       transform=[["scale", 0.5, 0.5, 0.5]]),
                     P(kind="stripe", colors=c2,
                       transform=[["rotate-z", 0.4]]),
                     P(kind="ring", colors=c2)]),
                 P(kind="perturbed", octaves=2, seed=9,
                   children=[P(kind="stripe", colors=c2)])])])
    return m.SceneDesc(
        camera=m.CameraDesc(width=8, height=4),
        lights=[m.LightDesc(kind="point", at=(-3, 4, -5))],
        world=[m.ShapeDesc(kind="sphere", material=m.MaterialDesc(
            patterns={"map_Kd": deep})),
               m.ShapeDesc(kind="cube", transform=[["translate", 2, 0, 0]])],
        config=m.ConfigDesc(divide_threshold=1))


def _compiled(scene):
    tsc = scene(tmodel)
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    return jir, tir


@pytest.fixture(scope="module")
def pattern_pair():
    return _compiled(_pattern_scene)


def test_pattern_scene_holds_every_kind(pattern_pair):
    jir, tir = pattern_pair
    kinds = set(range(14)) - {IR.PAT_UV_TEXTURE}
    assert set(tir.meta.pattern_kinds) == kinds
    assert set(tir.meta.map_kinds) == set(range(6))
    assert tir.meta.pattern_depth == 2 and tir.meta.max_perlin_octaves == 4
    assert tir.meta.pattern_kinds == jir.meta.pattern_kinds


def _points(rng, n):
    """Random world points around the prims, off and on their surfaces'
    neighbourhoods alike."""
    return rng.uniform(-2.5, 2.5, (n, 3))


def _ctx_pair(jir, tir, prim):
    return (jpat.build_shape_ctx(jir, jnp.asarray(prim, jnp.int32)),
            tpat.build_shape_ctx(tir, _t(prim)))


@pytest.mark.parametrize("group", ["concrete", "maps", "combinators"])
def test_eval_pattern(pattern_pair, group):
    """Every pattern row (children included) of the group's kinds, on
    random prims of every type and random points, with pid -1 lanes."""
    jir, tir = pattern_pair
    rng = np.random.default_rng({"concrete": 1, "maps": 2,
                                 "combinators": 3}[group])
    ptype = np.asarray(jir.pat_type)
    kinds = {"concrete": [0, 1, 2, 3, 4], "maps": [IR.PAT_MAP],
             "combinators": [5, 6, 7]}[group]
    pids = [i for i, k in enumerate(ptype) if k in kinds] + [-1]
    n = 2000
    na, nt = tir.meta.n_analytic, tir.meta.n_triangles
    prim = rng.integers(0, na + nt, n)
    pid = rng.choice(pids, n)
    pts = _points(rng, n)
    jctx, tctx = _ctx_pair(jir, tir, prim)
    want = np.asarray(jpat.eval_pattern(jir, jnp.asarray(pid, jnp.int32),
                                        jctx, jnp.asarray(pts)))
    got = tpat.eval_pattern(tir, _t(pid), tctx, _t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (np.abs(want).sum(-1) > 0).mean() > 0.5


def test_eval_pattern_three_deep():
    """Combinators three deep, then an explicit `depth` below the scene's,
    which cuts the recursion as the JAX package does (children past it
    read as black)."""
    jir, tir = _compiled(_deep_scene)
    assert tir.meta.pattern_depth == 3
    rng = np.random.default_rng(4)
    n = 2000
    pid = rng.integers(-1, tir.meta.n_patterns, n)
    top = int(np.asarray(jir.mat_map)[0, IR.SLOT_KD])
    assert int(np.asarray(jir.pat_type)[top]) == IR.PAT_PERTURBED
    pid[: n // 2] = top
    prim = rng.integers(0, tir.meta.n_analytic, n)
    pts = _points(rng, n)
    jctx, tctx = _ctx_pair(jir, tir, prim)
    for depth in (None, 1, 2):
        want = jpat.eval_pattern(jir, jnp.asarray(pid, jnp.int32), jctx,
                                 jnp.asarray(pts), depth=depth)
        got = tpat.eval_pattern(tir, _t(pid), tctx, _t(pts), depth=depth)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_normal_at_with_bump(pattern_pair):
    jir, tir = pattern_pair
    rng = np.random.default_rng(5)
    n = 2000
    na, nt = tir.meta.n_analytic, tir.meta.n_triangles
    prim = rng.integers(0, na + nt, n)
    pts = _points(rng, n)
    mat = np.concatenate([np.asarray(jir.material_id),
                          np.asarray(jir.tri_material_id)])[prim]
    bump = np.asarray(jir.mat_map)[mat, IR.SLOT_BUMP]
    bump[::7] = -1
    u, v = rng.uniform(0, 0.5, (2, n))
    jctx, tctx = _ctx_pair(jir, tir, prim)
    want = jnorm.normal_at(jir, jctx, jnp.asarray(prim, jnp.int32),
                           jnp.asarray(pts), jnp.asarray(u), jnp.asarray(v),
                           mat_bump_pid=jnp.asarray(bump, jnp.int32))
    got = tnorm.normal_at(tir, tctx, _t(prim), _t(pts), _t(u), _t(v),
                          mat_bump_pid=_t(bump))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    plain = tnorm.normal_at(tir, tctx, _t(prim), _t(pts), _t(u), _t(v))
    changed = np.abs(got.numpy() - plain.numpy()).max(-1) > 1e-6
    assert changed[bump >= 0].mean() > 0.9 and not changed[bump < 0].any()


def test_uv_radial_gradient_abs_equals_sqrt_square(pattern_pair):
    """ROADMAP C3: the port's |u| is bitwise JAX's sqrt(u*u) on the
    forward pass (u = 0 and -0 included; no u small enough for u*u to
    underflow), through _eval_uv too; only the gradient at 0 differs."""
    jir, tir = pattern_pair
    rng = np.random.default_rng(6)
    u = rng.standard_normal(50_000) * 10.0 ** rng.integers(-100, 100,
                                                            50_000)
    u[:3] = [0.0, -0.0, 1.0]
    np.testing.assert_array_equal(torch.abs(_t(u)).numpy(),
                                  np.asarray(jnp.sqrt(jnp.asarray(u) ** 2)))
    radial = int(np.nonzero(np.asarray(jir.pat_type)
                            == IR.PAT_UV_RADIAL_GRADIENT)[0][0])
    u = rng.uniform(-3, 3, 4000)
    u[:2] = [0.0, -0.0]
    v = rng.uniform(0, 1, 4000)
    pid = np.full(4000, radial)
    kinds = set(tir.meta.pattern_kinds)
    want = jpat._eval_uv(jir, jnp.asarray(pid, jnp.int32), jnp.asarray(u),
                         jnp.asarray(v), kinds)
    got = tpat._eval_uv(tir, _t(pid), _t(u), _t(v), kinds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the gradient at u = 0: sqrt(u*u) gives NaN, |u| a finite 0
    assert np.isnan(float(jax.grad(lambda x: jnp.sqrt(x * x))(0.0)))
    x = torch.zeros((), dtype=torch.float64, requires_grad=True)
    torch.abs(x).backward()
    assert float(x.grad) == 0.0
