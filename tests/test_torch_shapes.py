"""The port's analytic shapes against the JAX package, in float64 on the CPU:
the quartic solver and its cube root, the cube, cylinder, cone and toroid
intersectors (and the sphere and plane beside them), the candidate table
of a scene holding every type, and each type's object-space normal. The
inputs are made with numpy from fixed seeds and go through both packages.

Tolerances: the intersectors and normals agree to 1e-12 (the two
frameworks may round a division or a sqrt one ulp apart; which slots hit
is compared exactly). The quartic's roots agree to 1e-9 relative to
max(1, |root|) on standard-normal coefficients (4.6e-10 is the largest
difference on these draws): torch has no cbrt, and the port's `_cbrt` is
within one ulp of np.cbrt while XLA's cbrt is |x| ** (1/3), off by up to
two ulps; the solver's cancellations (cbrt(a) - cbrt(b), the resolvent's
s[0]) amplify that on ill-conditioned draws (with coefficients spread
over 10^-3..10^3 the two solvers differ by up to ~4e-6 relative). On the
constructed well-conditioned cases they agree to 1e-12. The candidate
table of a whole scene agrees to 1e-12 relative to max(1, t): the JAX
package maps rays to object space with a matrix product, the port term
by term.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import intersect as jint
from fast_ray_tracer_tpu.ops import quartic as jq
from fast_ray_tracer_tpu.render import normals as jnorm
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.ops import intersect as tint
from fast_ray_tracer_tpu_torch.ops import quartic as tq
from fast_ray_tracer_tpu_torch.render import normals as tnorm
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel

from scene_convert import convert

torch.set_num_threads(1)

ATOL = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _same_roots(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= rtol, err.max()


def test_cbrt_matches_numpy():
    """Within one ulp of np.cbrt on random magnitudes over the whole
    float64 range (subnormals included); exact on the edge values, the
    sign of zero kept."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200_000) * 10.0 ** rng.integers(-310, 300,
                                                            200_000)
    x = np.concatenate([x, [1e-310, -1e-310, 5e-324, 8.0, -27.0, 1e308,
                            -1e308]])
    got = tq._cbrt(_t(x)).numpy()
    want = np.cbrt(x)
    fin = want != 0
    ulps = np.abs(got[fin] - want[fin]) / np.spacing(np.abs(want[fin]))
    assert ulps.max() <= 1.0, ulps.max()
    np.testing.assert_array_equal(got[~fin], want[~fin])
    edge = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                       64.0, -0.125])
    got = tq._cbrt(_t(edge)).numpy()
    np.testing.assert_array_equal(got, np.cbrt(edge))
    np.testing.assert_array_equal(np.signbit(got[:2]), [False, True])


def test_quartic_random_coefficients():
    rng = np.random.default_rng(1)
    c = rng.standard_normal((5, 50_000))
    _same_roots(tq.solve_quartic(*map(_t, c)),
                jq.solve_quartic(*map(jnp.asarray, c)), 1e-9)
    c3 = rng.standard_normal((4, 50_000))
    _same_roots(tq.cubic_roots(*map(_t, c3)),
                jq.cubic_roots(*map(jnp.asarray, c3)), 1e-9)
    c2 = rng.standard_normal((2, 50_000))
    for g, w in zip(tq.solve_quadratic(*map(_t, c2)),
                    jq.solve_quadratic(*map(jnp.asarray, c2))):
        _same_roots(g, w, 1e-12)


@pytest.mark.parametrize("case", ["r=0", "D=0 cubic", "three real",
                                  "one real", "q=0", "no roots",
                                  "double quadratic"])
def test_quartic_degenerate(case):
    """Constructed coefficients that take each special-case branch."""
    cubic = {"D=0 cubic": [2.0, -3.0, 0.0, 1.0],      # (x-1)^2 (x+2)
             "three real": [6.0, -7.0, 0.0, 1.0],     # (x-1)(x-2)(x+3)
             "one real": [-1.0, 1.0, 1.0, 1.0],
             "q=0": [0.0, 0.0, 0.0, 1.0]}             # x^3
    quartic = {"r=0": [0.0, 2.0, -3.0, 0.0, 1.0],     # x (x^3 - 3x + 2)
               "three real": [24.0, -50.0, 35.0, -10.0, 1.0],  # 1..4
               "no roots": [5.0, 0.0, 3.0, 0.0, 1.0],
               "double quadratic": [1.0, 0.0, -2.0, 0.0, 1.0]}  # (x^2-1)^2
    if case in cubic:
        c = np.asarray(cubic[case])[:, None] * np.ones((1, 3))
        _same_roots(tq.cubic_roots(*map(_t, c)),
                    jq.cubic_roots(*map(jnp.asarray, c)), ATOL)
    if case in quartic:
        c = np.asarray(quartic[case])[:, None] * np.ones((1, 3))
        _same_roots(tq.solve_quartic(*map(_t, c)),
                    jq.solve_quartic(*map(jnp.asarray, c)), ATOL)
    if case == "double quadratic":
        c = np.asarray([[1.0, 0.0], [-2.0, 0.0]])      # D = 0 -> one root
        for g, w in zip(tq.solve_quadratic(*map(_t, c)),
                        jq.solve_quadratic(*map(jnp.asarray, c))):
            _same_roots(g, w, ATOL)


def _object_rays(seed, n=4000, k=3):
    """(R, k, 3) object-space rays: random origins and directions, plus
    axis-parallel, grazing (tangent to the unit sphere, cylinder, cone and
    toroid) and surface-parallel cone rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, k, 3))
    d = rng.standard_normal((n, k, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axis = np.eye(3)[rng.integers(0, 3, n // 4)] * rng.choice([-1, 1],
                                                               (n // 4, 1))
    d[: n // 4] = axis[:, None]
    m = n // 4
    # tangent to x^2 + z^2 = 1 (the cylinder wall and the sphere's equator)
    o[m:2 * m, :, 0] = 1.0
    o[m:2 * m, :, 2] = -5.0
    d[m:2 * m] = [0.0, 0.0, 1.0]
    # parallel to the cone's surface y = x (a == 0)
    d[2 * m:2 * m + m // 2] = np.asarray([1.0, 1.0, 0.0]) / np.sqrt(2.0)
    # tangent to the toroid's top at y = r2 = 0.25
    o[2 * m + m // 2:3 * m, :, 1] = 0.25
    d[2 * m + m // 2:3 * m] = [1.0, 0.0, 0.0]
    return o, d


def _params(seed, n, k):
    rng = np.random.default_rng(seed)
    mn = rng.uniform(-2, 0, (1, k))
    mx = rng.uniform(0, 2, (1, k))
    closed = (np.arange(k) % 2 == 0)[None].astype(np.float64)
    p = np.zeros((1, k, 4))
    p[..., 0], p[..., 1], p[..., 2] = mn, mx, closed
    return p


@pytest.mark.parametrize("shape", ["sphere", "plane", "cube", "cylinder",
                                   "cone", "toroid"])
def test_intersector(shape):
    o, d = _object_rays({"sphere": 2, "plane": 3, "cube": 4, "cylinder": 5,
                         "cone": 6, "toroid": 7}[shape])
    k = o.shape[1]
    params = _params(8, o.shape[0], k)
    if shape == "toroid":
        params[..., 0] = [0.75, 1.0, 0.5][:k]
        params[..., 1] = [0.25, 0.1, 0.4][:k]
    fn_t = getattr(tint, f"_{shape}_t")
    fn_j = getattr(jint, f"_{shape}_t")
    args_t = (_t(o), _t(d)) + ((_t(params),) if shape in (
        "cylinder", "cone", "toroid") else ())
    args_j = (jnp.asarray(o), jnp.asarray(d)) + ((jnp.asarray(params),)
                                                 if len(args_t) == 3 else ())
    got, want = fn_t(*args_t).numpy(), np.asarray(fn_j(*args_j))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).any()
    _same_roots(got, want, ATOL)


def _all_types_scene(m):
    """One of each analytic shape type, transformed, with open and closed
    cylinders and cones."""
    S = m.ShapeDesc
    return m.SceneDesc(
        camera=m.CameraDesc(width=8, height=4),
        lights=[m.LightDesc(kind="point", at=(-4, 4, -4))],
        world=[S(kind="plane", transform=[["rotate-z", 0.2]]),
               S(kind="sphere", transform=[["translate", 1, 1, 0]]),
               S(kind="cube", transform=[["rotate-y", 0.5],
                                         ["translate", -1, 1, 1]]),
               S(kind="cylinder", minimum=-1, maximum=1, closed=True,
                 transform=[["translate", 2, 1, 2]]),
               S(kind="cylinder", minimum=0, maximum=2),
               S(kind="cone", minimum=-1, maximum=0, closed=True,
                 transform=[["translate", -2, 1, -1]]),
               S(kind="cone", minimum=-1, maximum=1),
               S(kind="toroid", r1=0.8, r2=0.3,
                 transform=[["rotate-x", 0.7], ["translate", 0, 2, 2]])],
        config=m.ConfigDesc(divide_threshold=1))


def test_intersect_candidates_all_types():
    tsc = _all_types_scene(tmodel)
    jir = jcomp.compile_scene(convert(tsc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(tsc, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(9)
    o = rng.uniform(-4, 4, (3000, 3))
    d = rng.standard_normal((3000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jint.intersect_candidates(jir, jnp.asarray(o),
                                                jnp.asarray(d)))
    got = tint.intersect_candidates(tir, _t(o), _t(d)).numpy()
    assert got.shape == want.shape == (3000, 1 + 2 + 2 + 8 + 8 + 4)
    _same_roots(got, want, ATOL)


def test_local_normal_every_type():
    """Every type id 0..6 (6, a triangle, takes the toroid's formula as in
    the JAX package), and the pruned select of normal_at on the types
    present."""
    rng = np.random.default_rng(10)
    n = 6000
    p = rng.uniform(-2, 2, (n, 3))
    # points on the cylinder and cone caps and near the cube's edges
    p[:500, 1] = 1.0
    p[500:1000, 1] = -1.0
    p[1000:1500, :2] = 1.0 - rng.uniform(0, 2e-5, (500, 2))
    p[1500:1600] = 0.0
    params = np.zeros((n, 4))
    params[:, 0] = rng.uniform(-1.0, 1.0, n)
    params[:, 1] = np.where(p[:, 1] == 1.0, 1.0,
                            rng.uniform(0.2, 1.5, n))
    params[:500, 0], params[500:1000, 0] = -1.0, -1.0
    stype = rng.integers(0, 7, n)
    want = np.asarray(jnorm._local_normal(jnp.asarray(stype),
                                          jnp.asarray(params),
                                          jnp.asarray(p)))
    got = tnorm._local_normal(_t(stype), _t(params), _t(p),
                              range(6)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for types in ([0, 1], [2], [3, 4], [5], [0, 2, 5]):
        sel = np.isin(stype, types)
        pruned = tnorm._local_normal(_t(stype), _t(params), _t(p),
                                     types).numpy()
        np.testing.assert_array_equal(pruned[sel], got[sel])


def test_showcase_tables_hold_every_type():
    ir = tcomp.compile_scene(tdemo.primitives_showcase(8, 4),
                             dtype=torch.float64, device="cpu")
    assert [t for t, _, _ in ir.meta.type_ranges] == list(range(6))
