"""The port's stream compaction (fast_ray_tracer_tpu_torch/ops/compact.py)
against the JAX package's Pallas kernels, run in interpret mode, and the
XLA nonzero/gather form they replace — bit for bit, since the operation
is pure data movement. On the CPU the port's public functions take their
plain torch versions; the CUDA kernels are held to the same plain versions
on the card by chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import compact_pallas as cp
from fast_ray_tracer_tpu_torch.ops import compact

torch.set_num_threads(1)

# the case grid of tests/test_compact_pallas.py, plus one overflow case
# (count > B; B a multiple of 128, where the Pallas kernel's first B rows
# are exact) in which only the rows below B are compared
CASES = [(256, 256, 6, 0.5, False), (1024, 512, 6, 0.3, False),
         (1500, 1024, 9, 0.7, False), (2048, 1152, 3, 0.05, False),
         (4096, 2048, 9, 0.95, False), (300, 128, 2, 0.0, False),
         (1024, 256, 6, 1.0, False), (2048, 1024, 6, 0.8, True)]
IDS = [f"n{n}_b{b}_c{c}" + ("_overflow" if o else "")
       for n, b, c, _, o in CASES]


def _inputs(n, b, c, p, overflow, seed=0):
    rng = np.random.default_rng(seed)
    act = rng.random(n) < p
    on = np.nonzero(act)[0]
    if overflow:
        assert len(on) > b
    elif len(on) > b:
        act[on[b:]] = False
    src = rng.standard_normal((n, c)).astype(np.float32)
    child = rng.standard_normal((b, c)).astype(np.float32)
    return act, src, child


def _fill(c):
    return tuple(float(i) + 0.5 for i in range(c))


@functools.lru_cache(maxsize=None)
def _jax_results():
    """{case: (Pallas compact, Pallas expand, XLA compact, XLA expand)}
    for every case, from one jitted program: each interpret-mode kernel
    costs a compile, and one program for the whole grid compiles in about
    two thirds of the time that one program per case takes."""
    def grid(*args):
        out = []
        for (n, b, c, p, overflow), (a, s, ch) in zip(
                CASES, zip(args[0::3], args[1::3], args[2::3])):
            out.append((cp.compact_rows(s, a, b, _fill(c)),
                        cp.expand_rows(ch, a),
                        _xla_compact(s, a, b, _fill(c)),
                        _xla_expand(ch, a)))
        return out

    args = [jnp.asarray(x) for case in CASES for x in _inputs(*case)]
    with cp.override_mode("interpret"):
        out = jax.jit(grid)(*args)
    return {case: tuple(np.asarray(x) for x in res)
            for case, res in zip(CASES, out)}


def _xla_compact(src, act, b, fill):
    """trace_bucketed's XLA branch: nonzero(size=B) + one row gather."""
    pad = jnp.concatenate([src, jnp.asarray(fill, src.dtype)[None]])
    (idx,) = jnp.nonzero(act, size=b, fill_value=src.shape[0])
    return pad[idx]


def _xla_expand(child, act):
    pos = jnp.clip(jnp.cumsum(act.astype(jnp.int32)) - 1, 0,
                   child.shape[0] - 1)
    return jnp.where(act[:, None], child[pos], 0.0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compact_plain_matches_pallas_and_xla(case):
    n, b, c, p, overflow = case
    act, src, _ = _inputs(*case)
    got = compact.compact_rows(torch.from_numpy(src), torch.from_numpy(act),
                               b, _fill(c)).numpy()
    pallas, _, xla, _ = _jax_results()[case]
    assert got.shape == (b, c)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_expand_plain_matches_pallas_and_xla(case):
    n, b, c, p, overflow = case
    act, _, child = _inputs(*case)
    got = compact.expand_rows(torch.from_numpy(child),
                              torch.from_numpy(act)).numpy()
    _, pallas, _, xla = _jax_results()[case]
    # under overflow only the lanes routed from a real child row (or none)
    # are defined; the Pallas kernel leaves the others unspecified
    keep = ~act | (np.cumsum(act) - 1 < b)
    assert got.shape == (n, c)
    np.testing.assert_array_equal(got[keep], pallas[keep])
    np.testing.assert_array_equal(got, xla)


def test_vjps_match_jax():
    """The autograd.Function pair's VJPs equal jax.vjp of the Pallas pair."""
    rng = np.random.default_rng(2)
    n, b, c = 1300, 1024, 6
    act = rng.random(n) < 0.6
    src = rng.standard_normal((n, c)).astype(np.float32)
    child = rng.standard_normal((b, c)).astype(np.float32)
    ct_b = rng.standard_normal((b, c)).astype(np.float32)
    ct_n = rng.standard_normal((n, c)).astype(np.float32)
    fill = (0.0,) * c
    act_t = torch.from_numpy(act)

    s = torch.from_numpy(src).requires_grad_()
    compact.compact_rows(s, act_t, b, fill).backward(torch.from_numpy(ct_b))
    ch = torch.from_numpy(child).requires_grad_()
    compact.expand_rows(ch, act_t).backward(torch.from_numpy(ct_n))

    @jax.jit
    def jax_vjps(a, x, y, gb, gn):
        _, vjp_c = jax.vjp(lambda v: cp.compact_rows(v, a, b, fill), x)
        _, vjp_e = jax.vjp(lambda v: cp.expand_rows(v, a), y)
        return vjp_c(gb)[0], vjp_e(gn)[0]

    with cp.override_mode("interpret"):
        want_s, want_ch = (np.asarray(g) for g in jax_vjps(
            *(jnp.asarray(x) for x in (act, src, child, ct_b, ct_n))))
    np.testing.assert_allclose(s.grad.numpy(), want_s, rtol=0, atol=0)
    np.testing.assert_allclose(ch.grad.numpy(), want_ch, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_forms_agree_with_definition(dtype):
    """compact then expand restores exactly the active rows (any dtype),
    and the fill row pads the bucket."""
    rng = np.random.default_rng(3)
    n, b, c = 777, 640, 6
    act = torch.from_numpy(rng.random(n) < 0.4)
    src = torch.from_numpy(rng.standard_normal((n, c))).to(dtype)
    fill = (1e30, 1e30, 1e30, 1.0, 1.0, 1.0)
    rows = compact.compact_rows(src, act, b, fill)
    k = int(act.sum())
    assert torch.equal(rows[:k], src[act])
    assert torch.equal(rows[k:], torch.tensor(fill, dtype=dtype).expand(
        b - k, c))
    back = compact.expand_rows(rows, act)
    assert torch.equal(back, torch.where(act[:, None], src, 0.0))


def test_no_fallback_off_cpu():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises."""
    src = torch.zeros((4, 6), device="meta")
    act = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        compact.compact_rows(src, act, 4, (0.0,) * 6)
    with pytest.raises(ValueError):
        compact.expand_rows(src, act)


# the expansion's contract at its edges, which the CUDA kernel keeps too:
# (N, B, C, density); density None = the first B + 37 lanes active and the
# rest not, so the live count passes B and the lanes past it read row B-1
EDGES = {"n0": (0, 16, 9, 0.5), "all_inactive": (1000, 64, 9, 0.0),
         "all_active": (1000, 1000, 9, 1.0),
         "count_past_b": (1000, 300, 9, None),
         "c1": (1537, 900, 1, 0.6), "c32": (1537, 900, 32, 0.6)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_expand_edges_match_xla(edge, dtype):
    """The port's expand_rows on the CPU equals the jnp expansion,
    evaluated eagerly, bit for bit: N = 0, no live lane, every lane live,
    a live count past B (the clamp at row B - 1), C = 1 and C = 32."""
    n, b, c, p = EDGES[edge]
    rng = np.random.default_rng(11)
    if p is None:
        act = np.arange(n) < b + 37
    else:
        act = rng.random(n) < p
    child = rng.standard_normal((b, c)).astype(dtype)
    got = compact.expand_rows(torch.from_numpy(child),
                              torch.from_numpy(act)).numpy()
    want = np.asarray(_xla_expand(jnp.asarray(child), jnp.asarray(act)))
    assert got.shape == (n, c) and got.dtype == dtype
    assert want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if p is None:
        np.testing.assert_array_equal(got[b:b + 37], np.repeat(
            child[b - 1:], 37, 0))
