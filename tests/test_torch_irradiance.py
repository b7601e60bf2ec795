"""The irradiance estimate's routes (render/photon.irradiance_estimate).

On the CPU:
- the route chooser on every branch, and what the estimate hands it;
- CPU tensors take the torch route, uncounted, without the kernel's
  library; the grad path's torch route counts `irradiance_plain`; the
  kernel route's arguments, its launch count and no host sync, through a
  stand-in for the library; both counters through the tracer;
- the torch route against a brute-force pm_irradiance_estimate on hand-made
  maps in float64 (found, r^2 bit for bit, irr to 1e-12), and bitwise the
  same with and without its r^2 output.

On a CUDA card (skipped without one): the query kernel against the torch
route on the same device, on hand-made maps in float32 and float64: ties
at the num-th distance with more than num selected, n_in at num and num +-
1, found < 8, parked 1e30 points, empty and out-of-grid neighbour cells,
a 100,000-photon cluster (the block's route), num past a warp's buffer and
more photons tied at the threshold than a buffer holds (the passes over
the candidates), photons on walls. `found` and r^2 bit for bit, irr within
1e-5 (float32) or 1e-12 (float64) relative (the sums' order), two calls
bitwise. Run there, from the repository's root:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_irradiance.py -q

(the test suite's conftest imports jax, which the card's machine lacks).
"""

import math

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu_torch.render import photon
from fast_ray_tracer_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

RADIUS, CONE_K = 0.1, 1.0
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _fresh_counts():
    for k in photon.LAUNCHES:
        photon.LAUNCHES[k] = 0
    yield


@pytest.fixture
def recorder():
    rec = P.Recorder()
    remove = P.add_sink(rec)
    yield rec
    remove()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the query kernel runs on a CUDA card only")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# hand-made maps: (pos, power, dirs, points, eye, num), numpy float64
# ---------------------------------------------------------------------------

def _ball(rng, n, center, lo, hi):
    """n points at distances in [lo, hi) around `center`."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.asarray(center) + d * rng.uniform(lo, hi, (n, 1))


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    r = RADIUS
    c = np.array([0.5, 0.5, 0.5])
    num = 100
    if name == "ties":
        # 60 photons nearer than the 80 at one point: the 100th nearest is
        # in the tie, and all 140 are selected
        pos = np.concatenate([_ball(rng, 60, c, 0.0, 0.5 * r),
                              np.repeat([c + [0.6 * r, 0, 0]], 80, 0),
                              _ball(rng, 400, c, 1.1 * r, 3 * r)])
        pts = np.stack([c, c + [1e-3, 0, 0]])
    elif name.startswith("n_in_"):
        k = num + {"n_in_num_minus_1": -1, "n_in_num": 0,
                   "n_in_num_plus_1": 1}[name]
        pos = np.concatenate([_ball(rng, k, c, 0.0, 0.9 * r),
                              _ball(rng, 500, c, 1.1 * r, 3 * r)])
        pts = c[None]
    elif name == "few_found":
        pos = np.concatenate([_ball(rng, 5, c, 0.0, 0.9 * r),
                              _ball(rng, 40, c, 1.1 * r, 3 * r)])
        pts = np.stack([c, c + [0.5 * r, 0, 0], c + [2 * r, 0, 0]])
    elif name == "parked":
        pos = _ball(rng, 3000, c, 0.0, 4 * r)
        pts = np.array([[1e30] * 3, [-1e30] * 3, c, [1e30, 0.5, 0.5]])
    elif name == "edges":
        # sparse photons: most of a query's 27 cells are empty, and queries
        # at the grid's faces and far outside it reach cells out of it
        pos = rng.uniform(0.0, 1.0, (4000, 3))
        pts = np.concatenate([rng.uniform(-0.05, 1.05, (200, 3)),
                              [[5.0, 5.0, 5.0], [-3.0, 0.5, 0.5],
                               [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]])
    elif name == "cluster_100k":
        # a caustic's focus: 100,000 photons in one cell, more candidates
        # than one warp takes
        pos = np.concatenate([_ball(rng, 100_000, c, 0.0, 0.02),
                              rng.uniform(0.0, 1.0, (20_000, 3))])
        pts = np.concatenate([c[None], _ball(rng, 60, c, 0.0, 0.15)])
    elif name == "num_past_cap":
        num = 600
        pos = np.concatenate([_ball(rng, 2000, c, 0.0, 0.9 * r),
                              _ball(rng, 2000, c, 1.1 * r, 3 * r)])
        pts = np.concatenate([c[None], _ball(rng, 20, c, 0.0, 0.1)])
    elif name == "ties_past_cap":
        pos = np.concatenate([_ball(rng, 50, c, 0.0, 0.2 * r),
                              np.repeat([c + [0, 0.3 * r, 0]], 700, 0),
                              _ball(rng, 500, c, 0.4 * r, 0.9 * r)])
        pts = np.stack([c, c + [1e-4, 0, 0]])
    elif name == "walls":
        # photons on three walls of a unit box, queries on them
        n = 60_000
        uv = rng.uniform(0.0, 1.0, (n, 2))
        axis = rng.integers(0, 3, n)
        pos = np.zeros((n, 3))
        for a in range(3):
            m = axis == a
            pos[m, a] = 0.0
            pos[m, (a + 1) % 3] = uv[m, 0]
            pos[m, (a + 2) % 3] = uv[m, 1]
        pts = pos[rng.choice(n, 3000, replace=False)] \
            + rng.normal(scale=1e-3, size=(3000, 3))
    else:
        raise ValueError(name)
    power = rng.uniform(0.0, 1.0, (pos.shape[0], 3))
    dirs = _unit(rng, pos.shape[0])
    eye = _unit(rng, pts.shape[0])
    return pos, power, dirs, pts, eye, num


CASES = ("ties", "n_in_num_minus_1", "n_in_num", "n_in_num_plus_1",
         "few_found", "parked", "edges", "cluster_100k", "num_past_cap",
         "ties_past_cap", "walls")


def _map(pos, power, dirs, dtype, device):
    return photon.build_photon_map(pos, power, dirs, RADIUS, dtype, device)


def _oracle(pos, power, dirs, pts, eye, num):
    """pm_irradiance_estimate by brute force over every photon, in float64:
    (irr, found, r2)."""
    md2 = RADIUS * RADIUS
    out = np.zeros((len(pts), 3))
    found = np.zeros(len(pts), dtype=np.int64)
    r2s = np.full(len(pts), md2)
    for q in range(len(pts)):
        d = pos - pts[q]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        inr = d2 < md2
        n = int(inr.sum())
        r2 = np.partition(d2[inr], num - 1)[num - 1] if n >= num else md2
        front = ((dirs[:, 0] * eye[q, 0] + dirs[:, 1] * eye[q, 1])
                 + dirs[:, 2] * eye[q, 2]) < 0
        sel = inr & (d2 <= r2) & front
        w = 1.0 - np.sqrt(d2[sel]) * (1.0 / (CONE_K * RADIUS))
        s = (w[:, None] * power[sel]).sum(0)
        s = s * (1.0 / ((1.0 - 2.0 / (3.0 * CONE_K)) * math.pi * r2))
        found[q] = min(n, num)
        out[q] = s if found[q] >= 8 else 0.0
        r2s[q] = r2
    return out, found, r2s


# ---------------------------------------------------------------------------
# routing and counting (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_type, grad, want", [
    ("cpu", False, "cpu"), ("cpu", True, "cpu"),
    ("cuda", False, "irradiance"), ("cuda", True, "irradiance_plain")])
def test_route_chooser(device_type, grad, want):
    assert photon.estimate_route(device_type, grad) == want


def test_route_chooser_refuses_other_devices():
    with pytest.raises(ValueError):
        photon.estimate_route("meta", False)


def _small(dtype=torch.float64):
    pos, power, dirs, pts, eye, num = _case("ties")
    pm = _map(pos, power, dirs, dtype, "cpu")
    return (pm, torch.tensor(pts, dtype=dtype),
            torch.tensor(eye, dtype=dtype), num)


@pytest.mark.parametrize("how, want", [
    ("constants", False), ("points_grad", True), ("power_grad", True),
    ("no_grad_mode", False)])
def test_route_sees_the_grad_path(how, want, monkeypatch):
    pm, pts, eye, num = _small()
    seen = []
    real = photon.estimate_route

    def spy(device_type, grad):
        seen.append((device_type, grad))
        return real(device_type, grad)
    monkeypatch.setattr(photon, "estimate_route", spy)
    if how == "points_grad":
        pts.requires_grad_(True)
    if how in ("power_grad", "no_grad_mode"):
        pm = pm._replace(power=pm.power.clone().requires_grad_(True))
    with torch.set_grad_enabled(how != "no_grad_mode"):
        photon.irradiance_estimate(pm, pts, eye, num, RADIUS, CONE_K)
    assert seen == [("cpu", want)]


def test_cpu_takes_the_torch_route_uncounted(monkeypatch, recorder):
    pm, pts, eye, num = _small()

    def no_library(*a, **k):
        raise AssertionError("the CPU route loaded the kernel's library")
    monkeypatch.setattr(photon, "_load", no_library)
    irr, found = photon.irradiance_estimate(pm, pts, eye, num, RADIUS,
                                            CONE_K)
    want = photon._irradiance_estimate(pm, pts, eye, num, RADIUS, CONE_K)
    assert torch.equal(irr, want[0]) and torch.equal(found, want[1])
    assert photon.LAUNCHES == {"irradiance": 0, "irradiance_plain": 0}
    counts = recorder.counts[None]
    assert counts["gi.estimate_queries"] == pts.shape[0]
    assert counts["gi.estimate_slots"] > 0
    assert not any(k.startswith("launches.irradiance") for k in counts)


def test_grad_path_counts_the_torch_route(monkeypatch, recorder):
    pm, pts, eye, num = _small()
    monkeypatch.setattr(photon, "estimate_route",
                        lambda device_type, grad: "irradiance_plain")
    irr, found = photon.irradiance_estimate(pm, pts, eye, num, RADIUS,
                                            CONE_K)
    want = photon._irradiance_estimate(pm, pts, eye, num, RADIUS, CONE_K)
    assert torch.equal(irr, want[0]) and torch.equal(found, want[1])
    assert photon.LAUNCHES == {"irradiance": 0, "irradiance_plain": 1}
    counts = recorder.counts[None]
    assert counts["launches.irradiance_plain"] == 1
    assert "launches.irradiance" not in counts
    assert counts["gi.estimate_slots"] > 0


class _FakeLibrary:
    """Stands in for the kernel's library on the CPU: records the entry's
    arguments and writes the torch route's outputs where the pointers
    say."""

    def __init__(self, want):
        self.want, self.calls = want, []

    def __getattr__(self, name):
        if not name.startswith("frt_irradiance_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            irr, found, r2 = self.want
            import ctypes
            for t, ptr in ((irr, args[21]), (found, args[22]), (r2, args[23])):
                if ptr:
                    ctypes.memmove(ptr, t.data_ptr(),
                                   t.numel() * t.element_size())
            return 0
        return entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_route_arguments(dtype, monkeypatch):
    """The kernel route through a stand-in library: the entry of the
    points' type gets the map's tables, its grid and the torch route's
    scalars as Python computes them; one launch counted, through the
    tracer too; no host sync."""
    pm, pts, eye, num = _small(dtype)
    r2 = torch.empty(pts.shape[0], dtype=dtype)
    want = photon._irradiance_estimate(pm, pts, eye, num, RADIUS, CONE_K,
                                       r2_out=r2)
    fake = _FakeLibrary((*want, r2))
    monkeypatch.setattr(photon, "_load", lambda: fake)
    monkeypatch.setattr(photon, "estimate_route",
                        lambda device_type, grad: "irradiance")
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    recorder = P.Recorder()
    remove = P.add_sink(recorder)
    try:
        got = photon.irradiance_estimate(pm, pts, eye, num, RADIUS, CONE_K)
    finally:
        remove()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    (name, args), = fake.calls
    assert name == "frt_irradiance_" + ("f32" if dtype == torch.float32
                                        else "f64")
    assert args[2] == pts.shape[0] and args[6] == pm.n
    assert args[9] == pm.cell_keys.shape[0]
    assert args[10:13] == pm.dims and args[13:16] == pm.grid_origin
    assert args[16] == pm.cell_size and args[17] == num
    assert args[18:21] == (RADIUS * RADIUS, 1.0 / (CONE_K * RADIUS),
                           (1.0 - 2.0 / (3.0 * CONE_K)) * math.pi)
    assert args[23] == 0                      # no r^2 asked for
    assert args[3] == pm.pos.data_ptr() and args[7] == pm.cell_keys.data_ptr()
    assert photon.LAUNCHES == {"irradiance": 1, "irradiance_plain": 0}
    counts = recorder.counts[None]
    assert counts["launches.irradiance"] == 1
    assert "gi.estimate_slots" not in counts
    assert not any(k.startswith("host_syncs") for k in counts)


def test_kernel_route_checks_its_tensors():
    pm, pts, eye, num = _small()
    with pytest.raises(ValueError):
        photon.irradiance_cuda(pm, pts, eye.float(), num, RADIUS, CONE_K)
    with pytest.raises(TypeError):
        photon.irradiance_cuda(pm, pts.half(), eye, num, RADIUS, CONE_K)
    with pytest.raises(ValueError):
        photon.irradiance_cuda(pm, pts, eye, 0, RADIUS, CONE_K)


# ---------------------------------------------------------------------------
# the torch route against brute force (CPU, float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c for c in CASES if c != "cluster_100k"])
def test_torch_route_matches_brute_force(name):
    pos, power, dirs, pts, eye, num = _case(name)
    pm = _map(pos, power, dirs, torch.float64, "cpu")
    tp, te = torch.tensor(pts), torch.tensor(eye)
    r2 = torch.empty(len(pts), dtype=torch.float64)
    irr, found = photon._irradiance_estimate(pm, tp, te, num, RADIUS,
                                             CONE_K, r2_out=r2)
    # the positions as the map stores them (sorted by cell)
    pos_s, pow_s, dir_s = (t.numpy() for t in (pm.pos, pm.power, pm.dirs))
    want, wfound, wr2 = _oracle(pos_s, pow_s, dir_s, pts, eye, num)
    assert np.array_equal(found.numpy(), wfound)
    assert np.array_equal(r2.numpy(), wr2)
    np.testing.assert_allclose(irr.numpy(), want, rtol=1e-12, atol=1e-300)
    again = photon.irradiance_estimate(pm, tp, te, num, RADIUS, CONE_K)
    assert torch.equal(again[0], irr) and torch.equal(again[1], found)


def test_torch_route_brute_force_cases_reach_their_branches():
    """The hand-made maps hold what their names say (brute force)."""
    def founds(name):
        pos, power, dirs, pts, eye, num = _case(name)
        return _oracle(pos, power, dirs, pts, eye, num)[1], num
    f, num = founds("n_in_num_minus_1")
    assert f[0] == num - 1
    f, num = founds("n_in_num_plus_1")
    assert f[0] == num
    f, _ = founds("few_found")
    assert 0 < f[0] < 8
    f, _ = founds("parked")
    assert list(f[:2]) == [0, 0] and f[2] == 100


# ---------------------------------------------------------------------------
# the kernel against the torch route (CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_torch_route(name, dtype, cuda):
    pos, power, dirs, pts, eye, num = _case(name)
    pm = _map(pos, power, dirs, dtype, cuda)
    tp = torch.tensor(pts, dtype=dtype, device=cuda)
    te = torch.tensor(eye, dtype=dtype, device=cuda)
    R = tp.shape[0]
    r2p = torch.empty(R, dtype=dtype, device=cuda)
    r2k = torch.empty(R, dtype=dtype, device=cuda)
    with torch.no_grad():
        pirr, pfound = photon._irradiance_estimate(pm, tp, te, num, RADIUS,
                                                   CONE_K, r2_out=r2p)
        kirr, kfound = photon.irradiance_cuda(pm, tp, te, num, RADIUS,
                                              CONE_K, r2_out=r2k)
        again = photon.irradiance_estimate(pm, tp, te, num, RADIUS, CONE_K)
    torch.cuda.synchronize()
    assert photon.LAUNCHES == {"irradiance": 2, "irradiance_plain": 0}
    assert torch.equal(kfound, pfound)
    assert torch.equal(r2k, r2p)
    rtol = RTOL[dtype]
    err = ((kirr - pirr).abs() <= rtol * pirr.abs()) | (kirr == pirr)
    assert bool(err.all()), float(((kirr - pirr).abs()
                                   / pirr.abs().clamp(min=1e-300)).max())
    assert torch.equal(again[0], kirr) and torch.equal(again[1], kfound)
    if name == "cluster_100k":
        # the block's route: more candidates than a warp takes
        s, e = photon._neighbor_extents(pm, tp)
        light = int(photon._load().frt_irradiance_light_max())
        assert int(((e - s).sum(1) > light).sum()) > 0


@pytest.mark.parametrize("reach", [0.6, 1.4])
@pytest.mark.parametrize("name", ["edges", "walls", "cluster_100k"])
def test_kernel_matches_torch_route_at_another_reach(name, reach, cuda):
    """max_dist other than the map's cell (at 1.4 the 27 cells no longer
    cover it, in either route): the kernel stays the torch route's
    estimate."""
    pos, power, dirs, pts, eye, num = _case(name)
    dtype = torch.float32
    pm = _map(pos, power, dirs, dtype, cuda)
    tp = torch.tensor(pts, dtype=dtype, device=cuda)
    te = torch.tensor(eye, dtype=dtype, device=cuda)
    md = reach * RADIUS
    r2p = torch.empty(tp.shape[0], dtype=dtype, device=cuda)
    r2k = torch.empty(tp.shape[0], dtype=dtype, device=cuda)
    with torch.no_grad():
        pirr, pfound = photon._irradiance_estimate(pm, tp, te, num, md,
                                                   CONE_K, r2_out=r2p)
        kirr, kfound = photon.irradiance_cuda(pm, tp, te, num, md, CONE_K,
                                              r2_out=r2k)
    assert torch.equal(kfound, pfound) and torch.equal(r2k, r2p)
    ok = ((kirr - pirr).abs() <= RTOL[dtype] * pirr.abs()) | (kirr == pirr)
    assert bool(ok.all())
