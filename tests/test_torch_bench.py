"""The port's bench (bench_torch/) on the CPU at tiny sizes.

- One run of `python3 -m bench_torch --device cpu` (its `main`, every
  cell at the sizes of SMALL, one warm call each) serves the per-cell
  tests: each cell's line holds its declared metric names with their
  units, the device "cpu", and is JSON; the last line is the headline,
  under 1 KB.
- `--profile`'s round writes a Chrome trace.
- A forced bucket overflow makes the flagship cell raise; a cell that
  raises makes `main` exit non-zero, name the cell and print no headline;
  without a card `main([])` raises.
- The port's `entry(device="cpu")` forward step matches the JAX package's
  `__graft_entry__.entry()` under jax.jit (compiled at XLA's cheap
  optimization level) on the same 64x32 pixels: the
  float32 rule of tests/test_torch_render.py (99.5% of the pixels within
  1e-4), and the overflow flag is False.
- `dryrun_multichip(2, device="cpu")` (two gloo ranks in processes of
  their own) gives the loss of `dryrun_multichip(1, device="cpu")` within
  1e-6 relative, and the same canvas bit for bit.
- bench_torch imports neither jax nor the JAX package, nor chip_smoke.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from bench_torch import __main__ as bench
from bench_torch import entry, headline
from bench_torch.common import GateFailed

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# XLA's cheap optimization level for the JAX side's one jit (about 40% less
# compile time; tests/test_torch_grad_gi.py)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

# tiny sizes: the Cornell box without its block and with few photons, a
# torus of 2 x 4 x 2 triangles in soft, 4,096 triangles in the soup
SMALL = {"flagship": {"width": 32, "height": 16},
         "fwd_bwd": {"width": 24, "height": 12},
         "cornell_gi": {"width": 8, "height": 8, "photons": 500,
                        "block": False},
         "fwd_bwd_cornell": {"width": 8, "height": 8, "photons": 500,
                             "block": False},
         "mesh": {"width": 24, "height": 12, "segments": (16, 8)},
         "mesh_stream": {"n_tri": 4096, "n_rays": 256},
         "scaling": {"width": 16, "height": 8, "chunk": 64},
         "showcase": {"width": 16, "height": 8},
         "soft": {"width": 16, "height": 8, "segments": (4, 2)},
         "dof": {"width": 16, "height": 8}}

# each cell's metrics and their units
DECLARED = {
    "flagship": {
        "glass_spheres_whitted_d5_rays_per_s": "rays/s",
        "flagship_streamed_frame_s": "s", "flagship_single_call_s": "s",
        "flagship_cold_s": "s", "flagship_render_scene_cold_s": "s",
        "flagship_render_scene_warm_s": "s", "flagship_peak_gib": "GiB"},
    "fwd_bwd": {
        "fwd_bwd_ms_800x400_d5_level": "ms", "fwd_bwd_peak_gib_level": "GiB",
        "fwd_bwd_ms_800x400_d5_none": "ms", "fwd_bwd_peak_gib_none": "GiB"},
    "cornell_gi": {
        "cornell_gi_800x800_wall_s": "s",
        "cornell_gi_800x800_warm_wall_s": "s",
        "cornell_gi_photon_pass_s": "s",
        "cornell_gi_photon_pass_cold_s": "s", "cornell_gi_px_per_s": "px/s",
        "cornell_gi_warm_px_per_s": "px/s",
        "cornell_gi_rays_per_s_lb": "rays/s",
        "cornell_gi_warm_rays_per_s_lb": "rays/s",
        "cornell_gi_peak_gib": "GiB"},
    "fwd_bwd_cornell": {
        "fwd_bwd_ms_cornell_800x800": "ms", "cornell_fwd_bwd_chunk_ms": "ms",
        "cornell_fwd_bwd_cold_ms": "ms", "cornell_fwd_bwd_photon_pass_s": "s",
        "cornell_fwd_bwd_grad_l1_mat_kd_light": "1",
        "cornell_fwd_bwd_peak_gib": "GiB"},
    "mesh": {
        "mesh_141k_tri_600x240_wall_s": "s",
        "mesh_141k_tri_600x240_warm_wall_s": "s",
        "mesh_141k_tri_px_per_s": "px/s",
        "mesh_141k_tri_warm_px_per_s": "px/s",
        "mesh_141k_tri_warm_traced_rays_per_s": "rays/s",
        "mesh_141k_tri_peak_gib": "GiB"},
    "mesh_stream": {
        "mesh_stream_512k_ms": "ms", "mesh_stream_512k_plain_ms": "ms",
        "mesh_stream_parity": "bool"},
    "scaling": {
        "scaling_1Mpx_wall_s_1": "s", "scaling_1Mpx_wall_s_2": "s",
        "scaling_1Mpx_cold_s_1": "s", "scaling_1Mpx_cold_s_2": "s",
        "scaling_1Mpx_shard_overhead": "ratio"},
    **{cell: {f"{cell}_800x400_cold_s": "s", f"{cell}_800x400_warm_s": "s",
              f"{cell}_800x400_warm_px_per_s": "px/s",
              f"{cell}_800x400_peak_gib": "GiB"}
       for cell in ("showcase", "soft", "dof")},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One CPU run of every cell: (exit code, stdout lines)."""
    out = io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setenv("FRT_COMPILE_CACHE", str(tmp_path_factory.mktemp("cache")))
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", "cpu", "--reps", "1"], sizes=SMALL)
    finally:
        mp.undo()
    return rc, out.getvalue().strip().splitlines()


def test_cells_cover_the_bench():
    assert list(bench.CELLS) == list(DECLARED) == list(SMALL)


@pytest.mark.parametrize("cell", list(DECLARED))
def test_cell_line(run, cell):
    """The cell's line: its metric names and units, each a median with its
    min, max and count, on the device "cpu", JSON."""
    rc, lines = run
    assert rc == 0
    got = [json.loads(x) for x in lines[:-1]]
    line = next(x for x in got if x["cell"] == cell)
    assert line["device"] == {"type": "cpu"}
    assert {k: m["unit"] for k, m in line["metrics"].items()} == \
        DECLARED[cell]
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit", "min", "max", "n"}, name
        if m["unit"] == "GiB":          # no device memory on the CPU
            assert m["value"] is None and m["n"] == 0
        elif m["unit"] == "bool":
            assert m["value"] is True
        else:
            assert m["n"] >= 1 and m["min"] <= m["value"] <= m["max"], name
            assert np.isfinite(m["value"]) and m["value"] > 0.0, name
    assert json.loads(json.dumps(line)) == line


def test_headline_is_the_last_line(run):
    rc, lines = run
    assert rc == 0 and len(lines) == len(DECLARED) + 1
    assert len(lines[-1].encode()) < 1024
    head = json.loads(lines[-1])
    flag = json.loads(lines[0])
    want = flag["metrics"][headline.METRIC]["value"]
    assert head["metric"] == headline.METRIC and head["unit"] == "rays/s"
    assert head["value"] == want
    assert head["vs_baseline"] == pytest.approx(want / (400 * 200 * 126
                                                        / 1.329))
    assert head["device"] == {"type": "cpu"}
    assert head["cells"] == list(DECLARED)


def test_forced_overflow_raises(monkeypatch):
    """Buckets too small at every margin of the ladder: the flagship
    raises instead of timing dropped rays."""
    monkeypatch.setattr(headline, "quantize_buckets",
                        lambda counts, margin: (256,) * len(counts))
    with pytest.raises(GateFailed, match="overflow"):
        headline.flagship("cpu", 1, None, width=32, height=16)


def test_profile_writes_a_trace(tmp_path):
    """--profile's round (here a stand-in for the headline loop): a Chrome
    trace and the busy-time summary, with no device events on the CPU."""
    prof = headline.profile_round(
        "cpu", lambda: torch.ones(64).cumsum(0) * 2.0, str(tmp_path), 1.0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert prof["device_events"] == 0 and prof["idle_share"] is None
    assert prof["window_s"] > 0.0 and prof["unprofiled_round_s"] == 1.0


def test_failed_cell_exits_nonzero(monkeypatch, capsys):
    def broken(*a, **k):
        raise GateFailed("forced")

    monkeypatch.setitem(bench.CELLS, "mesh", broken)
    rc = bench.main(["--device", "cpu", "--reps", "1", "--cell", "dof",
                     "mesh", "showcase"], sizes=SMALL)
    out, err = capsys.readouterr()
    assert rc != 0
    assert "cell mesh failed" in err and "forced" in err
    lines = out.strip().splitlines()
    assert [json.loads(x)["cell"] for x in lines] == ["dof"]
    assert '"metric": ' not in out      # no headline


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_entry_matches_jax():
    """The 64x32 float32 forward step against JAX's under jax.jit."""
    fn, args = entry.entry(device="cpu")
    colors, overflow = fn(*args)
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn).lower(*jargs).compile(FAST_XLA)(*jargs))
    got = colors.numpy()
    assert got.shape == want.shape == (64 * 32, 3)
    assert not bool(overflow)
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.995, close.mean()


def test_dryrun_two_ranks_match_one(capsys):
    """Both dry runs at once (three rank processes), to halve the wait."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        one, two = pool.map(lambda n: entry.dryrun_multichip(n, device="cpu"),
                            (1, 2))
    out = capsys.readouterr().out
    for n in (1, 2):
        assert f"dryrun_multichip({n}): sharded render (8, 16, 3) OK" in out
        assert f"dryrun_multichip({n}): loss=" in out
    assert two["placement"]["backend"] == "gloo"
    assert two["loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert np.isfinite(one["loss"]) and one["loss"] > 0.0
    np.testing.assert_array_equal(two["canvas"], one["canvas"])


def test_bench_imports_no_jax():
    """With jax and the JAX package unimportable, every module of the bench
    imports; chip_smoke is not imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fast_ray_tracer_tpu'] = None\n"
        "import bench_torch, bench_torch.__main__, bench_torch.entry\n"
        "import bench_torch.extras, bench_torch.headline, bench_torch.ranks\n"
        "assert 'chip_smoke' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
