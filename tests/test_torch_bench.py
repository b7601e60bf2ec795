"""The port's entry points (bench_torch/) on the CPU.

- The port's `entry(device="cpu")` forward step matches the JAX package's
  `__graft_entry__.entry()` under jax.jit (compiled at XLA's cheap
  optimization level) on the same 64x32 pixels: the
  float32 rule of tests/test_torch_render.py (99.5% of the pixels within
  1e-4), and the overflow flag is False.
- `dryrun_multichip(2, device="cpu")` (two gloo ranks in processes of
  their own) gives the loss of `dryrun_multichip(1, device="cpu")` within
  1e-6 relative, and the same canvas bit for bit.
- Without a card `entry.resolve(None)` raises.
- bench_torch imports neither jax nor the JAX package, nor chip_smoke.
"""

import concurrent.futures
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from bench_torch import entry

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# XLA's cheap optimization level for the JAX side's one jit (about 40% less
# compile time; tests/test_torch_grad_gi.py)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.resolve(None)


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
    """With jax and the JAX package unimportable, every module of
    bench_torch imports; chip_smoke is not imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fast_ray_tracer_tpu'] = None\n"
        "import bench_torch, bench_torch.entry, bench_torch.ranks\n"
        "assert 'chip_smoke' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
