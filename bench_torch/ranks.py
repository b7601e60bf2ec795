"""Run a function on n ranks of a torch.distributed group, one process each.

    python3 -m bench_torch.ranks TARGET RANK WORLD STORE OUT PLACEMENT KWARGS

is one rank (what `spawn` starts): it joins the group through the
`file://` store STORE, calls TARGET (`module:function`) as
`function(mesh, out_dir, **kwargs)` and writes its JSON result to
OUT/rank<RANK>.json.

Placement: NCCL with one rank per card where there are as many cards as
ranks; otherwise gloo ranks sharing the cards (NCCL refuses two ranks on
one GPU; gloo's collectives go through host memory), which time-slice
them; and gloo on the CPU for `device="cpu"`.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180


def placement(n: int, device, backend=None) -> dict:
    """Where n ranks run: {"backend", "cards" (per rank; None on the CPU),
    "shared" (ranks sharing a card)}. `backend` overrides the choice."""
    if torch.device(device).type == "cpu":
        return {"backend": "gloo", "cards": [None] * n, "shared": False}
    count = torch.cuda.device_count()
    if backend is None:
        backend = "nccl" if count >= n else "gloo"
    return {"backend": backend, "cards": [r % count for r in range(n)],
            "shared": n > count}


def spawn(target: str, n: int, device, kwargs=None, backend=None,
          timeout: float = RANK_TIMEOUT_S):
    """Run `target` on n ranks placed as `placement(n, device, backend)`
    says, each within `timeout` seconds; a rank that fails or does not
    finish kills the others and raises with the end of its log. Returns
    (placement, each rank's result, the results' directory), the
    directory removed by the caller (shutil.rmtree)."""
    where = placement(n, device, backend)
    out = tempfile.mkdtemp(prefix="frt_bench_ranks_")
    env = dict(os.environ)
    if where["cards"][0] is None:
        env["OMP_NUM_THREADS"] = "1"
    procs, done = [], False
    try:
        for r in range(n):
            log = open(os.path.join(out, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "bench_torch.ranks", target, str(r),
                 str(n), f"file://{out}/store", out,
                 json.dumps({**where, "card": where["cards"][r]}),
                 json.dumps(kwargs or {})],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                log, time.monotonic() + timeout))
        failed = []
        for r, (p, log, deadline) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"no end within {timeout} s"
            log.close()
            if rc != 0:
                with open(os.path.join(out, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                failed.append(f"rank {r} of {n}: {rc}\n{tail}")
        if failed:
            raise RuntimeError(f"{target} failed on a rank:\n"
                               + "\n".join(failed))
        results = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                results.append(json.load(f))
        done = True
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if not done:
            shutil.rmtree(out, ignore_errors=True)
    return where, results, out


def main(argv) -> int:
    target, rank, world, store, out, where, kwargs = argv
    where, rank = json.loads(where), int(rank)
    from fast_ray_tracer_tpu_torch.parallel import distributed
    if where["card"] is None:
        torch.set_num_threads(1)
        ids = "cpu"
    else:
        ids = [where["card"]]
    distributed.init(store, int(world), rank, local_device_ids=ids,
                     backend=where["backend"])
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        res = fn(distributed.global_mesh(), out, **json.loads(kwargs))
    finally:
        distributed.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
