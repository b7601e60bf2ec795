"""Size the chunk of the 800x800 Cornell forward+backward on one CUDA card.

    python3 tools/cornell_fwd_bwd_chunks.py [--chunks 32768,65536,...]
                                            [--budget-gib 40] [--checks]

For each chunk size in turn (powers of two, smallest first), chip_smoke's
CornellGrad set-up (photon pass at chip_smoke.SEED, the live-power GI
hook, every float table a parameter, buckets from every chunk's probe)
and one warm-up chunk, then one whole frame, chunk by chunk, timed: the
wall, ms a chunk, the peak device memory over the frame, the bucket
overflow flags. Stops after the first size whose frame peaks past the
budget or runs out of memory, and prints the largest size within it
(chip_smoke.FB_CHUNK takes that one). With --checks it then runs
chip_smoke's other forward+backward phases on that size (the held chunk
against the plain versions, the card against the CPU, the Adam step, the
profiled chunk). With --shapes it profiles the middle chunk of that size
with host events and input shapes, and prints the device time of the
backward's accumulating index_put (`aten::_index_put_impl_`, the
backward of every table gather) by the shape of the table it fills.
Ends with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from fast_ray_tracer_tpu_torch import _build


def index_put_by_table(cg):
    """The middle chunk's forward+backward under torch.profiler with input
    shapes: the accumulating index_put's device time and calls by the
    shape of the table it fills, largest first."""
    from torch.profiler import ProfilerActivity, profile
    c = cg.n_chunks // 2

    def run():
        for p in cg.params.values():
            p.grad = None
        loss, _ = cg.loss(c)
        loss.backward()
        torch.cuda.synchronize()
    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
    t0 = time.perf_counter()
    by_table = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key != "aten::_index_put_impl_":
            continue
        table = tuple(e.input_shapes[0]) if e.input_shapes else ()
        t, n = by_table.get(table, (0.0, 0))
        dev = getattr(e, "device_time_total",
                      getattr(e, "cuda_time_total", 0))
        by_table[table] = (t + dev, n + e.count)
    total = sum(t for t, _ in by_table.values())
    print(f"chunk {c} of {cg.n_chunks} ({cg.chunk} pixels): accumulating "
          f"index_put {total / 1e3:.1f} ms of device time in "
          f"{sum(n for _, n in by_table.values())} calls; by table shape: "
          + ", ".join(f"{list(k)} {t / 1e3:.1f} ms ({n} calls)" for k, (t, n)
                      in sorted(by_table.items(), key=lambda kv: -kv[1][0]))
          + f"; read in {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="32768,65536,131072,262144,524288")
    ap.add_argument("--budget-gib", type=float, default=40.0)
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    _build.build(*_build.CUDA_SOURCES)
    best = None
    for chunk in (int(x) for x in args.chunks.split(",")):
        cg = None
        try:
            t0 = time.perf_counter()
            cg = cs.CornellGrad(device, chunk)
            setup = time.perf_counter() - t0
            loss, _ = cg.loss(0)
            loss.backward()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            wall, loss, ovfs, _, _ = cs.fb_frame(cg)
            peak = torch.cuda.max_memory_allocated(device)
        except torch.cuda.OutOfMemoryError as e:
            print(f"chunk {chunk}: out of memory ({str(e)[:120]})",
                  flush=True)
            break
        finally:
            del cg
            torch.cuda.empty_cache()
        print(f"chunk {chunk}: set-up {setup:.2f} s; frame {wall * 1e3:.1f} "
              f"ms ({-(-cs.CW * cs.CH // chunk)} chunks, "
              f"{wall * 1e3 / -(-cs.CW * cs.CH // chunk):.1f} ms a chunk); "
              f"peak {peak / 2**30:.3f} GiB; loss {loss:.6g}; overflow "
              f"{any(ovfs)}", flush=True)
        if peak > args.budget_gib * 2**30:
            break
        best = chunk
    print(f"largest chunk within {args.budget_gib} GiB: {best}", flush=True)
    if args.checks and best:
        cg = cs.CornellGrad(device, best)
        cs.check_fb_plain(cg)
        cs.check_fb_card_vs_cpu(device)
        cs.check_fb_adam(cg)
        cs.profile_fb_chunk(cg)
    if args.shapes and best:
        index_put_by_table(cs.CornellGrad(device, best))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
