"""Show where torch's CPU intra-op pool splits a small float kernel.

    python tools/torch_thread_split.py

Times torch.sqrt and torch.exp (float64, out=) just below and above 2,048
and 32,768 elements with one and with two torch threads. A jump in time
from 2,048 to 2,049 elements with two threads, and none with one, shows
that the kernel is split across the OpenMP pool at a grain of 2,048
elements: a 4,096-element sqrt computes rows 2048-4095 on the second
thread. The port's CPU tests pin torch to one thread for that reason
(ROADMAP fault C6). Prints one line per thread count and op, times in us.
"""

import time

import torch


def per_call_us(op, n, calls=20000):
    x = torch.rand(n, dtype=torch.float64) + 0.5
    out = torch.empty_like(x)
    for _ in range(200):
        op(x, out=out)
    t0 = time.perf_counter()
    for _ in range(calls):
        op(x, out=out)
    return (time.perf_counter() - t0) / calls * 1e6


def main():
    sizes = (1024, 2048, 2049, 4096, 32768, 32769)
    for threads in (1, 2):
        torch.set_num_threads(threads)
        for name, op in (("sqrt", torch.sqrt), ("exp", torch.exp)):
            times = ", ".join(f"{n}: {per_call_us(op, n):.2f}"
                              for n in sizes)
            print(f"threads={threads} {name} [elements: us per call] {times}",
                  flush=True)


if __name__ == "__main__":
    main()
