"""The PyTorch port's entry points, on the CUDA card.

The counterpart of the JAX package's __graft_entry__.py: `python3 -m
bench_torch.entry` runs a forward step and a multi-rank dry run
(entry.py), whose ranks are processes of bench_torch/ranks.py. It imports
torch, numpy and fast_ray_tracer_tpu_torch only. The port's benchmark is
`python3 -m benchmark` (benchmark/, BENCHMARK.json).
"""
