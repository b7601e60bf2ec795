"""The benchmark of the PyTorch port (`fast_ray_tracer_tpu_torch`) on one
NVIDIA H100: `python3 -m benchmark --workload NAME --seed N --seconds S
--trace 0|1`, run from the root of a checkout (harness.py). Its cells,
metrics and bounds are BENCHMARK.json's; its configurations, traffic
mixes and per-layer readers are data files and small modules found by
name (configs/, traffic/, metrics/); the plain reference that decides
`correct` is reference/. Nothing here imports jax or the JAX package."""
