"""The PyTorch port's bench and entry points, on the CUDA card.

The counterparts of the JAX package's bench.py (headline.py),
bench_extras.py (extras.py) and __graft_entry__.py (entry.py); the
command is `python3 -m bench_torch` (__main__.py). It imports torch, numpy
and fast_ray_tracer_tpu_torch only.
"""
