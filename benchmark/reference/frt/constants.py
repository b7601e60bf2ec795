"""Numeric constants shared across the tracer.

EPSILON matches the reference's geometric epsilon (src/libs/linalg/linalg.h:7)
used for surface offsetting (over/under points), parallel-ray tests and
approximate comparisons. The reference computes in float64 throughout; on TPU
we default to float32 compute with the same epsilon, and tests run float64 on
CPU for bit-close parity with the reference outputs.
"""

EPSILON = 1e-5

# L1 clamp magnitude used for the GI ambient term and the PPM "scaling" encode
# (reference: src/renderer/renderer.c:766, src/libs/canvas/canvas.c:239).
SQRT3 = 1.7320508075688772

# Quartic solver epsilon (reference: src/libs/quartic/Roots3And4.c `EQN_EPS`).
QUARTIC_EPS = 1e-9
