"""Integer-hash value noise, bit-compatible with the reference's perlin lib.

(src/libs/perlin/perlin.c, czinn/perlin; the port of the JAX package's
ops/perlin.py.) The reference's quirks are kept: int32 wraparound in the
hash, truncation toward zero of |coord| in smooth3d while the fraction is
taken against that truncated magnitude (negative coordinates get
out-of-range fractions), the 31-bit hash rounded through float32, cosine
interpolation, and the octave loop that halves the frequency each octave.

The hash is computed in int64 and wrapped to the int32 value with the same
low 32 bits wherever the next product could leave the int64 range, so the
wrap is explicit and the same on the CPU and the card (wrapping is a ring
homomorphism: the int32 result of every sum and product is the wrapped
int64 one). Float-to-int conversions saturate as XLA's do (NaN -> 0), so
dead lanes (far outside the scene) convert to the same integers
everywhere. The eight lattice corners of a cell are hashed as one batch
along a last axis of 8, each lane's arithmetic unchanged. The noise comes
back in the coordinates' dtype (the JAX package widens to float64 under
x64).
"""

from __future__ import annotations

import math

import torch

_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


def to_int32_saturated(x):
    """C-style truncation of a float tensor to int32 values, saturated at
    the int32 range and NaN -> 0 (XLA's convert), as int64."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return x.clamp(_INT32_MIN, _INT32_MAX).to(torch.int64)


def _wrap(n):
    """int64 -> the int32 value with the same low 32 bits."""
    return ((n + 2**31) & 0xFFFFFFFF) - 2**31


def _rawnoise(n, dtype):
    """n: int64 tensor of int32 values."""
    n = _wrap((n << 13) ^ n)
    inner = _wrap(_wrap(n * n) * 15731 + 789221)
    h = (n * inner + 1376312589) & 0x7FFFFFFF      # |n * inner| < 2^62
    return 1.0 - h.to(torch.float32).to(dtype) / 1073741824.0


def _lattice(x, y, z, octave, seed):
    """The hash's linear part, unwrapped: with int32 inputs every product
    is below 2^47, so the sum is exact in int64."""
    return x * 1919 + y * 31337 + z * 7669 + octave * 3463 + seed * 13397


def _noise3d(x, y, z, octave, seed, dtype):
    """x, y, z: int64 tensors of int32 values; octave, seed: ints or int64
    tensors of int32 values."""
    return _rawnoise(_wrap(_lattice(x, y, z, octave, seed)), dtype)


def _interpolate(a, b, x):
    f = (1.0 - torch.cos(x * math.pi)) * 0.5
    return a * (1.0 - f) + b * f


def _smooth3d(x, y, z, octave, seed):
    """x, y, z: float coordinates; octave, seed: ints or int64 tensors of
    int32 values, broadcastable against x."""
    dtype = x.dtype
    ix, iy, iz = (to_int32_saturated(c.abs()) for c in (x, y, z))
    fx, fy, fz = x - ix.to(dtype), y - iy.to(dtype), z - iz.to(dtype)
    # the cell's corners in the reference's order v1..v8 (x fastest), as
    # offsets of the hash's linear part; made on the device, not copied
    k = torch.arange(8, device=x.device)
    corners = _lattice(k & 1, (k >> 1) & 1, k >> 2, 0, 0)
    base = _lattice(ix, iy, iz, octave, seed)
    v = _rawnoise(_wrap(base[..., None] + corners), dtype)     # (..., 8)
    # v1..v8 pairwise along x, then y, then z
    i = _interpolate(v[..., 0::2], v[..., 1::2], fx[..., None])
    j = _interpolate(i[..., 0::2], i[..., 1::2], fy[..., None])
    return _interpolate(j[..., 0], j[..., 1], fz)


def pnoise3d(x, y, z, persistence, frequency, octaves: int, seed):
    """Octave sum; `octaves` is a Python int, persistence/frequency/seed
    floats or tensors broadcastable against x."""
    total = torch.zeros_like(x)
    amplitude = 1.0
    freq = frequency
    seed_i = to_int32_saturated(torch.as_tensor(seed, device=x.device))
    for i in range(int(octaves)):
        total = total + _smooth3d(x * freq, y * freq, z * freq, i,
                                  seed_i) * amplitude
        freq = freq / 2.0
        amplitude = amplitude * persistence
    return total
