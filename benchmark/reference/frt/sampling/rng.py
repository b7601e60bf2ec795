"""The port's random numbers: one tree of named sub-streams per render.

The JAX package draws from keyed streams (`jax.random` keys, split and
folded per chunk, level, light and purpose); the reference from the
global drand48. The port cannot reproduce jax's threefry streams, so its
stochastic frames are statistically, not bitwise, the JAX package's. It
keeps their structure, though: an `RNG` is a node of a tree rooted at a
render's `seed`, and `fold(i)` and `split(n)` derive children exactly
where the JAX package calls `jax.random.fold_in` and `jax.random.split`.
A node's draws are a pure function of (seed, path from the root, shape,
dtype, device): the node re-seeds the render's one `torch.Generator` from
a hash of its path before each draw. So

- the same seed renders the same frame, bit for bit;
- a draw never depends on what ran before it (how many chunks, which
  compaction, kernel or plain), only on where in the tree it is made;
- the same node drawn twice gives the same numbers, as a reused jax key
  does.

Every sampler takes the numbers it consumes as arguments (uniforms,
normals or integers); a thin wrapper beside it draws them from an RNG
node. Anything with the same five methods can stand in for an RNG: the
tests feed the port the JAX package's own draws that way.
"""

from __future__ import annotations

import hashlib
from typing import List

import torch


class RNG:
    """A node of a render's random tree (see the module docstring)."""

    def __init__(self, seed: int, device=None, path: tuple = (),
                 generator: torch.Generator = None):
        self.seed = int(seed)
        self.device = torch.device("cpu" if device is None else device)
        self.path = tuple(path)
        # the root makes the render's one generator; children share it
        self._gen = torch.Generator(device=self.device) \
            if generator is None else generator

    def _child(self, step) -> "RNG":
        return RNG(self.seed, self.device, self.path + (step,), self._gen)

    def fold(self, i: int) -> "RNG":
        """The child numbered i (jax.random.fold_in)."""
        return self._child(("fold", int(i)))

    def split(self, n: int) -> List["RNG"]:
        """n children (jax.random.split)."""
        return [self._child(("split", int(n), j)) for j in range(n)]

    def _generator(self) -> torch.Generator:
        digest = hashlib.blake2b(repr((self.seed, self.path)).encode(),
                                 digest_size=8).digest()
        self._gen.manual_seed(int.from_bytes(digest, "little") >> 1)
        return self._gen

    def uniform(self, shape, dtype) -> torch.Tensor:
        """Uniforms in [0, 1) of `shape` (jax.random.uniform)."""
        return torch.rand(tuple(shape), generator=self._generator(),
                          dtype=dtype, device=self.device)

    def normal(self, shape, dtype) -> torch.Tensor:
        """Standard normals of `shape` (jax.random.normal)."""
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=dtype, device=self.device)

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        """int64 integers in [low, high) (jax.random.randint)."""
        return torch.randint(low, high, tuple(shape),
                             generator=self._generator(), device=self.device)
