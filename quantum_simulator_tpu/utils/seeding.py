"""Deterministic seed management and NumPy<->JAX key bridging.

Parity target: ``/root/reference/quantum_sim/core/experiment.py:209-275``
(SeedManager with fork-safe child RNGs via ``rng.integers(0, 2**63)`` and
``reset()`` replaying the stream).

Extension: ``create_child_key`` forks a JAX PRNG key from the same
master stream, so host-side NumPy sampling and device-side trajectory
programs share one reproducible seed hierarchy.
"""

from __future__ import annotations

import jax
import numpy as np


class SeedManager:
    """Single point of control for all randomness in a run.

    A fixed master seed makes the n-th child RNG (or JAX key) fully
    deterministic; ``reset()`` replays the child stream from the start.
    """

    def __init__(self, seed: int | None = None):
        self._master_seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def seed(self) -> int | None:
        return self._master_seed

    def set_seed(self, seed: int | None) -> None:
        self._master_seed = seed
        self._rng = np.random.default_rng(seed)

    def create_child_rng(self) -> np.random.Generator:
        """Fork an independent NumPy child generator."""
        child_seed = self._rng.integers(0, 2**63)
        return np.random.default_rng(child_seed)

    def create_child_seed(self) -> int:
        """Fork a raw child seed (advances the master stream)."""
        return int(self._rng.integers(0, 2**63))

    def create_child_key(self) -> jax.Array:
        """Fork a JAX PRNG key from the same master stream."""
        return key_from_seed(self.create_child_seed())

    def reset(self) -> None:
        """Rewind so the next child equals the first child ever created."""
        self._rng = np.random.default_rng(self._master_seed)


def key_from_seed(seed: int) -> "jax.Array":
    """PRNG key carrying ALL bits of a (up to 63-bit) seed.

    ``jax.random.PRNGKey`` silently truncates to the low 32 bits when
    x64 is disabled (the default) — PRNGKey(2**32 + 5) == PRNGKey(5) —
    so the high word is folded in explicitly.
    """
    lo = int(seed) & 0xFFFFFFFF
    hi = int(seed) >> 32
    key = jax.random.PRNGKey(lo)
    if hi:
        key = jax.random.fold_in(key, hi)
    return key
