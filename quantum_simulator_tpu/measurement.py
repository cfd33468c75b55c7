"""Measurement bases, sampling, and readout-error wiring.

Parity target: ``/root/reference/quantum_sim/engine/measurement.py:12-129``
(Z/X/Y bases — X rotates by H, Y by S† then H; multinomial sampling over the
probability distribution; "distribution" readout mode transforms probs
BEFORE sampling, "shot" mode corrupts bitstrings AFTER).

Design differences: the basis rotation runs as one jitted device program
(cached per (n, basis)); shot-mode corruption is a single vectorized RNG
draw over all shots; a device-side categorical sampler is provided for
at-scale sampling where the 2^n distribution should never leave HBM.
"""

from __future__ import annotations

from enum import Enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .gates import H_MATRIX, S_DAG_MATRIX
from .ops.apply import apply_gate_all_qubits
from .state import StateVector
from .utils.seeding import key_from_seed


class MeasurementBasis(Enum):
    Z = "Z"  # computational basis
    X = "X"  # apply H to every qubit first
    Y = "Y"  # apply S-dagger then H to every qubit first


@partial(jax.jit, static_argnums=(1, 2))
def _rotate_basis(state: jnp.ndarray, num_qubits: int, basis: str):
    if basis == "Y":
        sdg = jnp.asarray(S_DAG_MATRIX, dtype=state.dtype)
        state = apply_gate_all_qubits(state, sdg, num_qubits)
    if basis in ("X", "Y"):
        h = jnp.asarray(H_MATRIX, dtype=state.dtype)
        state = apply_gate_all_qubits(state, h, num_qubits)
    return state


def rotate_to_basis(state: StateVector,
                    basis: MeasurementBasis) -> StateVector:
    """Basis-rotated copy (device-side, one compiled program)."""
    if basis == MeasurementBasis.Z:
        return state
    rotated = _rotate_basis(state.device_data, state.num_qubits, basis.value)
    return StateVector.from_device_array(rotated, state.num_qubits)


def counts_from_array(counts_array: np.ndarray, num_qubits: int
                      ) -> dict[str, int]:
    """Dense histogram -> {bitstring: count}; C fast path when built."""
    from .native import counts_from_array_native

    native = counts_from_array_native(counts_array, num_qubits)
    if native is not None:
        return native
    out: dict[str, int] = {}
    (nonzero,) = np.nonzero(counts_array)
    for i in nonzero:
        out[format(int(i), f"0{num_qubits}b")] = int(counts_array[i])
    return out


@partial(jax.jit, static_argnums=(1,))
def sample_counts_device(probs: jnp.ndarray, shots: int, key) -> jnp.ndarray:
    """Device-side sampler: ``shots`` categorical draws binned to counts.

    Keeps the whole pipeline on the accelerator for large n — the host only
    ever sees the (sparse) counts.
    """
    logits = jnp.log(probs + 1e-38)
    draws = jax.random.categorical(key, logits, shape=(shots,))
    return jnp.bincount(draws, length=probs.shape[-1])


class MeasurementEngine:
    """Static measurement helpers over StateVector (host-facing API)."""

    @staticmethod
    def measure_qubit(state: StateVector, qubit: int,
                      rng: np.random.Generator | None = None
                      ) -> tuple[int, StateVector]:
        collapsed = state.copy()
        outcome = collapsed.measure_qubit(qubit, rng)
        return outcome, collapsed

    @staticmethod
    def measure_all(state: StateVector,
                    rng: np.random.Generator | None = None
                    ) -> tuple[str, StateVector]:
        collapsed = state.copy()
        bitstring = collapsed.measure_all(rng)
        return bitstring, collapsed

    # Above this state size the 2^n probability vector stays on device and
    # sampling uses jax.random.categorical (the host only sees sparse
    # counts). Below it, host multinomial keeps NumPy-seed parity with the
    # reference.
    DEVICE_SAMPLING_MIN_DIM = 1 << 20

    @staticmethod
    def sample(state: StateVector, shots: int,
               rng: np.random.Generator | None = None) -> dict[str, int]:
        """Multinomial sampling without collapse (host RNG for seed parity
        with the reference's ``rng.multinomial``; device-side categorical
        for states too large to ship to the host)."""
        rng = rng or np.random.default_rng()
        dim = 2**state.num_qubits
        if dim >= MeasurementEngine.DEVICE_SAMPLING_MIN_DIM:
            from .ops.apply import probabilities as _probs

            key = key_from_seed(int(rng.integers(0, 2**63)))
            counts_dev = sample_counts_device(_probs(state.device_data),
                                              shots, key)
            return counts_from_array(np.asarray(counts_dev),
                                     state.num_qubits)
        probs = state.probabilities
        total = probs.sum()
        if total > 1e-15:
            probs = probs / total
        else:
            probs = np.full_like(probs, 1.0 / len(probs))
        counts_array = rng.multinomial(shots, probs)
        return counts_from_array(counts_array, state.num_qubits)

    @staticmethod
    def sample_with_basis(
        state: StateVector,
        shots: int,
        basis: MeasurementBasis = MeasurementBasis.Z,
        readout_error=None,
        readout_mode: str = "shot",
        rng: np.random.Generator | None = None,
    ) -> dict[str, int]:
        """Basis rotation + sampling + optional readout error.

        ``readout_mode="distribution"`` transforms the probability vector
        with the per-qubit confusion matrix before sampling;
        ``readout_mode="shot"`` corrupts sampled bitstrings afterwards.
        """
        rng = rng or np.random.default_rng()
        rotated = rotate_to_basis(state, basis)
        n = rotated.num_qubits

        if readout_error is not None and readout_mode == "distribution":
            probs = rotated.probabilities
            total = probs.sum()
            if total > 1e-15:
                probs = probs / total
            noisy_probs = readout_error.apply_to_distribution(probs, n)
            counts_array = rng.multinomial(shots, noisy_probs)
            return counts_from_array(counts_array, n)

        counts = MeasurementEngine.sample(rotated, shots, rng=rng)

        if readout_error is not None and readout_mode == "shot":
            counts = readout_error.corrupt_counts(counts, rng)

        return counts
