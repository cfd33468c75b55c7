"""Host-facing StateVector API over a device-resident amplitude array.

Parity target: ``/root/reference/quantum_sim/engine/state_vector.py:8-193``
(same property/method surface, same qubit-0-is-MSB convention). Differences:

* amplitudes live on the device as ``CONFIG.dtype`` (complex64 default);
  ``.data`` returns a NumPy complex128 copy for GUI/analysis consumers;
* ``measure_qubit`` collapse is a vectorized masked projection (the
  reference loops over all 2^n amplitudes in Python);
* gate application dispatches to the jitted segmented-einsum primitive.

This class is the *interactive* API. Hot paths (full-circuit runs, noisy
trajectories) never go through it — they use compiled programs
(``ops/program.py``) that keep everything on device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .config import CONFIG
from .utils.xfer import to_device_complex, to_host_complex
from .ops.apply import (
    apply_gate_host,
    basis_state_index,
    collapse_qubit,
    make_basis_state,
    prob_qubit_zero,
    reduced_density_matrix_1q,
)


class StateVector:
    """An n-qubit pure state as a device-resident complex array."""

    def __init__(self, num_qubits: int):
        if num_qubits < 1 or num_qubits > CONFIG.max_qubits:
            raise ValueError(
                f"num_qubits must be 1-{CONFIG.max_qubits}, got {num_qubits}")
        self._num_qubits = num_qubits
        self._data = make_basis_state(num_qubits, 0, CONFIG.dtype)

    # --- construction ----------------------------------------------------

    @classmethod
    def from_initial_states(cls, initial_states: list[int]) -> "StateVector":
        sv = cls(len(initial_states))
        idx = basis_state_index(initial_states)
        sv._data = make_basis_state(sv._num_qubits, idx, CONFIG.dtype)
        return sv

    @classmethod
    def from_device_array(cls, array: jnp.ndarray, num_qubits: int
                          ) -> "StateVector":
        """Wrap an existing device array without a host round-trip."""
        sv = cls.__new__(cls)
        sv._num_qubits = num_qubits
        sv._data = array.astype(CONFIG.dtype) \
            if array.dtype != CONFIG.dtype else array
        return sv

    def reset(self, initial_states: list[int] | None = None):
        idx = basis_state_index(initial_states) if initial_states else 0
        self._data = make_basis_state(self._num_qubits, idx, CONFIG.dtype)

    def copy(self) -> "StateVector":
        return StateVector.from_device_array(self._data, self._num_qubits)

    # --- properties --------------------------------------------------------

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def data(self) -> np.ndarray:
        """Host copy as complex128 (reference dtype)."""
        return to_host_complex(self._data)

    @data.setter
    def data(self, value):
        value = np.asarray(value)
        if value.shape != (2**self._num_qubits,):
            raise ValueError(
                f"Expected shape ({2**self._num_qubits},), got {value.shape}")
        self._data = to_device_complex(value, CONFIG.dtype)

    @property
    def device_data(self) -> jnp.ndarray:
        """The raw device array (no copy, no dtype change)."""
        return self._data

    @device_data.setter
    def device_data(self, value: jnp.ndarray):
        self._data = value

    @property
    def probabilities(self) -> np.ndarray:
        from .ops.apply import probabilities as _probs

        return np.asarray(_probs(self._data), dtype=np.float64)

    # --- operations --------------------------------------------------------

    def apply_gate(self, gate_matrix, target_qubits: list[int]):
        n = self._num_qubits
        for q in target_qubits:
            if q < 0 or q >= n:
                raise ValueError(f"Qubit index {q} out of range [0, {n-1}]")
        self._data = apply_gate_host(self._data, gate_matrix,
                                     target_qubits, n)

    def measure_qubit(self, qubit: int,
                      rng: np.random.Generator | None = None) -> int:
        """Projective single-qubit measurement with collapse + renorm."""
        if qubit < 0 or qubit >= self._num_qubits:
            raise ValueError(f"Qubit {qubit} out of range")
        rng = rng or np.random.default_rng()
        p0 = float(prob_qubit_zero(self._data, qubit, self._num_qubits))
        outcome = 0 if rng.random() < p0 else 1
        self._data = collapse_qubit(self._data, qubit,
                                    jnp.int32(outcome), self._num_qubits)
        return outcome

    def measure_all(self, rng: np.random.Generator | None = None) -> str:
        """Measure every qubit; collapse to the drawn basis state."""
        rng = rng or np.random.default_rng()
        probs = self.probabilities
        probs = probs / probs.sum()
        idx = int(rng.choice(len(probs), p=probs))
        self._data = make_basis_state(self._num_qubits, idx, CONFIG.dtype)
        return format(idx, f"0{self._num_qubits}b")

    def get_reduced_density_matrix(self, qubit: int) -> np.ndarray:
        if qubit < 0 or qubit >= self._num_qubits:
            raise ValueError(f"Qubit {qubit} out of range")
        rho = reduced_density_matrix_1q(self._data, qubit, self._num_qubits)
        return to_host_complex(rho)

    def get_bloch_coordinates(self, qubit: int) -> tuple[float, float, float]:
        rho = self.get_reduced_density_matrix(qubit)
        x = 2.0 * np.real(rho[0, 1])
        y = 2.0 * np.imag(rho[1, 0])
        z = np.real(rho[0, 0] - rho[1, 1])
        return (float(x), float(y), float(z))

    def get_density_matrix(self) -> np.ndarray:
        psi = self.data
        return np.outer(psi, np.conj(psi))

    def __repr__(self) -> str:
        return f"StateVector(num_qubits={self._num_qubits})"
