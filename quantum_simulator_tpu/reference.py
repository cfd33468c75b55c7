"""Reference-state management for consistent fidelity baselines.

Parity target: ``/root/reference/quantum_sim/engine/reference.py:26-161``
(state reference keyed by ``circuit_hash`` only — basis-independent;
measurement distributions lazily computed and cached per basis;
auto-invalidation on hash mismatch; |<psi|phi>|^2 fidelity).

Design differences: the reference state stays device-resident (its
density matrix is computed lazily — the reference eagerly materializes the
2^n x 2^n rho on every store); basis rotations reuse the jitted
all-qubit rotation program; fidelity is a device vdot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .state import StateVector


@dataclass
class ReferenceData:
    """Snapshot of a reference state for fidelity comparisons."""

    state: StateVector
    measurement_distribution: np.ndarray  # Z-basis (default)
    label: str = "reference"
    circuit_hash: int = 0
    _density_matrix: np.ndarray | None = field(default=None, repr=False)
    _basis_distributions: dict[str, np.ndarray] = field(
        default_factory=dict, repr=False)

    @property
    def density_matrix(self) -> np.ndarray:
        """Full rho = |psi><psi| (lazy: only GUI density panels need it)."""
        if self._density_matrix is None:
            self._density_matrix = self.state.get_density_matrix()
        return self._density_matrix


class ReferenceManager:
    """Stores the noiseless reference state all fidelity readouts use.

    Invalidation: the state reference clears when ``circuit_hash`` changes;
    per-basis distributions are cached inside the snapshot and recomputed
    lazily on basis switches (not a full invalidation).
    """

    def __init__(self):
        self._reference: ReferenceData | None = None

    @property
    def reference(self) -> ReferenceData | None:
        return self._reference

    @property
    def has_reference(self) -> bool:
        return self._reference is not None

    def store(self, state: StateVector, label: str = "reference",
              circuit_hash: int = 0) -> ReferenceData:
        """Snapshot ``state`` (device copy) as the new reference."""
        ref = ReferenceData(
            state=state.copy(),
            measurement_distribution=state.probabilities,
            label=label,
            circuit_hash=circuit_hash,
        )
        ref._basis_distributions["Z"] = ref.measurement_distribution
        self._reference = ref
        return ref

    def clear(self) -> None:
        self._reference = None

    def check_invalidation(self, circuit_hash: int) -> bool:
        """Auto-clear when the circuit structure changed. Returns True when
        the reference was invalidated."""
        if self._reference is None:
            return False
        stored = self._reference.circuit_hash
        if stored != 0 and stored != circuit_hash:
            self._reference = None
            return True
        return False

    def get_distribution(self, basis: str = "Z") -> np.ndarray | None:
        """Reference distribution in ``basis`` (lazily cached per basis)."""
        if self._reference is None:
            return None
        basis = basis.upper()
        cached = self._reference._basis_distributions.get(basis)
        if cached is not None:
            return cached

        from .measurement import MeasurementBasis, rotate_to_basis

        rotated = rotate_to_basis(self._reference.state,
                                  MeasurementBasis(basis))
        dist = rotated.probabilities
        self._reference._basis_distributions[basis] = dist
        return dist

    def fidelity_to_reference(self, state: StateVector) -> float | None:
        """|<ref|state>|^2, or None without a stored reference."""
        if self._reference is None:
            return None
        from .analysis import StateAnalysis

        return StateAnalysis.process_fidelity(self._reference.state, state)
