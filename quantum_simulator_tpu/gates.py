"""Quantum gate definitions: canonical matrices plus differentiable builders.

Parity target: ``/root/reference/quantum_sim/engine/gates.py:11-134`` (GateType
enum, frozen GateDefinition, the 9 fixed single-qubit gates, 5 parameterized
gates, and the 5 fixed multi-qubit gates).

Design difference: every parameterized gate also has a **traceable JAX
builder** (``jnp_*``) so a whole circuit lowers to one XLA program with the
parameter vector as a runtime argument — gradients flow through gate matrices
via ``jax.grad`` (the reference can only do parameter-shift re-simulation).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable

import jax.numpy as jnp
import numpy as np


class GateType(Enum):
    SINGLE = "single"
    CONTROLLED = "controlled"
    MULTI = "multi"
    MEASUREMENT = "measurement"
    BARRIER = "barrier"


@dataclass(frozen=True)
class GateDefinition:
    """Immutable definition of a quantum gate.

    ``matrix_func`` returns a NumPy complex128 matrix (host/reference path);
    ``jnp_matrix_func`` returns a traceable jnp matrix (device path). For
    non-parameterized gates the two agree bit-for-bit after dtype cast.
    """

    name: str
    display_name: str
    gate_type: GateType
    num_qubits: int
    num_params: int
    param_names: tuple[str, ...]
    matrix_func: Callable[..., np.ndarray]
    symbol: str
    color: str
    num_controls: int = 0
    num_targets: int = 1
    jnp_matrix_func: Callable[..., jnp.ndarray] | None = None
    # Wide controlled-phase diagonals (MCZ_k, k > 10): the dense matrix
    # is unrepresentable, so the definition carries only the phase the
    # all-targets-set amplitude picks up; matrix_func raises.
    cphase_value: complex | None = None

    def device_matrix(self, params, dtype) -> jnp.ndarray:
        """Traceable gate matrix for the device program."""
        if self.jnp_matrix_func is not None:
            return self.jnp_matrix_func(*params).astype(dtype)
        return jnp.asarray(self.matrix_func(*params), dtype=dtype)


# --- Fixed single-qubit matrices (canonical complex128, host side) ---------

I_MATRIX = np.eye(2, dtype=np.complex128)
X_MATRIX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y_MATRIX = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z_MATRIX = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H_MATRIX = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
S_MATRIX = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
S_DAG_MATRIX = np.array([[1, 0], [0, -1j]], dtype=np.complex128)
T_MATRIX = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128)
T_DAG_MATRIX = np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=np.complex128)

# --- Fixed multi-qubit matrices --------------------------------------------

CNOT_MATRIX = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
)
CZ_MATRIX = np.diag([1.0, 1.0, 1.0, -1.0]).astype(np.complex128)
SWAP_MATRIX = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)

TOFFOLI_MATRIX = np.eye(8, dtype=np.complex128)
TOFFOLI_MATRIX[[6, 7], [6, 7]] = 0.0
TOFFOLI_MATRIX[6, 7] = TOFFOLI_MATRIX[7, 6] = 1.0

FREDKIN_MATRIX = np.eye(8, dtype=np.complex128)
FREDKIN_MATRIX[[5, 6], [5, 6]] = 0.0
FREDKIN_MATRIX[5, 6] = FREDKIN_MATRIX[6, 5] = 1.0


# --- Parameterized builders: NumPy (host) ----------------------------------

def rx_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz_matrix(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-1j * theta / 2), 0], [0, np.exp(1j * theta / 2)]],
        dtype=np.complex128,
    )


def phase_matrix(phi: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * phi)]], dtype=np.complex128)


def u3_matrix(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


# --- Parameterized builders: JAX (traceable, differentiable) ----------------

def _jc(re, im):
    """Complex from real/imag traces."""
    return jnp.asarray(re) + 1j * jnp.asarray(im)


def jnp_rx_matrix(theta):
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    return jnp.stack([
        jnp.stack([_jc(c, z), _jc(z, -s)]),
        jnp.stack([_jc(z, -s), _jc(c, z)]),
    ])


def jnp_ry_matrix(theta):
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    return jnp.stack([
        jnp.stack([_jc(c, z), _jc(-s, z)]),
        jnp.stack([_jc(s, z), _jc(c, z)]),
    ])


def jnp_rz_matrix(theta):
    e_neg = jnp.exp(-0.5j * theta)
    e_pos = jnp.exp(0.5j * theta)
    zero = jnp.zeros_like(e_neg)
    return jnp.stack([jnp.stack([e_neg, zero]), jnp.stack([zero, e_pos])])


def jnp_phase_matrix(phi):
    one = jnp.ones_like(jnp.exp(1j * phi))
    zero = jnp.zeros_like(one)
    return jnp.stack([jnp.stack([one, zero]), jnp.stack([zero, jnp.exp(1j * phi)])])


def jnp_u3_matrix(theta, phi, lam):
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    c = c.astype(jnp.complex64) if not jnp.iscomplexobj(c) else c
    s = s.astype(c.dtype)
    return jnp.stack([
        jnp.stack([c + 0j, -jnp.exp(1j * lam) * s]),
        jnp.stack([jnp.exp(1j * phi) * s, jnp.exp(1j * (phi + lam)) * c]),
    ])


def cphase_matrix(phi: float) -> np.ndarray:
    """Controlled-phase: diag(1, 1, 1, e^{i phi}). Not in the reference's
    gate set (its QFT substitutes a plain Phase gate, ``algorithms.py:47``);
    added here so QFT/inverse-QFT are exact."""
    return np.diag([1.0, 1.0, 1.0, np.exp(1j * phi)]).astype(np.complex128)


def jnp_cphase_matrix(phi):
    one = jnp.ones_like(jnp.exp(1j * phi))
    return jnp.diag(jnp.stack([one, one, one, jnp.exp(1j * phi)]))


def mcz_matrix(num_qubits: int) -> np.ndarray:
    """Multi-controlled-Z on ``num_qubits`` qubits: diag(1,...,1,-1)."""
    d = np.ones(2**num_qubits, dtype=np.complex128)
    d[-1] = -1.0
    return np.diag(d)


def _const(matrix: np.ndarray) -> Callable[[], np.ndarray]:
    """No-arg callable returning a fixed matrix (reference `gates.py:130`)."""

    def _fn() -> np.ndarray:
        return matrix

    return _fn


JNP_BUILDERS: dict[str, Callable] = {
    "Rx": jnp_rx_matrix,
    "Ry": jnp_ry_matrix,
    "Rz": jnp_rz_matrix,
    "Phase": jnp_phase_matrix,
    "U3": jnp_u3_matrix,
    "CPhase": jnp_cphase_matrix,
}
