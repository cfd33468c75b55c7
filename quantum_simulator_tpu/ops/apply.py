"""Gate application primitives on flat amplitude vectors (XLA path).

Replaces the reference's per-gate ``np.tensordot`` + argsort-transpose
(``/root/reference/quantum_sim/engine/state_vector.py:41-74``) with a
segmented-reshape ``einsum`` that XLA lowers to ``dot_general``. The state is
never reshaped to a rank-``n`` tensor of 2s (tiny minor dims tile badly);
instead it is viewed as at most ``2k+1`` axes — the k target-qubit axes plus
the contiguous segments between them — so the contraction maps onto large,
well-tiled matmuls.

Bit-ordering convention (CRITICAL, inherited from the reference,
``state_vector.py:88,171-175``): **qubit 0 is the most-significant bit** of
the basis-state index. Qubit ``q`` therefore has block stride
``2**(n-1-q)`` in the flat amplitude array.

All functions are pure, traceable, vmap-able, and differentiable.
"""

from __future__ import annotations

import string
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def basis_state_index(initial_states: list[int]) -> int:
    """Index of the computational basis product state (qubit 0 = MSB)."""
    idx = 0
    n = len(initial_states)
    for i, bit in enumerate(initial_states):
        if bit:
            idx |= 1 << (n - 1 - i)
    return idx


@partial(jax.jit, static_argnums=(0, 1, 2))
def make_basis_state(num_qubits: int, index: int, dtype) -> jnp.ndarray:
    # jitted so the basis state is born on the device (no host copy).
    state = jnp.zeros(2**num_qubits, dtype=dtype)
    return state.at[index].set(1.0)


def _segmented_view(targets: tuple[int, ...], n: int):
    """Shape + einsum bookkeeping for the segmented reshape.

    Returns (state_shape, state_subscript, out_subscript, gate_subscript)
    where the gate tensor axes are ordered (outputs..., inputs...) for the
    SORTED targets.
    """
    k = len(targets)
    # 3 letters per target + 1 tail: lowercase alone caps gates at 8
    # targets (Grover-9's MCZ9 needs 28 subscripts)
    letters = iter(string.ascii_lowercase + string.ascii_uppercase)
    shape: list[int] = []
    state_sub: list[str] = []
    out_sub: list[str] = []
    gate_in: list[str] = []
    gate_out: list[str] = []
    prev = -1
    for t in targets:
        seg = t - prev - 1  # qubits strictly between previous target and t
        shape.append(1 << seg)
        seg_l = next(letters)
        state_sub.append(seg_l)
        out_sub.append(seg_l)
        shape.append(2)
        l_in, l_out = next(letters), next(letters)
        state_sub.append(l_in)
        gate_in.append(l_in)
        gate_out.append(l_out)
        out_sub.append(l_out)
        prev = t
    tail = n - targets[-1] - 1
    shape.append(1 << tail)
    tail_l = next(letters)
    state_sub.append(tail_l)
    out_sub.append(tail_l)
    spec = (
        "".join(gate_out) + "".join(gate_in)
        + "," + "".join(state_sub) + "->" + "".join(out_sub)
    )
    return tuple(shape), spec


def apply_gate(state: jnp.ndarray, matrix: jnp.ndarray,
               targets: tuple[int, ...], num_qubits: int) -> jnp.ndarray:
    """Apply a ``2^k x 2^k`` unitary to ``targets`` of a ``2^n`` state.

    ``targets`` order matters: the first target is the most-significant bit
    of the gate-matrix index (same convention as the reference).
    """
    n = num_qubits
    k = len(targets)
    if any(t < 0 or t >= n for t in targets):
        raise ValueError(f"target qubits {targets} out of range for n={n}")

    g = jnp.asarray(matrix, dtype=state.dtype).reshape((2,) * (2 * k))
    # Permute gate tensor axes so its targets appear in sorted-qubit order.
    order = sorted(range(k), key=lambda i: targets[i])
    if order != list(range(k)):
        perm = tuple(order) + tuple(k + i for i in order)
        g = g.transpose(perm)
    tsorted = tuple(sorted(targets))

    shape, spec = _segmented_view(tsorted, n)
    out = jnp.einsum(spec, g, state.reshape(shape),
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(state.shape)


def apply_cphase(state: jnp.ndarray, targets: tuple[int, ...],
                 value: complex, num_qubits: int) -> jnp.ndarray:
    """Controlled-phase-form diagonal of ANY width on a flat 2^n state:
    multiply the amplitudes whose targets are all |1> by ``value``. One
    elementwise pass with a bit-mask indicator — the dense 2^k matrix
    (impossible for k > 16, e.g. Grover's wide MCZ) is never built."""
    mask = 0
    for q in targets:
        mask |= 1 << (num_qubits - 1 - q)  # qubit 0 = MSB
    idx = jnp.arange(state.shape[0], dtype=jnp.uint32)
    hit = (idx & jnp.uint32(mask)) == jnp.uint32(mask)
    return jnp.where(hit, state * jnp.asarray(value, state.dtype), state)


def apply_gate_all_qubits(state: jnp.ndarray, matrix: jnp.ndarray,
                          num_qubits: int) -> jnp.ndarray:
    """Apply the same single-qubit gate to every qubit (basis rotations:
    H for X-basis, S†·H for Y-basis; reference ``measurement.py:91-98``)."""
    for q in range(num_qubits):
        state = apply_gate(state, matrix, (q,), num_qubits)
    return state


# Jitted entry point for the host-facing StateVector API. Compile cache is
# keyed by (targets, num_qubits) — matrices and state stay dynamic.
_apply_gate_jit = jax.jit(apply_gate, static_argnums=(2, 3))


def apply_gate_host(state: jnp.ndarray, matrix, targets, num_qubits: int):
    from ..utils.xfer import to_device_complex

    matrix = to_device_complex(matrix, state.dtype)
    return _apply_gate_jit(state, matrix, tuple(int(t) for t in targets),
                           int(num_qubits))


@partial(jax.jit, static_argnums=(1, 3))
def collapse_qubit(state: jnp.ndarray, qubit: int, outcome: jnp.ndarray,
                   num_qubits: int) -> jnp.ndarray:
    """Project onto ``qubit == outcome`` and renormalize (vectorized version
    of the reference's Python loop at ``state_vector.py:90-98``)."""
    n = num_qubits
    dim = state.shape[-1]
    bit_position = n - 1 - qubit
    idx = jax.lax.broadcasted_iota(jnp.int32, (dim, 1), 0).squeeze(-1)
    bits = (idx >> bit_position) & 1
    kept = jnp.where(bits == outcome, state, jnp.zeros_like(state))
    norm = jnp.sqrt(jnp.sum(jnp.abs(kept) ** 2))
    return jnp.where(norm > 1e-15, kept / norm, kept)


@partial(jax.jit, static_argnums=(1, 2))
def prob_qubit_zero(state: jnp.ndarray, qubit: int, num_qubits: int):
    """P(qubit = 0) via a masked reduction (qubit 0 = MSB)."""
    dim = state.shape[-1]
    bit_position = num_qubits - 1 - qubit
    idx = jax.lax.broadcasted_iota(jnp.int32, (dim, 1), 0).squeeze(-1)
    mask = ((idx >> bit_position) & 1) == 0
    probs = jnp.abs(state) ** 2
    return jnp.sum(jnp.where(mask, probs, 0.0))


@partial(jax.jit, static_argnums=(1, 2))
def reduced_density_matrix_1q(state: jnp.ndarray, qubit: int,
                              num_qubits: int) -> jnp.ndarray:
    """Single-qubit reduced density matrix by direct contraction on psi
    (reference ``state_vector.py:121-140``) — never builds the full rho."""
    a = 1 << qubit
    b = 1 << (num_qubits - qubit - 1)
    psi = state.reshape(a, 2, b)
    return jnp.einsum("aib,ajb->ij", psi, jnp.conj(psi),
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def probabilities(state: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(state) ** 2


@jax.jit
def normalize(state: jnp.ndarray) -> jnp.ndarray:
    norm = jnp.sqrt(jnp.sum(jnp.abs(state) ** 2))
    return jnp.where(norm > 1e-15, state / norm, state)
