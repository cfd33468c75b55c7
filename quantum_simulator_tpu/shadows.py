"""Classical shadows: randomized-measurement estimation of many
observables (Huang-Kueng-Preskill random single-qubit Pauli protocol).

Each snapshot draws a uniform basis in {X, Y, Z} per qubit, rotates by
the single-qubit Clifford that maps that basis to Z (the SAME rotations
as ``MeasurementEngine`` basis sampling: X -> H, Y -> H S^dag,
reference ``measurement.py:91-98``), and records one joint bit sample.
The inverse of the single-qubit shadow channel gives the unbiased
estimator for a k-local Pauli string P:

    est(P) = 3^k * prod_q sign(outcome_q)   when every basis matches P,
             0                              otherwise,

with variance <= 9^k — so ONE pool of snapshots estimates arbitrarily
many low-weight observables (the reference computes each expectation
from the exact state, ``analysis.py:222-248``, and has no
finite-measurement estimation surface at all).

Design:

* Statevector collector: snapshots vmap over (basis one-hots, keys) —
  each lane rotates the shared state by n one-hot-selected 2x2 gates
  through the statevector kernel and draws one categorical sample; the
  host loop chunks lanes so memory stays chunk x 2^n.
* MPS collector: the per-site rotation folds INTO the right-canonical
  sampling cascade (1-site unitaries commute with the canonical form),
  so shadows run at 100+ qubits with O(n chi^2) per snapshot and no
  2^n anywhere.
* Estimation is vectorized host numpy over the (S, n) snapshot table —
  mean or median-of-means.

Unbiasedness is test-locked by exact enumeration over all 3^n basis
draws and 2^n outcomes (``tests/test_shadows.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from .circuit import QuantumCircuit
from .ops.apply import apply_gate
from .state import StateVector

_PREC = jax.lax.Precision.HIGHEST

#: Basis codes in snapshot tables.
BASIS_X, BASIS_Y, BASIS_Z = 0, 1, 2
_LETTER_TO_CODE = {"X": BASIS_X, "Y": BASIS_Y, "Z": BASIS_Z}

_H = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
_SDG = np.array([[1, 0], [0, -1j]], np.complex64)
#: Rotation applied before a Z-readout, indexed by basis code.
_ROTATIONS = np.stack([_H, _H @ _SDG, np.eye(2, dtype=np.complex64)])

#: vmapping S lanes of a 2^n state bounds statevector shadows.
MAX_STATEVECTOR_SHADOW_QUBITS = 20


@dataclass
class ShadowData:
    """A pool of snapshots: ``bases[s, q]`` in {0=X, 1=Y, 2=Z} and
    ``outcomes[s, q]`` in {0, 1} (bit 0 = +1 eigenvalue)."""

    num_qubits: int
    bases: np.ndarray
    outcomes: np.ndarray

    @property
    def n_snapshots(self) -> int:
        return self.bases.shape[0]

    def _pauli_values(self, pauli_string: str, qubits) -> np.ndarray:
        pstr = str(pauli_string).upper()
        qubits = [int(q) for q in qubits]
        if len(pstr) != len(qubits):
            raise ValueError(f"{pstr!r} has {len(pstr)} Paulis for "
                             f"{len(qubits)} qubits")
        live = [(p, q) for p, q in zip(pstr, qubits) if p != "I"]
        if len({q for _, q in live}) != len(live):
            raise ValueError("duplicate qubits in Pauli string")
        if any(q < 0 or q >= self.num_qubits for _, q in live):
            raise ValueError("qubit index out of range")
        if not live:
            return np.ones(self.n_snapshots)
        try:
            codes = np.asarray([_LETTER_TO_CODE[p] for p, _ in live])
        except KeyError:
            raise ValueError(f"unsupported Pauli in {pstr!r}") from None
        qs = np.asarray([q for _, q in live])
        match = np.all(self.bases[:, qs] == codes[None, :], axis=1)
        signs = np.prod(1 - 2 * self.outcomes[:, qs].astype(np.int64),
                        axis=1)
        return np.where(match, float(3 ** len(live)) * signs, 0.0)

    def estimate_pauli(self, pauli_string: str, qubits,
                       median_of_means: int | None = None) -> float:
        """Estimate <P> from the pool.  ``median_of_means=K`` splits the
        snapshots into K chunks and returns the median of chunk means
        (the HKP concentration construction); default is the plain
        mean (minimum-variance, unbiased)."""
        vals = self._pauli_values(pauli_string, qubits)
        if median_of_means is None:
            return float(vals.mean())
        k = int(median_of_means)
        if k < 1 or k > vals.shape[0]:
            raise ValueError("median_of_means must be in 1..n_snapshots")
        usable = (vals.shape[0] // k) * k
        return float(np.median(vals[:usable].reshape(k, -1).mean(axis=1)))

    def estimate_hamiltonian(self, terms,
                             median_of_means: int | None = None) -> float:
        """sum_k c_k <P_k> for ``(coeff, pauli_string, qubits)`` terms
        (the shared Hamiltonian format)."""
        return float(sum(
            coeff * self.estimate_pauli(pstr, qubits, median_of_means)
            for coeff, pstr, qubits in terms))


# ---------------------------------------------------------------------------
# Collectors
# ---------------------------------------------------------------------------

def _statevector_snapshot_fn(n: int):
    # NUMPY constant, not an eager jnp array: a concrete complex DEVICE
    # array closed over by a jit gets materialized to host when the
    # trace embeds it as a constant; a numpy constant embeds directly at
    # trace time.
    rots = np.asarray(_ROTATIONS, dtype=np.complex64)

    def one(state, onehot, key):
        x = state
        for q in range(n):
            u = jnp.tensordot(onehot[q].astype(rots.dtype), rots, axes=1,
                              precision=_PREC)
            x = apply_gate(x, u, (q,), n)
        probs = jnp.abs(x) ** 2
        idx = jax.random.categorical(key, jnp.log(probs + 1e-30))
        shifts = jnp.arange(n - 1, -1, -1)      # qubit 0 = MSB
        return ((idx >> shifts) & 1).astype(jnp.int8)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


def _mps_snapshot_fn():
    rots = np.asarray(_ROTATIONS, dtype=np.complex64)  # numpy: see above

    def one(stack, onehot, key):
        cm = stack.shape[-1]

        def body(carry, inputs):
            t, oh = inputs
            v, k = carry
            u = jnp.tensordot(oh.astype(stack.dtype), rots.astype(
                stack.dtype), axes=1, precision=_PREC)
            t = jnp.einsum("qp,lpr->lqr", u, t, precision=_PREC)
            k, sub = jax.random.split(k)
            w0 = jnp.einsum("l,lr->r", v, t[:, 0, :], precision=_PREC)
            w1 = jnp.einsum("l,lr->r", v, t[:, 1, :], precision=_PREC)
            p0 = jnp.sum(jnp.abs(w0) ** 2)
            p1 = jnp.sum(jnp.abs(w1) ** 2)
            pr0 = p0 / jnp.maximum(p0 + p1, 1e-30)
            bit = (jax.random.uniform(sub) >= pr0).astype(jnp.int8)
            w = jnp.where(bit == 0, w0, w1)
            w = w / jnp.sqrt(jnp.maximum(jnp.sum(jnp.abs(w) ** 2), 1e-30))
            return (w, k), bit

        v0 = jnp.zeros((cm,), stack.dtype).at[0].set(1.0)
        (_, _), bits = jax.lax.scan(body, (v0, key), (stack, onehot))
        return bits

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


_SV_FNS: dict = {}
_MPS_FN = None


def collect_shadows(circuit: QuantumCircuit | StateVector,
                    n_snapshots: int,
                    seed: int | None = None,
                    engine: str = "auto",
                    chi: int = 32,
                    chunk: int = 256) -> ShadowData:
    """Collect a classical-shadow pool from a circuit (or a prepared
    ``StateVector``).

    ``engine``: "statevector" (n <= 20), "mps" (any width the bond
    dimension ``chi`` supports), or "auto" (statevector when it fits).
    ``chunk`` bounds device memory: snapshots launch ``chunk`` lanes at
    a time (statevector memory is chunk x 2^n).
    """
    rng = np.random.default_rng(seed)
    if isinstance(circuit, StateVector):
        n = circuit.num_qubits
        if engine == "mps":
            raise ValueError("a prepared StateVector collects on the "
                             "statevector engine")
        engine = "statevector"
    else:
        n = circuit.num_qubits
        if engine == "auto":
            engine = ("statevector"
                      if n <= MAX_STATEVECTOR_SHADOW_QUBITS else "mps")
    if engine not in ("statevector", "mps"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "statevector" and n > MAX_STATEVECTOR_SHADOW_QUBITS:
        raise ValueError(
            f"statevector shadows cap at n={MAX_STATEVECTOR_SHADOW_QUBITS} "
            "(each chunk lane holds a 2^n state); use engine='mps'")
    if n_snapshots < 1:
        raise ValueError("n_snapshots must be >= 1")

    bases = rng.integers(0, 3, size=(n_snapshots, n)).astype(np.int8)
    onehots = np.eye(3, dtype=np.float32)[bases]            # (S, n, 3)
    master = jax.random.PRNGKey(int(rng.integers(0, 2 ** 63)))
    keys = jax.random.split(master, n_snapshots)

    if engine == "statevector":
        if isinstance(circuit, StateVector):
            sv = circuit
        else:
            from .simulator import Simulator

            sv = Simulator().run(circuit, shots=0).final_state
        # Stay on device: pulling .data and re-uploading would copy
        # the whole state through the host twice.
        psi = sv.device_data.astype(jnp.complex64)
        fn = _SV_FNS.get(n)
        if fn is None:
            fn = _statevector_snapshot_fn(n)
            _SV_FNS[n] = fn
        carrier = psi
    else:
        from .mps import MPSSimulator, _stack_padded

        state = MPSSimulator()._final_state(circuit, chi)
        stack, _ = _stack_padded(state.tensors, state.tensors[0].dtype)
        global _MPS_FN
        if _MPS_FN is None:
            _MPS_FN = _mps_snapshot_fn()
        fn = _MPS_FN
        carrier = stack

    outs = []
    for lo in range(0, n_snapshots, chunk):
        hi = min(lo + chunk, n_snapshots)
        outs.append(np.asarray(fn(carrier,
                                  jnp.asarray(onehots[lo:hi]),
                                  keys[lo:hi])))
    return ShadowData(num_qubits=n, bases=bases,
                      outcomes=np.concatenate(outs, axis=0))
