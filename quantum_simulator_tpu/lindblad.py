"""Lindblad master equation: continuous-time open-system dynamics.

    drho/dt = -i [H, rho]
              + sum_k rate_k (L_k rho L_k^dag - 1/2 {L_k^dag L_k, rho})

The reference's noise surface is discrete — stochastic Kraus channels
applied per gate (``/root/reference/quantum_sim/engine/noise.py:224-260``)
— with no continuous-time dynamics anywhere.  This module adds the
generator those channels discretize: amplitude damping is the
``sigma_minus`` jump, dephasing the ``z`` jump, and a Trotterized
circuit with per-gate channels converges to this equation as the step
size shrinks.

Design:

* The right-hand side is MATRIX-FREE: H is a Pauli-term list (the same
  ``(coeff, pauli_string, qubits)`` tuples as ``models/trotter.py`` and
  the optimizer Hamiltonians), and every term/jump applies to rho
  through the statevector kernel's left/right contractions — the same
  vmapped ``apply_gate`` path as ``density.py``, so each application is
  a batched matmul contraction, never a 4^n x 4^n Liouvillian matrix.
* Integration is classical RK4 with a static step count under ONE
  jitted ``lax.scan``; the whole evolution (including every recorded
  observable) compiles to a single device program.  RK4's O(dt^4) local
  structure is exactness-tested against the dense Liouvillian
  exponential at small n (``tests/test_lindblad.py``).
* Observables are Pauli strings evaluated on device inside the scan
  (``tr(P rho)`` = trace of one left-application), so tracking M
  observables over S steps transfers S*M scalars, never a rho.

Memory: RK4 holds ~5 live rho buffers of 4^n complex entries, so the
practical cap is n <= 13 single-chip (5 x 512 MiB at complex64);
enforced via ``MAX_LINDBLAD_QUBITS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from .config import CONFIG
from .density import DensityMatrixResult, _apply_left, _apply_right_dag, \
    _apply_unitary
from .models.trotter import _PAULI, _validated
from .state import StateVector

#: RK4 holds ~5 live rho copies of 4^n complex entries.
MAX_LINDBLAD_QUBITS = 13

#: Named single-qubit jump operators (qubit basis |0> = [1, 0]).
JUMP_OPERATORS = {
    "sigma_minus": np.array([[0, 1], [0, 0]], dtype=np.complex128),
    "sigma_plus": np.array([[0, 0], [1, 0]], dtype=np.complex128),
    "x": _PAULI["X"],
    "y": _PAULI["Y"],
    "z": _PAULI["Z"],
}


def _pauli_term_matrix(pstr: str) -> np.ndarray:
    """kron of Paulis in string order (``targets[0]`` = MSB of the
    matrix index, the framework-wide convention, ``ops/apply.py:94``)."""
    mat = np.array([[1.0 + 0j]])
    for ch in pstr:
        mat = np.kron(mat, _PAULI[ch])
    return mat


def _normalize_jumps(jump_operators, num_qubits: int):
    """-> list of (rate, L 2x2 complex, qubit).  Each entry of
    ``jump_operators`` is ``(rate, op, qubit)`` with ``op`` a name from
    ``JUMP_OPERATORS`` or an explicit 2x2 matrix."""
    out = []
    for rate, op, qubit in jump_operators:
        rate = float(rate)
        if rate < 0:
            raise ValueError(f"jump rate must be >= 0, got {rate}")
        qubit = int(qubit)
        if not 0 <= qubit < num_qubits:
            raise ValueError(f"jump qubit {qubit} out of range")
        if isinstance(op, str):
            try:
                mat = JUMP_OPERATORS[op.lower()]
            except KeyError:
                raise ValueError(
                    f"unknown jump operator {op!r}; named ops: "
                    f"{sorted(JUMP_OPERATORS)}") from None
        else:
            mat = np.asarray(op, dtype=np.complex128)
            if mat.shape != (2, 2):
                raise ValueError("matrix jump operators must be 2x2 "
                                 f"(got {mat.shape})")
        if rate > 0:
            out.append((rate, mat, qubit))
    return out


@dataclass
class LindbladResult:
    """Evolution record: ``times[i]`` pairs with ``expectations[:, i]``
    (row k = k-th requested observable, real parts of tr(P rho));
    ``final`` is the full density matrix at ``times[-1]``."""

    times: np.ndarray                 # (n_records,)
    expectations: np.ndarray          # (n_observables, n_records)
    final: DensityMatrixResult
    observable_labels: list[str]


class LindbladSimulator:
    """Integrate the Lindblad equation for an n-qubit open system.

    ``hamiltonian_terms``: ``[(coeff, pauli_string, qubits), ...]`` —
    the shared Hamiltonian format (identity components drop exactly:
    c*[I, rho] = 0).  ``jump_operators``: ``[(rate, op, qubit), ...]``
    with ``op`` a ``JUMP_OPERATORS`` name or a 2x2 matrix; ``rate`` is
    the Lindblad prefactor (so ``("sigma_minus", gamma)`` gives
    population decay exp(-gamma t)).
    """

    def __init__(self, num_qubits: int, hamiltonian_terms=(),
                 jump_operators=()):
        if num_qubits < 1 or num_qubits > MAX_LINDBLAD_QUBITS:
            raise ValueError(
                f"num_qubits must be 1..{MAX_LINDBLAD_QUBITS} (RK4 holds "
                "~5 live 4^n density matrices)")
        self.num_qubits = num_qubits
        self._terms = [
            (coeff, _pauli_term_matrix(pstr), tuple(qubits))
            for coeff, pstr, qubits in _validated(num_qubits,
                                                  list(hamiltonian_terms))]
        self._jumps = _normalize_jumps(jump_operators, num_qubits)
        self._fns: dict = {}

    # -- rho0 coercion ------------------------------------------------------

    def _initial_rho(self, initial, dtype) -> jnp.ndarray:
        n = self.num_qubits
        dim = 1 << n
        if initial is None:
            rho = np.zeros((dim, dim), dtype=np.complex128)
            rho[0, 0] = 1.0
            return jnp.asarray(rho, dtype=dtype)
        if isinstance(initial, StateVector):
            if initial.num_qubits != n:
                raise ValueError("initial state has wrong qubit count")
            psi = initial.data
            return jnp.asarray(np.outer(psi, np.conj(psi)), dtype=dtype)
        if isinstance(initial, DensityMatrixResult):
            return jnp.asarray(initial.rho, dtype=dtype)
        arr = np.asarray(initial, dtype=np.complex128)
        if arr.shape == (dim,):
            return jnp.asarray(np.outer(arr, np.conj(arr)), dtype=dtype)
        if arr.shape == (dim, dim):
            return jnp.asarray(arr, dtype=dtype)
        raise ValueError(f"initial must be a {dim}-vector, {dim}x{dim} "
                         f"matrix, StateVector or DensityMatrixResult")

    # -- compiled evolution -------------------------------------------------

    def _build(self, n_steps: int, record_every: int, obs_key, dtype):
        n = self.num_qubits
        terms = [(c, jnp.asarray(u, dtype=dtype), tg)
                 for c, u, tg in self._terms]
        jumps = []
        for rate, L, q in self._jumps:
            LdL = np.conj(L.T) @ L
            jumps.append((rate, jnp.asarray(L, dtype=dtype),
                          jnp.asarray(LdL, dtype=dtype), (q,)))
        obs_ops = [(jnp.asarray(_pauli_term_matrix(pstr), dtype=dtype),
                    tuple(qubits)) for pstr, qubits in obs_key]

        def rhs(rho, dt):
            """dt * (Hamiltonian commutator + dissipators)."""
            acc = jnp.zeros_like(rho)
            for coeff, u, tg in terms:
                acc = acc + (-1j * coeff) * (
                    _apply_left(rho, u, tg, n)
                    - _apply_right_dag(rho, u, tg, n))
            for rate, L, LdL, tg in jumps:
                acc = acc + rate * (
                    _apply_unitary(rho, L, tg, n)
                    - 0.5 * _apply_left(rho, LdL, tg, n)
                    - 0.5 * _apply_right_dag(rho, LdL, tg, n))
            return dt * acc

        def measure(rho):
            if not obs_ops:
                return jnp.zeros((0,), jnp.float32)
            vals = [jnp.real(jnp.trace(_apply_left(rho, u, tg, n)))
                    for u, tg in obs_ops]
            return jnp.stack(vals).astype(jnp.float32)

        n_windows, rem = divmod(n_steps, record_every)
        assert rem == 0

        def window(rho, dt):
            def rk4(r, _):
                k1 = rhs(r, dt)
                k2 = rhs(r + 0.5 * k1, dt)
                k3 = rhs(r + 0.5 * k2, dt)
                k4 = rhs(r + k3, dt)
                return r + (k1 + 2.0 * (k2 + k3) + k4) / 6.0, None

            rho, _ = jax.lax.scan(rk4, rho, None, length=record_every)
            return rho, measure(rho)

        def evolve(rho0, dt):
            first = measure(rho0)
            rho, recs = jax.lax.scan(lambda r, _: window(r, dt), rho0,
                                     None, length=n_windows)
            return rho, jnp.concatenate([first[None], recs], axis=0)

        return jax.jit(evolve)

    def evolve(self, t_final: float, n_steps: int, initial=None,
               observables=(), record_every: int = 1,
               dtype=None) -> LindbladResult:
        """Integrate to ``t_final`` in ``n_steps`` RK4 steps.

        ``observables``: ``[(pauli_string, qubits), ...]`` recorded at
        t=0 and after every ``record_every``-th step (must divide
        ``n_steps``).  The compiled program is cached per
        (steps, cadence, observables, dtype) — ``t_final`` is a runtime
        scalar, so sweeps over total time recompile nothing.
        """
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if record_every < 1 or n_steps % record_every:
            raise ValueError("record_every must divide n_steps")
        dtype = dtype or CONFIG.dtype
        obs_key = tuple((str(pstr).upper(), tuple(int(q) for q in qubits))
                        for pstr, qubits in observables)
        for pstr, qubits in obs_key:
            _validated(self.num_qubits, [(1.0, pstr, list(qubits))])
        cache_key = (n_steps, record_every, obs_key, str(dtype))
        fn = self._fns.get(cache_key)
        if fn is None:
            fn = self._build(n_steps, record_every, obs_key, dtype)
            self._fns[cache_key] = fn
        rho0 = self._initial_rho(initial, dtype)
        dt = jnp.asarray(float(t_final) / n_steps, dtype=dtype)
        rho, recs = fn(rho0, dt)
        n_windows = n_steps // record_every
        times = np.linspace(0.0, float(t_final), n_windows + 1)
        labels = [f"{pstr}@{list(qs)}" for pstr, qs in obs_key]
        return LindbladResult(
            times=times,
            expectations=np.asarray(recs).T,
            final=DensityMatrixResult(num_qubits=self.num_qubits,
                                      device_rho=rho),
            observable_labels=labels)

    def dense_liouvillian(self) -> np.ndarray:
        """The 4^n x 4^n Liouvillian matrix on vec(rho) (row-major:
        vec[i * 2^n + j] = rho[i, j]) — host-side, for validation and
        spectral analysis at small n (n <= 6)."""
        n = self.num_qubits
        if n > 6:
            raise ValueError("dense Liouvillian is 4^n x 4^n; n capped at 6")
        dim = 1 << n
        eye = np.eye(dim, dtype=np.complex128)

        def embed(u, targets):
            """u (2^k x 2^k, targets[0] = MSB) -> dim x dim operator,
            the numpy mirror of ``ops.apply.apply_gate`` applied to
            every identity column at once."""
            k = len(targets)
            u_t = np.asarray(u, np.complex128).reshape([2] * (2 * k))
            cols = np.eye(dim, dtype=np.complex128).reshape([2] * n + [dim])
            moved = np.tensordot(u_t, cols,
                                 axes=(list(range(k, 2 * k)), list(targets)))
            # moved axes: u's k output qubit axes, then the untouched row
            # axes in qubit order, then the column axis — restore order.
            pos = {q: i for i, q in enumerate(targets)}
            rest = [q for q in range(n) if q not in pos]
            for i, q in enumerate(rest):
                pos[q] = k + i
            perm = [pos[q] for q in range(n)] + [n]
            return np.transpose(moved, perm).reshape(dim, dim)

        L_total = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
        for coeff, u, tg in self._terms:
            H = coeff * embed(u, tg)
            L_total += -1j * (np.kron(H, eye) - np.kron(eye, H.T))
        for rate, Lm, q in self._jumps:
            Lf = embed(Lm, (q,))
            LdL = np.conj(Lf.T) @ Lf
            L_total += rate * (np.kron(Lf, np.conj(Lf))
                               - 0.5 * np.kron(LdL, eye)
                               - 0.5 * np.kron(eye, LdL.T))
        return L_total
