"""Dynamical two-point correlators at MPS widths.

``C_ij(t) = <psi| P_i(t) P_j |psi>`` is the quantity quench
spectroscopy, transport, and response theory are built from.  It is NOT
an expectation of the evolved state — the operator insertion at t=0
makes it a MIXED matrix element — so the standard trick evolves TWO
states under the same unitary,

    C_ij(t) = <psi(t)| P_i |phi(t)>,    |phi(0)> = P_j |psi(0)>,

and contracts them through one operator-inserted transfer network per
record point.  Here both evolutions are second-order Trotter circuits
on the trace-time MPS (``mps._TraceMPS``): the whole pair of
trajectories plus every recorded matrix element compiles into ONE
program, with steps past the bond-growth fixed point riding a single
``lax.scan`` over record windows (the ``lindblad_mps`` move).  The
result transfers as stacked real/imag float32 (``utils/xfer.py``).

The reference has no time evolution at all (its engine runs gate lists
only, ``/root/reference/quantum_sim/engine/simulator.py``); this rides
the framework's Trotter + MPS stack to 40+ qubit correlators, validated
against dense ``expm`` evolution at small n
(``tests/test_correlators.py``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .config import CONFIG
from .lindblad import _pauli_term_matrix
from .models.trotter import _PAULI, _validated
from .mps import MPSState, _PREC, _TraceMPS

__all__ = ["mps_two_point_correlator"]


def _mixed_element(bra_tensors, ket_tensors, site: int, op):
    """``<bra| op_site |ket>`` transfer contraction over two ragged MPS
    (any canonical forms, any bond profiles)."""
    dtype = ket_tensors[0].dtype
    env = jnp.ones((1, 1), dtype)
    for i, (a, b) in enumerate(zip(bra_tensors, ket_tensors)):
        tb = b if i != site else jnp.einsum(
            "qp,lpr->lqr", op.astype(dtype), b, precision=_PREC)
        env = jnp.einsum("lm,lpa,mpb->ab", env, jnp.conj(a), tb,
                         precision=_PREC)
    return env[0, 0]


def mps_two_point_correlator(num_qubits: int, hamiltonian_terms,
                             t_final: float, n_steps: int,
                             site_i: int, site_j: int,
                             pauli_i: str = "Z", pauli_j: str = "Z",
                             chi: int = 32, initial=None,
                             record_every: int = 1,
                             order: int = 2, dtype=None):
    """-> ``(times, C)`` with ``C[k] = <psi(t_k)| P_i |phi(t_k)>``
    complex128, ``t_k`` the record grid (t=0 first).

    ``hamiltonian_terms`` is the shared ``(coeff, pauli_string,
    qubits)`` format; ``initial`` is a product-state bit list (default
    all-zeros) OR any ``MPSState`` — e.g. a DMRG ground state, which
    turns the correlator into spectroscopy: for an eigenstate start the
    signal's frequencies are exactly the excitation gaps (see
    ``examples/quench_spectroscopy.py``).  MPS initial states are
    re-canonicalized by two norm-preserving QR sweeps on entry, so the
    truncation discipline never trusts the caller's canonical form.
    Both evolutions and every record contraction compile into one
    jitted program whose cost is O(warmup + record window), independent
    of ``n_steps``.
    """
    n = num_qubits
    if not (0 <= site_i < n and 0 <= site_j < n):
        raise ValueError("correlator sites out of range")
    if pauli_i not in "XYZ" or pauli_j not in "XYZ":
        raise ValueError("pauli_i/pauli_j must be X, Y, or Z")
    if n_steps < 1 or record_every < 1 or n_steps % record_every:
        raise ValueError("record_every must divide n_steps (both >= 1)")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    dtype = dtype or CONFIG.dtype
    terms = _validated(n, list(hamiltonian_terms))
    init_state = None
    if isinstance(initial, MPSState):
        if initial.num_qubits != n:
            raise ValueError("initial MPSState has wrong qubit count")
        init_state = initial
        bits = [0] * n
    else:
        bits = list(initial) if initial is not None else [0] * n
        if len(bits) != n or any(b not in (0, 1) for b in bits):
            raise ValueError("initial must be n bits (product state) "
                             "or an MPSState")
    dt = float(t_final) / n_steps
    half = 0.5 * dt if order == 2 else dt

    def term_gate(coeff, pstr, qubits, step_dt):
        P = _pauli_term_matrix(pstr)
        theta = float(coeff) * step_dt
        g = np.cos(theta) * np.eye(P.shape[0]) - 1j * np.sin(theta) * P
        return list(qubits), jnp.asarray(g, dtype)

    if order == 2:
        fwd = [term_gate(c, p, q, half) for c, p, q in terms]
        gates = fwd + fwd[::-1]
    else:
        gates = [term_gate(c, p, q, dt) for c, p, q in terms]
    op_i = jnp.asarray(_PAULI[pauli_i], dtype)
    op_j = jnp.asarray(_PAULI[pauli_j], dtype)

    def run_step(mps):
        for positions, g in gates:
            if len(positions) == 1:
                mps.apply_1q(positions[0], g)
            else:
                mps.route_and_apply(positions, g)

    def seed():
        if init_state is None:
            return _TraceMPS(n, chi, bits, dtype)
        m = object.__new__(_TraceMPS)
        m.n, m.chi, m.dtype = n, chi, dtype
        m.tensors = [jnp.asarray(t, dtype) for t in init_state.tensors]
        m.center = 0
        m.discarded = jnp.zeros((), jnp.float32)
        # Re-canonicalize with two QR sweeps (norm-preserving, no
        # truncation): the state contract says center-at-0 but the
        # SVD-truncation discipline must not depend on it being exact.
        m.move_center_to(n - 1)
        m.move_center_to(0)
        return m

    @jax.jit
    def evolve():
        psi = seed()
        phi = seed()
        phi.apply_1q(site_j, op_j)      # P_j |psi(0)>; 1q op keeps the
                                        # canonical form (may be non-
                                        # unitary for projectors later;
                                        # Paulis are unitary)

        def record():
            v = _mixed_element(psi.tensors, phi.tensors, site_i, op_i)
            return jnp.stack([jnp.real(v), jnp.imag(v)]
                             ).astype(jnp.float32)

        recs = [record()]
        shapes = None
        fixed = False
        s = 0
        while s < n_steps:
            if fixed and s % record_every == 0:
                break
            run_step(psi)
            run_step(phi)
            s += 1
            if s % record_every == 0:
                recs.append(record())
            now = (tuple(t.shape for t in psi.tensors), psi.center,
                   tuple(t.shape for t in phi.tensors), phi.center)
            fixed = fixed or now == shapes
            shapes = now

        n_win = (n_steps - s) // record_every
        if n_win > 0:
            centers = (psi.center, phi.center)

            def rebuild(tensors, center):
                m = object.__new__(_TraceMPS)
                m.n, m.chi, m.dtype = n, chi, dtype
                m.tensors = list(tensors)
                m.center = center
                m.discarded = jnp.zeros((), jnp.float32)
                return m

            def body(carry, _):
                ta, tb = carry
                a = rebuild(ta, centers[0])
                b = rebuild(tb, centers[1])
                for _j in range(record_every):
                    run_step(a)
                    run_step(b)
                if (tuple(t.shape for t in a.tensors), a.center,
                        tuple(t.shape for t in b.tensors),
                        b.center) != shapes:
                    raise AssertionError(
                        "step map left its shape fixed point")
                v = _mixed_element(a.tensors, b.tensors, site_i, op_i)
                return (tuple(a.tensors), tuple(b.tensors)), jnp.stack(
                    [jnp.real(v), jnp.imag(v)]).astype(jnp.float32)

            _, scanned = jax.lax.scan(
                body, (tuple(psi.tensors), tuple(phi.tensors)), None,
                length=n_win)
            all_recs = jnp.concatenate([jnp.stack(recs), scanned],
                                       axis=0)
        else:
            all_recs = jnp.stack(recs)
        return all_recs

    recs = np.asarray(evolve(), np.float64)        # (n_records, 2)
    times = np.linspace(0.0, float(t_final),
                        n_steps // record_every + 1)
    return times, recs[:, 0] + 1j * recs[:, 1]
