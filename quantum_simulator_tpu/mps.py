"""Matrix-product-state (MPS) engine: low-entanglement circuits at 100+ qubits.

Fills the gap between the dense amplitude engines (exact, capped near
n=32 by the 2^n wall — ``ops/bigstate.py``) and the Clifford tableau
engine (``clifford.py``: any width, but Clifford gates only): an MPS
tracks *arbitrary* gates on hundreds of qubits exactly while the
entanglement across every left/right cut fits the bond dimension
``chi``, and degrades gracefully (with a *measured* discarded weight)
when it does not.

Design
-----------------
* The circuit lowers at trace time to ONE jitted program: a static
  chain of small dense contractions, QR center moves and
  SVD-truncations.  Bond dimensions are **static trace-time Python
  ints** that grow ``1 -> 2 -> 4 -> ... -> chi`` exactly as the gate
  sequence allows, so XLA sees fixed shapes everywhere — no dynamic
  shapes, no padding waste in the evolution itself.
* The orthogonality-center discipline (left-canonical to the left,
  right-canonical to the right of the gate being applied) makes every
  SVD truncation *globally* optimal for that bond, and the discarded
  squared Schmidt weight is accumulated on device and reported per run
  (``MPSState.truncation_weight`` — 0.0 means the run was exact).
* Sampling right-canonicalizes once, pads the ragged site tensors to a
  uniform ``(chi, 2, chi)`` stack, and draws every shot as a
  ``lax.scan`` over sites vmapped over shots — S shots of an n-qubit
  conditional cascade are ONE device launch, like the tableau
  engine's sampler.
* Non-adjacent multi-qubit gates route by adjacent SWAPs (each a
  truncated 2-site update, so routing cost is visible in the
  truncation ledger) and un-route afterwards; gate matrices follow the
  framework-wide convention that ``target_qubits[0]`` is the
  most-significant bit of the matrix index (``ops/apply.py:94``).

Semantics match the reference engine contract: qubit 0 is the MSB of
every bitstring, MEASUREMENT/BARRIER gates are skipped during evolution
and sampling happens at the end
(``/root/reference/quantum_sim/engine/simulator.py:61-83``).  Agreement
with the statevector engine is locked in by ``tests/test_mps.py``
(amplitude-exact on random circuits when ``chi`` covers the cut rank).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .circuit import QuantumCircuit
from .config import CONFIG
from .gates import GateType
from .registry import GateRegistry

_PREC = jax.lax.Precision.HIGHEST

# Widest dense gate the k-site contraction path accepts: theta holds
# 2^k * chi^2 amplitudes and the split SVDs touch (2*chi, 2^(k-1)*chi)
# matrices — fine to k=8, unreasonable beyond.
_MAX_DENSE_SITES = 8


class MPSState(NamedTuple):
    """Final MPS: ragged site tensors with the orthogonality center at
    site 0 (everything right of it is right-canonical), plus the total
    squared Schmidt weight discarded by truncation during the run."""

    tensors: tuple
    num_qubits: int
    chi: int
    truncation_weight: float


# --------------------------------------------------------------------------
# Trace-time MPS with an orthogonality center
# --------------------------------------------------------------------------


class _TraceMPS:
    """Mutable trace-time MPS. All shape arithmetic (bond growth,
    center position, routing) happens in Python while tracing; the
    compiled program is a static DAG of dense ops."""

    def __init__(self, n: int, chi: int, bits, dtype):
        self.n = n
        self.chi = chi
        self.dtype = dtype
        self.tensors = []
        for i in range(n):
            t = jnp.zeros((1, 2, 1), dtype).at[0, int(bits[i]), 0].set(1.0)
            self.tensors.append(t)
        self.center = 0
        self.discarded = jnp.zeros((), jnp.float32)

    # --- canonical-form maintenance ------------------------------------

    def _shift_right(self, i: int) -> None:
        """Center i -> i+1 via thin QR (left tensor becomes left-canonical)."""
        t = self.tensors[i]
        l, _, r = t.shape
        q, rm = jnp.linalg.qr(t.reshape(l * 2, r))
        k = min(l * 2, r)
        self.tensors[i] = q.reshape(l, 2, k)
        self.tensors[i + 1] = jnp.einsum(
            "ab,bpc->apc", rm, self.tensors[i + 1], precision=_PREC)
        self.center = i + 1

    def _shift_left(self, i: int) -> None:
        """Center i -> i-1 via LQ (right tensor becomes right-canonical)."""
        t = self.tensors[i]
        l, _, r = t.shape
        # LQ of M (l, 2r): M^H = Q R  =>  M = R^H Q^H with Q^H row-orthonormal.
        q, rm = jnp.linalg.qr(t.reshape(l, 2 * r).conj().T)
        k = min(l, 2 * r)
        self.tensors[i] = q.conj().T.reshape(k, 2, r)
        self.tensors[i - 1] = jnp.einsum(
            "apl,lk->apk", self.tensors[i - 1], rm.conj().T, precision=_PREC)
        self.center = i - 1

    def move_center_to(self, j: int) -> None:
        while self.center < j:
            self._shift_right(self.center)
        while self.center > j:
            self._shift_left(self.center)

    # --- gate application -----------------------------------------------

    def apply_1q(self, site: int, g2) -> None:
        """Unitary 1-site gates commute with the canonical form."""
        self.tensors[site] = jnp.einsum(
            "qp,lpr->lqr", g2, self.tensors[site], precision=_PREC)

    def _truncated_split(self, m, l: int, r: int):
        """SVD-split an (l*2, 2*r) matrix at the center bond, keep at
        most ``chi`` Schmidt vectors, renormalize, ledger the rest."""
        u, s, vh = jnp.linalg.svd(m, full_matrices=False)
        k = min(m.shape[0], m.shape[1], self.chi)
        w_all = jnp.sum(s * s)
        sk = s[:k]
        w_kept = jnp.sum(sk * sk)
        self.discarded = self.discarded + jnp.maximum(
            w_all - w_kept, 0.0).astype(jnp.float32)
        sk = sk / jnp.sqrt(jnp.maximum(w_kept, 1e-30))
        left = u[:, :k].reshape(l, 2, k)
        right = (sk[:, None].astype(m.dtype) * vh[:k, :]).reshape(k, 2, r)
        return left, right

    def apply_2site(self, i: int, g4) -> None:
        """Apply a 4x4 unitary to adjacent sites (i, i+1); center ends
        on i+1. ``g4``'s MSB is site i."""
        self.move_center_to(i if self.center <= i else i + 1)
        a, b = self.tensors[i], self.tensors[i + 1]
        l, r = a.shape[0], b.shape[2]
        theta = jnp.einsum("lpa,aqr->lpqr", a, b, precision=_PREC)
        theta = jnp.einsum("pqxy,lxyr->lpqr",
                           g4.reshape(2, 2, 2, 2), theta, precision=_PREC)
        left, right = self._truncated_split(theta.reshape(l * 2, 2 * r), l, r)
        self.tensors[i] = left
        self.tensors[i + 1] = right
        self.center = i + 1

    def apply_ksite(self, start: int, k: int, g) -> None:
        """Apply a 2^k x 2^k gate to the contiguous sites
        start..start+k-1 (MSB = leftmost), splitting back with k-1
        truncated SVDs; center ends on the rightmost site."""
        if k == 1:
            self.apply_1q(start, g)
            return
        if k == 2:
            self.apply_2site(start, g)
            return
        self.move_center_to(start)
        theta = self.tensors[start]                       # (l, 2, r0)
        for j in range(1, k):
            theta = jnp.einsum("lpa,aqr->lpqr", theta,
                               self.tensors[start + j], precision=_PREC)
            sh = theta.shape
            theta = theta.reshape(sh[0], sh[1] * sh[2], sh[3])
        l, r = theta.shape[0], theta.shape[2]
        theta = jnp.einsum("pq,lqr->lpr", g, theta, precision=_PREC)
        # Peel sites off the left one truncated SVD at a time.
        for j in range(k - 1):
            rem = 2 ** (k - j - 1)  # physical dims right of site start+j
            m = theta.reshape(l * 2, rem * r)
            left, carry = self._truncated_split(m, l, (rem * r) // 2)
            kk = left.shape[2]
            self.tensors[start + j] = left
            # carry is (kk, 2, rem*r/2) with the next site's physical leg
            # exposed; re-fold the tail for the next peel.
            theta = carry.reshape(kk, rem, r)
            l = kk
        self.tensors[start + k - 1] = theta
        self.center = start + k - 1

    def apply_kraus_1q(self, site: int, kstack, key) -> None:
        """Stochastic 1-qubit Kraus draw (one noise trajectory step):
        with the center moved to ``site``, every branch weight
        ``||K_m psi||^2`` is the Frobenius norm of ``K_m`` applied to
        the center tensor alone — O(chi^2), no global contraction.  The
        drawn branch applies in place and renormalizes; the canonical
        form survives because only the center tensor changed.  Returns
        the drawn branch index (for projector stacks this is the
        measurement outcome)."""
        self.move_center_to(site)
        t = self.tensors[site]
        branches = jnp.einsum("mqp,lpr->mlqr", kstack, t, precision=_PREC)
        w = jnp.sum(jnp.abs(branches) ** 2, axis=(1, 2, 3))
        m = jax.random.categorical(key, jnp.log(jnp.maximum(w, 1e-30)))
        chosen = branches[m]
        norm = jnp.sqrt(jnp.maximum(jnp.sum(jnp.abs(chosen) ** 2), 1e-30))
        self.tensors[site] = chosen / norm.astype(chosen.dtype)
        return m

    def swap_adjacent(self, i: int) -> None:
        self.apply_2site(i, _SWAP4(self.dtype))

    def route_and_apply(self, positions, g) -> None:
        """Apply a dense k-site gate on arbitrary (distinct) qubit
        positions: permute the gate tensor into sorted-position order,
        bubble the targets into one contiguous block with adjacent
        SWAPs (relative order preserved), apply, un-route."""
        kq = len(positions)
        order = sorted(range(kq), key=lambda t: positions[t])
        if order != list(range(kq)):
            gt = g.reshape((2,) * (2 * kq))
            perm = tuple(order) + tuple(kq + t for t in order)
            g = gt.transpose(perm).reshape(2 ** kq, 2 ** kq)
        pos = sorted(positions)
        swaps = []
        # Bubble each target right until adjacent to its right neighbor.
        for idx in range(kq - 2, -1, -1):
            while pos[idx] < pos[idx + 1] - 1:
                swaps.append(pos[idx])
                self.swap_adjacent(pos[idx])
                pos[idx] += 1
        self.apply_ksite(pos[0], kq, g)
        for site in reversed(swaps):
            self.swap_adjacent(site)


def _SWAP4(dtype):
    return jnp.asarray(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype)


# --------------------------------------------------------------------------
# Circuit lowering
# --------------------------------------------------------------------------


def _count_noise_sites(circuit: QuantumCircuit, noise_model) -> int:
    """Static count of (channel, target) stochastic-draw sites — one
    PRNG key each (mirrors the clifford lowering's per-target emission,
    ``clifford.py:346-356`` / reference ``noise.py:224-260``)."""
    registry = GateRegistry.instance()
    count = 0
    for column in circuit.get_ordered_gates():
        for gate in column:
            gdef = registry.get(gate.gate_name)
            if gdef.gate_type in (GateType.MEASUREMENT, GateType.BARRIER):
                continue
            count += (len(noise_model.channels_for_gate(gate.gate_name))
                      * len(gate.target_qubits))
    return count


def _evolve(circuit: QuantumCircuit, chi: int, dtype,
            noise_model=None, key=None, collapse_measures=False,
            param_overrides=None):
    """Trace-time evolution body: returns (ragged tensors with the
    center at site 0, discarded squared weight, collapse outcomes in
    Measure order). With a noise model and a PRNG key this traces ONE
    stochastic Kraus trajectory (reference ``run`` semantics,
    ``noise.py:224-260``); with ``collapse_measures`` Measure gates
    project mid-circuit (projector stacks through the same Kraus-draw
    machinery) instead of being deferred to final sampling.
    ``param_overrides`` maps ``id(gate)`` to a replacement params list
    (entries may be traced scalars — the VQE path)."""
    registry = GateRegistry.instance()
    mps = _TraceMPS(circuit.num_qubits, chi,
                    circuit.initial_states, dtype)
    n_keys = 0
    if noise_model is not None:
        n_keys += _count_noise_sites(circuit, noise_model)
    measure_sites = []
    if collapse_measures:
        for column in circuit.get_ordered_gates():
            for gate in column:
                gdef = registry.get(gate.gate_name)
                if gdef.gate_type == GateType.MEASUREMENT:
                    measure_sites.append((gate.column,
                                          gate.target_qubits[0]))
        n_keys += len(measure_sites)
    keys = jax.random.split(key, n_keys) if n_keys else None
    key_idx = 0
    outcomes = []
    proj = jnp.stack([jnp.diag(jnp.asarray([1, 0], dtype)),
                      jnp.diag(jnp.asarray([0, 1], dtype))])
    for column in circuit.get_ordered_gates():
        for gate in column:
            gdef = registry.get(gate.gate_name)
            if gdef.gate_type == GateType.MEASUREMENT:
                if collapse_measures:
                    out = mps.apply_kraus_1q(gate.target_qubits[0], proj,
                                             keys[key_idx])
                    key_idx += 1
                    outcomes.append(out)
                continue
            if gdef.gate_type == GateType.BARRIER:
                continue
            kq = len(gate.target_qubits)
            if kq > _MAX_DENSE_SITES:
                raise ValueError(
                    f"{gate.gate_name} touches {kq} qubits; the MPS "
                    f"engine's dense-gate path stops at "
                    f"{_MAX_DENSE_SITES} (use the statevector engine "
                    f"or decompose the gate)")
            params = gate.params
            if param_overrides is not None:
                params = param_overrides.get(id(gate), params)
            g = gdef.device_matrix(params, dtype)
            if kq == 1:
                mps.apply_1q(gate.target_qubits[0], g)
            else:
                if len(set(gate.target_qubits)) != kq:
                    raise ValueError(
                        f"duplicate target qubits in {gate.gate_name}: "
                        f"{gate.target_qubits}")
                mps.route_and_apply(list(gate.target_qubits), g)
            if noise_model is not None:
                for ch in noise_model.channels_for_gate(gate.gate_name):
                    kstack = jnp.asarray(ch.kraus_stack(), dtype)
                    if kstack.shape[1:] != (2, 2):
                        raise ValueError(
                            f"{type(ch).__name__} is not a 1-qubit "
                            "channel; the MPS engine applies Kraus "
                            "noise per target qubit")
                    for q in gate.target_qubits:
                        mps.apply_kraus_1q(q, kstack, keys[key_idx])
                        key_idx += 1
    mps.move_center_to(0)
    outs = (jnp.stack(outcomes).astype(jnp.int32) if outcomes
            else jnp.zeros((0,), jnp.int32))
    return tuple(mps.tensors), mps.discarded, outs, measure_sites


def compile_mps(circuit: QuantumCircuit, chi: int):
    """Jit-compile the whole circuit into one MPS-evolution program.

    Gate parameters are baked into the trace (the cache key in
    ``MPSSimulator`` is ``circuit_hash()``, which covers them)."""
    dtype = CONFIG.dtype

    def evolve():
        tensors, discarded, _, _ = _evolve(circuit, chi, dtype)
        return tensors, discarded

    return jax.jit(evolve)


# --------------------------------------------------------------------------
# Sampling / observables on a finished MPS
# --------------------------------------------------------------------------


def _stack_padded(tensors, dtype):
    """Pad ragged (l, 2, r) site tensors to a uniform (chi_max, 2,
    chi_max) stack. Zero padding never mixes into the populated
    sub-block, so canonical-form identities survive."""
    cm = max(max(t.shape[0] for t in tensors),
             max(t.shape[2] for t in tensors))
    padded = [jnp.pad(t, ((0, cm - t.shape[0]), (0, 0),
                          (0, cm - t.shape[2]))) for t in tensors]
    return jnp.stack(padded), cm


def _sample_one_shot(stack, key):
    """One conditional cascade over a right-canonical padded stack."""
    cm = stack.shape[-1]

    def body(carry, t):
        v, k = carry
        k, sub = jax.random.split(k)
        w0 = jnp.einsum("l,lr->r", v, t[:, 0, :], precision=_PREC)
        w1 = jnp.einsum("l,lr->r", v, t[:, 1, :], precision=_PREC)
        p0 = jnp.sum(jnp.abs(w0) ** 2)
        p1 = jnp.sum(jnp.abs(w1) ** 2)
        pr0 = p0 / jnp.maximum(p0 + p1, 1e-30)
        bit = (jax.random.uniform(sub) >= pr0).astype(jnp.int32)
        w = jnp.where(bit == 0, w0, w1)
        w = w / jnp.sqrt(jnp.maximum(jnp.sum(jnp.abs(w) ** 2), 1e-30))
        return (w, k), bit

    v0 = jnp.zeros((cm,), stack.dtype).at[0].set(1.0)
    (_, _), bits = jax.lax.scan(body, (v0, key), stack)
    return bits


# One jitted sampler object: the compile cache persists across run()
# calls (specialized per (n, chi, shots) shape combination).
_sample_shots = jax.jit(jax.vmap(_sample_one_shot, in_axes=(None, 0)))


_PAULI_2X2 = {
    "I": np.eye(2, dtype=np.complex64),
    "X": np.array([[0, 1], [1, 0]], np.complex64),
    "Y": np.array([[0, -1j], [1j, 0]], np.complex64),
    "Z": np.array([[1, 0], [0, -1]], np.complex64),
}

_H_2X2 = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
_SDG_2X2 = np.array([[1, 0], [0, -1j]], np.complex64)

# Shared cache of jitted observable programs, keyed on the STATIC parts
# of each closure (op placements, parsed terms, bond index). jax.jit
# itself re-specializes per tensor shape inside each entry, so one
# entry serves every (n, chi) combination of the same observable.
_JIT_CACHE: dict = {}


def _put_jit(key, body):
    fn = jax.jit(body)
    if len(_JIT_CACHE) > 128:
        _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
    _JIT_CACHE[key] = fn
    return fn


def expectation_pauli_string(state: MPSState, paulis: dict | str) -> float:
    """<P> for an arbitrary Pauli string via one left-to-right transfer
    contraction — O(n * chi^3), no 2^n anything.  ``paulis`` is either a
    length-n string over IXYZ or a {qubit: 'X'|'Y'|'Z'} dict (identity
    elsewhere).  Reference surface: ``analysis.py:222-248`` expectations,
    here at widths the reference cannot represent."""
    n = state.num_qubits
    if isinstance(paulis, str):
        if len(paulis) != n:
            raise ValueError(f"Pauli string length {len(paulis)} != n={n}")
        ops = {q: p for q, p in enumerate(paulis.upper()) if p != "I"}
    else:
        ops = {int(q): str(p).upper() for q, p in paulis.items()}
    for q, p in ops.items():
        if q < 0 or q >= n:
            raise ValueError(f"qubit {q} out of range for n={n}")
        if p not in ("X", "Y", "Z"):
            raise ValueError(f"unsupported Pauli {p!r}")

    # Module-level jit cache: closures are keyed on the op placement so
    # repeated calls (per-qubit profiles, sweeps) never retrace.
    key = ("pauli", tuple(sorted(ops.items())))
    contract = _JIT_CACHE.get(key)
    if contract is None:

        def body(tensors):
            env = jnp.ones((1, 1), tensors[0].dtype)
            norm = jnp.ones((1, 1), tensors[0].dtype)
            for i, t in enumerate(tensors):
                o = jnp.asarray(_PAULI_2X2[ops.get(i, "I")], t.dtype)
                env = jnp.einsum("lm,lpa,pq,mqb->ab", env, t.conj(), o,
                                 t, precision=_PREC)
                norm = jnp.einsum("lm,lpa,mpb->ab", norm, t.conj(), t,
                                  precision=_PREC)
            return jnp.real(env[0, 0]) / jnp.real(norm[0, 0])

        contract = _put_jit(key, body)

    return float(contract(state.tensors))


def _parse_terms(n: int, terms):
    """Validate ``(coeff, pauli_string, qubits)`` Hamiltonian terms
    (the ``models.hamiltonians`` format) into ``(coeff, {site: pauli},
    min_site, max_site)`` tuples.  Identity-only terms parse to an
    empty ops dict (pure energy offset)."""
    parsed = []
    for coeff, pstr, qubits in terms:
        if len(pstr) != len(qubits):
            raise ValueError(f"term {pstr!r} has {len(pstr)} Paulis for "
                             f"{len(qubits)} qubits")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"duplicate qubits in term {pstr!r}: {qubits}")
        ops = {}
        for q, p in zip(qubits, pstr.upper()):
            if q < 0 or q >= n:
                raise ValueError(f"qubit {q} out of range for n={n}")
            if p == "I":
                continue
            if p not in ("X", "Y", "Z"):
                raise ValueError(f"unsupported Pauli {p!r} in {pstr!r}")
            ops[int(q)] = p
        if ops:
            parsed.append((float(coeff), ops, min(ops), max(ops)))
        else:
            parsed.append((float(coeff), ops, 0, -1))
    return parsed


def _hamiltonian_energy(tensors, parsed, n: int):
    """Traceable <H>/<1> over tensors whose orthogonality center is at
    site 0 (the ``MPSState`` / ``_evolve`` invariant: everything right
    of site 0 is right-canonical, so every term's right environment is
    the identity).  After one shared left-identity-environment sweep
    (O(n chi^3)) each term costs only O(support * chi^3) — a 100-qubit
    TFIM energy is ~300 small contractions, not 300 full sweeps."""
    dt = tensors[0].dtype
    left = [jnp.ones((1, 1), dt)]
    for t in tensors:
        left.append(jnp.einsum("lm,lpa,mpb->ab", left[-1],
                               t.conj(), t, precision=_PREC))
    norm2 = jnp.real(left[n][0, 0])
    total = jnp.zeros((), jnp.float32)
    for coeff, ops, a, b in parsed:
        if not ops:  # identity term: <I> = 1 exactly, skip the sweep
            total = total + jnp.float32(coeff) * norm2.astype(jnp.float32)
            continue
        env = left[a]
        for i in range(a, b + 1):
            o = jnp.asarray(_PAULI_2X2[ops.get(i, "I")], dt)
            env = jnp.einsum("lm,lpa,pq,mqb->ab", env,
                             tensors[i].conj(), o, tensors[i],
                             precision=_PREC)
        # Right-canonical tail => right environment is the identity.
        total = total + jnp.float32(coeff) * jnp.real(
            jnp.trace(env)).astype(jnp.float32)
    return total / norm2.astype(jnp.float32)


def expectation_hamiltonian(state: MPSState, terms) -> float:
    """<H> for ``H = sum_k coeff_k * P_k`` in the ``models.hamiltonians``
    term format ``(coeff, pauli_string, qubits)`` — ONE jitted program
    (see ``_hamiltonian_energy`` for the contraction strategy), cached
    on the parsed terms so repeated evaluations never retrace."""
    parsed = _parse_terms(state.num_qubits, terms)
    n = state.num_qubits
    key = ("ham", n,
           tuple((c, tuple(sorted(ops.items()))) for c, ops, _, _ in parsed))
    contract = _JIT_CACHE.get(key)
    if contract is None:
        contract = _put_jit(
            key, lambda tensors: _hamiltonian_energy(tensors, parsed, n))
    return float(contract(state.tensors))


# --------------------------------------------------------------------------
# Variational path: circuit-with-free-parameters -> energy, batched
# --------------------------------------------------------------------------

_COST_FN_CACHE: dict = {}


def build_batched_cost_fn(circuit: QuantumCircuit, bindings, terms,
                          chi: int, constant: float = 0.0):
    """jitted ``f(values_batch[B, P]) -> energies[B]`` evaluating the
    MPS-evolved circuit's ``<H> + constant`` at many parameter points in
    one vmapped launch — the VQE forward pass at widths the dense
    engines cannot hold (reference optimizer surface:
    ``/root/reference/quantum_sim/engine/optimizer.py:133-165``, capped
    at 16 qubits there by ``circuit.py:130``).

    ``bindings`` are ``optimizer.ParameterBinding``-shaped objects
    (``gate_index`` / ``param_index``); every bound gate must have a
    traceable ``jnp_matrix_func`` (the same contract as the compiled
    dense path).  Gradients pair this with the parameter-shift rule:
    reverse-mode autodiff through the truncated-SVD splits is
    numerically unsafe (the SVD JVP divides by ``s_i^2 - s_j^2``, and
    product-state starts make degenerate/zero Schmidt values the common
    case, not the edge case)."""
    registry = GateRegistry.instance()
    n = circuit.num_qubits
    parsed = _parse_terms(n, terms)
    per_gate: dict[int, list] = {}
    for vi, b in enumerate(bindings):
        gate = circuit.gates[b.gate_index]
        gdef = registry.get(gate.gate_name)
        if gdef.jnp_matrix_func is None:
            raise ValueError(
                f"{gate.gate_name} has no traceable matrix builder; the "
                "MPS variational path needs jnp_matrix_func on every "
                "bound gate (same contract as gradient_method='autodiff')")
        if not 0 <= b.param_index < len(gate.params):
            raise ValueError(
                f"binding {vi} indexes param {b.param_index} of "
                f"{gate.gate_name} which has {len(gate.params)}")
        per_gate.setdefault(b.gate_index, []).append((b.param_index, vi))

    key = (circuit.circuit_hash(), chi, float(constant),
           tuple(sorted((gi, tuple(sorted(slots)))
                        for gi, slots in per_gate.items())),
           tuple((c, tuple(sorted(ops.items()))) for c, ops, _, _ in parsed))
    fn = _COST_FN_CACHE.get(key)
    if fn is not None:
        return fn
    dtype = CONFIG.dtype

    def one(values):
        overrides = {}
        for gi, slots in per_gate.items():
            gate = circuit.gates[gi]
            params = list(gate.params)
            for pi, vi in slots:
                params[pi] = values[vi]
            overrides[id(gate)] = params
        tensors, _, _, _ = _evolve(circuit, chi, dtype,
                                   param_overrides=overrides)
        return _hamiltonian_energy(tensors, parsed, n) + jnp.float32(
            constant)

    fn = jax.jit(jax.vmap(one))
    if len(_COST_FN_CACHE) > 32:
        _COST_FN_CACHE.pop(next(iter(_COST_FN_CACHE)))
    _COST_FN_CACHE[key] = fn
    return fn


def overlap(a: MPSState, b: MPSState) -> complex:
    """``<a|b>`` via one transfer contraction — O(n chi^3), any pair of
    bond profiles.  Both states are normalized by construction, so the
    magnitude is the fidelity's square root."""
    if a.num_qubits != b.num_qubits:
        raise ValueError("overlap needs equal qubit counts")

    contract = _JIT_CACHE.get("overlap")
    if contract is None:

        def body(ta, tb):
            env = jnp.ones((1, 1), ta[0].dtype)
            for x, y in zip(ta, tb):
                env = jnp.einsum("lm,lpa,mpb->ab", env, x.conj(), y,
                                 precision=_PREC)
            return env[0, 0]

        contract = _put_jit("overlap", body)

    val = contract(a.tensors, b.tensors)
    return complex(float(jnp.real(val)), float(jnp.imag(val)))


def amplitude(state: MPSState, bits) -> complex:
    """Amplitude of one computational basis state (qubit 0 = MSB,
    matching ``ops/apply.py:30``)."""
    if isinstance(bits, str):
        bits = [int(b) for b in bits]
    if len(bits) != state.num_qubits:
        raise ValueError("bitstring length != num_qubits")

    contract = _JIT_CACHE.get("amplitude")
    if contract is None:

        def body(tensors, b):
            v = jnp.ones((1,), tensors[0].dtype)
            for i, t in enumerate(tensors):
                v = jnp.einsum("l,lr->r", v, t[:, b[i], :],
                               precision=_PREC)
            return v[0]

        contract = _put_jit("amplitude", body)

    val = contract(state.tensors, jnp.asarray(bits, jnp.int32))
    # Transfer real/imag separately (utils/xfer.py).
    return complex(float(jnp.real(val)), float(jnp.imag(val)))


def to_statevector(state: MPSState) -> np.ndarray:
    """Contract the MPS to a dense 2^n vector (n <= 20 guard) — the
    cross-engine validation bridge to the statevector engine."""
    n = state.num_qubits
    if n > 20:
        raise ValueError(f"to_statevector caps at n=20, got n={n}")

    contract = _JIT_CACHE.get("to_statevector")
    if contract is None:

        def body(tensors):
            psi = tensors[0].reshape(2, -1)
            for t in tensors[1:]:
                psi = jnp.einsum("dl,lpr->dpr", psi, t, precision=_PREC)
                psi = psi.reshape(psi.shape[0] * 2, -1)
            return psi[:, 0]

        contract = _put_jit("to_statevector", body)

    vec = contract(state.tensors)
    return np.asarray(jnp.real(vec)) + 1j * np.asarray(jnp.imag(vec))


def entanglement_entropy(state: MPSState, bond: int) -> float:
    """Von Neumann entropy (bits) across the cut between sites ``bond``
    and ``bond+1`` — exact from the Schmidt spectrum at that bond."""
    n = state.num_qubits
    if bond < 0 or bond >= n - 1:
        raise ValueError(f"bond must be in [0, {n - 2}], got {bond}")

    key = ("entropy", bond)
    cached = _JIT_CACHE.get(key)
    if cached is not None:
        return float(cached(state.tensors))

    def schmidt(tensors):
        mps = _TraceMPS.__new__(_TraceMPS)
        mps.n = n
        mps.chi = max(t.shape[2] for t in tensors)
        mps.dtype = tensors[0].dtype
        mps.tensors = list(tensors)
        mps.center = 0
        mps.discarded = jnp.zeros((), jnp.float32)
        mps.move_center_to(bond)
        t = mps.tensors[bond]
        l, _, r = t.shape
        s = jnp.linalg.svd(t.reshape(l * 2, r), compute_uv=False)
        p = s * s
        p = p / jnp.sum(p)
        return -jnp.sum(jnp.where(p > 1e-12, p * jnp.log2(p), 0.0))

    return float(_put_jit(key, schmidt)(state.tensors))


# --------------------------------------------------------------------------
# Simulator facade
# --------------------------------------------------------------------------


class MPSSimulator:
    """Run arbitrary-gate circuits as a bond-dimension-``chi`` MPS.

    Mirrors the sampling surface of ``Simulator.run`` /
    ``CliffordSimulator.run``: counts keyed by MSB-first bitstrings.
    ``truncation_weight`` on the returned state reports exactly how
    much squared Schmidt weight the run discarded (0.0 == exact)."""

    def __init__(self, chi: int = 64):
        if chi < 1:
            raise ValueError("chi must be >= 1")
        self.chi = chi
        self._compiled: dict = {}

    def _final_state(self, circuit: QuantumCircuit,
                     chi: int | None) -> MPSState:
        chi = self.chi if chi is None else chi
        key = (circuit.circuit_hash(), chi)
        fn = self._compiled.get(key)
        if fn is None:
            fn = compile_mps(circuit, chi)
            self._compiled[key] = fn
        tensors, discarded = fn()
        return MPSState(tensors, circuit.num_qubits, chi,
                        float(discarded))

    def run(self, circuit: QuantumCircuit, shots: int = 1000,
            seed: int | None = None, chi: int | None = None,
            basis: str = "Z", readout_error=None):
        """-> (counts, MPSState).

        ``basis`` mirrors ``MeasurementEngine.sample_with_basis``
        (reference ``measurement.py:60-129``): "X" rotates every site
        by H, "Y" by H S-dagger, before the conditional-cascade draw —
        ONE einsum on the padded stack, since 1-site unitaries commute
        with the canonical form.  ``readout_error`` applies SHOT-mode
        corruption (per-bit confusion draws) at any width; the
        reference's distribution mode needs the 2^n probability vector
        and is meaningless at MPS scale."""
        basis = str(getattr(basis, "value", basis)).upper()
        if basis not in ("Z", "X", "Y"):
            raise ValueError(f"unsupported basis {basis!r}")
        state = self._final_state(circuit, chi)
        counts: dict[str, int] = {}
        if shots > 0:
            stack, _ = _stack_padded(state.tensors, state.tensors[0].dtype)
            if basis != "Z":
                rot = _H_2X2 if basis == "X" else _H_2X2 @ _SDG_2X2
                stack = jnp.einsum(
                    "qp,slpr->slqr", jnp.asarray(rot, stack.dtype),
                    stack, precision=_PREC)
            rng = np.random.default_rng(seed)
            key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 63)))
            bits = np.asarray(
                _sample_shots(stack, jax.random.split(key, shots)))
            uniq, cnts = np.unique(bits.astype(np.uint8), axis=0,
                                   return_counts=True)
            counts = {"".join("1" if b else "0" for b in row): int(c)
                      for row, c in zip(uniq, cnts)}
            if readout_error is not None:
                counts = readout_error.corrupt_counts(counts, rng)
        return counts, state

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               chi: int | None = None,
                               noise_model=None):
        """Run T independent monitored trajectories: Measure gates
        collapse mid-circuit via projector draws through the Kraus
        machinery (optionally interleaved with stochastic noise).
        Mirrors ``CliffordSimulator.monitored_trajectories`` at
        arbitrary (non-Clifford) gate sets.

        -> (outcomes[T, M] int array in Measure column order,
            sites [(column, qubit)] * M,
            states: list of T final ``MPSState``s — feed each to
            ``entanglement_entropy`` / ``expectation_pauli_string``)."""
        chi = self.chi if chi is None else chi
        cache_key = (circuit.circuit_hash(), chi, "monitored",
                     str(noise_model.spec_key()) if noise_model else None)
        entry = self._compiled.get(cache_key)
        if entry is None:
            dtype = CONFIG.dtype
            sites_box = []

            def one(k):
                tensors, disc, outs, sites = _evolve(
                    circuit, chi, dtype, noise_model, k,
                    collapse_measures=True)
                if not sites_box:
                    sites_box.append(sites)
                return tensors, disc, outs

            entry = (jax.jit(jax.vmap(one)), sites_box)
            self._compiled[cache_key] = entry
        fn, sites_box = entry
        rng = np.random.default_rng(seed)
        keys = jax.random.split(
            jax.random.PRNGKey(int(rng.integers(0, 2 ** 63))),
            n_trajectories)
        tensors, disc, outs = fn(keys)
        states = [MPSState(tuple(t[i] for t in tensors),
                           circuit.num_qubits, chi, float(disc[i]))
                  for i in range(n_trajectories)]
        return np.asarray(outs), list(sites_box[0]), states

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1000, seed: int | None = None,
                       chi: int | None = None):
        """Noisy counts at MPS scale: one stochastic Kraus trajectory per
        shot (reference re-simulate-per-shot semantics,
        ``simulator.py:116-153``), every trajectory AND its measurement
        drawn in ONE vmapped device launch.  Supports all four reference
        channels — including amplitude damping, which the Clifford
        engine's Pauli-frame trick cannot express — at widths the
        amplitude engines cannot hold.

        -> (counts, mean discarded squared Schmidt weight per
        trajectory; 0.0 means every trajectory was exact at this chi).
        Readout error (shot mode) applies if configured."""
        chi = self.chi if chi is None else chi
        n = circuit.num_qubits
        cache_key = (circuit.circuit_hash(), str(noise_model.spec_key()),
                     chi, "noisy")
        fn = self._compiled.get(cache_key)
        if fn is None:
            dtype = CONFIG.dtype

            def one(k):
                k_traj, k_meas = jax.random.split(k)
                tensors, disc, _, _ = _evolve(circuit, chi, dtype,
                                              noise_model, k_traj)
                stack, _ = _stack_padded(tensors, dtype)
                return _sample_one_shot(stack, k_meas), disc

            fn = jax.jit(jax.vmap(one))
            self._compiled[cache_key] = fn
        rng = np.random.default_rng(seed)
        keys = jax.random.split(
            jax.random.PRNGKey(int(rng.integers(0, 2 ** 63))), shots)
        bits, disc = fn(keys)
        bits = np.asarray(bits).astype(np.uint8)
        uniq, cnts = np.unique(bits, axis=0, return_counts=True)
        counts = {"".join("1" if b else "0" for b in row): int(c)
                  for row, c in zip(uniq, cnts)}
        ro = getattr(noise_model, "readout_error", None)
        if ro is not None:
            counts = ro.corrupt_counts(counts, rng)
        return counts, float(np.asarray(jnp.mean(disc)))

    # Observable surface re-exported on the class for discoverability.
    expectation_pauli_string = staticmethod(expectation_pauli_string)
    expectation_hamiltonian = staticmethod(expectation_hamiltonian)
    overlap = staticmethod(overlap)
    amplitude = staticmethod(amplitude)
    to_statevector = staticmethod(to_statevector)
    entanglement_entropy = staticmethod(entanglement_entropy)
