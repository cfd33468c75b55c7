"""Clifford/stabilizer tableau engine: hundreds of qubits, no 2^n state.

The statevector engines (dense, chunked, sharded) top out near n=32 —
the information-theoretic wall for amplitude simulation.  Circuits made
of Clifford gates (H, S, S_DAG, X, Y, Z, CNOT, CZ, SWAP) evolve stabilizer
states, which the Aaronson-Gottesman CHP tableau tracks in O(n^2) bits:
2n generator rows (n destabilizers + n stabilizers) of X/Z bit vectors
plus a sign.  This module implements that representation on the device:

* a gate is a handful of column XOR/AND updates over all 2n rows at
  once (pure elementwise int32 ops on (2n, n) tensors);
* the whole circuit compiles to ONE jitted tableau program (gate
  dispatch happens at trace time, like ``ops/program.py``);
* Z-basis measurement is branchless — the random and deterministic
  branches both evaluate as masked tensor algebra and ``jnp.where``
  selects, so a shot's n-qubit measurement cascade is a ``lax.scan``
  and S shots vmap into one device launch.

Semantics match the reference conventions: qubit 0 is the MSB of
result bitstrings, MEASUREMENT/BARRIER gates are skipped during
evolution and sampling happens at the end
(``/root/reference/quantum_sim/engine/simulator.py:61-83``).  Agreement
with the statevector engine is locked in by tests (exact counts on
deterministic circuits, TVD on random Clifford circuits, GHZ parity).

Reference for the tableau algebra: Aaronson & Gottesman,
"Improved simulation of stabilizer circuits" (quant-ph/0406196).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .circuit import QuantumCircuit
from .gates import GateType
from .registry import GateRegistry


CLIFFORD_GATES = frozenset(
    {"I", "H", "X", "Y", "Z", "S", "S_DAG", "CNOT", "CZ", "SWAP"})


def is_clifford_circuit(circuit: QuantumCircuit) -> bool:
    """True when every (non-measurement, non-barrier) gate is Clifford."""
    registry = GateRegistry.instance()
    for g in circuit.gates:
        try:
            gdef = registry.get(g.gate_name)
        except KeyError:
            return False
        if gdef.gate_type in (GateType.MEASUREMENT, GateType.BARRIER):
            continue
        if g.gate_name not in CLIFFORD_GATES:
            return False
    return True


class Tableau(NamedTuple):
    """CHP tableau: rows 0..n-1 destabilizers, n..2n-1 stabilizers."""

    x: jnp.ndarray   # (2n, n) int32 0/1
    z: jnp.ndarray   # (2n, n) int32 0/1
    r: jnp.ndarray   # (2n,)  int32 0/1 sign bits


def identity_tableau(n: int) -> Tableau:
    """|0...0>: destabilizer i = X_i, stabilizer i = Z_i."""
    eye = np.eye(n, dtype=np.int32)
    x = np.concatenate([eye, np.zeros((n, n), np.int32)])
    z = np.concatenate([np.zeros((n, n), np.int32), eye])
    return Tableau(jnp.asarray(x), jnp.asarray(z),
                   jnp.zeros(2 * n, jnp.int32))


# --- gate updates -----------------------------------------------------------
# The single source of tableau gate algebra is ``_build_branches`` (the
# lax.switch bodies of the scan executor); ``_apply_gate`` is a thin
# trace-time wrapper over the same branch functions so the algebra can
# never drift between the unit-testable API and the compiled path.

def _apply_gate(tab: Tableau, name: str, qubits: list[int]) -> Tableau:
    if name in ("I", "Barrier", "Measure"):
        return tab
    if name == "CZ":
        c, t = qubits
        tab = _apply_gate(tab, "H", [t])
        tab = _apply_gate(tab, "CNOT", [c, t])
        return _apply_gate(tab, "H", [t])
    if name not in _GATE_OPCODES:
        raise ValueError(f"not a Clifford gate: {name}")
    branch = _branches()[_GATE_OPCODES[name]]
    a = qubits[0]
    b = qubits[1] if len(qubits) > 1 else 0
    tab, _ = branch(tab, a, b, jnp.float32(0.0), jnp.float32(0.0))
    return tab


# --- measurement ------------------------------------------------------------

def _g_phase(x1, z1, x2, z2):
    """Aaronson-Gottesman g(): phase exponent (mod 4 contribution) of
    multiplying single-qubit Paulis (x1,z1) * (x2,z2); elementwise."""
    return jnp.where(
        (x1 == 1) & (z1 == 1), z2 - x2,
        jnp.where((x1 == 1) & (z1 == 0), z2 * (2 * x2 - 1),
                  jnp.where((x1 == 0) & (z1 == 1), x2 * (1 - 2 * z2), 0)))


def _rowsum_phase(xs, zs, xh, zh, rs, rh):
    """Sign bit of (row h) * (row s): rows are full Pauli strings;
    batched over leading dims. Result is the new r for row h."""
    gsum = jnp.sum(_g_phase(xs, zs, xh, zh), axis=-1)
    tot = 2 * rh + 2 * rs + gsum
    return (tot % 4) // 2


def _measure_z(tab: Tableau, q: int | jnp.ndarray, rand_bit) -> tuple:
    """Measure Z on qubit q. Branchless: both the random-outcome and
    deterministic-outcome branches evaluate; ``jnp.where`` selects.
    Returns (tableau', outcome)."""
    x, z, r = tab
    two_n, n = x.shape
    rows = jnp.arange(two_n)
    xq = jnp.take(x, q, axis=1)                      # (2n,)
    stab_has_x = xq * (rows >= n)
    exists = jnp.any(stab_has_x == 1)
    p = jnp.argmax(stab_has_x)                       # first stabilizer w/ x=1

    # --- random branch: rowsum every other x-having row with row p ----------
    xp, zp, rp = x[p], z[p], r[p]
    fix = (xq == 1) & (rows != p)
    new_r_all = _rowsum_phase(xp[None, :], zp[None, :], x, z, rp, r)
    r_rand = jnp.where(fix, new_r_all, r)
    x_rand = jnp.where(fix[:, None], x ^ xp[None, :], x)
    z_rand = jnp.where(fix[:, None], z ^ zp[None, :], z)
    # destabilizer p-n := old row p; row p := Z_q with sign = outcome
    outcome_rand = rand_bit.astype(jnp.int32)
    dest = p - n
    x_rand = x_rand.at[dest].set(xp)
    z_rand = z_rand.at[dest].set(zp)
    r_rand = r_rand.at[dest].set(rp)
    zq_row = (jnp.arange(n) == q).astype(jnp.int32)
    x_rand = x_rand.at[p].set(jnp.zeros(n, jnp.int32))
    z_rand = z_rand.at[p].set(zq_row)
    r_rand = r_rand.at[p].set(outcome_rand)

    # --- deterministic branch: accumulate stabilizers whose destabilizer
    # partner has x=1 at q into a scratch row (sequential phase tracking) ---
    def body(i, carry):
        sx, sz, sr = carry
        use = xq[i]                                   # destabilizer row i
        xs, zs, rs = x[i + n], z[i + n], r[i + n]
        new_sr = _rowsum_phase(xs, zs, sx, sz, rs, sr)
        sr = jnp.where(use == 1, new_sr, sr)
        sx = jnp.where(use == 1, sx ^ xs, sx)
        sz = jnp.where(use == 1, sz ^ zs, sz)
        return sx, sz, sr

    sx0 = jnp.zeros(n, jnp.int32)
    _, _, outcome_det = jax.lax.fori_loop(
        0, n, body, (sx0, sx0, jnp.int32(0)))

    x_new = jnp.where(exists, x_rand, x)
    z_new = jnp.where(exists, z_rand, z)
    r_new = jnp.where(exists, r_rand, r)
    outcome = jnp.where(exists, outcome_rand, outcome_det)
    return Tableau(x_new, z_new, r_new), outcome


def _sample_fn(n: int):
    """jitted ``(tableau, rand_bits[S, n]) -> bits[S, n]`` — S shots of a
    full computational-basis measurement cascade, vmapped."""

    def one_shot(tab, rand_bits):
        def step(carry, q):
            tab = carry
            tab, out = _measure_z(tab, q, rand_bits[q])
            return tab, out

        _, outs = jax.lax.scan(step, tab, jnp.arange(n))
        return outs                                  # (n,) qubit-0 first

    return jax.jit(jax.vmap(one_shot, in_axes=(None, 0)))


# --- compiled circuit: schedule-as-data scan engine -------------------------
#
# The whole circuit lowers to four integer/float arrays (opcode, qubit a,
# qubit b, channel prob) consumed by ONE lax.scan step containing a
# lax.switch — so XLA compiles each op KIND once and compile time is
# independent of circuit depth (a 600-measurement monitored circuit
# previously inlined 600 measurement bodies and took minutes to compile).

_OP_I, _OP_H, _OP_S, _OP_SDAG, _OP_X, _OP_Y, _OP_Z = range(7)
_OP_CNOT, _OP_SWAP, _OP_MEASURE = 7, 8, 9
_OP_NOISE_BF, _OP_NOISE_PF, _OP_NOISE_DEPOL = 10, 11, 12
_OP_NOISE_DEPOL2 = 13

_GATE_OPCODES = {"I": _OP_I, "H": _OP_H, "S": _OP_S, "S_DAG": _OP_SDAG,
                 "X": _OP_X, "Y": _OP_Y, "Z": _OP_Z, "CNOT": _OP_CNOT,
                 "SWAP": _OP_SWAP}
_NOISE_OPCODES = {"BitFlipNoise": _OP_NOISE_BF,
                  "PhaseFlipNoise": _OP_NOISE_PF,
                  "DepolarizingNoise": _OP_NOISE_DEPOL}


def _build_branches():
    """lax.switch branches: ``(tab, a, b, u, p) -> (tab, out)`` with
    dynamic qubit indices (jnp.take / .at scatter on traced columns).
    This is THE tableau gate algebra — ``_apply_gate`` wraps the same
    functions with static indices."""

    def _i(tab, a, b, u, p):
        return tab, jnp.int32(0)

    def _h(tab, a, b, u, p):
        x, z, r = tab
        xq, zq = jnp.take(x, a, axis=1), jnp.take(z, a, axis=1)
        return Tableau(x.at[:, a].set(zq), z.at[:, a].set(xq),
                       r ^ (xq & zq)), jnp.int32(0)

    def _s(tab, a, b, u, p):
        x, z, r = tab
        xq, zq = jnp.take(x, a, axis=1), jnp.take(z, a, axis=1)
        return Tableau(x, z.at[:, a].set(zq ^ xq),
                       r ^ (xq & zq)), jnp.int32(0)

    def _sdag(tab, a, b, u, p):
        x, z, r = tab
        xq, zq = jnp.take(x, a, axis=1), jnp.take(z, a, axis=1)
        return Tableau(x, z.at[:, a].set(zq ^ xq),
                       r ^ (xq & zq) ^ xq), jnp.int32(0)

    def _px(tab, a, b, u, p):
        x, z, r = tab
        return Tableau(x, z, r ^ jnp.take(z, a, axis=1)), jnp.int32(0)

    def _py(tab, a, b, u, p):
        x, z, r = tab
        return Tableau(x, z, r ^ jnp.take(x, a, axis=1)
                       ^ jnp.take(z, a, axis=1)), jnp.int32(0)

    def _pz(tab, a, b, u, p):
        x, z, r = tab
        return Tableau(x, z, r ^ jnp.take(x, a, axis=1)), jnp.int32(0)

    def _cnot(tab, a, b, u, p):
        x, z, r = tab
        xc, zc = jnp.take(x, a, axis=1), jnp.take(z, a, axis=1)
        xt, zt = jnp.take(x, b, axis=1), jnp.take(z, b, axis=1)
        r = r ^ (xc & zt & (xt ^ zc ^ 1))
        return Tableau(x.at[:, b].set(xt ^ xc),
                       z.at[:, a].set(zc ^ zt), r), jnp.int32(0)

    def _swap(tab, a, b, u, p):
        x, z, r = tab
        xa, xb = jnp.take(x, a, axis=1), jnp.take(x, b, axis=1)
        za, zb = jnp.take(z, a, axis=1), jnp.take(z, b, axis=1)
        x = x.at[:, a].set(xb).at[:, b].set(xa)
        z = z.at[:, a].set(zb).at[:, b].set(za)
        return Tableau(x, z, r), jnp.int32(0)

    def _meas(tab, a, b, u, p):
        tab, out = _measure_z(tab, a, (u < 0.5).astype(jnp.int32))
        return tab, out

    def _pauli(tab, a, x_bit, z_bit):
        x, z, r = tab
        sign = (x_bit & jnp.take(z, a, axis=1)) \
            ^ (z_bit & jnp.take(x, a, axis=1))
        return Tableau(x, z, r ^ sign), jnp.int32(0)

    def _nbf(tab, a, b, u, p):
        return _pauli(tab, a, (u < p).astype(jnp.int32), jnp.int32(0))

    def _npf(tab, a, b, u, p):
        return _pauli(tab, a, jnp.int32(0), (u < p).astype(jnp.int32))

    def _ndepol(tab, a, b, u, p):
        xb = (u < 2 * p / 3).astype(jnp.int32)
        zb = ((u >= p / 3) & (u < p)).astype(jnp.int32)
        return _pauli(tab, a, xb, zb)

    def _ndepol2(tab, a, b, u, p):
        """Correlated two-qubit depolarizing: u < p picks one of the 15
        non-identity Pauli pairs uniformly (pair id 1..15, qubit-a
        Pauli = id >> 2, qubit-b Pauli = id & 3; 0=I 1=X 2=Y 3=Z)."""
        fire = (u < p).astype(jnp.int32)
        pid = (1 + jnp.clip((u * 15 / p).astype(jnp.int32), 0, 14)) * fire
        ia, ja = pid >> 2, pid & 3
        tab, _ = _pauli(tab, a, ((ia == 1) | (ia == 2)).astype(jnp.int32),
                        ((ia == 2) | (ia == 3)).astype(jnp.int32))
        return _pauli(tab, b, ((ja == 1) | (ja == 2)).astype(jnp.int32),
                      ((ja == 2) | (ja == 3)).astype(jnp.int32))

    return [_i, _h, _s, _sdag, _px, _py, _pz, _cnot, _swap, _meas,
            _nbf, _npf, _ndepol, _ndepol2]


_BRANCH_CACHE: list = []


def _branches():
    if not _BRANCH_CACHE:
        _BRANCH_CACHE.append(_build_branches())
    return _BRANCH_CACHE[0]


def _lower(circuit: QuantumCircuit, noise_model=None,
           collapse_measures: bool = False):
    """Circuit (+ optional Pauli noise) -> static schedule arrays
    (codes, qa, qb, pp) and the (column, qubit) site per Measure.
    CZ lowers to H CNOT H."""
    if not is_clifford_circuit(circuit):
        raise ValueError(
            "circuit contains non-Clifford gates; use Simulator instead")
    registry = GateRegistry.instance()
    codes: list[int] = []
    qa: list[int] = []
    qb: list[int] = []
    pp: list[float] = []
    sites: list[tuple[int, int]] = []

    def emit(code, a, b=0, p=0.0):
        codes.append(code)
        qa.append(a)
        qb.append(b)
        pp.append(p)

    # Honor per-qubit initial states (|1> preps lower to X ops, noise-free
    # — the amplitude engines do the same via program.initial_index).
    for q, bit in enumerate(circuit.initial_states):
        if bit:
            emit(_OP_X, q)

    for column in circuit.get_ordered_gates():
        for g in column:
            gdef = registry.get(g.gate_name)
            if gdef.gate_type == GateType.BARRIER:
                continue
            if gdef.gate_type == GateType.MEASUREMENT:
                if collapse_measures:
                    emit(_OP_MEASURE, g.target_qubits[0])
                    sites.append((g.column, g.target_qubits[0]))
                continue
            if g.gate_name == "CZ":
                c, t = g.target_qubits
                emit(_OP_H, t)
                emit(_OP_CNOT, c, t)
                emit(_OP_H, t)
            else:
                ts = list(g.target_qubits)
                emit(_GATE_OPCODES[g.gate_name], ts[0],
                     ts[1] if len(ts) > 1 else 0)
            if noise_model is not None:
                for ch in noise_model.channels_for_gate(g.gate_name):
                    kind = type(ch).__name__
                    if kind == "TwoQubitDepolarizingNoise":
                        if len(g.target_qubits) != 2:
                            raise ValueError(
                                "TwoQubitDepolarizingNoise is registered "
                                f"on {g.gate_name}, a "
                                f"{len(g.target_qubits)}-qubit gate; "
                                "register it per 2-qubit gate name")
                        emit(_OP_NOISE_DEPOL2, g.target_qubits[0],
                             g.target_qubits[1], ch.probability)
                        continue
                    if kind not in _NOISE_OPCODES:
                        raise ValueError(
                            f"{kind} is not a Pauli channel; the Clifford "
                            "engine supports bit_flip/phase_flip/"
                            "depolarizing (1- and 2-qubit)")
                    for q in g.target_qubits:
                        emit(_NOISE_OPCODES[kind], q, 0, ch.probability)

    return (np.asarray(codes, np.int32), np.asarray(qa, np.int32),
            np.asarray(qb, np.int32), np.asarray(pp, np.float32), sites)


def _scan_evolve_fn(n: int, codes, qa, qb, pp):
    """jitted ``(key) -> (Tableau, outcomes[M])`` over the static
    schedule arrays. ``outcomes`` are the per-Measure results in
    schedule order (empty when the schedule has no measurements)."""
    branches = _branches()
    L = len(codes)
    measure_idx = np.nonzero(codes == _OP_MEASURE)[0]

    @jax.jit
    def evolve(key):
        if L == 0:
            return identity_tableau(n), jnp.zeros(0, jnp.int32)
        u = jax.random.uniform(key, (L,))

        def body(tab, xs):
            code, a, b, uu, p = xs
            tab, out = jax.lax.switch(code, branches, tab, a, b, uu, p)
            return tab, out

        tab, outs = jax.lax.scan(
            body, identity_tableau(n),
            (jnp.asarray(codes), jnp.asarray(qa), jnp.asarray(qb), u,
             jnp.asarray(pp)))
        outcomes = (outs[jnp.asarray(measure_idx)] if len(measure_idx)
                    else jnp.zeros(0, jnp.int32))
        return tab, outcomes

    return evolve


def compile_clifford(circuit: QuantumCircuit):
    """Circuit -> jitted ``() -> Tableau`` (MEASUREMENT/BARRIER skipped,
    reference simulator semantics; schedule-as-data scan engine)."""
    codes, qa, qb, pp, _ = _lower(circuit)
    fn = _scan_evolve_fn(circuit.num_qubits, codes, qa, qb, pp)

    def evolve():
        tab, _ = fn(jax.random.PRNGKey(0))
        return tab

    return evolve


def compile_clifford_monitored(circuit: QuantumCircuit,
                               feedforward=None):
    """Circuit -> jitted ``(key) -> (Tableau, outcomes[M])`` where every
    MEASUREMENT gate COLLAPSES its qubit at its column position (instead
    of the reference's skip-and-sample-at-the-end semantics, which
    ``compile_clifford`` keeps).  ``outcomes[i]`` is the i-th Measure
    gate's result in column order, and the measured (column, qubit)
    sites come back as the second return value.

    ``feedforward``: optional [(measure_index, 'X'|'Y'|'Z', qubit)]
    classical corrections applied AFTER the circuit, conditioned on the
    recorded outcome.  For Clifford circuits this loses no generality:
    a mid-circuit conditional Pauli commutes through the remaining
    Cliffords as another conditional Pauli, so end-applied corrections
    implement teleportation/entanglement-swapping protocols exactly.

    This is the monitored-circuit primitive: unitaries + mid-circuit
    measurements + tableau entropy = measurement-induced entanglement
    physics at widths no amplitude engine reaches. Trajectories vmap
    over keys."""
    codes, qa, qb, pp, sites = _lower(circuit, collapse_measures=True)
    base = _scan_evolve_fn(circuit.num_qubits, codes, qa, qb, pp)
    if not feedforward:
        return base, sites

    for mi, pauli, q in feedforward:
        if not 0 <= mi < len(sites):
            raise ValueError(f"feedforward references measurement {mi}; "
                             f"circuit has {len(sites)}")
        if pauli not in ("X", "Y", "Z"):
            raise ValueError(f"not a Pauli correction: {pauli}")
        if not 0 <= q < circuit.num_qubits:
            raise ValueError(f"feedforward qubit {q} out of range")
    rules = [(int(mi), pauli, int(q)) for mi, pauli, q in feedforward]

    @jax.jit
    def evolve(key):
        tab, outcomes = base(key)
        x, z, r = tab
        for mi, pauli, q in rules:
            bit = outcomes[mi]
            if pauli in ("X", "Y"):
                r = r ^ (bit & z[:, q])
            if pauli in ("Z", "Y"):
                r = r ^ (bit & x[:, q])
        return Tableau(x, z, r), outcomes

    return evolve, sites


_PAULI_CHANNELS = frozenset(_NOISE_OPCODES)


def compile_clifford_noisy(circuit: QuantumCircuit, noise_model):
    """Circuit + Pauli noise -> jitted ``(key) -> Tableau`` — ONE
    stochastic trajectory.

    Pauli channels commute with the tableau representation: a stochastic
    Kraus draw is exactly an iid Pauli insertion (the branch norms
    ``||K_i psi||^2`` are state-independent for Pauli Kraus operators,
    so the statevector engine's state-dependent selection
    (``noise.py:224-260`` in the reference) reduces to the channel
    probabilities).  A conditional Pauli with runtime bits (a, b) is two
    sign updates — ``r ^= a & z[:, q] ^ b & x[:, q]`` — so the noisy
    program stays pure tensor algebra and trajectories vmap.

    Channels fire after every gate on that gate's target qubits, the
    reference semantics.  AmplitudeDamping is not a Pauli channel and is
    rejected (use the statevector engine at amplitude widths)."""
    codes, qa, qb, pp, _ = _lower(circuit, noise_model=noise_model)
    fn = _scan_evolve_fn(circuit.num_qubits, codes, qa, qb, pp)

    def evolve(key):
        tab, _ = fn(key)
        return tab

    return evolve


class CliffordSimulator:
    """Run Clifford circuits on the tableau engine at any width.

    ``run`` mirrors ``Simulator.run``'s sampling surface (counts keyed
    by MSB-first bitstrings); ``stabilizers`` renders the generator
    strings; ``expectation_z_string`` reduces a Z-string against the
    group exactly (+1/-1/0)."""

    def __init__(self):
        self._compiled: dict[str, tuple] = {}

    def _final_tableau(self, circuit: QuantumCircuit) -> Tableau:
        key = circuit.structure_hash()
        entry = self._compiled.get(key)
        if entry is None:
            entry = (compile_clifford(circuit), _sample_fn(
                circuit.num_qubits))
            self._compiled[key] = entry
        return entry[0](), entry[1]

    def run(self, circuit: QuantumCircuit, shots: int = 1000,
            seed: int | None = None):
        """-> (counts, Tableau). Counts use the qubit-0-is-MSB
        convention shared by every engine in this framework."""
        n = circuit.num_qubits
        tab, sampler = self._final_tableau(circuit)
        counts: dict[str, int] = {}
        if shots > 0:
            key = jax.random.PRNGKey(
                int(np.random.default_rng(seed).integers(0, 2 ** 63)))
            rand = jax.random.bernoulli(
                key, 0.5, (shots, n)).astype(jnp.int32)
            bits = np.asarray(sampler(tab, rand))    # (S, n), qubit 0 first
            # Row-wise unique (integer packing would overflow past n=63).
            uniq, cnts = np.unique(bits.astype(np.uint8), axis=0,
                                   return_counts=True)
            counts = {"".join("1" if b else "0" for b in row): int(c)
                      for row, c in zip(uniq, cnts)}
        return counts, tab

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               feedforward=None):
        """Run T independent monitored trajectories (Measure gates
        collapse mid-circuit, ``compile_clifford_monitored``).

        -> (outcomes[T, M] int array in Measure column order,
            sites [(column, qubit)] * M,
            tableaus: list of T final ``Tableau``s — feed each to
            ``entanglement_entropy`` / ``stabilizers``)."""
        key = ("monitored", circuit.structure_hash(),
               tuple(map(tuple, feedforward)) if feedforward else None)
        entry = self._compiled.get(key)
        if entry is None:
            evolve, sites = compile_clifford_monitored(circuit,
                                                       feedforward)
            entry = (jax.jit(jax.vmap(evolve)), sites)
            self._compiled[key] = entry
        fn, sites = entry
        rng = np.random.default_rng(seed)
        keys = jax.random.split(
            jax.random.PRNGKey(int(rng.integers(0, 2 ** 63))),
            n_trajectories)
        tabs, outs = fn(keys)
        tableaus = [Tableau(tabs.x[t], tabs.z[t], tabs.r[t])
                    for t in range(n_trajectories)]
        return np.asarray(outs), list(sites), tableaus

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1000, seed: int | None = None):
        """Noisy counts: one stochastic Pauli trajectory per shot, all
        trajectories AND their measurement cascades vmapped into one
        device launch (reference semantics: re-simulate per shot,
        ``simulator.py:116-153``; here that is actually affordable at
        n=100+). Readout error (shot mode) applies if configured.

        Memory: shots x tableau = S * 2n * n ints; chunk shots for
        n in the thousands."""
        n = circuit.num_qubits
        key = (circuit.structure_hash(), str(noise_model.spec_key()))
        entry = self._compiled.get(key)
        if entry is None:
            traj = compile_clifford_noisy(circuit, noise_model)
            sampler_one = _sample_fn(n)

            def one(k):
                k_traj, k_meas = jax.random.split(k)
                tab = traj(k_traj)
                rand = jax.random.bernoulli(
                    k_meas, 0.5, (1, n)).astype(jnp.int32)
                return sampler_one(tab, rand)[0]

            entry = jax.jit(jax.vmap(one))
            self._compiled[key] = entry
        rng = np.random.default_rng(seed)
        keys = jax.random.split(
            jax.random.PRNGKey(int(rng.integers(0, 2 ** 63))), shots)
        bits = np.asarray(entry(keys)).astype(np.uint8)   # (S, n)
        uniq, cnts = np.unique(bits, axis=0, return_counts=True)
        counts = {"".join("1" if b else "0" for b in row): int(c)
                  for row, c in zip(uniq, cnts)}
        ro = getattr(noise_model, "readout_error", None)
        if ro is not None:
            counts = ro.corrupt_counts(counts, rng)
        return counts

    @staticmethod
    def stabilizers(tab: Tableau) -> list[str]:
        """Stabilizer generator strings, e.g. '+XXI', qubit 0 first."""
        x = np.asarray(tab.x)
        z = np.asarray(tab.z)
        r = np.asarray(tab.r)
        n = x.shape[1]
        out = []
        for i in range(n, 2 * n):
            chars = []
            for q in range(n):
                chars.append("IXZY"[x[i, q] + 2 * z[i, q]])
            out.append(("-" if r[i] else "+") + "".join(chars))
        return out

    @staticmethod
    def entanglement_entropy(tab: Tableau, subsystem: list[int]) -> float:
        """Exact entanglement entropy (in bits) of a stabilizer state:
        S_A = rank_GF2 of the stabilizer generators restricted to A
        minus |A| (Fattal et al., quant-ph/0406168).  Lets the analysis
        library's entropy surface (``analysis.py:107-116`` parity) run
        at hundreds of qubits — validated against the statevector
        entropy for n <= 6 in tests."""
        x = np.asarray(tab.x)
        z = np.asarray(tab.z)
        n = x.shape[1]
        A = sorted(set(subsystem))
        if any(q < 0 or q >= n for q in A):
            raise ValueError(f"subsystem out of range for n={n}")
        if not A or len(A) == n:
            return 0.0
        # Stabilizer rows restricted to A as [X_A | Z_A] over GF(2).
        m = np.concatenate([x[n:, A], z[n:, A]], axis=1).astype(np.uint8)
        rank = 0
        rows, cols = m.shape
        r = 0
        for c in range(cols):
            pivot = None
            for i in range(r, rows):
                if m[i, c]:
                    pivot = i
                    break
            if pivot is None:
                continue
            m[[r, pivot]] = m[[pivot, r]]
            for i in range(rows):
                if i != r and m[i, c]:
                    m[i] ^= m[r]
            r += 1
        rank = r
        return float(rank - len(A))

    @staticmethod
    def expectation_pauli_string(tab: Tableau,
                                 paulis: list[tuple[int, str]]) -> float:
        """<P> for an arbitrary Pauli string P = prod (q, 'X'|'Y'|'Z'):
        exactly +1, -1, or 0 on a stabilizer state.

        P commutes with the full stabilizer group iff the product of
        stabilizers paired to P-anticommuting destabilizers reproduces
        P's bit pattern; the accumulated sign (the same mod-4 ``g``
        bookkeeping the measurement rowsum uses, so Y = XZ phases are
        tracked exactly) gives the value, otherwise <P> = 0."""
        x = np.asarray(tab.x)
        z = np.asarray(tab.z)
        r = np.asarray(tab.r)
        n = x.shape[1]
        seen = set()
        x_mask = np.zeros(n, dtype=np.int64)
        z_mask = np.zeros(n, dtype=np.int64)
        for q, p in paulis:
            if q in seen:
                raise ValueError("duplicate qubits in Pauli string")
            if q < 0 or q >= n:
                raise ValueError(f"qubit {q} out of range for n={n}")
            seen.add(q)
            if p in ("X", "Y"):
                x_mask[q] = 1
            if p in ("Z", "Y"):
                z_mask[q] = 1
            if p not in ("X", "Y", "Z"):
                raise ValueError(f"not a Pauli: {p}")
        # Destabilizer i anticommutes with P iff the symplectic overlap
        # sum_q (xP*z_i + zP*x_i) is odd.
        sel = (z[:n] @ x_mask + x[:n] @ z_mask) % 2   # (n,)
        sx = np.zeros(n, np.int64)
        sz = np.zeros(n, np.int64)
        sr = 0
        for i in range(n):
            if sel[i]:
                xs, zs, rs = x[i + n], z[i + n], r[i + n]
                g = np.where((xs == 1) & (zs == 1), sz - sx,
                             np.where((xs == 1) & (zs == 0),
                                      sz * (2 * sx - 1),
                                      np.where((xs == 0) & (zs == 1),
                                               sx * (1 - 2 * sz), 0)))
                sr = ((2 * sr + 2 * rs + int(g.sum())) % 4) // 2
                sx ^= xs
                sz ^= zs
        if (sx != x_mask).any() or (sz != z_mask).any():
            return 0.0
        return -1.0 if sr else 1.0

    @staticmethod
    def expectation_z_string(tab: Tableau, qubits: list[int]) -> float:
        """<prod_q Z_q> — the Z-only case of
        ``expectation_pauli_string``."""
        if len(set(qubits)) != len(qubits):
            raise ValueError("duplicate qubits in Z string")
        return CliffordSimulator.expectation_pauli_string(
            tab, [(q, "Z") for q in qubits])
