"""Circuit-level-noise QEC memory on the Clifford tableau engine.

The other QEC engines draw *phenomenological* noise: iid data errors per
round plus iid syndrome-readout flips (``qec_frame``).  This module runs
the REAL syndrome-extraction circuit — ancilla qubits, H / CNOT ladders,
mid-circuit measurements — as noisy Clifford trajectories
(``clifford.py``'s schedule-as-data scan engine, one vmapped launch for
all trials), so every fault location the hardware has exists in the
simulation: ancilla preparation, each CNOT (hook errors that propagate
onto multiple data qubits), and readout.  Decoding reuses the space-time
union-find matching graph (``qec_matching.space_time_graph``): detection
events from real circuits are still vertex pairs (or boundary singles),
just with fault mechanisms the phenomenological graph prices
approximately — the standard practice when decoding circuit noise on a
phenomenological graph.

No mid-circuit resets are needed: ancillas are measured and *reused*.
With the ancilla left in its measured state, round r's outcome obeys
``o_r = o_{r-1} XOR s_r`` (the fresh parity XORs onto the previous
eigenstate), so per-round syndromes are recovered classically as
consecutive-outcome differences — and an ancilla flip AFTER its readout
cancels telescopically, acting as exactly one measurement-error
(vertical) edge, which keeps the no-reset chain compatible with the
decoder's graph.

Noise models: per-target 1q depolarizing after every gate (default),
or the literature's standard circuit noise (``two_qubit_depol=True``):
correlated 15-Pauli depolarizing after every CNOT + 1q depolarizing
after every 1q gate.  NOTE the conventions differ in total noise per
CNOT (two independent p-draws vs one p-draw), so logical rates are not
comparable across them at equal p.

Reference anchor: the reference's QEC runs one noisy cycle of three
small codes through a dense statevector with *implicit* (perfect,
circuit-free) syndrome extraction
(``/root/reference/quantum_sim/engine/qec.py:497-549``); fault-bearing
extraction circuits are beyond it at any size.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .circuit import GateInstance, QuantumCircuit
from .clifford import _OP_MEASURE, _lower, _scan_evolve_fn
from .noise import DepolarizingNoise, NoiseModel
from .qec import _rotated_surface_geometry
from .qec_matching import space_time_decode_fn


def _check_schedule(checks: list[list[int]], d: int,
                    order: tuple[int, ...]) -> list[dict[int, int]]:
    """Per-check ``{step: data_qubit}`` CNOT schedule.

    Each check's support qubits sit in fixed SLOTS of its (possibly
    boundary-clipped) 2x2 cell — 0=NW 1=NE 2=SW 3=SE — and ``order``
    maps step k to the slot read at step k.  Two rules make the
    schedule sound, both test-locked:

    - **Slot-true steps for boundary half-cells.**  A weight-2 check
      keeps its qubits' full-cell slots (a top-row X half-cell holds
      SW/SE, a left-column Z half-cell NE/SE, etc.).  Compressing them
      to the first free steps breaks the even-overlap commutation rule
      with neighboring full cells: mid-round, exactly one of the two
      shared qubits would see the X-check's CNOT before the Z-check's,
      entangling the two ancillas and randomizing the Z syndrome
      (measured: the d=3 top-boundary X check made Z-check 0's outcome
      a coin flip at p=0).
    - **Hook orientation.**  An ancilla fault after step k propagates
      to the remaining targets, so the last two slots read are the
      weight-2 data hook; X hooks must land perpendicular to X_L
      (column 0) and Z hooks perpendicular to Z_L (row 0) — hence the
      two different zigzags chosen by the caller.
    """
    out = []
    for sup in checks:
        coords = sorted((q // d, q % d) for q in sup)
        rows = {rc[0] for rc in coords}
        cols = {rc[1] for rc in coords}
        if len(sup) == 4:
            r0, c0 = min(rows), min(cols)
        elif len(rows) == 1:        # horizontal pair: row-edge half-cell
            r0 = -1 if next(iter(rows)) == 0 else d - 1
            c0 = min(cols)
        else:                       # vertical pair: col-edge half-cell
            c0 = -1 if next(iter(cols)) == 0 else d - 1
            r0 = min(rows)
        sched: dict[int, int] = {}
        for rr, cc in coords:
            slot = (rr - r0) * 2 + (cc - c0)
            sched[order.index(slot)] = rr * d + cc
        out.append(sched)
    return out


@dataclass(frozen=True)
class ExtractionLayout:
    """Index bookkeeping for one extraction circuit's measurement record
    (outcome positions are schedule order: per round all Z ancillas then
    all X ancillas, finally the data qubits)."""

    distance: int
    n_rounds: int
    n_data: int
    n_z: int
    n_x: int
    basis: str                  # "z" (|0>_L vs X errors) | "x" (|+>_L)
    sector_matrix: np.ndarray   # decoded sector's (nc, n_data) checks
    sector_support: np.ndarray  # (n_data,) decoded logical's support
    sector_diagonals: tuple     # per data qubit: None | (early, late)
                                # check rows by CNOT step order — the
                                # circuit-aware diagonal edges

    def sector_outcomes(self, outcomes: np.ndarray) -> np.ndarray:
        """(T, M) full record -> (T, R, nc) decoded-sector ancilla
        outcomes (Z ancillas come first in each round's block)."""
        per_round = self.n_z + self.n_x
        o = outcomes[:, :self.n_rounds * per_round]
        o = o.reshape(-1, self.n_rounds, per_round)
        return (o[:, :, :self.n_z] if self.basis == "z"
                else o[:, :, self.n_z:])

    def data_outcomes(self, outcomes: np.ndarray) -> np.ndarray:
        """(T, M) full record -> (T, n_data) final transversal readout
        (Z basis for the z memory, X basis for the x memory)."""
        start = self.n_rounds * (self.n_z + self.n_x)
        return outcomes[:, start:start + self.n_data]


def repetition_extraction_circuit(
        distance: int,
        n_rounds: int) -> tuple[QuantumCircuit, ExtractionLayout]:
    """R-round bit-flip repetition-chain extraction circuit.

    ``d`` data qubits in a line, one ancilla per adjacent pair; each
    round is two CNOT steps (check i reads data i then data i+1 —
    all-Z-type, so there is no commutation constraint) and an ancilla
    measurement column (no reset, same outcome-chain convention as the
    surface circuit).  The logical readout is data bit 0, matching
    ``qec_frame.build_ml_memory_fn``; only the z memory exists (the
    code has no X checks).  With the linear sampler this makes
    circuit-level bit-flip memories at d=25+ a single small matmul.
    """
    if n_rounds < 1:
        raise ValueError("need n_rounds >= 1")
    d = distance
    if d < 3 or d % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    nd, nz = d, d - 1
    anc = [nd + i for i in range(nz)]
    circ = QuantumCircuit(nd + nz)
    col = 0
    for _ in range(n_rounds):
        for step in range(2):
            for i, a in enumerate(anc):
                circ.add_gate(GateInstance("CNOT", [i + step, a], [],
                                           col))
            col += 1
        for a in anc:
            circ.add_gate(GateInstance("Measure", [a], [], col))
        col += 1
    for q in range(nd):
        circ.add_gate(GateInstance("Measure", [q], [], col))

    matrix = np.zeros((nz, nd), dtype=np.uint8)
    for i in range(nz):
        matrix[i, i] = matrix[i, i + 1] = 1
    support = np.zeros(nd, dtype=np.uint8)
    support[0] = 1
    # Interior data qubit q: check q reads it at step 0 (early), check
    # q-1 at step 1 (late) — the circuit-aware diagonal orientation.
    diagonals = [None] + [(q, q - 1) for q in range(1, nd - 1)] + [None]
    return circ, ExtractionLayout(
        distance=d, n_rounds=n_rounds, n_data=nd, n_z=nz, n_x=0,
        basis="z", sector_matrix=matrix, sector_support=support,
        sector_diagonals=tuple(diagonals))


def surface_extraction_circuit(
        distance: int, n_rounds: int,
        basis: str = "z") -> tuple[QuantumCircuit, ExtractionLayout]:
    """R-round rotated-surface-code syndrome-extraction circuit.

    Qubits: ``d^2`` data (index = row * d + col, the framework-wide
    qubit-0-is-MSB grid), then one ancilla per Z check, then one per X
    check.  Per round: H on X ancillas; four CNOT steps (data->ancilla
    for Z checks, ancilla->data for X checks); H on X ancillas; measure
    every ancilla (no reset — see module docstring).  After the last
    round every data qubit is measured (the perfect-readout layer; gate
    noise models measurement faults on the mid-circuit rounds, the
    final transversal readout is taken fault-free as in
    ``qec_frame.build_matching_memory_fn``).

    ``basis`` picks the memory experiment: ``"z"`` prepares ``|0...0>``
    (a ``+Z_L`` eigenstate, decode the Z sector against X errors);
    ``"x"`` prepares ``|+...+>`` via a transversal H column and reads
    the data out in the X basis (H before the final measures), decoding
    the X sector against Z errors — the same extraction rounds serve
    both, only the data-qubit boundary columns differ.
    """
    if n_rounds < 1:
        raise ValueError("need n_rounds >= 1")
    if basis not in ("z", "x"):
        raise ValueError(f"basis must be 'z' or 'x', got {basis!r}")
    d = distance
    z_checks, x_checks, z_logical, x_logical = \
        _rotated_surface_geometry(d)
    nd, nz, nx = d * d, len(z_checks), len(x_checks)
    z_anc = [nd + i for i in range(nz)]
    x_anc = [nd + nz + j for j in range(nx)]
    # Zigzag choice (see _check_schedule): X hooks end on the SW-SE row
    # (perpendicular to X_L = column 0), Z hooks end on the NE-SE
    # column (perpendicular to Z_L = row 0).  Measured: the swapped
    # assignment costs ~1.4x in d=5 logical rate at p=0.002.
    z_sched = _check_schedule(z_checks, d, (0, 2, 1, 3))   # "N" zigzag
    x_sched = _check_schedule(x_checks, d, (0, 1, 2, 3))   # "Z" zigzag

    circ = QuantumCircuit(nd + nz + nx)
    col = 0
    if basis == "x":                        # transversal |+...+> prep
        for q in range(nd):
            circ.add_gate(GateInstance("H", [q], [], col))
        col += 1
    for _ in range(n_rounds):
        for j, a in enumerate(x_anc):
            circ.add_gate(GateInstance("H", [a], [], col))
        col += 1
        for step in range(4):
            for i, a in enumerate(z_anc):
                if step in z_sched[i]:
                    circ.add_gate(GateInstance(
                        "CNOT", [z_sched[i][step], a], [], col))
            for j, a in enumerate(x_anc):
                if step in x_sched[j]:
                    circ.add_gate(GateInstance(
                        "CNOT", [a, x_sched[j][step]], [], col))
            col += 1
        for j, a in enumerate(x_anc):
            circ.add_gate(GateInstance("H", [a], [], col))
        col += 1
        for a in z_anc + x_anc:                         # Z first, X second
            circ.add_gate(GateInstance("Measure", [a], [], col))
        col += 1
    if basis == "x":                        # transversal X-basis readout
        for q in range(nd):                 # (the H column carries gate
            circ.add_gate(GateInstance("H", [q], [], col)) # noise: the
        col += 1                            # x memory's final layer is a
                                            # ~2p/3 noisy readout, unlike
                                            # the z memory's noise-free
                                            # one — see module docstring)
    for q in range(nd):
        circ.add_gate(GateInstance("Measure", [q], [], col))

    sec_checks = z_checks if basis == "z" else x_checks
    sec_sched = z_sched if basis == "z" else x_sched
    sec_logical = z_logical if basis == "z" else x_logical
    matrix = np.zeros((len(sec_checks), nd), dtype=np.uint8)
    for i, sup in enumerate(sec_checks):
        matrix[i, sup] = 1
    support = np.zeros(nd, dtype=np.uint8)
    support[sec_logical] = 1
    # Circuit-aware diagonals: qubit q's two sector checks read it at
    # different steps; a fault in the window between them is seen by
    # the later check this round and the earlier one next round.
    read_at: dict[int, list[tuple[int, int]]] = {}
    for i, sched in enumerate(sec_sched):
        for step, q in sched.items():
            read_at.setdefault(q, []).append((step, i))
    diagonals = []
    for q in range(nd):
        reads = sorted(read_at.get(q, []))
        if len(reads) == 2 and reads[0][0] != reads[1][0]:
            diagonals.append((reads[0][1], reads[1][1]))
        else:
            diagonals.append(None)
    return circ, ExtractionLayout(
        distance=d, n_rounds=n_rounds, n_data=nd, n_z=nz, n_x=nx,
        basis=basis, sector_matrix=matrix, sector_support=support,
        sector_diagonals=tuple(diagonals))


def detection_events(lay: ExtractionLayout,
                     outcomes: np.ndarray) -> np.ndarray:
    """Measurement record -> detection tensor ``det[T, R+1, nc]``:
    per-round sector syndromes recovered from the no-reset outcome
    chains (``s_r = o_r XOR o_{r-1}``), differenced between consecutive
    rounds and closed by the final transversal readout's syndrome."""
    R = lay.n_rounds
    T = outcomes.shape[0]
    o = lay.sector_outcomes(outcomes)                  # (T, R, nc)
    syn = o.copy()                                     # no-reset chain
    syn[:, 1:] = o[:, 1:] ^ o[:, :-1]
    data = lay.data_outcomes(outcomes)                 # (T, nd)
    final = (data @ lay.sector_matrix.T) % 2
    det = np.empty((T, R + 1, lay.sector_matrix.shape[0]), dtype=np.uint8)
    det[:, 0] = syn[:, 0]
    if R > 1:
        det[:, 1:R] = syn[:, 1:] ^ syn[:, :-1]
    det[:, R] = final ^ syn[:, R - 1]
    return det


def decode_memory_record(lay: ExtractionLayout,
                         outcomes: np.ndarray) -> tuple:
    """Measurement record -> ``(fail, raw, det)`` per trial.

    Recovers the decoded sector's per-round syndromes from the no-reset
    outcome chains (``s_r = o_r XOR o_{r-1}``), forms the R+1 detection
    layers (closed by the final transversal readout's syndrome), decodes
    with space-time union-find matching, and returns the corrected
    logical parity ``fail``, the uncorrected readout parity ``raw``, and
    the detection-event tensor ``det[T, R+1, nc]``.
    """
    R = lay.n_rounds
    T = outcomes.shape[0]
    det = detection_events(lay, outcomes)
    data = lay.data_outcomes(outcomes)                 # (T, nd)
    corr = space_time_decode_fn(
        lay.sector_matrix, R, diagonals=list(lay.sector_diagonals))(
        det.reshape(T, -1)).astype(np.uint8)
    raw = ((data @ lay.sector_support) % 2).astype(np.int32)
    fail = (raw ^ (corr @ lay.sector_support) % 2).astype(np.int32)
    return fail, raw, det


# ---------------------------------------------------------------------------
# Pauli-frame sampler (stim's trick: propagate only the error frame)
# ---------------------------------------------------------------------------

def _frame_branches():
    """Frame twins of ``clifford._build_branches`` — same opcode order,
    but the state is one (x, z) error-frame bit pair per qubit, O(1)
    per gate instead of the tableau's O(n) column updates.  Deterministic
    Paulis (the reference circuit's own X/Y/Z, incl. |1> preps) are
    frame identities; measurement reports the qubit's x bit (the flip
    of the recorded reference outcome) and clears its z bit (a phase on
    a collapsed computational state is physically gone — and must NOT
    survive into the next round's H, where it would become a phantom
    bit flip)."""
    import jax.numpy as jnp

    def _i(s, a, b, u, p):
        return s, jnp.int32(0)

    def _h(s, a, b, u, p):
        x, z = s
        xa, za = x[a], z[a]
        return (x.at[a].set(za), z.at[a].set(xa)), jnp.int32(0)

    def _s_(s, a, b, u, p):
        x, z = s
        return (x, z.at[a].set(z[a] ^ x[a])), jnp.int32(0)

    def _cnot(s, a, b, u, p):
        x, z = s
        return (x.at[b].set(x[b] ^ x[a]),
                z.at[a].set(z[a] ^ z[b])), jnp.int32(0)

    def _swap(s, a, b, u, p):
        x, z = s
        xa, xb = x[a], x[b]
        za, zb = z[a], z[b]
        return (x.at[a].set(xb).at[b].set(xa),
                z.at[a].set(zb).at[b].set(za)), jnp.int32(0)

    def _meas(s, a, b, u, p):
        x, z = s
        return (x, z.at[a].set(0)), x[a]

    def _nbf(s, a, b, u, p):
        x, z = s
        return (x.at[a].set(x[a] ^ (u < p)), z), jnp.int32(0)

    def _npf(s, a, b, u, p):
        x, z = s
        return (x, z.at[a].set(z[a] ^ (u < p))), jnp.int32(0)

    def _ndepol(s, a, b, u, p):
        # Same u mapping as clifford._ndepol: draws are bit-identical
        # under the same per-step uniforms (test-locked).
        x, z = s
        return (x.at[a].set(x[a] ^ (u < 2 * p / 3)),
                z.at[a].set(z[a] ^ ((u >= p / 3) & (u < p)))), jnp.int32(0)

    def _ndepol2(s, a, b, u, p):
        # Same pair-id mapping as clifford._ndepol2 (bit-identical).
        x, z = s
        fire = (u < p).astype(jnp.int32)
        pid = (1 + jnp.clip((u * 15 / p).astype(jnp.int32), 0, 14)) * fire
        ia, ja = pid >> 2, pid & 3
        x = x.at[a].set(x[a] ^ ((ia == 1) | (ia == 2)))
        z = z.at[a].set(z[a] ^ ((ia == 2) | (ia == 3)))
        x = x.at[b].set(x[b] ^ ((ja == 1) | (ja == 2)))
        z = z.at[b].set(z[b] ^ ((ja == 2) | (ja == 3)))
        return (x, z), jnp.int32(0)

    # opcode order: i, h, s, sdag, px, py, pz, cnot, swap, meas, bf, pf,
    # depol, depol2 — S and Sdag share a frame rule; Paulis are
    # identities.
    return [_i, _h, _s_, _s_, _i, _i, _i, _cnot, _swap, _meas,
            _nbf, _npf, _ndepol, _ndepol2]


def _frame_evolve_fn(n: int, codes, qa, qb, pp, ref_outcomes,
                     with_injection: bool = False):
    """jitted ``(key[, fault_step, fx, fz]) -> outcomes[M]`` — one noise
    trajectory through the Pauli-frame sampler: the recorded reference
    sample (one clean tableau run) XOR the frame's measurement flips.
    Per-step uniforms index positionally exactly like
    ``clifford._scan_evolve_fn``, so the same key draws the same noise
    Paulis in both engines.  ``with_injection`` adds a unit-fault input
    (XOR ``(fx, fz)`` onto step ``fault_step``'s target qubit after the
    step) — the signature probe the linear sampler is built from."""
    branches = _frame_branches()
    L = len(codes)
    measure_idx = np.nonzero(codes == _OP_MEASURE)[0]
    ref = jnp.asarray(ref_outcomes, jnp.int32)

    @jax.jit
    def evolve(key, fault_step=-1, fxa=0, fza=0, fxb=0, fzb=0):
        u = jax.random.uniform(key, (L,))

        def body(s, xs):
            idx, code, a, b, uu, p = xs
            s, out = jax.lax.switch(code, branches, s, a, b, uu, p)
            if with_injection:
                x, z = s
                hit = (idx == fault_step).astype(jnp.int32)
                x = x.at[a].set(x[a] ^ (hit & fxa))
                z = z.at[a].set(z[a] ^ (hit & fza))
                x = x.at[b].set(x[b] ^ (hit & fxb))
                z = z.at[b].set(z[b] ^ (hit & fzb))
                s = (x, z)
            return s, out

        s0 = (jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32))
        _, outs = jax.lax.scan(
            body, s0,
            (jnp.arange(L), jnp.asarray(codes), jnp.asarray(qa),
             jnp.asarray(qb), u, jnp.asarray(pp)))
        return ref ^ outs[jnp.asarray(measure_idx)]

    return evolve


_NOISE_CODES = (10, 11, 12, 13)    # bf, pf, depol, depol2 opcodes


_sig_cache: dict[tuple, object] = {}


def _linear_sampler_fn(codes, qa, qb, pp, ref_outcomes, n: int,
                       sig_key: tuple | None = None):
    """The Pauli-frame sampler LINEARIZED: frame propagation is GF(2)-
    linear, so every noise site's unit x-flip / z-flip has a fixed
    measurement-flip signature, probed ONCE through the injected frame
    scan (one vmapped launch over 2S unit faults).  Sampling then needs
    no circuit walk at all — draw the per-site Pauli bits and apply ONE
    (T, 2S) x (2S, M) matmul mod 2 (``Precision.HIGHEST``: counts stay
    < 2^24, exact in f32) — the matmul-shaped formulation of stim's frame
    simulator.  Draw-identical to the scan engines under the same keys:
    per-trajectory uniforms are generated positionally over all L steps
    and sliced to the noise sites.  Signatures depend only on circuit
    STRUCTURE (the probe runs at zeroed probabilities), so ``sig_key``
    caches them across noise rates — a p-sweep probes once."""
    L = len(codes)
    noise_idx = np.asarray([i for i, c in enumerate(codes)
                            if int(c) in _NOISE_CODES], np.int32)
    S = len(noise_idx)
    kinds = np.asarray([int(codes[i]) for i in noise_idx])
    probs = np.asarray([float(pp[i]) for i in noise_idx], np.float32)
    ref = jnp.asarray(ref_outcomes, jnp.int32)
    M = len(ref_outcomes)

    # Unit-fault signatures: zero all noise probabilities, inject one
    # frame bit per (site, component) — 4 components per site: (x, z)
    # on each of the step's two schedule targets (the b components of
    # 1-qubit sites never fire, their signatures are inert).
    sig_f = _sig_cache.get(sig_key) if sig_key is not None else None
    if sig_f is None:
        pp0 = np.zeros_like(np.asarray(pp))
        probe = _frame_evolve_fn(n, codes, qa, qb, pp0, ref_outcomes,
                                 with_injection=True)
        key0 = jax.random.PRNGKey(0)
        steps = jnp.asarray(np.repeat(noise_idx, 4))
        unit = np.tile(np.eye(4, dtype=np.int32), (S, 1))  # (4S, 4)
        sigs = jax.vmap(
            lambda st, v: probe(key0, st, v[0], v[1], v[2], v[3]) ^ ref)(
            steps, jnp.asarray(unit))          # (4S, M) 0/1
        sig_f = jnp.asarray(sigs, jnp.float32)
        if sig_key is not None:
            _sig_cache[sig_key] = sig_f

    kinds_j = jnp.asarray(kinds)
    probs_j = jnp.asarray(probs)
    noise_j = jnp.asarray(noise_idx)

    def one_bits(key):
        u = jax.random.uniform(key, (L,))[noise_j]
        p = probs_j
        fire2 = (kinds_j == 13) & (u < p)
        pid = jnp.where(
            fire2,
            1 + jnp.clip((u * 15 / jnp.where(p > 0, p, 1.0)
                          ).astype(jnp.int32), 0, 14), 0)
        ia, ja = pid >> 2, pid & 3
        xa = ((kinds_j == 10) & (u < p))             | ((kinds_j == 12) & (u < 2 * p / 3))             | (ia == 1) | (ia == 2)
        za = ((kinds_j == 11) & (u < p))             | ((kinds_j == 12) & (u >= p / 3) & (u < p))             | (ia == 2) | (ia == 3)
        xb = (ja == 1) | (ja == 2)
        zb = (ja == 2) | (ja == 3)
        return jnp.stack([xa, za, xb, zb], axis=1).reshape(4 * S)

    @jax.jit
    def run(keys):
        bits = jax.vmap(one_bits)(keys).astype(jnp.float32)   # (T, 4S)
        flips = jnp.matmul(bits, sig_f,
                           precision=jax.lax.Precision.HIGHEST)
        return (ref[None, :] ^ (flips.astype(jnp.int32) & 1))

    return run


_traj_cache: dict[tuple, tuple] = {}


def _extraction_circuit(code: str, distance: int, n_rounds: int,
                        basis: str):
    if code == "surface":
        return surface_extraction_circuit(distance, n_rounds, basis)
    if code == "repetition":
        if basis != "z":
            raise ValueError("repetition chains have no X checks; only "
                             "the z memory exists")
        return repetition_extraction_circuit(distance, n_rounds)
    raise ValueError(f"unknown code: {code!r}")


def _trajectory_fn(distance: int, n_rounds: int, noise_prob: float,
                   basis: str = "z", engine: str = "linear",
                   two_qubit_depol: bool = False,
                   code: str = "surface"):
    """Compiled ``keys[T] -> outcomes[T, M]`` for one (d, R, p) point,
    cached per structure (the scan program is identical across p only
    up to the embedded channel probability, so p is part of the key).

    Three engines, all draw-identical in detection events and readout
    parities under the same keys (test-locked): ``"clifford"`` runs the
    full O(n^2)-per-gate tableau; ``"frame"`` propagates only the Pauli
    error frame (O(1) per gate, a lax.scan circuit walk); ``"linear"``
    (default) exploits that frame propagation is GF(2)-LINEAR — unit
    fault signatures are probed once, then every trajectory batch is
    ONE matmul mod 2, no circuit walk at all."""
    key = (distance, n_rounds, float(noise_prob), basis, engine,
           two_qubit_depol, code)
    hit = _traj_cache.get(key)
    if hit is not None:
        return hit
    circ, lay = _extraction_circuit(code, distance, n_rounds, basis)
    nm = NoiseModel()
    if noise_prob > 0.0:
        if two_qubit_depol:
            # The literature's "standard depolarizing circuit noise":
            # correlated 15-Pauli depolarizing after every CNOT,
            # 1q depolarizing after every 1q gate.
            from .noise import TwoQubitDepolarizingNoise
            nm.add_gate_noise("CNOT",
                              TwoQubitDepolarizingNoise(noise_prob))
            nm.add_gate_noise("H", DepolarizingNoise(noise_prob))
        else:
            nm.add_global_noise(DepolarizingNoise(noise_prob))
    codes, qa, qb, pp, _ = _lower(
        circ, noise_model=nm if noise_prob > 0.0 else None,
        collapse_measures=True)
    if engine == "clifford":
        evolve = _scan_evolve_fn(circ.num_qubits, codes, qa, qb, pp)
        run = jax.jit(jax.vmap(lambda k: evolve(k)[1]))
    elif engine in ("frame", "linear"):
        c_codes, c_qa, c_qb, c_pp, _ = _lower(circ,
                                              collapse_measures=True)
        clean = _scan_evolve_fn(circ.num_qubits, c_codes, c_qa, c_qb,
                                c_pp)
        ref = np.asarray(clean(jax.random.PRNGKey(0))[1], np.int32)
        if engine == "frame":
            evolve = _frame_evolve_fn(circ.num_qubits, codes, qa, qb,
                                      pp, ref)
            run = jax.jit(jax.vmap(evolve))
        else:
            run = _linear_sampler_fn(
                codes, qa, qb, pp, ref, circ.num_qubits,
                sig_key=(distance, n_rounds, basis, two_qubit_depol,
                         code) if noise_prob > 0.0 else None)
    else:
        raise ValueError(f"unknown engine: {engine!r}")
    _traj_cache[key] = (run, lay)
    return run, lay


def circuit_level_memory(distance: int, n_rounds: int, noise_prob: float,
                         n_trials: int = 1000, seed: int = 0,
                         basis: str = "z",
                         decoder: str = "dem",
                         engine: str = "linear",
                         two_qubit_depol: bool = False,
                         code: str = "surface",
                         mesh=None) -> dict:
    """Memory experiment under circuit-level depolarizing noise.

    ``basis="z"`` prepares ``|0...0>`` (a ``+Z_L`` eigenstate), runs
    ``n_rounds`` of real extraction with depolarizing probability
    ``noise_prob`` after every gate on each touched qubit, then measures
    the data transversally.  The Z sector's detection events
    (consecutive-round syndrome differences, closed by the final
    readout's syndrome) are decoded by space-time union-find matching;
    failure is the corrected ``Z_L`` parity.  X-check extraction is
    fully simulated — its first-round outcomes are random (they project
    ``|0...0>`` into the codespace) and its CNOTs contribute fault
    locations — but only the Z sector is decoded, as only X-type
    residuals flip ``Z_L``.  ``basis="x"`` is the mirror experiment:
    ``|+...+>`` prep, X-sector decoding, ``X_L`` readout (its
    transversal H columns carry gate noise, so its prep and final
    readout are ~2p/3 noisy where the z memory's are noise-free —
    honest circuit modeling, not an artifact).

    ``decoder``: ``"dem"`` (default) matches on the circuit's own
    measured detector error model (``qec_dem.extract_dem`` — one cached
    fault-enumeration launch per (d, R, basis)) and predicts the
    logical directly from matched edges' flags; measured strictly
    better than ``"phenomenological"`` (the hand-built
    graph + schedule diagonals, zero precompute) at every sampled
    point — e.g. d=3 p=0.002: 0.0027 vs 0.0077, d=5 p=0.005: 0.0047
    vs 0.0120 (3k/1.5k trials, same draws).

    ``engine`` picks the sampler (see ``_trajectory_fn``): ``"linear"``
    (default, one matmul per batch), ``"frame"``, or
    ``"clifford"`` — all draw-identical in every decode-relevant
    statistic under the same seed.  ``two_qubit_depol`` switches to the
    literature's standard circuit noise: correlated 15-Pauli
    depolarizing(p) after every CNOT + 1q depolarizing(p) after every
    1q gate, instead of per-target 1q depolarizing everywhere.
    """
    run, lay = _trajectory_fn(distance, n_rounds, noise_prob, basis,
                              engine, two_qubit_depol, code)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
    if mesh is not None:
        # Trials are embarrassingly parallel: shard the keys over the
        # mesh's first axis and the sampler (vmapped scans or the
        # linear engine's bits+matmul) shards its whole batch with
        # them — zero collectives in the program.  Decoding is host
        # C-loop work either way.
        axis = mesh.axis_names[0]
        keys = jax.device_put(
            keys, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(axis)))
    outcomes = np.asarray(run(keys), dtype=np.uint8)
    if decoder == "phenomenological":
        fail, raw, det = decode_memory_record(lay, outcomes)
    elif decoder == "dem":
        # Measured detector error model: weighted matching on the
        # circuit's own fault signatures, logical prediction straight
        # from matched edges' flags (qec_dem).
        from .qec_dem import extract_dem
        dem = extract_dem(distance, n_rounds, basis,
                          two_qubit_depol=two_qubit_depol, code=code)
        det = detection_events(lay, outcomes)
        raw = ((lay.data_outcomes(outcomes) @ lay.sector_support) % 2
               ).astype(np.int32)
        pred = dem.decode(det.reshape(n_trials, -1), noise_prob)
        fail = raw ^ pred
    else:
        raise ValueError(f"unknown decoder: {decoder!r}")
    p_fail = float(fail.mean())
    R = n_rounds
    return {
        "logical_failure_probability": p_fail,
        "per_round_logical_rate":
            1.0 - (1.0 - min(p_fail, 1.0 - 1e-12)) ** (1.0 / R),
        "raw_failure_probability": float(raw.mean()),
        "detection_fraction": float(det.mean()),
        "n_rounds": R,
        "n_trials": n_trials,
        "distance": distance,
        "basis": basis,
        "code": code,
        "decoder": decoder,
        "noise_prob": float(noise_prob),
        "n_qubits": lay.n_data + lay.n_z + lay.n_x,
    }
