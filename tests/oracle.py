"""Plain NumPy references for cross-checking the engines.

Everything here is independent of ``quantum_simulator_tpu/ops``: gate
matrices are written out from their textbook definitions, states are
complex128 ``(2,) * n`` tensors updated one gate at a time with
``np.tensordot``, and qubit 0 is the MSB of the basis index, matching the
framework-wide convention (CLAUDE.md). ``chip_smoke.py`` imports this file
too, so the CPU tests and the on-card smoke run compare against the same
reference.
"""

import math

import numpy as np

PAULIS = {
    "I": np.eye(2),
    "X": np.array([[0, 1], [1, 0]]),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.diag([1.0, -1.0]),
}


def dense_hamiltonian(n, terms):
    """2^n x 2^n matrix for (coeff, pauli_string, qubits) term lists."""
    h = np.zeros((2 ** n, 2 ** n), complex)
    for c, pstr, qs in terms:
        full = ["I"] * n
        for q, p in zip(qs, pstr):
            full[q] = p
        op = np.eye(1)
        for ch in full:
            op = np.kron(op, PAULIS[ch])
        h += c * op
    return h


# ---------------------------------------------------------------------------
# Gate matrices (textbook definitions; first listed target = MSB)
# ---------------------------------------------------------------------------

_SQ2 = 1.0 / math.sqrt(2.0)
_FIXED = {
    "I": np.eye(2),
    "X": PAULIS["X"],
    "Y": PAULIS["Y"],
    "Z": PAULIS["Z"],
    "H": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]]),
    "S": np.diag([1, 1j]),
    "T": np.diag([1, np.exp(1j * math.pi / 4)]),
    "CNOT": np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, 0, 1], [0, 0, 1, 0]]),
    "CZ": np.diag([1, 1, 1, -1]),
    "SWAP": np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]]),
}


def gate_matrix(name, params=()):
    """complex128 unitary of a named gate. ``MCZ_<k>`` is the k-qubit
    multi-controlled Z (the Grover oracle/diffusion phase)."""
    if name in _FIXED:
        return np.asarray(_FIXED[name], dtype=np.complex128)
    if name == "Rx":
        c, s = math.cos(params[0] / 2), math.sin(params[0] / 2)
        return np.array([[c, -1j * s], [-1j * s, c]])
    if name == "Ry":
        c, s = math.cos(params[0] / 2), math.sin(params[0] / 2)
        return np.array([[c, -s], [s, c]], dtype=np.complex128)
    if name == "Rz":
        t = params[0]
        return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])
    if name == "CPhase":
        return np.diag([1, 1, 1, np.exp(1j * params[0])])
    if name.startswith("MCZ_"):
        d = np.ones(1 << int(name[4:]), dtype=np.complex128)
        d[-1] = -1
        return np.diag(d)
    raise KeyError(f"oracle has no matrix for gate {name!r}")


# ---------------------------------------------------------------------------
# Statevector reference
# ---------------------------------------------------------------------------

def basis_state(n, index=0):
    psi = np.zeros(1 << n, dtype=np.complex128)
    psi[index] = 1.0
    return psi


def apply_gate(psi, u, targets, n):
    """Apply the 2^k x 2^k unitary ``u`` to qubits ``targets`` of the flat
    2^n state ``psi`` (per-gate ``tensordot``; qubit 0 = MSB)."""
    k = len(targets)
    u = np.asarray(u, dtype=np.complex128)
    if k == 1:
        # Same contraction, without tensordot's transpose copies: view the
        # state as (high bits, target bit, low bits).
        v = psi.reshape(1 << targets[0], 2, -1)
        out = np.empty_like(v)
        np.multiply(u[0, 0], v[:, 0], out=out[:, 0])
        out[:, 0] += u[0, 1] * v[:, 1]
        np.multiply(u[1, 0], v[:, 0], out=out[:, 1])
        out[:, 1] += u[1, 1] * v[:, 1]
        return out.reshape(-1)
    t = psi.reshape((2,) * n)
    g = u.reshape((2,) * (2 * k))
    out = np.tensordot(g, t, axes=(list(range(k, 2 * k)), list(targets)))
    return np.moveaxis(out, list(range(k)), list(targets)).reshape(-1)


def initial_index(circuit):
    """Basis index of the circuit's ``initial_states`` (qubit 0 = MSB)."""
    idx = 0
    for bit in circuit.initial_states:
        idx = (idx << 1) | int(bit)
    return idx


def run_circuit(circuit):
    """Final complex128 state of a ``QuantumCircuit`` (gates column by
    column, Measure/Barrier skipped as in the reference's ``run``)."""
    n = circuit.num_qubits
    psi = basis_state(n, initial_index(circuit))
    for column in circuit.get_ordered_gates():
        for g in column:
            if g.gate_name in ("Measure", "Barrier"):
                continue
            name = g.gate_name
            if name.upper().startswith("MCZ"):
                name = f"MCZ_{len(g.target_qubits)}"
            psi = apply_gate(psi, gate_matrix(name, g.params),
                             g.target_qubits, n)
    return psi


# ---------------------------------------------------------------------------
# Circuits the checks share
# ---------------------------------------------------------------------------

def brickwork_circuit(n, depth, seed, complex_=False):
    """Brickwork: rotation columns alternating with CNOT brick columns —
    ``bench.py``'s circuit. With ``complex_`` every rotation column is an
    Ry column followed by an Rz column (a complex state)."""
    from quantum_simulator_tpu import GateInstance, QuantumCircuit

    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        if layer % 2 == 0:
            names = ("Ry", "Rz") if complex_ else ("Ry",)
            for name in names:
                for q in range(n):
                    c.add_gate(GateInstance(
                        name, [q], [float(rng.uniform(0, 2 * np.pi))],
                        column=col))
                col += 1
        else:
            for q in range((layer // 2) % 2, n - 1, 2):
                c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
            col += 1
    return c


def ghz_circuit(n, monitor=()):
    """GHZ ladder (H on 0, CNOT chain), then a Measure on each qubit in
    ``monitor`` in one trailing column."""
    from quantum_simulator_tpu import GateInstance, QuantumCircuit

    c = QuantumCircuit(n)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for q in range(n - 1):
        c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=q + 1))
    for q in monitor:
        c.add_gate(GateInstance("Measure", [q], [], column=n))
    return c


def qft_circuit(n, x):
    """The repo's QFT template applied to the basis input ``|x>``."""
    from quantum_simulator_tpu.algorithms import AlgorithmTemplate

    c = AlgorithmTemplate.quantum_fourier_transform(n)
    for q in range(n):
        c.set_qubit_initial_state(q, (x >> (n - 1 - q)) & 1)
    return c


# ---------------------------------------------------------------------------
# Analytic values
# ---------------------------------------------------------------------------

def qft_amplitudes(n, x, ks):
    """<k| QFT |x> = exp(2 pi i x k / 2^n) / sqrt(2^n) at indices ``ks``
    (exact phases: x*k is reduced mod 2^n in integers first)."""
    phase = np.array([(int(x) * int(k)) % (1 << n) for k in ks],
                     dtype=np.float64) / (1 << n)
    return np.exp(2j * np.pi * phase) / math.sqrt(1 << n)


def grover_amplitude(n, iterations):
    """|marked amplitude| after ``iterations`` exact Grover iterations
    from the uniform state: sin((2r + 1) asin(2^(-n/2)))."""
    return math.sin((2 * iterations + 1) * math.asin(2.0 ** (-n / 2)))


def fidelity(a, b):
    a = np.asarray(a, dtype=np.complex128).reshape(-1)
    b = np.asarray(b, dtype=np.complex128).reshape(-1)
    return float(abs(np.vdot(a, b)) ** 2
                 / (np.vdot(a, a).real * np.vdot(b, b).real))


def kraus_qubit_z(thetas, kraus):
    """<Z> of one qubit that starts in |0> and, for each angle, gets Ry(angle)
    followed by the channel with Kraus operators ``kraus`` (2x2 density
    matrix, complex128)."""
    rho = np.array([[1, 0], [0, 0]], dtype=np.complex128)
    for t in thetas:
        u = gate_matrix("Ry", (t,))
        rho = u @ rho @ u.conj().T
        rho = sum(k @ rho @ k.conj().T for k in kraus)
    return float((rho[0, 0] - rho[1, 1]).real)


# ---------------------------------------------------------------------------
# Sampling checks
# ---------------------------------------------------------------------------

def coarse_distribution(probs_or_counts, n, bits):
    """Marginal over the top ``bits`` qubits (qubit 0 = MSB) of a dense
    probability vector, or of a ``{bitstring: count}`` dict (normalized)."""
    if isinstance(probs_or_counts, dict):
        out = np.zeros(1 << bits)
        for s, c in probs_or_counts.items():
            out[int(s[:bits], 2)] += c
        return out / out.sum()
    p = np.asarray(probs_or_counts, dtype=np.float64).reshape(1 << bits, -1)
    return p.sum(axis=1)


def tvd(p, q):
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


def tvd_bound(p, shots, delta=1e-6):
    """Bound on the TVD between ``p`` and the empirical distribution of
    ``shots`` exact draws from it, exceeded with probability <= ``delta``:
    E[TVD] <= 1/2 sum sqrt(p(1-p)/N) (Jensen per bin), plus the McDiarmid
    deviation sqrt(ln(1/delta) / 2N) (one draw moves TVD by <= 1/N)."""
    p = np.asarray(p, dtype=np.float64)
    mean = 0.5 * float(np.sqrt(p * (1 - p) / shots).sum())
    return mean + math.sqrt(math.log(1 / delta) / (2 * shots))
