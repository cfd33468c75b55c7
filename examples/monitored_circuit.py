"""Measurement-induced entanglement transition on the Clifford engine.

Random Clifford brickwork interleaved with rate-p mid-circuit
measurements is the canonical monitored-circuit model: below a critical
measurement rate the steady-state half-cut entanglement entropy grows
with system size (volume law); above it, measurements pin the state
near a product state (area law).  Studying this requires (a) mid-circuit
collapse, (b) exact entanglement entropy, (c) widths far beyond
amplitude simulation — all three live in ``clifford.py``
(tableau evolution + branchless ``_measure_z`` + GF(2)-rank entropy).

The reference simulator cannot express any part of this (measurements
are end-of-circuit sampling markers and n caps at 16).

Run:  python examples/monitored_circuit.py [--qubits 32] [--depth 32]
          [--trajectories 8] [--rates 0.05,0.15,0.3,0.6]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quantum_simulator_tpu import (  # noqa: E402
    CliffordSimulator, GateInstance, QuantumCircuit,
)


def monitored_brickwork(n: int, depth: int, p_meas: float,
                        rng: np.random.Generator) -> QuantumCircuit:
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add_gate(GateInstance(
                str(rng.choice(["H", "S", "S_DAG", "X", "Z"])), [q], [],
                column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
        for q in range(n):
            if rng.random() < p_meas:
                c.add_gate(GateInstance("Measure", [q], [], column=col))
        col += 1
    return c


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qubits", type=int, default=32)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--trajectories", type=int, default=8)
    ap.add_argument("--rates", type=str, default="0.05,0.15,0.3,0.6")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rates = [float(r) for r in args.rates.split(",")]
    n = args.qubits
    rng = np.random.default_rng(args.seed)
    sim = CliffordSimulator()

    print(f"monitored brickwork: n={n}, depth={args.depth}, "
          f"{args.trajectories} trajectories/rate")
    half = list(range(n // 2))
    for p in rates:
        c = monitored_brickwork(n, args.depth, p, rng)
        n_meas = sum(1 for g in c.gates if g.gate_name == "Measure")
        t0 = time.perf_counter()
        _, _, tabs = sim.monitored_trajectories(
            c, args.trajectories, seed=args.seed)
        entropies = [CliffordSimulator.entanglement_entropy(tab, half)
                     for tab in tabs]
        dt = time.perf_counter() - t0
        print(f"  p={p:4.2f}: S(half-cut) = {np.mean(entropies):5.2f} "
              f"+- {np.std(entropies):4.2f} bits   "
              f"({n_meas} measurements, {dt:.1f}s)")
    print("volume-law entropy at low p collapsing toward area law at "
          "high p = the measurement-induced transition")


if __name__ == "__main__":
    main()
