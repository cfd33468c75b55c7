"""Noise probability sweep: fidelity / entropy / purity vs noise rate.

CLI- and JSON-compatible with the reference script
(``/root/reference/scripts/noise_sweep.py``), rebuilt on this engine:
all trials at a sweep point run as ONE batched trajectory launch and the
mean fidelity is a single device reduction (the reference re-simulates the
circuit per trial in Python).

Usage:
    python scripts/noise_sweep.py --circuit bell --noise depolarizing --seed 42
    python scripts/noise_sweep.py --circuit ghz3 --noise bit_flip --output out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from quantum_sim.engine.analysis import StateAnalysis  # noqa: E402
from quantum_sim.engine.circuit import GateInstance, QuantumCircuit  # noqa: E402
from quantum_sim.engine.noise import (  # noqa: E402
    BitFlipNoise,
    DepolarizingNoise,
    NoiseModel,
    PhaseFlipNoise,
)
from quantum_sim.engine.simulator import Simulator  # noqa: E402


def _chain_circuit(num_qubits: int) -> QuantumCircuit:
    c = QuantumCircuit(num_qubits)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, num_qubits):
        c.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    return c


CIRCUITS = {
    "bell": lambda: _chain_circuit(2),
    "ghz3": lambda: _chain_circuit(3),
    "ghz4": lambda: _chain_circuit(4),
}

NOISE_TYPES = {
    "bit_flip": BitFlipNoise,
    "phase_flip": PhaseFlipNoise,
    "depolarizing": DepolarizingNoise,
}


def run_sweep(circuit: QuantumCircuit, noise_cls, probabilities: np.ndarray,
              n_trials: int, seed: int) -> list[dict]:
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    ideal = Simulator().run(circuit, shots=0, seed=seed).final_state
    ideal_dev = ideal.device_data

    results = []
    for p in probabilities:
        trial_seed = int(rng.integers(0, 2**63))
        nm = NoiseModel()
        nm.add_global_noise(noise_cls(float(p)))
        sim = Simulator(noise_model=nm)
        # All trials in one batched device launch.
        states = sim.trajectory_states(circuit, n_trials, seed=trial_seed)
        overlaps = jnp.einsum("d,td->t", jnp.conj(ideal_dev), states)
        fids = np.asarray(jnp.abs(overlaps) ** 2, dtype=np.float64)
        norms = np.asarray(jnp.sum(jnp.abs(states) ** 2, axis=1),
                           dtype=np.float64)
        # Trajectories are pure states: S(|psi><psi|) = 0, purity = norm^2.
        results.append({
            "noise_prob": float(p),
            "mean_fidelity": float(fids.mean()),
            "mean_entropy": 0.0,
            "mean_purity": float((norms**2).mean()),
        })

    return results


def main():
    parser = argparse.ArgumentParser(
        description="Noise probability sweep experiment")
    parser.add_argument("--circuit", choices=list(CIRCUITS), default="bell")
    parser.add_argument("--noise", choices=list(NOISE_TYPES),
                        default="depolarizing")
    parser.add_argument("--min-p", type=float, default=0.0)
    parser.add_argument("--max-p", type=float, default=0.3)
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--trials", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args()

    circuit = CIRCUITS[args.circuit]()
    noise_cls = NOISE_TYPES[args.noise]
    probs = np.linspace(args.min_p, args.max_p, args.steps)

    print(f"Running noise sweep: circuit={args.circuit}, noise={args.noise}, "
          f"p=[{args.min_p:.3f}, {args.max_p:.3f}], "
          f"steps={args.steps}, trials={args.trials}, seed={args.seed}")

    results = run_sweep(circuit, noise_cls, probs, args.trials, args.seed)

    output = {
        "experiment": "noise_sweep",
        "circuit": args.circuit,
        "noise_type": args.noise,
        "n_trials": args.trials,
        "seed": args.seed,
        "results": results,
    }

    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
        print(f"Results saved to {args.output}")
    else:
        print(json.dumps(output, indent=2))


if __name__ == "__main__":
    main()
