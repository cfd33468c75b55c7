"""VQE optimization benchmark: hardware-efficient ansatz + Adam.

CLI- and JSON-compatible with ``/root/reference/scripts/vqe_benchmark.py``,
rebuilt on this engine. Adds ``--grad`` to select the gradient method;
the default "autodiff" differentiates straight through the compiled
circuit (the reference can only re-simulate 2P shifted circuits per step).

Usage:
    python scripts/vqe_benchmark.py --qubits 4 --layers 3 --hamiltonian zz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from quantum_sim.engine.circuit import GateInstance, QuantumCircuit  # noqa: E402
from quantum_sim.engine.optimizer import (  # noqa: E402
    CircuitOptimizer,
    CostFunction,
    ParameterizedCircuitConfig,
)


def _build_ansatz(n_qubits: int, n_layers: int) -> QuantumCircuit:
    """Hardware-efficient ansatz: Ry layers + CNOT chains + final Ry."""
    c = QuantumCircuit(n_qubits)
    col = 0
    for _ in range(n_layers):
        for q in range(n_qubits):
            c.add_gate(GateInstance("Ry", [q], [0.0], column=col))
        col += 1
        for q in range(n_qubits - 1):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    for q in range(n_qubits):
        c.add_gate(GateInstance("Ry", [q], [0.0], column=col))
    return c


HAMILTONIANS = {
    "z0": lambda n: CostFunction.z_expectation(0),
    "zz": lambda n: CostFunction.vqe_hamiltonian(
        [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]),
    "heisenberg": lambda n: CostFunction.vqe_hamiltonian(
        [(-1.0, "XX", [i, i + 1]) for i in range(n - 1)]
        + [(-1.0, "YY", [i, i + 1]) for i in range(n - 1)]
        + [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]),
}


def run_benchmark(n_qubits: int, n_layers: int, hamiltonian_name: str,
                  lr: float, max_iters: int, seed: int,
                  grad_method: str = "autodiff", n_starts: int = 1,
                  engine: str = "statevector", chi: int = 32) -> dict:
    circuit = _build_ansatz(n_qubits, n_layers)
    config = ParameterizedCircuitConfig.auto_detect(circuit)
    cost_fn = HAMILTONIANS[hamiltonian_name](n_qubits)

    rng = np.random.default_rng(seed)
    init_vals = rng.uniform(-np.pi, np.pi, size=config.num_params)
    for i, b in enumerate(config.bindings):
        circuit.gates[b.gate_index].params[b.param_index] = float(
            init_vals[i])
    if engine == "mps":
        # Variational optimization on the MPS engine: cost batches are
        # bond-dimension-chi tensor contractions, so the ansatz width is
        # limited by entanglement, not by 2^n (reference cap: 16 qubits,
        # circuit.py:130). Reverse-mode is unsafe through truncated
        # SVDs, so gradients use the parameter-shift rule.
        from quantum_simulator_tpu.optimizer import MPSParameterizedConfig
        if n_starts > 1:
            raise SystemExit("--starts > 1 needs autodiff; "
                             "--engine mps uses parameter_shift")
        if grad_method == "autodiff":
            grad_method = "parameter_shift"
        config = MPSParameterizedConfig.auto_detect(circuit, chi=chi)
    else:
        config = ParameterizedCircuitConfig.auto_detect(circuit)

    if n_starts > 1:
        # Batched multi-start: every start's full Adam loop runs in one
        # vmapped device launch. Start 0 uses the same initialization as
        # the single-start path; the JSON keeps its shape, plus the
        # per-start summary.
        inits = np.vstack(
            [init_vals[None, :],
             rng.uniform(-np.pi, np.pi,
                         size=(n_starts - 1, config.num_params))])
        t0 = time.perf_counter()
        ms = CircuitOptimizer.multi_start(
            config, cost_fn, n_starts=n_starts, max_iterations=max_iters,
            learning_rate=lr, init_values=inits)
        elapsed = time.perf_counter() - t0
        cost_trace = [float(c) for c in ms.cost_histories[ms.best_start]]
        return {
            "n_qubits": n_qubits,
            "n_layers": n_layers,
            "n_params": config.num_params,
            "hamiltonian": hamiltonian_name,
            "learning_rate": lr,
            "max_iterations": max_iters,
            "actual_iterations": ms.iterations,
            "converged": False,
            "optimal_cost": float(ms.optimal_cost),
            "initial_cost": cost_trace[0] if cost_trace else None,
            "cost_improvement": ((cost_trace[0] - ms.optimal_cost)
                                 if cost_trace else 0),
            "elapsed_seconds": round(elapsed, 3),
            "gradient_method": "autodiff",
            "cost_trace": cost_trace,
            "n_starts": n_starts,
            "best_start": ms.best_start,
            "start_costs": [float(c) for c in ms.start_costs],
        }

    optimizer = CircuitOptimizer(
        config=config,
        cost_fn=cost_fn,
        learning_rate=lr,
        max_iterations=max_iters,
        gradient_method=grad_method,
    )

    t0 = time.perf_counter()
    result = optimizer.run(seed=seed)
    elapsed = time.perf_counter() - t0

    cost_trace = [float(h[1]) for h in result.history]
    return {
        "n_qubits": n_qubits,
        "n_layers": n_layers,
        "n_params": config.num_params,
        "hamiltonian": hamiltonian_name,
        "learning_rate": lr,
        "max_iterations": max_iters,
        "actual_iterations": result.iterations,
        "converged": result.converged,
        "optimal_cost": float(result.optimal_cost),
        "initial_cost": cost_trace[0] if cost_trace else None,
        "cost_improvement": ((cost_trace[0] - result.optimal_cost)
                             if cost_trace else 0),
        "elapsed_seconds": round(elapsed, 3),
        "gradient_method": grad_method,
        "cost_trace": cost_trace,
        "engine": engine,
        **({"chi": chi} if engine == "mps" else {}),
    }


def main():
    parser = argparse.ArgumentParser(description="VQE optimization benchmark")
    parser.add_argument("--qubits", type=int, default=2)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--hamiltonian", choices=list(HAMILTONIANS),
                        default="z0")
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--grad", choices=["autodiff", "parameter_shift",
                                           "finite_difference"],
                        default="autodiff")
    parser.add_argument(
        "--starts", type=int, default=1,
        help="multi-start: N full Adam loops in one vmapped device "
             "launch (forces autodiff; start 0 = the --seed init)")
    parser.add_argument(
        "--engine", choices=["statevector", "mps"], default="statevector",
        help="mps: evaluate costs as bond-dimension-chi MPS contractions "
             "(VQE at 40+ qubits; parameter-shift gradients)")
    parser.add_argument("--chi", type=int, default=32,
                        help="MPS bond dimension (with --engine mps)")
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args()

    print(f"Running VQE benchmark: qubits={args.qubits}, "
          f"layers={args.layers}, H={args.hamiltonian}, lr={args.lr}, "
          f"iters={args.iters}, seed={args.seed}, grad={args.grad}, "
          f"engine={args.engine}")

    result = run_benchmark(args.qubits, args.layers, args.hamiltonian,
                           args.lr, args.iters, args.seed, args.grad,
                           n_starts=args.starts, engine=args.engine,
                           chi=args.chi)

    output = {
        "experiment": "vqe_benchmark",
        "seed": args.seed,
        "result": result,
    }

    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
        print(f"Results saved to {args.output}")
    else:
        print(json.dumps(output, indent=2))


if __name__ == "__main__":
    main()
