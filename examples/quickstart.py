"""End-to-end tour of the framework (runs headless on CPU or GPU).

    python examples/quickstart.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from quantum_simulator_tpu import (
        DepolarizingNoise,
        GateInstance,
        NoiseModel,
        QuantumCircuit,
        ReadoutError,
        Simulator,
    )
    from quantum_simulator_tpu.analysis import StateAnalysis
    from quantum_simulator_tpu.debugger import CircuitDebugger
    from quantum_simulator_tpu.models import (
        hardware_efficient_ansatz,
        zz_chain,
    )
    from quantum_simulator_tpu.optimizer import (
        CircuitOptimizer,
        CostFunction,
        ParameterizedCircuitConfig,
    )
    from quantum_simulator_tpu.qec import QECSimulator, SteaneCode
    from quantum_simulator_tpu.render import CircuitExporter

    # --- 1. Build and run a GHZ circuit --------------------------------
    ghz = QuantumCircuit(4)
    ghz.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, 4):
        ghz.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    result = Simulator().run(ghz, shots=1000, seed=42)
    print("GHZ-4 counts:", result.measurement_counts)

    # --- 2. Analysis -----------------------------------------------------
    state = result.final_state
    print(f"bipartite entropy: "
          f"{StateAnalysis.entanglement_entropy(state, [0, 1]):.3f} bits, "
          f"I(q0:q3) = {StateAnalysis.mutual_information(state, 0, 3):.3f}")

    # --- 3. Noisy Monte-Carlo (one batched device launch) ----------------
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.03))
    nm.set_readout_error(ReadoutError(p01=0.01, p10=0.02))
    noisy = Simulator(noise_model=nm).run_with_noise(ghz, shots=5000,
                                                     seed=7)
    top = sorted(noisy.measurement_counts.items(), key=lambda kv: -kv[1])[:4]
    print("noisy top counts:", dict(top))

    # --- 4. Debug where the noise bites ---------------------------------
    attribution = CircuitDebugger().compute_noise_attribution(
        ghz, nm, n_trials=50, seed=42)
    worst = int(np.argmax(attribution.column_attribution_pct))
    print(f"noisiest column: {worst} "
          f"({attribution.column_attribution_pct[worst]:.0f}% of loss, "
          f"gates {attribution.gate_labels[worst]})")

    # --- 5. VQE with autodiff gradients ----------------------------------
    ansatz = hardware_efficient_ansatz(4, 2)
    config = ParameterizedCircuitConfig.auto_detect(ansatz)
    cost = CostFunction.vqe_hamiltonian(zz_chain(4))
    opt = CircuitOptimizer(config, cost, learning_rate=0.2,
                           max_iterations=60, gradient_method="autodiff")
    vqe = opt.run(seed=42)
    print(f"VQE energy: {vqe.optimal_cost:.4f} "
          f"({vqe.iterations} iterations, {config.num_params} params)")

    # --- 6. QEC: Steane code corrects a noisy cycle ----------------------
    qec = QECSimulator(SteaneCode())
    cycle = qec.run_cycle(0, "depolarizing", 0.05, seed=3)
    print(f"Steane cycle: syndrome={cycle.syndrome} "
          f"corrections={cycle.correction_applied} "
          f"F: {cycle.fidelity_before:.3f} -> {cycle.fidelity_after:.3f}")

    # --- 7. Export the circuit diagram ------------------------------------
    out = os.path.join(os.path.dirname(__file__), "ghz4.png")
    CircuitExporter.export_png(ghz, out)
    print("circuit diagram written to", out)

    # --- 7b. Exact density matrix (deterministic channel evolution) -------
    from quantum_simulator_tpu import DensityMatrixSimulator

    dm = DensityMatrixSimulator(noise_model=nm).run(ghz)
    print(f"exact noisy rho: trace={dm.trace():.6f} "
          f"purity={dm.purity():.4f} (no Monte-Carlo error)")

    # --- 8. Mesh-sharded run + sharded VQE step ----------------------------
    # (on a multi-chip slice this shards the amplitude vector over ICI; on
    # a single chip it degrades to a 1-device mesh)
    import jax

    if len(jax.devices()) >= 2:
        from quantum_simulator_tpu.parallel import (
            DistributedSimulator, make_vqe_mesh, sharded_vqe_step)

        dsim = DistributedSimulator(n_devices=2)
        dstate = dsim.run(ghz)
        print("sharded GHZ counts:", dsim.sample(dstate, 200))
        vqe_mesh = make_vqe_mesh(2)
        mesh_ansatz = hardware_efficient_ansatz(4, 2, initial_angle=0.7)
        step = sharded_vqe_step(mesh_ansatz, vqe_mesh)
        _, costs = step.run(8)
        print(f"sharded VQE <Z0>: {costs[0]:.4f} -> {costs[-1]:.4f}")

    # --- 9. Beyond amplitudes: the bit-algebra engines ---------------------
    # Clifford circuits at hundreds of qubits (stabilizer tableau):
    from quantum_simulator_tpu import CliffordSimulator, GateInstance

    wide = QuantumCircuit(128)
    wide.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(127):
        wide.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    counts, tab = CliffordSimulator().run(wide, shots=100, seed=0)
    print("GHZ-128 support:", sorted(k[:4] + "..." for k in counts),
          "| half-cut entropy:",
          CliffordSimulator.entanglement_entropy(tab, list(range(64))),
          "bit")

    # Arbitrary (non-Clifford) gates at 100 qubits while entanglement
    # fits the bond dimension: the MPS engine, with an honest ledger of
    # what truncation discarded (0.0 == exact).
    from quantum_simulator_tpu import MPSSimulator
    from quantum_simulator_tpu import mps as mps_mod

    twist = QuantumCircuit(100)
    twist.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(99):
        twist.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    twist.add_gate(GateInstance("Rz", [50], [0.7], column=100))  # non-Clifford
    counts, state = MPSSimulator(chi=8).run(twist, shots=200, seed=0)
    print("twisted GHZ-100 support:", sorted(k[:4] + "..." for k in counts),
          "| truncated weight:", state.truncation_weight,
          "| <X^100>:", round(mps_mod.expectation_pauli_string(
              state, "X" * 100), 4))

    # Ground-state physics past the 2^n wall: two-site DMRG on the same
    # Hamiltonian term lists VQE optimizes, plus the first excited
    # state via penalty-orthogonalized sweeps.
    from quantum_simulator_tpu.dmrg import dmrg_excited_states
    from quantum_simulator_tpu.models.hamiltonians import tfim_chain

    # h > |j|: paramagnetic phase, where the gap is visibly open (in the
    # ordered phase it is an exponentially small tunneling splitting).
    spectrum = dmrg_excited_states(tfim_chain(24, j=-1.0, h=-1.3), 24,
                                   n_states=2, chi=8, sweeps=3)
    print(f"TFIM-24 via DMRG: E0 = {spectrum[0].energy:.4f}, "
          f"gap = {spectrum[1].energy - spectrum[0].energy:.4f} "
          f"(orthogonality |<0|1>| = "
          f"{abs(mps_mod.overlap(spectrum[0].state, spectrum[1].state)):.1e})")

    # QEC threshold sweeps with no 2^n state (Pauli-frame engine):
    from quantum_simulator_tpu.qec_frame import (
        FrameQECSimulator, repetition_frame_spec)

    res = FrameQECSimulator.ml_memory_experiment(
        distance=9, noise_prob=0.03, n_rounds=10, n_trials=2048,
        meas_error_prob=0.03, seed=1)
    print(f"d=9 memory, 10 rounds, p=q=0.03: exact-ML logical failure "
          f"{res['ml_failure_probability']:.4f} vs single-shot "
          f"{res['final_syndrome_failure_probability']:.4f}")


if __name__ == "__main__":
    main()
