"""Validation harness: 9 groups, 33 assertions, exit code 0/1.

Port of the reference's acceptance harness semantics
(``/root/reference/test_validation.py``: Bell physics, norm preservation,
measurement sanity, readout-mode consistency, QEC basics, reference
invalidation, CPTP limits, performance bounds, scaling proofs) against the
accelerator-native engine. Run: ``python test_validation.py`` (add ``--cpu`` to
force the CPU backend).
"""

from __future__ import annotations

import sys
import time

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from quantum_sim.engine.analysis import ConvergenceAnalysis, StateAnalysis
from quantum_sim.engine.circuit import GateInstance, QuantumCircuit
from quantum_sim.engine.gate_registry import GateRegistry
from quantum_sim.engine.measurement import MeasurementBasis, MeasurementEngine
from quantum_sim.engine.noise import (
    AmplitudeDampingNoise,
    BitFlipNoise,
    DepolarizingNoise,
    NoiseModel,
    PhaseFlipNoise,
    ReadoutError,
)
from quantum_sim.engine.qec import BitFlipCode, QECSimulator
from quantum_sim.engine.reference import ReferenceManager
from quantum_sim.engine.simulator import Simulator
from quantum_sim.engine.state_vector import StateVector

PASS = 0
FAIL = 0


def _report(name: str, ok: bool, detail: str = ""):
    global PASS, FAIL
    status = "PASS" if ok else "FAIL"
    if ok:
        PASS += 1
    else:
        FAIL += 1
    print(f"  [{status}] {name}" + (f"  ({detail})" if detail else ""))


def bell_circuit():
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], column=0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
    return c


# --- Group 1: Bell-state physics (4 assertions) ----------------------------

def group_bell_physics():
    print("Group 1: Bell-state physics")
    state = Simulator().run(bell_circuit(), shots=0, seed=42).final_state
    amps = state.data
    inv = 1 / np.sqrt(2)
    _report("amplitudes 1/sqrt(2) at |00>,|11>",
            abs(amps[0] - inv) < 1e-5 and abs(amps[3] - inv) < 1e-5)
    _report("zero amplitudes at |01>,|10>",
            abs(amps[1]) < 1e-6 and abs(amps[2]) < 1e-6)
    mi = StateAnalysis.mutual_information(state, 0, 1)
    _report("I(0:1) = 2 bits", abs(mi - 2.0) < 1e-4, f"mi={mi:.6f}")
    s0 = StateAnalysis.entanglement_entropy(state, [0])
    _report("S(q0) = 1 bit", abs(s0 - 1.0) < 1e-4, f"S={s0:.6f}")


# --- Group 2: Norm preservation (3 assertions) ------------------------------

def group_norm_preservation():
    print("Group 2: Norm preservation")
    rng = np.random.default_rng(42)
    sv = StateVector(4)
    reg = GateRegistry.instance()
    for name in ["H", "X", "Y", "Z", "S", "T"]:
        sv.apply_gate(reg.get(name).matrix_func(), [int(rng.integers(4))])
    norm = sv.probabilities.sum()
    _report("norm = 1 after unitary gates", abs(norm - 1.0) < 1e-5)

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.2))
    nm.set_seed(42)
    state = Simulator(noise_model=nm).run(
        bell_circuit(), shots=0, seed=42).final_state
    norm = state.probabilities.sum()
    _report("norm = 1 after stochastic depolarizing noise",
            abs(norm - 1.0) < 1e-5)

    nm2 = NoiseModel()
    nm2.add_global_noise(AmplitudeDampingNoise(0.4))
    nm2.set_seed(7)
    state = Simulator(noise_model=nm2).run(
        bell_circuit(), shots=0, seed=7).final_state
    _report("norm = 1 after amplitude damping",
            abs(state.probabilities.sum() - 1.0) < 1e-5)


# --- Group 3: Measurement sanity (4 assertions) ------------------------------

def group_measurement():
    print("Group 3: Measurement sanity")
    state = Simulator().run(bell_circuit(), shots=0, seed=42).final_state
    rng = np.random.default_rng(42)
    for basis in (MeasurementBasis.Z, MeasurementBasis.X,
                  MeasurementBasis.Y):
        counts = MeasurementEngine.sample_with_basis(
            state, 10_000, basis=basis, rng=rng)
        _report(f"{basis.value}-basis: 10,000 shots sum correctly",
                sum(counts.values()) == 10_000)
    probs = state.probabilities
    _report("probabilities sum to 1", abs(probs.sum() - 1.0) < 1e-6)


# --- Group 4: Readout-error mode consistency (3 assertions) ------------------

def group_readout():
    print("Group 4: Readout-error mode consistency")
    ro = ReadoutError(p01=0.05, p10=0.05)
    c = ro.confusion_matrix
    _report("confusion-matrix columns sum to 1",
            np.allclose(c.sum(axis=0), 1.0))

    state = Simulator().run(bell_circuit(), shots=0, seed=42).final_state
    shots = 100_000
    c_shot = MeasurementEngine.sample_with_basis(
        state, shots, readout_error=ro, readout_mode="shot",
        rng=np.random.default_rng(1))
    c_dist = MeasurementEngine.sample_with_basis(
        state, shots, readout_error=ro, readout_mode="distribution",
        rng=np.random.default_rng(2))
    keys = set(c_shot) | set(c_dist)
    max_diff = max(abs(c_shot.get(k, 0) - c_dist.get(k, 0)) / shots
                   for k in keys)
    _report("shot vs distribution modes agree (< 0.02 @ 100k shots)",
            max_diff < 0.02, f"max_diff={max_diff:.4f}")

    probs = np.array([0.4, 0.3, 0.2, 0.1])
    got = ro.apply_to_distribution(probs, 2)
    full = np.kron(c, c) @ probs
    full /= full.sum()
    _report("2q distribution transform matches kron to 1e-12",
            np.max(np.abs(got - full)) < 1e-12)


# --- Group 5: QEC basics (3 assertions) --------------------------------------

def group_qec():
    print("Group 5: QEC")
    sim = QECSimulator(BitFlipCode())
    r = sim.run_cycle(0, "bit_flip", 0.0, seed=1)
    _report("bit-flip code noiseless fidelity = 1.0",
            abs(r.fidelity_after - 1.0) < 1e-4)
    _report("<Z_L> = +1 for |0>_L",
            abs(r.logical_z_expectation - 1.0) < 1e-4)
    r1 = sim.run_cycle(1, "bit_flip", 0.0, seed=1)
    _report("<Z_L> = -1 for |1>_L",
            abs(r1.logical_z_expectation + 1.0) < 1e-4)


# --- Group 6: Reference invalidation + layer API (4 assertions) ---------------

def group_reference():
    print("Group 6: Reference invalidation & layer API")
    mgr = ReferenceManager()
    circuit = bell_circuit()
    state = Simulator().run(circuit, shots=0).final_state
    mgr.store(state, circuit_hash=circuit.circuit_hash())
    _report("reference stored", mgr.has_reference)
    _report("same hash keeps reference",
            mgr.check_invalidation(circuit.circuit_hash()) is False)
    circuit.add_gate(GateInstance("X", [1], [], column=2))
    _report("changed hash invalidates reference",
            mgr.check_invalidation(circuit.circuit_hash()) is True
            and not mgr.has_reference)

    layers = circuit.compute_layers()
    g2l = circuit.gate_to_layer_map()
    consistent = all(gi in layers[g2l[gi]]
                     for gi in range(len(circuit.gates)))
    _report("compute_layers / gate_to_layer_map consistent", consistent)


# --- Group 7: Noise CPTP limits (4 assertions) --------------------------------

def group_cptp():
    print("Group 7: Noise CPTP limits")
    c = QuantumCircuit(1, initial_states=[1])
    c.add_gate(GateInstance("I", [0], [], column=0))

    nm0 = NoiseModel()
    nm0.add_global_noise(AmplitudeDampingNoise(0.0))
    nm0.set_seed(1)
    s = Simulator(noise_model=nm0).run(c, shots=0).final_state
    _report("amp-damp gamma=0 is identity",
            abs(s.probabilities[1] - 1.0) < 1e-5)

    nm1 = NoiseModel()
    nm1.add_global_noise(AmplitudeDampingNoise(1.0))
    nm1.set_seed(1)
    s = Simulator(noise_model=nm1).run(c, shots=0).final_state
    _report("amp-damp gamma=1 decays |1> to |0>",
            abs(s.probabilities[0] - 1.0) < 1e-5)

    nm3 = NoiseModel()
    nm3.add_global_noise(AmplitudeDampingNoise(0.3))
    nm3.set_seed(3)
    s = Simulator(noise_model=nm3).run(c, shots=0).final_state
    _report("amp-damp gamma=0.3 preserves norm",
            abs(s.probabilities.sum() - 1.0) < 1e-5)

    nmd = NoiseModel()
    nmd.add_global_noise(DepolarizingNoise(1.0))
    nmd.set_seed(5)
    s = Simulator(noise_model=nmd).run(bell_circuit(), shots=0).final_state
    _report("depolarizing p=1 preserves norm",
            abs(s.probabilities.sum() - 1.0) < 1e-5)


# --- Group 8: Performance regression (4 assertions) ----------------------------

def group_performance():
    print("Group 8: Performance regression")
    rng = np.random.default_rng(42)
    c = QuantumCircuit(10)
    for col in range(20):
        for q in range(10):
            c.add_gate(GateInstance("Ry", [q],
                                    [float(rng.uniform(0, np.pi))],
                                    column=col))
    sim = Simulator()
    sim.run(c, shots=0)  # warm the compile cache
    t0 = time.perf_counter()
    for _ in range(10):
        r = sim.run(c, shots=0)
    r.final_state.device_data.block_until_ready()
    per_run = (time.perf_counter() - t0) / 10
    _report("[perf] 10q depth-20 ideal run < 2 s (avg of 10)",
            per_run < 2.0, f"{per_run*1000:.1f} ms/run")

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nsim = Simulator(noise_model=nm)
    # warm with the SAME circuit structure and trial count: a different
    # vmap batch shape recompiles inside the timed region (the observed
    # 32/33 flake under concurrent load)
    nsim.ensemble_density_matrix(_ghz4(), n_trials=50, seed=0)
    t0 = time.perf_counter()
    rho = nsim.ensemble_density_matrix(_ghz4(), n_trials=50, seed=42)
    elapsed = time.perf_counter() - t0
    _report("[perf] 4q ensemble rho, 50 trials < 5 s", elapsed < 5.0,
            f"{elapsed:.2f} s")
    purity = float(np.real(np.trace(rho @ rho)))
    _report("ensemble purity < 1 under noise", purity < 0.9999,
            f"purity={purity:.4f}")
    _report("ensemble trace = 1", abs(np.trace(rho).real - 1.0) < 1e-3)


def _ghz4():
    c = QuantumCircuit(4)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, 4):
        c.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    return c


# --- Group 9: Scaling proof (4 assertions) --------------------------------------

def group_scaling():
    print("Group 9: Scaling proof")
    rng = np.random.default_rng(0)
    probs = rng.random(2**16)
    probs /= probs.sum()
    ro = ReadoutError(p01=0.02, p10=0.02)
    ro.apply_to_distribution(probs, 16)  # warm (compile outside the bound)
    t0 = time.perf_counter()
    out = ro.apply_to_distribution(probs, 16)
    elapsed = time.perf_counter() - t0
    _report("[perf] 16q distribution-transform readout < 1 s",
            elapsed < 1.0, f"{elapsed*1000:.1f} ms")
    _report("16q transform normalized", abs(out.sum() - 1.0) < 1e-9)

    probs2 = np.array([0.5, 0.25, 0.15, 0.1])
    got = ro.apply_to_distribution(probs2, 2)
    brute = np.kron(ro.confusion_matrix, ro.confusion_matrix) @ probs2
    brute /= brute.sum()
    _report("2q transform matches brute-force kron < 1e-12",
            np.max(np.abs(got - brute)) < 1e-12)

    # Beyond-reference scaling: a 20-qubit circuit runs (the reference
    # caps at 16 qubits).
    c = QuantumCircuit(20)
    for q in range(20):
        c.add_gate(GateInstance("H", [q], [], column=0))
    state = Simulator().run(c, shots=0).final_state
    import jax.numpy as jnp

    norm = float(jnp.sum(jnp.abs(state.device_data) ** 2))
    _report("20-qubit circuit runs with norm 1 (beyond reference cap)",
            abs(norm - 1.0) < 1e-4)


def main():
    groups = [
        group_bell_physics,
        group_norm_preservation,
        group_measurement,
        group_readout,
        group_qec,
        group_reference,
        group_cptp,
        group_performance,
        group_scaling,
    ]
    t0 = time.perf_counter()
    for g in groups:
        g()
    elapsed = time.perf_counter() - t0
    total = PASS + FAIL
    print(f"\n{PASS}/{total} assertions passed in {elapsed:.1f} s")
    sys.exit(0 if FAIL == 0 else 1)


if __name__ == "__main__":
    main()
