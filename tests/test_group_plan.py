"""Group-matmul plan executor vs the per-gate einsum path."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.ops.plan import (
    AxisMatmulStep,
    BitPairStep,
    CrossStep,
    GenericStep,
    GroupLayout,
    build_group_plan,
    group_forward_fn,
)


def both(circuit, atol=1e-5):
    p = prog.compile_circuit(circuit)
    params = jnp.asarray(p.initial_params)
    got = np.asarray(group_forward_fn(p)(params))
    expected = np.asarray(
        jnp.asarray(prog._forward_body(p, params, None))
        if False else prog.forward_fn(p)(params))
    np.testing.assert_allclose(got, expected, atol=atol)
    return got


class TestGroupLayout:
    def test_axis_partition(self):
        lay = GroupLayout.for_qubits(16)
        assert lay.axis_bits == (2, 7, 7)
        assert lay.axis_sizes == (4, 128, 128)
        assert lay.axis_of(0) == 0 and lay.axis_of(1) == 0
        assert lay.axis_of(2) == 1 and lay.axis_of(8) == 1
        assert lay.axis_of(9) == 2 and lay.axis_of(15) == 2
        # MSB-first position within axis
        assert lay.pos_in_axis(0) == 0
        assert lay.pos_in_axis(2) == 0
        assert lay.pos_in_axis(8) == 6
        assert lay.pos_in_axis(15) == 6

    def test_small_circuit_single_axis(self):
        lay = GroupLayout.for_qubits(5)
        assert lay.axis_bits == (5,)


class TestCorrectness:
    def test_brickwork_various_sizes(self):
        for n in (8, 10, 12, 16):
            both(brickwork_circuit(n, 6, seed=7))

    def test_cross_group_cnot(self):
        c = QuantumCircuit(10)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 9], [], column=1))
        got = both(c)
        probs = np.abs(got) ** 2
        assert probs[0] == pytest.approx(0.5, abs=1e-5)
        assert probs[(1 << 9) | 1] == pytest.approx(0.5, abs=1e-5)

    def test_cross_group_toffoli_two_plus_one(self):
        c = QuantumCircuit(10, initial_states=[1, 1] + [0] * 8)
        c.add_gate(GateInstance("Toffoli", [0, 1, 7], [], column=0))
        both(c)

    def test_three_group_gate_falls_back(self):
        c = QuantumCircuit(16, initial_states=[1] + [0] * 15)
        c.add_gate(GateInstance("X", [4], [], column=0))
        c.add_gate(GateInstance("Toffoli", [0, 4, 12], [], column=1))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert any(isinstance(s, GenericStep) for s in plan.steps)
        both(c)

    def test_composition_reduces_steps(self):
        """A column of rotations on one group = ONE matmul step."""
        c = QuantumCircuit(8)
        for q in range(1, 8):
            c.add_gate(GateInstance("Ry", [q], [0.1 * q], column=0))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        matmuls = [s for s in plan.steps if isinstance(s, AxisMatmulStep)]
        assert len(matmuls) <= 2  # one per touched axis
        both(c)

    def test_cross_steps_built(self):
        # A bare straddling 2q gate (nothing pending to fold) lowers to
        # the bandwidth-only BitPairStep, not a cross matmul.
        c = QuantumCircuit(10)
        c.add_gate(GateInstance("CNOT", [1, 8], [], column=0))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert any(isinstance(s, BitPairStep) for s in plan.steps)
        assert not any(isinstance(s, CrossStep) for s in plan.steps)
        # With a conflicting pending on the op axis, the gate folds the
        # pending into an embedded CrossStep (one pass instead of two).
        c2 = QuantumCircuit(10)
        c2.add_gate(GateInstance("Ry", [1], [0.3], column=0))
        c2.add_gate(GateInstance("CNOT", [1, 8], [], column=1))
        p2 = prog.compile_circuit(c2)
        plan2 = build_group_plan(p2)
        assert any(isinstance(s, CrossStep) for s in plan2.steps)

    def test_parameterized_no_recompile(self):
        c = QuantumCircuit(9)
        c.add_gate(GateInstance("Ry", [0], [0.4], column=0))
        c.add_gate(GateInstance("CNOT", [0, 8], [], column=1))
        p = prog.compile_circuit(c)
        fn = group_forward_fn(p)
        out1 = np.asarray(fn(jnp.asarray([0.4], jnp.float32)))
        out2 = np.asarray(fn(jnp.asarray([1.3], jnp.float32)))
        assert not np.allclose(out1, out2)


class TestGroupTrajectories:
    def test_matches_einsum_body_same_key(self):
        import jax
        from quantum_simulator_tpu.noise import (
            AmplitudeDampingNoise,
            DepolarizingNoise,
            NoiseModel,
        )
        from quantum_simulator_tpu.ops.plan import group_trajectory_body
        from quantum_simulator_tpu.ops.program import _trajectory_body

        c = QuantumCircuit(9)
        c.add_gate(GateInstance("H", [0], [], column=0))
        for i in range(1, 9):
            c.add_gate(GateInstance("CNOT", [0, i], [], column=i))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        nm.add_global_noise(AmplitudeDampingNoise(0.05))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(3)
        got = np.asarray(group_trajectory_body(p, nm, params, key))
        expected = np.asarray(_trajectory_body(
            p, nm.kraus_stacks_for_gate, params, key, jnp.complex64,
            False))
        np.testing.assert_allclose(got, expected, atol=1e-6)
        assert np.sum(np.abs(got) ** 2) == pytest.approx(1.0, abs=1e-5)

    def test_record_columns_shapes(self):
        import jax
        from quantum_simulator_tpu.noise import DepolarizingNoise, NoiseModel
        from quantum_simulator_tpu.ops.plan import group_trajectory_body

        c = brickwork_circuit(8, 4, seed=1)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.05))
        p = prog.compile_circuit(c)
        steps = group_trajectory_body(p, nm, jnp.asarray(p.initial_params),
                                      jax.random.PRNGKey(0),
                                      record_columns=True)
        assert steps.shape == (5, 2**8)


def test_group_evolve_body_matches_einsum_evolve():
    """The group-path evolve (provided initial state) must match the
    per-gate evolve body — this is the GPU route of program.evolve_fn."""
    import jax

    from quantum_simulator_tpu.ops.apply import apply_gate
    from quantum_simulator_tpu.ops.plan import group_evolve_body

    c = brickwork_circuit(10, 4, seed=9)
    p = prog.compile_circuit(c)
    params = jnp.asarray(p.initial_params)
    # arbitrary (non-basis) starting state
    rng = np.random.default_rng(1)
    raw = rng.normal(size=2**10) + 1j * rng.normal(size=2**10)
    raw /= np.linalg.norm(raw)
    state = jnp.asarray(raw, jnp.complex64)

    got = np.asarray(jax.jit(
        lambda s, pp: group_evolve_body(p, s, pp, jnp.complex64))(
            state, params))

    expected = state
    for op in p.ops:
        expected = apply_gate(expected, p.op_matrix(op, params,
                                                    jnp.complex64),
                              op.targets, 10)
    np.testing.assert_allclose(got, np.asarray(expected), atol=2e-5)


class TestDiagProduct:
    """Controlled-phase-form diagonals spanning >= 3 axes apply as one
    fused broadcast pass (DiagProductStep), never GenericStep — the
    Grover-MCZ enabler for n >= 21."""

    def test_mcz3_three_axes(self):
        from quantum_simulator_tpu.ops.plan import DiagProductStep

        c = QuantumCircuit(16)   # axes (4, 128, 128)
        for q in range(16):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("MCZ3", [0, 7, 15], [], column=1))
        for q in range(16):
            c.add_gate(GateInstance("Ry", [q], [0.1 * q + 0.2], column=2))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert any(isinstance(s, DiagProductStep) for s in plan.steps)
        assert not any(isinstance(s, GenericStep) for s in plan.steps)
        assert plan.all_real  # H, MCZ, Ry are all real
        both(c)

    def test_wide_mcz_with_multiple_targets_per_axis(self):
        from quantum_simulator_tpu.ops.plan import DiagProductStep

        c = QuantumCircuit(16)
        for q in range(16):
            c.add_gate(GateInstance("H", [q], [], column=0))
        # 5 targets across all 3 axes, two in one axis
        c.add_gate(GateInstance("MCZ5", [0, 1, 5, 7, 15], [], column=1))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert any(isinstance(s, DiagProductStep) for s in plan.steps)
        both(c)

    def test_ordering_vs_dense_pendings(self):
        # Ry on qubit 0 BEFORE the MCZ overlaps its bits -> must flush
        # first; Ry on untouched qubit 2 commutes and may flush after.
        c = QuantumCircuit(16)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("H", [7], [], column=0))
        c.add_gate(GateInstance("H", [15], [], column=0))
        c.add_gate(GateInstance("Ry", [0], [0.7], column=1))
        c.add_gate(GateInstance("Ry", [2], [0.4], column=1))
        c.add_gate(GateInstance("MCZ3", [0, 7, 15], [], column=2))
        c.add_gate(GateInstance("Ry", [0], [0.3], column=3))
        both(c)

    def test_trajectory_body_with_matrixless_mcz(self):
        # The group trajectory executor must route matrix-less
        # controlled-phase ops through apply_cphase_grouped, not
        # op_matrix (which raises) — and match the per-gate trajectory.
        import jax
        from quantum_simulator_tpu.noise import DepolarizingNoise, NoiseModel
        from quantum_simulator_tpu.ops.plan import group_trajectory_body
        from quantum_simulator_tpu.ops.program import _trajectory_body

        c = QuantumCircuit(12)
        for q in range(12):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("MCZ12", list(range(12)), [], column=1))
        for q in range(12):
            c.add_gate(GateInstance("Ry", [q], [0.1 * q + 0.2], column=2))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.05))
        p = prog.compile_circuit(c)
        assert p.ops[12].cphase_value == -1.0  # k=12 > dense cap of 10
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(3)
        got = np.asarray(group_trajectory_body(p, nm, params, key))
        expected = np.asarray(_trajectory_body(
            p, nm.kraus_stacks_for_gate, params, key, jnp.complex64,
            False))
        np.testing.assert_allclose(got, expected, atol=1e-6)

    def test_wide_mcz17_matrixless(self):
        # k=17 > the dense-matrix cap: the op carries only cphase_value.
        # Execution agreement between the group plan (DiagProductStep)
        # and the per-gate path (apply_cphase) at a runnable n.
        n = 17
        c = QuantumCircuit(n)
        for q in range(n):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance(f"MCZ{n}", list(range(n)), [], column=1))
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q], [0.11 * q + 0.3], column=2))
        p = prog.compile_circuit(c)
        assert p.ops[n].cphase_value == -1.0
        assert p.ops[n].static_matrix is None
        # serialization round trip through the on-demand registry
        c2 = QuantumCircuit.from_dict(c.to_dict())
        p2 = prog.compile_circuit(c2)
        assert p2.ops[n].cphase_value == -1.0
        plan = build_group_plan(p)
        assert plan.all_real
        got = both(c)
        # the all-ones amplitude picked up the phase: spot-check against
        # a manual statevector of the H-wall + flip
        probs = np.abs(got) ** 2
        np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-4)

    def test_grover_iteration_plan_at_21_has_no_generic(self):
        # Plan-level check only (a full Grover-21 is ~1,100 iterations):
        # one oracle+diffusion iteration — whose MCZ spans 4 axes —
        # routes to DiagProductStep, and the whole plan stays all-real.
        from quantum_simulator_tpu.ops.plan import DiagProductStep

        n = 21
        c = QuantumCircuit(n)
        col = 0
        for q in range(n):
            c.add_gate(GateInstance("H", [q], [], column=col))
        col += 1
        # oracle for |0...01>: X-conjugated MCZ over all qubits
        for q in range(n - 1):
            c.add_gate(GateInstance("X", [q], [], column=col))
        col += 1
        c.add_gate(GateInstance(f"MCZ{n}", list(range(n)), [], column=col))
        col += 1
        for q in range(n - 1):
            c.add_gate(GateInstance("X", [q], [], column=col))
        col += 1
        # diffusion
        for q in range(n):
            c.add_gate(GateInstance("H", [q], [], column=col))
            c.add_gate(GateInstance("X", [q], [], column=col + 1))
        col += 2
        c.add_gate(GateInstance(f"MCZ{n}", list(range(n)), [], column=col))
        col += 1
        for q in range(n):
            c.add_gate(GateInstance("X", [q], [], column=col))
            c.add_gate(GateInstance("H", [q], [], column=col + 1))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert not any(isinstance(s, GenericStep) for s in plan.steps)
        assert sum(isinstance(s, DiagProductStep) for s in plan.steps) == 2
        assert plan.all_real


class TestRealnessAnalysis:
    """Static realness flags: real composed operators skip the plane
    contraction; all-real plans evolve a real state."""

    def test_brickwork_is_all_real(self):
        # Ry + CNOT: every matrix real -> whole evolution stays real.
        p = prog.compile_circuit(brickwork_circuit(12, 6, seed=3))
        plan = build_group_plan(p)
        assert plan.all_real
        assert all(r for ax in plan.dense_real for r in ax)
        assert all(plan.cross_real)
        both(brickwork_circuit(12, 6, seed=3))

    def test_phase_gate_breaks_all_real(self):
        c = brickwork_circuit(10, 4, seed=5)
        col = max(g.column for g in c.gates) + 1
        c.add_gate(GateInstance("T", [0], [], column=col))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert not plan.all_real
        both(c)

    def test_qft_mixes_real_and_complex_steps(self):
        from quantum_simulator_tpu.algorithms import AlgorithmTemplate

        c = AlgorithmTemplate.quantum_fourier_transform(10)
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert not plan.all_real  # CPhase is complex-diagonal
        both(c)

    def test_real_op_on_complex_state(self):
        # A complex column (T) flushed by a cross step, then a REAL Ry
        # column applied to the now-complex state: exercises the real-op
        # specs on a planar (complex) state.
        c = QuantumCircuit(10)
        for q in range(10):
            c.add_gate(GateInstance("T", [q], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 9], [], column=1))
        for q in range(10):
            c.add_gate(GateInstance("Ry", [q], [0.3 + 0.1 * q], column=2))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert not plan.all_real
        assert any(r for ax in plan.dense_real for r in ax)
        both(c)

    def test_ry_only_circuit_matches_reference_numbers(self):
        # End-to-end numeric sanity on the all-real path against the
        # per-gate engine (both() uses forward_fn as reference).
        c = QuantumCircuit(9)
        for col in range(3):
            for q in range(9):
                c.add_gate(GateInstance("Ry", [q],
                                        [0.2 * (col + 1) + 0.05 * q],
                                        column=2 * col))
            for q in range(0, 8, 2):
                c.add_gate(GateInstance("CNOT", [q, q + 1], [],
                                        column=2 * col + 1))
        got = both(c)
        np.testing.assert_allclose(np.imag(got), 0.0, atol=1e-6)
        np.testing.assert_allclose(np.sum(np.abs(got) ** 2), 1.0,
                                   atol=1e-5)


class TestBitPairSteps:
    """Straddling 2q gates with nothing folded: the BitPairStep lowering
    (K=4 einsum / pure transpose for exact SWAPs) must match the
    per-gate engine exactly."""

    def test_straddling_swap_is_transpose_step(self):
        c = QuantumCircuit(10)
        c.add_gate(GateInstance("H", [2], [], column=0))
        c.add_gate(GateInstance("SWAP", [1, 9], [], column=1))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        bps = [s for s in plan.steps if isinstance(s, BitPairStep)]
        assert len(bps) == 1
        assert plan.bitpair_specs[bps[0].index].is_swap
        both(c)

    def test_straddling_cnot_einsum(self):
        c = QuantumCircuit(10)
        c.add_gate(GateInstance("H", [9], [], column=0))
        c.add_gate(GateInstance("CNOT", [9, 1], [], column=1))
        c.add_gate(GateInstance("CNOT", [1, 8], [], column=2))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        bps = [s for s in plan.steps if isinstance(s, BitPairStep)]
        assert bps and not any(
            plan.bitpair_specs[s.index].is_swap for s in bps)
        both(c)

    def test_qft_final_swaps_all_bitpairs(self):
        from quantum_simulator_tpu.algorithms import AlgorithmTemplate

        c = AlgorithmTemplate.quantum_fourier_transform(12)
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        bps = [s for s in plan.steps if isinstance(s, BitPairStep)]
        # QFT-12 has 6 final SWAPs; every straddling one must be a
        # transpose bitpair, none a cross matmul.
        assert all(plan.bitpair_specs[s.index].is_swap for s in bps)
        assert len(bps) >= 4
        assert not any(isinstance(s, CrossStep) for s in plan.steps)
        both(c)

    def test_swap_run_counts_one_pass(self):
        from quantum_simulator_tpu.ops.plan import count_state_passes

        c = QuantumCircuit(12)
        for i, (a, b) in enumerate([(0, 11), (1, 10), (2, 9)]):
            c.add_gate(GateInstance("SWAP", [a, b], [], column=i))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        bps = [s for s in plan.steps if isinstance(s, BitPairStep)]
        assert len(bps) == 3
        assert count_state_passes(plan) == 1  # adjacent swaps fuse
        both(c)

    def test_bitpair_is_real_flagged(self):
        c = QuantumCircuit(10)
        c.add_gate(GateInstance("Ry", [3], [0.7], column=0))
        c.add_gate(GateInstance("SWAP", [1, 9], [], column=1))
        p = prog.compile_circuit(c)
        plan = build_group_plan(p)
        assert plan.all_real
