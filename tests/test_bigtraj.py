"""Huge-path noisy trajectories (ops/bigtraj.py) vs the dense paths.

The per-gate chunked trajectory executor exists for n >= 30; its math is
validated at small n — chunking forced on — against
``plan.group_trajectory_body`` (the n <= 29 device path), which itself is
validated against the reference's stochastic-Kraus semantics
(``/root/reference/quantum_sim/engine/noise.py:224-260``). Both paths
split keys identically, so for the same key they take the SAME stochastic
branches and the final states match exactly (up to f32 rounding, and up
to a global phase on the phase-real fast path).
"""

import jax
import jax.numpy as jnp
import numpy as np

from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.noise import (
    AmplitudeDampingNoise,
    BitFlipNoise,
    DepolarizingNoise,
    NoiseModel,
    PhaseFlipNoise,
)
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.ops.bigtraj import (
    huge_trajectory_sample_fn,
    huge_trajectory_state_body,
    phase_real_stack,
    qubit_rhos_from_grams,
    trajectory_is_real,
)
from quantum_simulator_tpu.ops.plan import group_trajectory_body
from quantum_simulator_tpu.simulator import Simulator


def _fidelity_vs_group(circuit, nm, seed, chunks_list=(1, 2, 4)):
    p = prog.compile_circuit(circuit)
    params = jnp.asarray(p.initial_params)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(group_trajectory_body(p, nm, params, key,
                                           jnp.complex64))
    planar_expected = not trajectory_is_real(p, nm)
    for n_chunks in chunks_list:
        x, planar = huge_trajectory_state_body(p, nm, params, key,
                                               jnp.complex64,
                                               n_chunks=n_chunks)
        assert planar == planar_expected
        if planar:
            got = (np.asarray(x[0]) + 1j * np.asarray(x[1])).reshape(-1)
        else:
            got = np.asarray(x).reshape(-1).astype(complex)
        # |<ref|got>|^2 — invariant under the phase-real path's global sign
        fid = abs(np.vdot(ref, got)) ** 2 / (
            np.vdot(ref, ref).real * np.vdot(got, got).real)
        assert fid > 1 - 1e-5, (n_chunks, fid)
        np.testing.assert_allclose(np.vdot(got, got).real, 1.0, atol=1e-4)


class TestTrajectoryExecutor:
    def test_real_brickwork_matches_group_path(self):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        _fidelity_vs_group(brickwork_circuit(10, 4, seed=3), nm, seed=7)

    def test_mixed_channels(self):
        # BitFlip+AmplitudeDamping routes to the MONOMIAL splice path
        # (r5): that path is joint-LAW-exact vs the per-gate executor
        # (locked in tests/test_monomial_traj.py), not draw-exact, so
        # the huge path is compared same-key against the unchunked
        # monomial body instead of group_trajectory_body.
        from quantum_simulator_tpu.ops.monomial_traj import (
            monomial_insert_evolve_ok,
            monomial_trajectory_body,
        )

        nm = NoiseModel()
        nm.add_global_noise(BitFlipNoise(0.08))
        nm.add_global_noise(AmplitudeDampingNoise(0.15))
        c = brickwork_circuit(9, 4, seed=5)
        p = prog.compile_circuit(c)
        assert monomial_insert_evolve_ok(p, nm)
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(11)
        ref = np.asarray(monomial_trajectory_body(p, nm, params, key,
                                                  jnp.complex64))
        for n_chunks in (1, 2):
            x, planar = huge_trajectory_state_body(p, nm, params, key,
                                                   jnp.complex64,
                                                   n_chunks=n_chunks)
            got = ((np.asarray(x[0]) + 1j * np.asarray(x[1])).reshape(-1)
                   if planar else np.asarray(x).reshape(-1).astype(complex))
            fid = abs(np.vdot(ref, got)) ** 2 / (
                np.vdot(ref, ref).real * np.vdot(got, got).real)
            assert fid > 1 - 1e-5, (n_chunks, fid)
            np.testing.assert_allclose(np.vdot(got, got).real, 1.0,
                                       atol=1e-4)

    def test_mixed_channels_fold_path_draw_exact(self):
        # The per-gate fold executor keeps its original draw-exact
        # contract vs group_trajectory_body for the same mix — called
        # directly, bypassing the monomial routing.
        from quantum_simulator_tpu.ops.bigtraj import huge_trajectory_evolve
        from quantum_simulator_tpu.ops.plan import (
            GroupLayout,
            _real_basis_state,
        )
        from quantum_simulator_tpu.ops.bigtraj import _planar_basis_state

        nm = NoiseModel()
        nm.add_global_noise(BitFlipNoise(0.08))
        nm.add_global_noise(AmplitudeDampingNoise(0.15))
        c = brickwork_circuit(9, 4, seed=5)
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(11)
        ref = np.asarray(group_trajectory_body(p, nm, params, key,
                                               jnp.complex64))
        layout = GroupLayout.for_qubits(p.num_qubits)
        planar = not trajectory_is_real(p, nm)
        for n_chunks in (1, 2):
            x0 = (_planar_basis_state(layout, p.initial_index) if planar
                  else _real_basis_state(layout, p.initial_index))
            x = huge_trajectory_evolve(p, nm, params, key, x0, None,
                                       n_chunks, from_basis=True)
            got = ((np.asarray(x[0]) + 1j * np.asarray(x[1])).reshape(-1)
                   if planar else np.asarray(x).reshape(-1).astype(complex))
            fid = abs(np.vdot(ref, got)) ** 2 / (
                np.vdot(ref, ref).real * np.vdot(got, got).real)
            assert fid > 1 - 1e-5, (n_chunks, fid)

    def test_complex_planar_exact(self):
        # Rz makes the trajectory complex -> planar path, no phase
        # freedom: exact state equality.
        c = brickwork_circuit(9, 2, seed=3)
        col = max(g.column for g in c.gates) + 1
        for q in range(9):
            c.add_gate(GateInstance("Rz", [q], [0.3 + 0.1 * q], column=col))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(11)
        ref = np.asarray(group_trajectory_body(p, nm, params, key,
                                               jnp.complex64))
        x, planar = huge_trajectory_state_body(p, nm, params, key,
                                               jnp.complex64, n_chunks=2)
        assert planar
        got = (np.asarray(x[0]) + 1j * np.asarray(x[1])).reshape(-1)
        np.testing.assert_allclose(got, ref, atol=2e-5)

    def test_wide_mcz_per_qubit_fallback(self):
        # MCZ3 spanning 3 axes at n=15: no joint-rho fold — the per-qubit
        # reduce/apply fallback, with the prod-diag chunked apply.
        c = QuantumCircuit(15)
        for q in range(15):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("MCZ3", [0, 7, 14], [], column=1))
        for q in range(15):
            c.add_gate(GateInstance("Ry", [q], [0.07 * q + 0.2], column=2))
        nm = NoiseModel()
        nm.add_global_noise(PhaseFlipNoise(0.2))
        _fidelity_vs_group(c, nm, seed=7, chunks_list=(2,))

    def test_three_group_toffoli_bits_fallback(self):
        # Toffoli spanning three layout groups at n=15: no axis/cross
        # form — the rank-2k bit-contraction applier serves it.
        c = QuantumCircuit(15)
        c.add_gate(GateInstance("H", [1], [], column=0))
        c.add_gate(GateInstance("H", [7], [], column=0))
        c.add_gate(GateInstance("Toffoli", [1, 7, 14], [], column=1))
        nm = NoiseModel()
        nm.add_global_noise(BitFlipNoise(0.1))
        _fidelity_vs_group(c, nm, seed=5, chunks_list=(1, 2))

    def test_gate_specific_noise(self):
        nm = NoiseModel()
        nm.add_gate_noise("CNOT", DepolarizingNoise(0.15))
        _fidelity_vs_group(brickwork_circuit(9, 4, seed=9), nm, seed=13,
                           chunks_list=(2,))

    def test_phase_real_stacks(self):
        for ch in (BitFlipNoise(0.1), PhaseFlipNoise(0.1),
                   DepolarizingNoise(0.1), AmplitudeDampingNoise(0.3)):
            assert phase_real_stack(ch.kraus_stack()) is not None, ch
        # diag(1, i) is NOT real up to a global phase
        bad = np.stack([np.diag([1.0, 1.0j]), np.diag([1.0, 1.0])])
        assert phase_real_stack(bad) is None

    def test_trajectory_realness_detection(self):
        c = brickwork_circuit(8, 2, seed=1)
        p = prog.compile_circuit(c)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        assert trajectory_is_real(p, nm)  # Ry/CNOT + phase-real Kraus
        c2 = brickwork_circuit(8, 2, seed=1)
        c2.add_gate(GateInstance("T", [0], [], column=99))
        assert not trajectory_is_real(prog.compile_circuit(c2), nm)


def _fold_vs_group(circuit, nm, seed):
    """Draw-exactness lock (VERDICT r3 #1): the folded mid-n body must
    take the SAME stochastic branches as plan.group_trajectory_body for
    the same key — final states match up to f32 rounding (and a global
    phase on the phase-real real-state path)."""
    from quantum_simulator_tpu.ops.bigtraj import fold_trajectory_body

    p = prog.compile_circuit(circuit)
    params = jnp.asarray(p.initial_params)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(group_trajectory_body(p, nm, params, key,
                                           jnp.complex64))
    got = np.asarray(fold_trajectory_body(p, nm, params, key,
                                          jnp.complex64))
    fid = abs(np.vdot(ref, got)) ** 2 / (
        np.vdot(ref, ref).real * np.vdot(got, got).real)
    assert fid > 1 - 1e-5, fid
    np.testing.assert_allclose(np.vdot(got, got).real, 1.0, atol=1e-4)


class TestFoldTrajectoryBody:
    """The unchunked folded executor behind the vmapped mid-n
    batched-trajectory path."""

    def test_real_brickwork(self):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        _fold_vs_group(brickwork_circuit(12, 4, seed=3), nm, seed=7)

    def test_complex_planar_exact(self):
        c = brickwork_circuit(9, 2, seed=3)
        col = max(g.column for g in c.gates) + 1
        for q in range(9):
            c.add_gate(GateInstance("Rz", [q], [0.3 + 0.1 * q], column=col))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        from quantum_simulator_tpu.ops.bigtraj import fold_trajectory_body
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(11)
        ref = np.asarray(group_trajectory_body(p, nm, params, key,
                                               jnp.complex64))
        got = np.asarray(fold_trajectory_body(p, nm, params, key,
                                              jnp.complex64))
        np.testing.assert_allclose(got, ref, atol=2e-5)

    def test_cphase_ops_fold_densely(self):
        # CZ / MCZ3 with channels ride the dense prod-fold (one pass)
        # on the unchunked path — same draws as the per-gate body.
        c = QuantumCircuit(13)
        for q in range(13):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("CZ", [0, 12], [], column=1))
        c.add_gate(GateInstance("CZ", [3, 4], [], column=1))
        c.add_gate(GateInstance("MCZ3", [1, 6, 11], [], column=2))
        for q in range(13):
            c.add_gate(GateInstance("Ry", [q], [0.05 * q + 0.1], column=3))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.12))
        _fold_vs_group(c, nm, seed=5)

    def test_mixed_and_gate_specific_channels(self):
        nm = NoiseModel()
        nm.add_global_noise(BitFlipNoise(0.08))
        nm.add_gate_noise("CNOT", AmplitudeDampingNoise(0.2))
        _fold_vs_group(brickwork_circuit(10, 3, seed=5), nm, seed=13)

    def test_fold_supported_routing(self):
        from quantum_simulator_tpu.ops.bigtraj import fold_supported
        assert fold_supported(prog.compile_circuit(
            brickwork_circuit(10, 2, seed=1)))
        # MCZ5 is controlled-phase-form: supported (prod applier)
        c = QuantumCircuit(12)
        c.add_gate(GateInstance("MCZ5", [0, 2, 4, 6, 8], [], column=0))
        assert fold_supported(prog.compile_circuit(c))

    def test_wide_mcz_with_noise_unchunked(self):
        # MCZ4 exceeds _FOLD_MAX_TARGETS: apply + per-qubit kraus route
        # on the unchunked path too — still draw-exact vs the group body.
        c = QuantumCircuit(12)
        for q in range(12):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("MCZ4", [0, 3, 6, 9], [], column=1))
        nm = NoiseModel()
        nm.add_global_noise(PhaseFlipNoise(0.15))
        _fold_vs_group(c, nm, seed=21)


class TestDonationChain:
    def test_sample_fn_counts_match_state(self):
        c = brickwork_circuit(10, 3, seed=9)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.05))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        shots = 30000
        fn, planar = huge_trajectory_sample_fn(p, nm, shots,
                                               keep_state=True)
        x, marg, idx = fn(params, jax.random.PRNGKey(3),
                          jax.random.PRNGKey(4))
        idx = np.asarray(idx)
        assert idx.shape == (shots,)
        # sampled distribution matches the returned state's |amp|^2
        if planar:
            probs = (np.asarray(x[0]) ** 2
                     + np.asarray(x[1]) ** 2).reshape(-1)
        else:
            probs = (np.asarray(x) ** 2).reshape(-1)
        emp = np.bincount(idx, minlength=1 << 10) / shots
        tvd = 0.5 * np.abs(emp - probs / probs.sum()).sum()
        assert tvd < 0.06, tvd
        # marginals consistent with the state
        m0 = np.asarray(marg[0])
        np.testing.assert_allclose(
            m0, probs.reshape(8, 128).sum(axis=1), atol=1e-5)


class TestSimulatorHugeNoisy:
    def test_run_huge_single_trajectory(self):
        from quantum_simulator_tpu.measurement import MeasurementBasis
        from quantum_simulator_tpu.ops.bigstate import PlanarStateVector

        c = brickwork_circuit(10, 3, seed=9)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.08))
        p = prog.compile_circuit(c)
        sim = Simulator(noise_model=nm)
        res = sim._run_huge(c, p, 2000, False, 3,
                            np.random.default_rng(3), MeasurementBasis.Z)
        assert isinstance(res.final_state, PlanarStateVector)
        assert sum(res.measurement_counts.values()) == 2000
        np.testing.assert_allclose(res.final_state.norm_sq(), 1.0,
                                   atol=1e-4)
        # X-basis sampling rotates inside the stats dispatch; the final
        # state is the same trajectory re-run (same key, same branches).
        res_x = sim._run_huge(c, p, 500, False, 3,
                              np.random.default_rng(3), MeasurementBasis.X)
        assert sum(res_x.measurement_counts.values()) == 500
        np.testing.assert_allclose(res_x.final_state.norm_sq(), 1.0,
                                   atol=1e-4)

    def test_run_with_noise_huge_distribution(self):
        c = brickwork_circuit(8, 3, seed=9)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.08))
        sim = Simulator(noise_model=nm)
        shots = 30000
        r_h = sim._run_with_noise_huge(c, shots, 1,
                                       np.random.default_rng(1), 64)
        assert r_h.final_state is None
        assert sum(r_h.measurement_counts.values()) == shots
        r_d = sim.run_with_noise(c, shots, seed=2)

        def dist(counts):
            v = np.zeros(1 << 8)
            for b, k in counts.items():
                v[int(b, 2)] = k
            return v / v.sum()

        tvd = 0.5 * np.abs(dist(r_h.measurement_counts)
                           - dist(r_d.measurement_counts)).sum()
        assert tvd < 0.12, tvd  # 64-trajectory Monte-Carlo + shot noise

    def test_ensemble_qubit_density_matrices(self):
        c = brickwork_circuit(8, 3, seed=7)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        sim = Simulator(noise_model=nm)
        trials = 150
        rho_q = sim.ensemble_qubit_density_matrices(c, n_trials=trials,
                                                    seed=5)
        assert rho_q.shape == (8, 2, 2)
        np.testing.assert_allclose(
            [np.trace(rho_q[q]).real for q in range(8)], 1.0, atol=1e-4)
        # agreement with the dense ensemble rho's partial trace
        rho_full = sim.ensemble_density_matrix(c, n_trials=trials, seed=5)
        for q in (0, 3, 7):
            pre, post = 1 << q, (1 << 8) >> (q + 1)
            want = np.einsum(
                "apbaqb->pq",
                rho_full.reshape(pre, 2, post, pre, 2, post))
            assert np.abs(rho_q[q] - want).max() < 0.09  # statistical

    def test_ensemble_qubit_rho_huge_path_matches(self):
        # Drive the gram-reduction path directly (the public router gates
        # on state size + the GPU backend) and compare with the batched path.
        from quantum_simulator_tpu.ops.bigtraj import huge_trajectory_gram_fn

        c = brickwork_circuit(9, 3, seed=7)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        fn, _ = huge_trajectory_gram_fn(p, nm)
        trials = 60
        key = jax.random.PRNGKey(0)
        acc = np.zeros((9, 2, 2), np.complex128)
        for t in range(trials):
            grams = fn(params, jax.random.fold_in(key, t))
            acc += qubit_rhos_from_grams(grams, 9)
        rho_q = acc / trials
        sim = Simulator(noise_model=nm)
        rho_ref = sim.ensemble_qubit_density_matrices(c, n_trials=trials,
                                                      seed=1)
        for q in range(9):
            assert np.abs(rho_q[q] - rho_ref[q]).max() < 0.15  # statistical
