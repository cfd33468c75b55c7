"""Chunked in-place executor (ops/bigstate.py) vs the whole-state path.

The chunked schedule exists for states whose whole-state einsum (in+out)
would not fit the device budget; its math must be identical at every n,
so it is validated here at small n — forced on with explicit chunk
counts — against the whole-state group executor and the per-gate einsum
program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.ops.bigstate import (
    auto_chunks,
    group_forward_planar_body,
    planar_norm_sq,
    planar_probabilities,
)


def planar_vs_reference(circuit, n_chunks, atol=1e-5):
    p = prog.compile_circuit(circuit)
    params = jnp.asarray(p.initial_params)
    x = jax.jit(lambda pr: group_forward_planar_body(
        p, pr, jnp.complex64, n_chunks=n_chunks))(params)
    got = np.asarray(x[0]) + 1j * np.asarray(x[1])
    expected = np.asarray(prog.forward_fn(p)(params))
    np.testing.assert_allclose(got.reshape(-1), expected, atol=atol)
    return x


class TestChunkedExecutor:
    def test_brickwork_chunk_counts(self):
        # n=16 -> axes (4, 128, 128): dense + cross steps, several
        # chunkable axes. Every divisor schedule must agree.
        c = brickwork_circuit(16, 6, seed=3)
        for chunks in (1, 2, 4, 8):
            planar_vs_reference(c, chunks)

    def test_qft_diag_pairs_chunked(self):
        from quantum_simulator_tpu.algorithms import AlgorithmTemplate

        c = AlgorithmTemplate.quantum_fourier_transform(12)
        planar_vs_reference(c, 4)

    def test_three_group_generic_fallback(self):
        # Toffoli spanning three groups at n=16 -> GenericStep inside the
        # chunked schedule (whole-state fallback for that op only).
        c = QuantumCircuit(16)
        c.add_gate(GateInstance("H", [1], [], column=0))
        c.add_gate(GateInstance("H", [5], [], column=0))
        c.add_gate(GateInstance("Toffoli", [1, 5, 12], [], column=1))
        planar_vs_reference(c, 4)

    def test_chunks_exceeding_axis_size_clamp(self):
        # n=9 -> axes (4, 128): a cross step touches both axes of the
        # 2-axis layout, so it must fall back to whole-state; dense steps
        # chunk along the other axis.
        c = brickwork_circuit(9, 4, seed=5)
        planar_vs_reference(c, 16)

    def test_planar_helpers(self):
        c = brickwork_circuit(10, 4, seed=1)
        x = planar_vs_reference(c, 2)
        probs = np.asarray(planar_probabilities(x))
        assert probs.shape == (1 << 10,)
        np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            float(planar_norm_sq(x)), 1.0, atol=1e-5)

    @pytest.mark.parametrize("budget_gib, planar, whole_up_to", [
        (16, True, 29), (16, False, 30), (80, True, 31), (80, False, 32),
    ])
    def test_auto_chunks_threshold(self, budget_gib, planar, whole_up_to):
        """Whole-state (1 chunk) while 2x the state fits 5/8 of the
        budget, 8 chunks past it — 16 GiB and 80 GiB devices."""
        budget = budget_gib << 30
        for n in (16, 28, 29, 30, 31, 32):
            want = 1 if n <= whole_up_to else 8
            assert auto_chunks(n, planar=planar, budget=budget) == want, n


class TestHugeSampling:
    def _planar(self, circuit):
        p = prog.compile_circuit(circuit)
        params = jnp.asarray(p.initial_params)
        return p, jax.jit(lambda pr: group_forward_planar_body(
            p, pr, jnp.complex64, n_chunks=2))(params)

    def test_inverse_cdf_matches_distribution(self):
        from quantum_simulator_tpu.ops.bigstate import sample_planar_indices

        c = brickwork_circuit(10, 4, seed=9)
        p, x = self._planar(c)
        shots = 40000
        idx = np.asarray(sample_planar_indices(
            x, jax.random.PRNGKey(5), shots))
        assert idx.shape == (shots,) and idx.min() >= 0 \
            and idx.max() < 1 << 10
        emp = np.bincount(idx, minlength=1 << 10) / shots
        probs = np.asarray(planar_probabilities(x))
        tvd = 0.5 * np.abs(emp - probs / probs.sum()).sum()
        assert tvd < 0.05

    def test_chunked_prod_diag_all_axes_involved(self):
        # n=15 -> axes (2, 128, 128); an MCZ spanning all three axes
        # leaves NO free chunk axis, exercising the slice-the-factor
        # chunk loop in the chunked executor.
        from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit

        for add_t in (False, True):   # real path (lead=0) + planar (lead=1)
            c = QuantumCircuit(15)
            for q in range(15):
                c.add_gate(GateInstance("H", [q], [], column=0))
            if add_t:
                c.add_gate(GateInstance("T", [3], [], column=1))
            c.add_gate(GateInstance("MCZ3", [0, 7, 14], [], column=2))
            for q in range(15):
                c.add_gate(GateInstance("Ry", [q], [0.07 * q + 0.2],
                                        column=3))
            for chunks in (2, 4):
                planar_vs_reference(c, chunks)

    def test_bf16_probs_tier_matches_distribution(self):
        # The n=31 memory tier: bf16 within-tile probs, f32 block sums.
        from quantum_simulator_tpu.ops.bigstate import sample_state_indices

        c = brickwork_circuit(10, 4, seed=9)
        p, x = self._planar(c)
        shots = 40000
        idx = np.asarray(jax.jit(
            lambda xx, kk: sample_state_indices(
                xx, kk, shots, planar=True, probs_dtype=jnp.bfloat16)
        )(x, jax.random.PRNGKey(5)))
        emp = np.bincount(idx, minlength=1 << 10) / shots
        probs = np.asarray(planar_probabilities(x))
        tvd = 0.5 * np.abs(emp - probs / probs.sum()).sum()
        assert tvd < 0.05

    def test_sample_chunking_boundaries(self):
        # Handcrafted planar state with all mass ON slab boundaries
        # (first/last flat index of each lead-axis slab) — any off-by-one
        # in the per-slab offset chain or the final-slab catch-all would
        # misattribute these draws to a neighbouring slab.
        from quantum_simulator_tpu.ops.bigstate import sample_planar_indices

        lead, rest = 4, 8
        boundary = [0, rest - 1, rest, 2 * rest, 3 * rest - 1,
                    lead * rest - 1]
        amps = np.zeros(lead * rest, np.float32)
        amps[boundary] = 1.0 / np.sqrt(len(boundary))
        x = jnp.stack([jnp.asarray(amps.reshape(lead, rest)),
                       jnp.zeros((lead, rest), jnp.float32)])
        shots = 30000
        idx = np.asarray(sample_planar_indices(
            x, jax.random.PRNGKey(0), shots))
        assert set(np.unique(idx)) == set(boundary)
        emp = np.bincount(idx, minlength=lead * rest) / shots
        expected = amps ** 2
        assert 0.5 * np.abs(emp - expected).sum() < 0.03

    def test_planar_state_vector_wrapper(self):
        from quantum_simulator_tpu.ops.bigstate import PlanarStateVector

        c = brickwork_circuit(10, 4, seed=9)
        p, x = self._planar(c)
        sv = PlanarStateVector(x, 10)
        assert sv.num_qubits == 10
        np.testing.assert_allclose(sv.norm_sq(), 1.0, atol=1e-5)
        expected = np.asarray(prog.forward_fn(p)(
            jnp.asarray(p.initial_params)))
        for i in (0, 5, 1023):
            got = sv.amplitude(i)
            np.testing.assert_allclose([got.real, got.imag],
                                       [expected[i].real, expected[i].imag],
                                       atol=1e-5)
        try:
            sv.data
            assert False, "expected MemoryError"
        except MemoryError:
            pass

    def test_qubit_probabilities_match_dense(self):
        # Marginals from the fused forward vs per-qubit P(1) computed
        # densely; covers both the all-real and the planar (T-gate) case.
        from quantum_simulator_tpu.ops.bigstate import (
            PlanarStateVector,
            huge_forward_fn,
        )

        for add_t in (False, True):
            c = brickwork_circuit(10, 4, seed=9)
            if add_t:
                col = max(g.column for g in c.gates) + 1
                for q in range(10):
                    c.add_gate(GateInstance("T", [q], [], column=col))
            p = prog.compile_circuit(c)
            fn, planar = huge_forward_fn(p)
            x, marg = fn(jnp.asarray(p.initial_params))
            assert planar == add_t  # T makes the plan complex
            sv = PlanarStateVector(x, 10, planar=planar,
                                   axis_marginals=marg)
            got = sv.qubit_probabilities()
            dense = np.abs(np.asarray(prog.forward_fn(p)(
                jnp.asarray(p.initial_params)))) ** 2
            want = [dense[((np.arange(1 << 10) >> (10 - 1 - q)) & 1) == 1]
                    .sum() for q in range(10)]
            np.testing.assert_allclose(got, want, atol=1e-5)
            # the lazy (no-marginals) path agrees
            sv2 = PlanarStateVector(x, 10, planar=planar)
            np.testing.assert_allclose(sv2.qubit_probabilities(), want,
                                       atol=1e-5)
            np.testing.assert_allclose(sv.expectation_z(3),
                                       1.0 - 2.0 * want[3], atol=1e-5)
            # Z strings vs dense parity sums: same-group ([4,7] — free
            # from the captured marginal) AND cross-group ([0,9],
            # [0,2,9] — one fused parity-weighted device reduction).
            for qs in ([4, 7], [0, 9], [0, 2, 9]):
                zz = sv.expectation_z_string(qs)
                par = np.ones(1 << 10)
                for q in qs:
                    par *= np.where(
                        ((np.arange(1 << 10) >> (10 - 1 - q)) & 1),
                        -1.0, 1.0)
                np.testing.assert_allclose(zz, (dense * par).sum(),
                                           atol=1e-5, err_msg=str(qs))

    def test_simulator_huge_path(self):
        # Drive Simulator._run_huge directly at a small n (the public
        # router gates on state size + the GPU backend).
        from quantum_simulator_tpu.measurement import MeasurementBasis
        from quantum_simulator_tpu.ops.bigstate import PlanarStateVector
        from quantum_simulator_tpu.simulator import Simulator

        c = brickwork_circuit(10, 4, seed=9)
        p = prog.compile_circuit(c)
        sim = Simulator()
        shots = 40000
        res = sim._run_huge(c, p, shots, False, 3,
                            np.random.default_rng(3), MeasurementBasis.Z)
        assert isinstance(res.final_state, PlanarStateVector)
        assert sum(res.measurement_counts.values()) == shots
        # Agreement with the standard path's distribution
        ref = Simulator().run(c, shots=0)
        probs = np.abs(np.asarray(ref.final_state.device_data)) ** 2
        emp = np.zeros(1 << 10)
        for b, k in res.measurement_counts.items():
            emp[int(b, 2)] = k / shots
        assert 0.5 * np.abs(emp - probs / probs.sum()).sum() < 0.08

        # X-basis sampling goes through the rotated-circuit program
        # (H appended: still all-real, so the rotated forward is real).
        res_x = sim._run_huge(c, p, 500, False, 3,
                              np.random.default_rng(4), MeasurementBasis.X)
        assert sum(res_x.measurement_counts.values()) == 500

        # Y-basis rotation appends S_DAG (complex): the rotated
        # forward+sample runs the PLANAR fused program while the final
        # state stays on the all-real path. Validate the Y distribution
        # against the standard engine's rotated probabilities.
        shots_y = 60000
        res_y = sim._run_huge(c, p, shots_y, False, 3,
                              np.random.default_rng(5), MeasurementBasis.Y)
        assert sum(res_y.measurement_counts.values()) == shots_y
        assert not res_y.final_state.is_planar  # final state is all-real
        from quantum_simulator_tpu.measurement import rotate_to_basis

        rot = rotate_to_basis(ref.final_state, MeasurementBasis.Y)
        ref_probs = np.abs(np.asarray(rot.device_data)) ** 2
        emp_y = np.zeros(1 << 10)
        for b, k in res_y.measurement_counts.items():
            emp_y[int(b, 2)] = k / shots_y
        tvd = 0.5 * np.abs(emp_y - ref_probs / ref_probs.sum()).sum()
        assert tvd < 0.08

    def test_step_marginals_match_dense_steps(self):
        # Column-by-column marginal snapshots (the n >= 30 stepping mode)
        # vs the dense per-column states, both paths.
        from quantum_simulator_tpu.ops.bigstate import (
            MarginalStateSummary,
            huge_step_marginals_fn,
            qubit_probs_from_marginals,
        )

        for add_t in (False, True):
            c = brickwork_circuit(10, 4, seed=9)
            if add_t:
                c.add_gate(GateInstance("T", [2], [],
                                        column=max(g.column
                                                   for g in c.gates) + 1))
            p = prog.compile_circuit(c)
            params = jnp.asarray(p.initial_params)
            fn, ncols = huge_step_marginals_fn(p)
            outs = fn(params)
            stacked = prog.steps_fn(p)(params)  # (cols+1, 2^n) dense
            assert len(outs) == ncols + 1 == stacked.shape[0]
            for i, marg in enumerate(outs):
                probs = np.abs(np.asarray(stacked[i])) ** 2
                want = [probs[((np.arange(1 << 10) >> (10 - 1 - q)) & 1)
                              == 1].sum() for q in range(10)]
                got = qubit_probs_from_marginals(marg, 10)
                np.testing.assert_allclose(got, want, atol=1e-5,
                                           err_msg=f"col {i}")
            s = MarginalStateSummary(outs[-1], 10)
            np.testing.assert_allclose(
                s.qubit_probabilities(),
                qubit_probs_from_marginals(outs[-1], 10))
            try:
                s.data
                assert False, "expected MemoryError"
            except MemoryError:
                pass

    def test_simulator_huge_path_rejects_steps(self):
        # Noise is SUPPORTED on the huge path since round 3
        # (tests/test_bigtraj.py); per-column state retention remains
        # structurally impossible at n >= 30.
        from quantum_simulator_tpu.measurement import MeasurementBasis
        from quantum_simulator_tpu.simulator import Simulator

        c = brickwork_circuit(10, 2, seed=1)
        p = prog.compile_circuit(c)
        try:
            Simulator()._run_huge(c, p, 10, True, 0,
                                  np.random.default_rng(0),
                                  MeasurementBasis.Z)
            assert False
        except ValueError as e:
            assert "record_steps" in str(e)


class TestPauliStringExpectation:
    def test_matches_dense_gate_trick(self):
        # Mixed X/Y/Z strings on planar and all-real states vs the dense
        # engine's kron-observable expectation; odd-Y on a real state is
        # exactly 0 (psi^T A psi = 0).
        from quantum_simulator_tpu.analysis import StateAnalysis
        from quantum_simulator_tpu.ops.bigstate import (
            PlanarStateVector,
            huge_forward_fn,
        )
        from quantum_simulator_tpu.state import StateVector

        strings = [
            ([3], "X"), ([4], "Y"), ([0, 9], "XZ"), ([0, 9], "YY"),
            ([2, 5], "XY"), ([0, 4, 9], "XYZ"), ([1, 2, 8], "YYX"),
            ([0, 3, 6, 9], "XZXY"), ([5], "Z"), ([0, 5, 9], "ZZZ"),
        ]
        for add_t in (False, True):
            c = brickwork_circuit(10, 4, seed=11)
            if add_t:
                col = max(g.column for g in c.gates) + 1
                for q in range(10):
                    c.add_gate(GateInstance("T", [q], [], column=col))
            p = prog.compile_circuit(c)
            fn, planar = huge_forward_fn(p)
            x, marg = fn(jnp.asarray(p.initial_params))
            sv = PlanarStateVector(x, 10, planar=planar,
                                   axis_marginals=marg)
            dense_arr = np.asarray(prog.forward_fn(p)(
                jnp.asarray(p.initial_params)))
            dense = StateVector.from_device_array(
                jnp.asarray(dense_arr), 10)
            for qs, ps in strings:
                got = sv.expectation_pauli_string(qs, ps)
                want = StateAnalysis.pauli_string_expectation(
                    dense, qs, ps)
                if not planar and ps.count("Y") % 2 == 1:
                    assert got == 0.0
                    assert abs(want) < 1e-5, (qs, ps, want)
                else:
                    np.testing.assert_allclose(
                        got, want, atol=2e-5,
                        err_msg=f"{qs} {ps} planar={planar}")

    def test_unified_entry_and_validation(self):
        import pytest

        from quantum_simulator_tpu.analysis import StateAnalysis
        from quantum_simulator_tpu.ops.bigstate import (
            PlanarStateVector,
            huge_forward_fn,
        )

        c = brickwork_circuit(10, 3, seed=4)
        p = prog.compile_circuit(c)
        fn, planar = huge_forward_fn(p)
        x, marg = fn(jnp.asarray(p.initial_params))
        sv = PlanarStateVector(x, 10, planar=planar, axis_marginals=marg)
        # delegation: StateAnalysis routes PlanarStateVector to the
        # chunked reduction
        assert StateAnalysis.pauli_string_expectation(sv, [0, 9], "ZZ") \
            == pytest.approx(sv.expectation_z_string([0, 9]), abs=1e-7)
        assert sv.expectation_pauli_string([], "") == 1.0
        with pytest.raises(ValueError):
            sv.expectation_pauli_string([0, 1], "X")
        with pytest.raises(ValueError):
            sv.expectation_pauli_string([0, 0], "XX")
        with pytest.raises(ValueError):
            sv.expectation_pauli_string([0], "Q")
        with pytest.raises(ValueError):
            sv.expectation_pauli_string([77], "X")


@pytest.mark.parametrize("n", [21, 25])
def test_sampler_low_bits_unbiased(n):
    """Every index bit of a uniform state is a fair coin: the in-tile
    draw must resolve single amplitudes even where 2^-n is below the
    f32 resolution of the whole CDF."""
    from quantum_simulator_tpu.ops.bigstate import sample_state_indices
    from quantum_simulator_tpu.ops.plan import GroupLayout

    shape = GroupLayout.for_qubits(n).axis_sizes
    x = jnp.full(shape, 2.0 ** (-n / 2), jnp.float32)
    shots = 4096
    idx = np.asarray(jax.jit(lambda x, k: sample_state_indices(
        x, k, shots, planar=False))(x, jax.random.PRNGKey(1)))
    bits = (idx[:, None] >> np.arange(n - 1, -1, -1)) & 1
    assert np.abs(bits.mean(0) - 0.5).max() <= 5 * 0.5 / np.sqrt(shots)
