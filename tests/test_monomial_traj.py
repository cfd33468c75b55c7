"""General-Kraus (monomial) splice trajectories (``ops/monomial_traj.py``).

Every reference channel's Kraus operators are monomial (generalized
permutation matrices) in the computational basis, so state-dependent
draws become classical given ONE basis sample per composition window
(joint-law-exact; see the module docstring's proof sketch). Locks:

* stack classification: AD / thermal / depol / flips monomial; a
  rotated (X-basis) damping channel is not;
* trajectory-ensemble agreement with the exact density-matrix engine
  for amplitude damping, thermal relaxation, and channel mixes —
  including deep circuits where early decays bias later marginals
  (the cross-window conditioning this path must get right);
* distribution agreement with ``plan.group_trajectory_body`` (this
  path consumes keys differently — same law, not same per-key draws);
* monitored trajectories: projective collapse through the group plan,
  deterministic cases bit-exact, GHZ correlations, Born frequencies,
  agreement with the per-gate einsum monitored body's law.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu.noise import (
    AmplitudeDampingNoise,
    BitFlipNoise,
    DepolarizingNoise,
    NoiseChannel,
    NoiseModel,
    PhaseFlipNoise,
    ThermalRelaxationNoise,
    TwoQubitDepolarizingNoise,
)
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.ops.monomial_traj import (
    monomial_insert_supported,
    monomial_monitored_body,
    monomial_spec,
    monomial_stack,
    monomial_trajectory_body,
)


def brickwork(n, layers, *, rz=False):
    c = QuantumCircuit(n)
    col = 0
    for layer in range(layers):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q], [0.1 * (q + layer + 1)],
                                    column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    if rz:
        c.add_gate(GateInstance("Rz", [n // 3], [0.7], column=col))
    return c


class _XBasisDamping(NoiseChannel):
    """Amplitude damping conjugated by H: CPTP but NOT monomial."""

    def __init__(self, g):
        self._g = g

    @property
    def probability(self):
        return self._g

    def get_kraus_operators(self):
        H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
        ks = AmplitudeDampingNoise(self._g).get_kraus_operators()
        return [H @ k @ H for k in ks]


class TestStackClassification:
    def test_reference_family_is_monomial(self):
        for ch in (AmplitudeDampingNoise(0.2), DepolarizingNoise(0.1),
                   BitFlipNoise(0.3), PhaseFlipNoise(0.3),
                   ThermalRelaxationNoise(50.0, 70.0, 10.0),
                   TwoQubitDepolarizingNoise(0.2)):
            ms = monomial_stack(ch.kraus_stack())
            assert ms is not None, type(ch).__name__
            np.testing.assert_allclose(ms.w2.sum(axis=0),
                                       np.ones(ms.w2.shape[1]), atol=1e-5)

    def test_amplitude_damping_maps(self):
        ms = monomial_stack(AmplitudeDampingNoise(0.36).kraus_stack())
        # K0 = diag(1, sqrt(1-g)): identity map, weights (1, 1-g).
        np.testing.assert_allclose(ms.w2[0], [1.0, 0.64], atol=1e-6)
        assert list(ms.fmap[0]) == [0, 1]
        # K1 = sqrt(g)|0><1|: input 1 -> output 0 with weight g.
        np.testing.assert_allclose(ms.w2[1], [0.0, 0.36], atol=1e-6)
        assert ms.fmap[1][1] == 0

    def test_rotated_damping_is_not_monomial(self):
        assert monomial_stack(_XBasisDamping(0.3).kraus_stack()) is None
        nm = NoiseModel()
        nm.add_global_noise(_XBasisDamping(0.3))
        assert not monomial_insert_supported(
            prog.compile_circuit(brickwork(5, 1)), nm)

    def test_supported_for_channel_mixes(self):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.05))
        nm.add_global_noise(AmplitudeDampingNoise(0.1))
        nm.add_gate_noise("CNOT", ThermalRelaxationNoise(40.0, 60.0, 5.0))
        assert monomial_insert_supported(
            prog.compile_circuit(brickwork(6, 2)), nm)


def _ensemble_probs(circuit, nm, n_traj=700, seed=0):
    p = prog.compile_circuit(circuit)
    params = jnp.asarray(p.initial_params)
    body = jax.jit(jax.vmap(
        lambda k: monomial_trajectory_body(p, nm, params, k)))
    keys = jax.random.split(jax.random.PRNGKey(seed), n_traj)
    states = np.asarray(body(keys))
    norms = (np.abs(states) ** 2).sum(axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    return (np.abs(states) ** 2).mean(axis=0)


class TestEnsembleVsDensityMatrix:
    def test_amplitude_damping(self):
        from quantum_simulator_tpu.density import DensityMatrixSimulator

        c = brickwork(4, 2)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.25))
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(_ensemble_probs(c, nm), dm.probabilities,
                                   atol=0.05)

    def test_thermal_relaxation_planar(self):
        from quantum_simulator_tpu.density import DensityMatrixSimulator

        c = brickwork(4, 2, rz=True)
        nm = NoiseModel()
        nm.add_global_noise(ThermalRelaxationNoise(30.0, 40.0, 8.0))
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(_ensemble_probs(c, nm), dm.probabilities,
                                   atol=0.05)

    def test_depol_plus_damping_same_qubit_chain(self):
        # Two channels firing on the SAME target per gate: the classical
        # bit chain must thread f_m between same-qubit sites.
        from quantum_simulator_tpu.density import DensityMatrixSimulator

        c = brickwork(3, 2)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.15))
        nm.add_global_noise(AmplitudeDampingNoise(0.2))
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(_ensemble_probs(c, nm), dm.probabilities,
                                   atol=0.05)

    def test_deep_circuit_cross_window_conditioning(self):
        # Strong damping over depth 6: the population decays toward |0>
        # and each window's draws must condition on every earlier decay.
        from quantum_simulator_tpu.density import DensityMatrixSimulator

        c = brickwork(3, 6)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.3))
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(_ensemble_probs(c, nm), dm.probabilities,
                                   atol=0.05)

    def test_correlated_2q_with_damping(self):
        from quantum_simulator_tpu.density import DensityMatrixSimulator

        c = brickwork(4, 2)
        nm = NoiseModel()
        nm.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(0.3))
        nm.add_global_noise(AmplitudeDampingNoise(0.1))
        # 2q depol alone is mixed-unitary; adding damping forces the
        # monomial path to handle the (16, 4, 4) stack itself.
        from quantum_simulator_tpu.ops.unitary_traj import (
            unitary_insert_supported,
        )

        p = prog.compile_circuit(c)
        assert not unitary_insert_supported(p, nm)
        assert monomial_insert_supported(p, nm)
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(_ensemble_probs(c, nm), dm.probabilities,
                                   atol=0.05)


class TestDistributionVsGroupBody:
    def test_mean_probabilities_agree(self):
        # Different key-consumption schedule -> same trajectory LAW:
        # compare mean output distributions over many keys.
        from quantum_simulator_tpu.ops.plan import group_trajectory_body

        c = brickwork(5, 3)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.2))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        keys = jax.random.split(jax.random.PRNGKey(3), 600)
        ref_body = jax.jit(jax.vmap(
            lambda k: group_trajectory_body(p, nm, params, k,
                                            jnp.complex64)))
        ref = (np.abs(np.asarray(ref_body(keys))) ** 2).mean(axis=0)
        got = _ensemble_probs(c, nm, n_traj=600, seed=3)
        np.testing.assert_allclose(got, ref, atol=0.06)


class TestSpecStructure:
    def test_windows_per_column(self):
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.1))
        p = prog.compile_circuit(brickwork(6, 2))
        spec = monomial_spec(p, nm)
        # 4 gate columns -> 4 windows (boundaries only where a later
        # gate touches a pending site's target), NOT one per gate.
        assert len(spec.windows) == 4
        assert len(spec.segments) == 5
        assert sum(len(w) for w in spec.windows) == sum(
            len(op.targets) for op in p.ops)

    def test_real_detection(self):
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.1))
        assert monomial_spec(
            prog.compile_circuit(brickwork(4, 1)), nm).real
        assert not monomial_spec(
            prog.compile_circuit(brickwork(4, 1, rz=True)), nm).real


class TestMonitored:
    def _run(self, circuit, nm, events, n_traj, seed=0):
        p = prog.compile_circuit(circuit)
        params = jnp.asarray(p.initial_params)
        body = jax.jit(jax.vmap(
            lambda k: monomial_monitored_body(p, nm, events, params, k),
            in_axes=0))
        keys = jax.random.split(jax.random.PRNGKey(seed), n_traj)
        states, outs = body(keys)
        return np.asarray(states), np.asarray(outs)

    def test_deterministic_outcomes(self):
        # |0> measured -> 0; X|0> measured -> 1. Bit-exact, every traj.
        c = QuantumCircuit(4)
        c.add_gate(GateInstance("X", [1], [], column=0))
        p = prog.compile_circuit(c)
        nm = NoiseModel()
        events = ((1, 0), (1, 1))  # after the X op
        states, outs = self._run(c, nm, events, 8)
        assert outs.shape == (8, 2)
        assert (outs[:, 0] == 0).all()
        assert (outs[:, 1] == 1).all()
        norms = (np.abs(states) ** 2).sum(axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)

    def test_born_frequencies_and_collapse(self):
        # H|0> measured: ~50/50 outcomes; post-state = |outcome> exactly.
        c = QuantumCircuit(3)
        c.add_gate(GateInstance("H", [0], [], column=0))
        nm = NoiseModel()
        events = ((1, 0),)
        states, outs = self._run(c, nm, events, 400)
        f1 = outs[:, 0].mean()
        assert 0.42 < f1 < 0.58, f1
        for t in range(12):
            idx = int(outs[t, 0]) << 2
            probs = np.abs(states[t]) ** 2
            assert probs[idx] > 0.999, (t, probs)

    def test_ghz_outcome_correlation(self):
        # GHZ then measure both qubits mid-circuit: outcomes always equal.
        c = QuantumCircuit(2)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
        nm = NoiseModel()
        events = ((2, 0), (2, 1))
        _, outs = self._run(c, nm, events, 300)
        assert (outs[:, 0] == outs[:, 1]).all()
        f = outs[:, 0].mean()
        assert 0.4 < f < 0.6, f

    def test_collapse_feeds_forward(self):
        # Measure q0 of (H q0), then CNOT(0,1): final q1 must equal the
        # recorded outcome (collapse happened BEFORE the entangler).
        c = QuantumCircuit(2)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
        nm = NoiseModel()
        events = ((1, 0),)  # between H and CNOT
        states, outs = self._run(c, nm, events, 200)
        for t in range(20):
            b = int(outs[t, 0])
            probs = np.abs(states[t]) ** 2
            assert probs[b * 2 + b] > 0.999, (t, b, probs)

    def test_monitored_with_noise_matches_einsum_law(self):
        # Per-gate einsum monitored body vs the splice body: outcome
        # marginal frequencies agree (same law, different key schedule).
        c = brickwork(3, 2)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.3))
        events = ((len(prog.compile_circuit(c).ops), q) for q in range(3))
        events = tuple(events)
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        keys = jax.random.split(jax.random.PRNGKey(9), 500)
        ref_fn = jax.jit(jax.vmap(
            lambda pa, k: prog._monitored_body(
                p, nm.kraus_stacks_for_gate, events, pa, k,
                jnp.complex64),
            in_axes=(None, 0)))
        _, ref_outs = ref_fn(params, keys)
        ref_f = np.asarray(ref_outs).mean(axis=0)
        _, outs = self._run(c, nm, events, 500, seed=10)
        got_f = outs.mean(axis=0)
        np.testing.assert_allclose(got_f, ref_f, atol=0.08)

    def test_simulator_monitored_api_group_path(self):
        # Simulator.monitored_trajectories no longer rejects the group
        # regime; on CPU the einsum path still serves, so just assert
        # the API contract end-to-end with a Measure gate.
        from quantum_simulator_tpu.simulator import Simulator

        c = QuantumCircuit(4)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
        c.add_gate(GateInstance("Measure", [0], [], column=2))
        c.add_gate(GateInstance("Measure", [1], [], column=2))
        outs, sites, states = Simulator().monitored_trajectories(
            c, n_trajectories=50, seed=4)
        assert outs.shape == (50, 2)
        assert (outs[:, 0] == outs[:, 1]).all()
        assert sites == [(2, 0), (2, 1)]
        assert len(states) == 50


class TestHugePathEvolve:
    def test_chunked_matches_unchunked_same_key(self):
        # The chunked (n >= 30 schedule) evolve and the whole-state body
        # share the key schedule and the boundary-sampling code; the
        # same key must take the same branches (f32 prob rounding can
        # only flip a draw at ~1e-7 boundaries).
        from quantum_simulator_tpu.ops.bigtraj import (
            huge_trajectory_state_body,
        )
        from quantum_simulator_tpu.ops.monomial_traj import (
            monomial_insert_evolve_ok,
        )
        from quantum_simulator_tpu.ops.unitary_traj import (
            unitary_insert_evolve_ok,
        )

        c = brickwork(9, 3)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.2))
        p = prog.compile_circuit(c)
        assert not unitary_insert_evolve_ok(p, nm)
        assert monomial_insert_evolve_ok(p, nm)
        params = jnp.asarray(p.initial_params)
        for seed in range(4):
            key = jax.random.PRNGKey(seed)
            ref = np.asarray(monomial_trajectory_body(p, nm, params, key,
                                                      jnp.complex64))
            x, planar = huge_trajectory_state_body(p, nm, params, key,
                                                   n_chunks=2)
            got = np.asarray(x if not planar
                             else x[0] + 1j * x[1]).reshape(-1)
            got = got / np.sqrt(np.vdot(got, got).real)
            fid = abs(np.vdot(ref, got)) ** 2
            assert fid > 1 - 1e-5, (seed, fid)

    def test_huge_ensemble_matches_density_matrix(self):
        from quantum_simulator_tpu.density import DensityMatrixSimulator
        from quantum_simulator_tpu.ops.bigtraj import (
            huge_trajectory_state_body,
        )

        c = brickwork(4, 2)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.3))
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)

        def one(key):
            x, planar = huge_trajectory_state_body(p, nm, params, key,
                                                   n_chunks=2)
            flat = (x[0] + 1j * x[1] if planar else
                    x.astype(jnp.complex64)).reshape(-1)
            return jnp.abs(flat) ** 2

        probs = np.asarray(jax.jit(jax.vmap(one))(
            jax.random.split(jax.random.PRNGKey(2), 500))).mean(axis=0)
        dm = DensityMatrixSimulator(noise_model=nm).run(c)
        np.testing.assert_allclose(probs, dm.probabilities, atol=0.05)


class TestMonitoredGroupVsEinsumDirect:
    def test_group_monitored_fn_routing_guard(self):
        # Non-monomial noise at group widths must raise with guidance
        # (checked directly against the fn builder; _use_group_path is
        # GPU-only so call the body instead).
        nm = NoiseModel()
        nm.add_global_noise(_XBasisDamping(0.2))
        p = prog.compile_circuit(brickwork(4, 1))
        with pytest.raises(ValueError, match="non-monomial"):
            monomial_monitored_body(p, nm, ((0, 0),),
                                    jnp.asarray(p.initial_params),
                                    jax.random.PRNGKey(0))


class TestHugeMonitored:
    """n >= 30 monitored path (``bigtraj.huge_monitored_sample_fn``),
    validated at small n with chunking forced — same discipline as the
    other huge-path twins."""

    def _events_after(self, circuit, qubits):
        p = prog.compile_circuit(circuit)
        return tuple((len(p.ops), q) for q in qubits)

    def test_matches_monitored_body_same_key(self):
        from quantum_simulator_tpu.ops.bigtraj import (
            huge_monitored_sample_fn,
        )

        c = brickwork(9, 3)
        nm = NoiseModel()
        nm.add_global_noise(AmplitudeDampingNoise(0.1))
        p = prog.compile_circuit(c)
        events = ((10, 0), (len(p.ops), 4))
        params = jnp.asarray(p.initial_params)
        key = jax.random.PRNGKey(3)
        ref_state, ref_outs = monomial_monitored_body(
            p, nm, events, params, key, jnp.complex64)
        for n_chunks in (1, 2):
            fn, planar = huge_monitored_sample_fn(p, nm, events, 0,
                                                  n_chunks=n_chunks)
            outs = np.asarray(fn(params, key, jax.random.PRNGKey(9)))
            np.testing.assert_array_equal(outs, np.asarray(ref_outs))

    def test_shots_and_counts_ghz(self):
        from quantum_simulator_tpu.ops.bigtraj import (
            huge_monitored_sample_fn,
        )
        from quantum_simulator_tpu.ops.program import _NoNoise

        n = 8
        c = QuantumCircuit(n)
        c.add_gate(GateInstance("H", [0], [], column=0))
        for i in range(n - 1):
            c.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
        p = prog.compile_circuit(c)
        # measure q0 and q1 mid-circuit... after full entangling chain
        events = ((len(p.ops), 0), (len(p.ops), 1))
        fn, _ = huge_monitored_sample_fn(p, _NoNoise, events, 64,
                                         n_chunks=2)
        params = jnp.asarray(p.initial_params)
        ones = zeros = 0
        for s in range(12):
            outs, idx = fn(params, jax.random.PRNGKey(2 * s),
                           jax.random.PRNGKey(2 * s + 1))
            outs = np.asarray(outs)
            assert outs[0] == outs[1]  # GHZ: perfectly correlated
            idx = np.asarray(idx)
            # post-collapse state is |b>^n: every sample equals it
            want = 0 if outs[0] == 0 else (1 << n) - 1
            assert (idx == want).all()
            ones += int(outs[0] == 1)
            zeros += int(outs[0] == 0)
        assert ones > 0 and zeros > 0  # both branches occur in 12 draws

    def test_simulator_monitored_huge_helper(self):
        # _monitored_huge drives the loop + counts conversion (CPU:
        # _is_huge is GPU-gated, so call the helper directly).
        from quantum_simulator_tpu.simulator import Simulator

        n = 6
        c = QuantumCircuit(n)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
        c.add_gate(GateInstance("Measure", [0], [], column=2))
        c.add_gate(GateInstance("Measure", [1], [], column=2))
        p = prog.compile_circuit(c)
        sites = [(2, 0), (2, 1)]
        events = ((2, 0), (2, 1))
        sim = Simulator()
        outs, got_sites, counts = sim._monitored_huge(
            c, p, None, events, sites, 10, 7, 32)
        assert outs.shape == (10, 2)
        assert (outs[:, 0] == outs[:, 1]).all()
        assert got_sites == sites
        assert len(counts) == 10
        for t, cnt in enumerate(counts):
            b = int(outs[t, 0])
            want = format(b * ((1 << 2) - 1) << (n - 2), f"0{n}b")
            # post-collapse q0=q1=b, rest |0>: all 32 shots identical
            assert cnt == {want: 32}, (t, cnt)

    def test_final_shots_rejected_below_huge(self):
        from quantum_simulator_tpu.simulator import Simulator

        c = QuantumCircuit(3)
        c.add_gate(GateInstance("H", [0], [], column=0))
        c.add_gate(GateInstance("Measure", [0], [], column=1))
        with pytest.raises(ValueError, match="final_shots"):
            Simulator().monitored_trajectories(c, n_trajectories=2,
                                               seed=0, final_shots=16)
