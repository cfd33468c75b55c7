"""Interactive (edit-hot) forward path: skeleton-keyed executor reuse
(VERDICT r3 #6 — recompilation management, SURVEY §7).

A 1-gate edit that preserves the group plan's step skeleton must reuse
the compiled executor (no fresh XLA compile), and the interactive
result must match the fused (operands-in-trace) program exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantum_simulator_tpu.algorithms import AlgorithmTemplate
from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu.config import CONFIG
from quantum_simulator_tpu.ops import plan as P
from quantum_simulator_tpu.ops import program as prog


def brickwork(n, layers, *, rz=False, extra_gate=False):
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
    if extra_gate:
        c.add_gate(GateInstance("Rz", [2 * n // 3], [0.4], column=col))
    return c


def _no_measures(circuit):
    c = QuantumCircuit(circuit.num_qubits)
    for g in circuit.gates:
        if g.gate_name != "Measure":
            c.add_gate(g)
    return c


def _qft(n):
    return _no_measures(AlgorithmTemplate.quantum_fourier_transform(n))


def _grover(n, marked):
    return _no_measures(
        AlgorithmTemplate.grover_search(n, marked_state=marked,
                                        num_iterations=2))


def _fused_state(program):
    return np.asarray(P.group_forward_fn(program)(
        jnp.asarray(program.initial_params)))


def _interactive_state(program):
    fn = P.interactive_forward_fn(program)
    assert fn is not None
    return np.asarray(fn(jnp.asarray(program.initial_params)))


class TestInteractiveMatchesFused:
    @pytest.mark.parametrize("circuit", [
        brickwork(10, 3),                       # all-real (real state path)
        brickwork(10, 3, rz=True),              # planar
        _qft(8),                                # cphase diag-pair steps
        _grover(10, 5),                         # MCZ prod steps
    ], ids=["real-brickwork", "planar-brickwork", "qft8", "grover10"])
    def test_state_matches(self, circuit):
        p = prog.compile_circuit(circuit)
        ref = _fused_state(p)
        got = _interactive_state(p)
        np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_swap_bitpair(self):
        c = QuantumCircuit(10)
        for q in range(10):
            c.add_gate(GateInstance("H", [q], [], column=0))
        c.add_gate(GateInstance("SWAP", [0, 9], [], column=1))
        c.add_gate(GateInstance("Rz", [4], [0.3], column=2))
        p = prog.compile_circuit(c)
        np.testing.assert_allclose(_interactive_state(p), _fused_state(p),
                                   atol=1e-6)


class TestSkeletonReuse:
    def test_one_gate_edit_keeps_skeleton(self):
        pA = prog.compile_circuit(brickwork(12, 3, rz=True))
        pB = prog.compile_circuit(brickwork(12, 3, rz=True,
                                            extra_gate=True))
        assert pA.compile_key != pB.compile_key
        sA = P.plan_skeleton(P.get_group_plan(pA))
        sB = P.plan_skeleton(P.get_group_plan(pB))
        assert sA is not None and sA == sB

    def test_edit_reuses_compiled_executor(self):
        P._SKEL_CACHE.clear()
        pA = prog.compile_circuit(brickwork(11, 2, rz=True))
        pB = prog.compile_circuit(brickwork(11, 2, rz=True,
                                            extra_gate=True))
        _interactive_state(pA)
        assert len(P._SKEL_CACHE) == 1
        (fn,) = P._SKEL_CACHE.values()
        n_before = fn._cache_size()
        got = _interactive_state(pB)
        assert len(P._SKEL_CACHE) == 1
        assert fn._cache_size() == n_before  # no retrace for the edit
        np.testing.assert_allclose(got, _fused_state(pB), atol=1e-6)

    def test_param_edit_no_retrace(self):
        # Angle edits ride the operand inputs — same executor, no
        # retrace, correct amplitudes (incl. the traced MCZ/CPhase
        # phase scalars on the prod path).
        P._SKEL_CACHE.clear()
        c1 = _grover(9, 3)
        p1 = prog.compile_circuit(c1)
        _interactive_state(p1)
        (fn,) = P._SKEL_CACHE.values()
        n_before = fn._cache_size()
        c2 = _grover(9, 3)
        for g in c2.gates:
            if g.gate_name == "Ry":
                g.params[0] += 0.1
        p2 = prog.compile_circuit(c2)
        got = _interactive_state(p2)
        assert fn._cache_size() == n_before
        np.testing.assert_allclose(got, _fused_state(p2), atol=1e-6)


class TestRouting:
    def test_flag_routes_uncompiled_structures(self):
        c = brickwork(10, 2)
        c.add_gate(GateInstance("Phase", [1], [0.123],
                                column=max(g.column for g in c.gates) + 1))
        p = prog.compile_circuit(c)
        key = ("group-plan", p.compile_key, str(CONFIG.dtype))
        P._PLAN_CACHE.pop(key, None)
        old = CONFIG.interactive
        CONFIG.interactive = True
        try:
            fn = P.group_forward_fn(p)
            assert key not in P._PLAN_CACHE  # served by the skeleton path
            got = np.asarray(fn(jnp.asarray(p.initial_params)))
        finally:
            CONFIG.interactive = old
        np.testing.assert_allclose(got, _fused_state(p), atol=1e-6)

    def test_fused_cache_takes_precedence(self):
        p = prog.compile_circuit(brickwork(10, 2, rz=True))
        fused = P.group_forward_fn(p)  # compiles + caches
        old = CONFIG.interactive
        CONFIG.interactive = True
        try:
            assert P.group_forward_fn(p) is fused
        finally:
            CONFIG.interactive = old

    def test_interactive_noisy_trajectory_matches_fused(self):
        from quantum_simulator_tpu.noise import (
            DepolarizingNoise,
            NoiseModel,
        )
        from quantum_simulator_tpu.ops.unitary_traj import (
            interactive_trajectory_fn,
            unitary_insert_trajectory_body,
        )

        c = brickwork(9, 2, rz=True)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        p = prog.compile_circuit(c)
        fn = interactive_trajectory_fn(p, nm)
        assert fn is not None
        params = jnp.asarray(p.initial_params)
        for seed in (0, 3):
            key = jax.random.PRNGKey(seed)
            got = np.asarray(fn(params, key))
            ref = np.asarray(unitary_insert_trajectory_body(
                p, nm, params, key))
            # the interactive executor skips the final exact
            # normalization pass (f32 drift only)
            np.testing.assert_allclose(got / np.linalg.norm(got), ref,
                                       atol=2e-6)

    def test_interactive_noisy_edit_reuses_executor(self):
        from quantum_simulator_tpu.noise import (
            DepolarizingNoise,
            NoiseModel,
        )
        from quantum_simulator_tpu.ops.unitary_traj import (
            interactive_trajectory_fn,
        )

        P._SKEL_CACHE.clear()
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        pA = prog.compile_circuit(brickwork(9, 2, rz=True))
        pB = prog.compile_circuit(brickwork(9, 2, rz=True,
                                            extra_gate=True))
        fA = interactive_trajectory_fn(pA, nm)
        fA(jnp.asarray(pA.initial_params), jax.random.PRNGKey(0))
        assert len(P._SKEL_CACHE) == 1
        (fn,) = P._SKEL_CACHE.values()
        n_before = fn._cache_size()
        fB = interactive_trajectory_fn(pB, nm)
        out = fB(jnp.asarray(pB.initial_params), jax.random.PRNGKey(1))
        assert len(P._SKEL_CACHE) == 1
        assert fn._cache_size() == n_before
        assert np.isfinite(np.asarray(out)).all()

    def test_interactive_batched_trajectories_match(self, monkeypatch):
        from quantum_simulator_tpu.noise import (
            DepolarizingNoise,
            NoiseModel,
        )
        from quantum_simulator_tpu.ops.unitary_traj import (
            unitary_insert_trajectory_body,
        )

        # The group path is GPU-gated; force it so the interactive
        # batched loop executes under the CPU test mesh too.
        monkeypatch.setattr(prog, "_use_group_path", lambda _p: True)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        p = prog.compile_circuit(brickwork(8, 2, rz=True))
        params = jnp.asarray(p.initial_params)
        keys = jax.random.split(jax.random.PRNGKey(2), 3)
        cache_key = ("vtraj", p.compile_key, nm.spec_key(),
                     str(CONFIG.dtype), False, True)
        prog._CACHE.pop(cache_key, None)
        old = CONFIG.interactive
        CONFIG.interactive = True
        try:
            batched = prog.batched_trajectories_fn(p, nm)(params, keys)
            assert cache_key not in prog._CACHE  # interactive loop
        finally:
            CONFIG.interactive = old
        ref = np.stack([
            np.asarray(unitary_insert_trajectory_body(p, nm, params, k))
            for k in keys])
        got = np.asarray(batched)
        got = got / np.linalg.norm(got, axis=1, keepdims=True)
        np.testing.assert_allclose(got, ref, atol=2e-6)

    def test_generic_step_returns_none(self):
        # A non-diagonal 3-axis gate needs GenericStep: no skeleton.
        rng = np.random.default_rng(0)
        m = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
        q, _ = np.linalg.qr(m)
        from quantum_simulator_tpu.gates import GateDefinition, GateType
        from quantum_simulator_tpu.registry import GateRegistry
        reg = GateRegistry.instance()
        reg.register(GateDefinition(
            name="G3AXES_TEST", display_name="G3", gate_type=GateType.MULTI,
            num_qubits=3, num_params=0, param_names=(),
            matrix_func=lambda: q, symbol="G3", color="#888888"))
        try:
            c = QuantumCircuit(18)
            c.add_gate(GateInstance("G3AXES_TEST", [0, 8, 17], [],
                                    column=0))
            p = prog.compile_circuit(c)
            plan = P.get_group_plan(p)
            if any(isinstance(s, P.GenericStep) for s in plan.steps):
                assert P.plan_skeleton(plan) is None
                assert P.interactive_forward_fn(p) is None
            else:  # layout kept it under 3 axes: still a valid skeleton
                assert P.plan_skeleton(plan) is not None
        finally:
            reg.reset()
