"""Singleton gate registry.

Parity target: ``/root/reference/quantum_sim/engine/gate_registry.py:14-173``
(21 built-in gates including Measure/Barrier, runtime-registrable custom
gates, ``reset()`` for test isolation).

Note: custom gates registered at runtime participate in circuit
compilation — their (static) matrices are baked into the traced program,
and ``compile_circuit`` folds those matrix bytes into its compile key
(``ops/program.py``), so re-registering a gate with a new matrix never
hits a stale compiled program. (``circuit_hash`` is the reference-
invalidation key, ``structure_hash`` the jit cache key — see CLAUDE.md.)
"""

from __future__ import annotations

from .gates import (
    CNOT_MATRIX,
    CZ_MATRIX,
    FREDKIN_MATRIX,
    GateDefinition,
    GateType,
    H_MATRIX,
    I_MATRIX,
    JNP_BUILDERS,
    S_DAG_MATRIX,
    S_MATRIX,
    SWAP_MATRIX,
    T_DAG_MATRIX,
    T_MATRIX,
    TOFFOLI_MATRIX,
    X_MATRIX,
    Y_MATRIX,
    Z_MATRIX,
    _const,
    cphase_matrix,
    phase_matrix,
    rx_matrix,
    ry_matrix,
    rz_matrix,
    u3_matrix,
)


def _single(name, display, mat, symbol, color):
    return GateDefinition(
        name=name, display_name=display, gate_type=GateType.SINGLE,
        num_qubits=1, num_params=0, param_names=(),
        matrix_func=_const(mat), symbol=symbol, color=color,
    )


def _param(name, display, func, n_params, param_names, symbol, color):
    return GateDefinition(
        name=name, display_name=display, gate_type=GateType.SINGLE,
        num_qubits=1, num_params=n_params, param_names=param_names,
        matrix_func=func, symbol=symbol, color=color,
        jnp_matrix_func=JNP_BUILDERS.get(name),
    )


class GateRegistry:
    """Singleton registry mapping gate names to GateDefinition objects."""

    _instance: GateRegistry | None = None

    def __init__(self):
        self._gates: dict[str, GateDefinition] = {}

    @classmethod
    def instance(cls) -> GateRegistry:
        if cls._instance is None:
            cls._instance = cls()
            cls._instance._register_builtins()
        return cls._instance

    @classmethod
    def reset(cls):
        """Reset the singleton (for testing)."""
        cls._instance = None

    def _register_builtins(self):
        for args in [
            ("I", "Identity", I_MATRIX, "I", "#888888"),
            ("H", "Hadamard", H_MATRIX, "H", "#4A90D9"),
            ("X", "Pauli-X", X_MATRIX, "X", "#E74C3C"),
            ("Y", "Pauli-Y", Y_MATRIX, "Y", "#2ECC71"),
            ("Z", "Pauli-Z", Z_MATRIX, "Z", "#3498DB"),
            ("S", "S Gate", S_MATRIX, "S", "#9B59B6"),
            ("S_DAG", "S† Gate", S_DAG_MATRIX, "S†", "#8E44AD"),
            ("T", "T Gate", T_MATRIX, "T", "#E67E22"),
            ("T_DAG", "T† Gate", T_DAG_MATRIX, "T†", "#D35400"),
        ]:
            self.register(_single(*args))

        self.register(_param("Rx", "Rotation-X", rx_matrix, 1, ("θ",), "Rx", "#E91E63"))
        self.register(_param("Ry", "Rotation-Y", ry_matrix, 1, ("θ",), "Ry", "#00BCD4"))
        self.register(_param("Rz", "Rotation-Z", rz_matrix, 1, ("θ",), "Rz", "#FF9800"))
        self.register(_param("Phase", "Phase Gate", phase_matrix, 1, ("φ",), "P", "#795548"))
        self.register(
            _param("U3", "Universal U3", u3_matrix, 3,
                   ("θ", "φ", "λ"), "U3", "#607D8B")
        )

        self.register(GateDefinition(
            name="CPhase", display_name="Controlled-Phase",
            gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=1, param_names=("φ",),
            matrix_func=cphase_matrix, symbol="CP", color="#5D4037",
            num_controls=1, num_targets=1,
            jnp_matrix_func=JNP_BUILDERS.get("CPhase")))
        self.register(GateDefinition(
            name="CNOT", display_name="Controlled-NOT", gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(CNOT_MATRIX), symbol="CX", color="#FF5722",
            num_controls=1, num_targets=1))
        self.register(GateDefinition(
            name="CZ", display_name="Controlled-Z", gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(CZ_MATRIX), symbol="CZ", color="#673AB7",
            num_controls=1, num_targets=1))
        self.register(GateDefinition(
            name="SWAP", display_name="SWAP", gate_type=GateType.MULTI,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(SWAP_MATRIX), symbol="SW", color="#009688",
            num_controls=0, num_targets=2))
        self.register(GateDefinition(
            name="Toffoli", display_name="Toffoli (CCX)", gate_type=GateType.CONTROLLED,
            num_qubits=3, num_params=0, param_names=(),
            matrix_func=_const(TOFFOLI_MATRIX), symbol="CCX", color="#F44336",
            num_controls=2, num_targets=1))
        self.register(GateDefinition(
            name="Fredkin", display_name="Fredkin (CSWAP)", gate_type=GateType.CONTROLLED,
            num_qubits=3, num_params=0, param_names=(),
            matrix_func=_const(FREDKIN_MATRIX), symbol="CSW", color="#4CAF50",
            num_controls=1, num_targets=2))

        self.register(GateDefinition(
            name="Measure", display_name="Measurement", gate_type=GateType.MEASUREMENT,
            num_qubits=1, num_params=0, param_names=(),
            matrix_func=_const(I_MATRIX), symbol="M", color="#FFC107"))
        self.register(GateDefinition(
            name="Barrier", display_name="Barrier", gate_type=GateType.BARRIER,
            num_qubits=1, num_params=0, param_names=(),
            matrix_func=_const(I_MATRIX), symbol="||", color="#BDBDBD"))

    def register(self, gate_def: GateDefinition):
        self._gates[gate_def.name] = gate_def

    def get(self, name: str) -> GateDefinition:
        if name not in self._gates:
            # MCZ_k gates are synthesized on demand so circuits saved
            # with them (Grover) deserialize in a fresh process
            import re as _re

            m = _re.fullmatch(r"MCZ(\d+)", name)
            if m and 2 <= int(m.group(1)) <= 10:
                from .gates import _const, mcz_matrix

                k = int(m.group(1))
                self.register(GateDefinition(
                    name=name,
                    display_name=f"Multi-Controlled-Z ({k})",
                    gate_type=GateType.CONTROLLED, num_qubits=k,
                    num_params=0, param_names=(),
                    matrix_func=_const(mcz_matrix(k)),
                    symbol="MCZ", color="#455A64",
                    num_controls=k - 1, num_targets=1))
                return self._gates[name]
            if m and 10 < int(m.group(1)) <= 32:
                # Wide MCZ: the dense 2^k x 2^k matrix is unaffordable
                # (4 GiB of host diag at k=14, 68 GiB at k=16); register
                # a matrix-less definition carrying only the controlled
                # phase. Executors apply it as a bit-mask elementwise
                # pass (dense stops at k=10 = 16 MB, where existing
                # serialized circuits still get byte-identical matrices).
                k = int(m.group(1))

                def _no_matrix(*_a, _k=k):
                    raise MemoryError(
                        f"MCZ{_k} has no dense matrix (2^{_k} x 2^{_k}); "
                        "it is applied as an elementwise phase pass")

                self.register(GateDefinition(
                    name=name,
                    display_name=f"Multi-Controlled-Z ({k})",
                    gate_type=GateType.CONTROLLED, num_qubits=k,
                    num_params=0, param_names=(),
                    matrix_func=_no_matrix,
                    symbol="MCZ", color="#455A64",
                    num_controls=k - 1, num_targets=1,
                    cphase_value=-1.0 + 0.0j))
                return self._gates[name]
            # ExpP[<pauli string>] evolution gates likewise synthesize
            # on demand, so Trotter circuits deserialize in a fresh
            # process (models/trotter.py registers them lazily anyway).
            # Length bound matches trotter._MAX_SITES: longer names
            # stay KeyError (the contract auto_detect-style callers
            # rely on), not a ValueError from the builder.
            m = _re.fullmatch(r"ExpP\[([IXYZ]{1,8})\]", name)
            if m:
                from .models.trotter import exp_pauli_gate

                exp_pauli_gate(m.group(1))  # registers `name`
                return self._gates[name]
            raise KeyError(f"Gate '{name}' not found in registry")
        return self._gates[name]

    def all_gates(self) -> list[GateDefinition]:
        return list(self._gates.values())

    def single_qubit_gates(self) -> list[GateDefinition]:
        return [g for g in self._gates.values() if g.gate_type == GateType.SINGLE]

    def multi_qubit_gates(self) -> list[GateDefinition]:
        return [g for g in self._gates.values()
                if g.gate_type in (GateType.CONTROLLED, GateType.MULTI)]

    def parameterized_gates(self) -> list[GateDefinition]:
        return [g for g in self._gates.values() if g.num_params > 0]

    def gate_names(self) -> list[str]:
        return list(self._gates.keys())
