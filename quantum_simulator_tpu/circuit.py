"""Circuit intermediate representation.

Parity target: ``/root/reference/quantum_sim/engine/circuit.py:9-173``
(GateInstance / QuantumCircuit, column-as-time-step layout, shared
``compute_layers`` / ``gate_to_layer_map`` layer definition, structure hash,
JSON serde version "1.0" with ``initial_states`` omitted when all zero).

Design difference: ``circuit_hash()`` is the **jit compile-cache key** —
a circuit with the same structure but different gate parameters re-uses the
same lowered XLA program (parameters are a runtime vector). The reference
uses the hash only to invalidate its fidelity reference
(``reference.py:99-113``); here it also keys compiled executables.

The reference enforces 1–16 qubits (``circuit.py:130``); this engine raises
the cap to ``config.CONFIG.max_qubits`` (default 32) because amplitude
vectors shard over a device mesh (see ``parallel/``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .config import CONFIG

SERDE_VERSION = "1.0"


@dataclass
class GateInstance:
    """One placed gate: name, target qubits, params, and time column."""

    gate_name: str
    target_qubits: list[int]
    params: list[float] = field(default_factory=list)
    column: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.gate_name,
            "targets": self.target_qubits,
            "params": self.params,
            "column": self.column,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "GateInstance":
        return cls(
            gate_name=data["name"],
            target_qubits=list(data["targets"]),
            params=list(data.get("params", [])),
            column=data.get("column", 0),
        )

    def structure_key(self) -> tuple:
        """Static identity for compile caching (params excluded — they are
        runtime inputs to the compiled program)."""
        return (self.gate_name, tuple(self.target_qubits), self.column)


def _validated_qubit_count(n: int) -> int:
    # Structural cap only: amplitude engines re-validate against
    # CONFIG.max_qubits at their own entries (simulator.py, state.py);
    # the tableau/frame engines legitimately run hundreds of qubits.
    if n < 1 or n > CONFIG.max_circuit_qubits:
        raise ValueError(
            f"num_qubits must be 1-{CONFIG.max_circuit_qubits}, got {n}")
    return n


@dataclass
class QuantumCircuit:
    """Gate list on ``num_qubits`` qubits; a column is one time step."""

    num_qubits: int = 4
    gates: list[GateInstance] = field(default_factory=list)
    initial_states: list[int] = field(default_factory=list)

    def __post_init__(self):
        _validated_qubit_count(self.num_qubits)
        pad = self.num_qubits - len(self.initial_states)
        if pad > 0:
            self.initial_states = list(self.initial_states) + [0] * pad
        else:
            self.initial_states = list(self.initial_states[: self.num_qubits])

    # --- mutation -----------------------------------------------------

    def add_gate(self, gate: GateInstance) -> None:
        self.gates.append(gate)

    def add(self, gate_name: str, targets: list[int],
            params: list[float] | None = None,
            column: int | None = None) -> GateInstance:
        """Fluent helper: append a gate at the given (or next free) column."""
        col = self.get_column_count() if column is None else column
        inst = GateInstance(gate_name, list(targets), list(params or []), col)
        self.gates.append(inst)
        return inst

    def remove_gate(self, gate: GateInstance) -> None:
        if gate in self.gates:
            self.gates.remove(gate)

    def move_gate(self, gate: GateInstance, new_col: int,
                  new_targets: list[int]) -> None:
        if gate in self.gates:
            gate.column = new_col
            gate.target_qubits = new_targets

    def clear(self) -> None:
        self.gates.clear()

    def set_num_qubits(self, n: int) -> None:
        _validated_qubit_count(n)
        self.gates = [g for g in self.gates
                      if max(g.target_qubits, default=0) < n]
        self.num_qubits = n
        pad = n - len(self.initial_states)
        if pad > 0:
            self.initial_states += [0] * pad
        else:
            self.initial_states = self.initial_states[:n]

    def toggle_qubit_initial_state(self, qubit: int) -> None:
        if 0 <= qubit < self.num_qubits:
            self.initial_states[qubit] ^= 1

    def set_qubit_initial_state(self, qubit: int, state: int) -> None:
        if 0 <= qubit < self.num_qubits and state in (0, 1):
            self.initial_states[qubit] = state

    # --- structure queries ---------------------------------------------

    def get_column_count(self) -> int:
        return 0 if not self.gates else max(g.column for g in self.gates) + 1

    def get_gates_at_column(self, col: int) -> list[GateInstance]:
        return [g for g in self.gates if g.column == col]

    def get_ordered_gates(self) -> list[list[GateInstance]]:
        """Gates grouped by column, columns ascending, empty columns dropped;
        within a column sorted by first target qubit (reference
        ``circuit.py:69-79`` ordering contract)."""
        by_col: dict[int, list[GateInstance]] = {}
        for g in self.gates:
            by_col.setdefault(g.column, []).append(g)
        return [sorted(by_col[c], key=lambda g: g.target_qubits[0])
                for c in sorted(by_col)]

    def compute_layers(self) -> list[list[int]]:
        """Layers = gate-index groups by column (shared definition used by
        optimizer / debugger / entropy panels; reference ``circuit.py:81``)."""
        by_col: dict[int, list[int]] = {}
        for gi, g in enumerate(self.gates):
            by_col.setdefault(g.column, []).append(gi)
        return [by_col[c] for c in sorted(by_col)]

    def gate_to_layer_map(self) -> list[int]:
        mapping = [0] * len(self.gates)
        for layer_idx, indices in enumerate(self.compute_layers()):
            for gi in indices:
                mapping[gi] = layer_idx
        return mapping

    def gate_count(self) -> int:
        return len(self.gates)

    def depth(self) -> int:
        """Number of non-empty columns."""
        return len({g.column for g in self.gates})

    def circuit_hash(self) -> int:
        """Structure hash: qubit count, initial states, and every gate
        (name, targets, params, column). Used for reference invalidation
        AND as part of the jit compile-cache key."""
        parts: list = [self.num_qubits, tuple(self.initial_states)]
        parts.extend(
            (g.gate_name, tuple(g.target_qubits), tuple(g.params), g.column)
            for g in self.gates
        )
        return hash(tuple(parts))

    def structure_hash(self) -> int:
        """Like ``circuit_hash`` but parameter-independent: the compile key.

        Two circuits with identical gate placement but different rotation
        angles lower to the same XLA executable.
        """
        parts: list = [self.num_qubits, tuple(self.initial_states)]
        parts.extend(g.structure_key() + (len(g.params),) for g in self.gates)
        return hash(tuple(parts))

    # --- serde ----------------------------------------------------------

    def to_dict(self) -> dict:
        d: dict = {
            "version": SERDE_VERSION,
            "num_qubits": self.num_qubits,
            "gates": [g.to_dict() for g in self.gates],
        }
        if any(self.initial_states):
            d["initial_states"] = self.initial_states
        return d

    @classmethod
    def from_dict(cls, data: dict) -> "QuantumCircuit":
        circuit = cls(
            num_qubits=data["num_qubits"],
            initial_states=list(data.get("initial_states", [])),
        )
        for g_data in data.get("gates", []):
            circuit.add_gate(GateInstance.from_dict(g_data))
        return circuit

    def copy(self) -> "QuantumCircuit":
        c = QuantumCircuit(self.num_qubits,
                           initial_states=list(self.initial_states))
        c.gates = [GateInstance(g.gate_name, list(g.target_qubits),
                                list(g.params), g.column) for g in self.gates]
        return c
