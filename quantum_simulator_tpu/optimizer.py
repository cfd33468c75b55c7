"""Variational optimization: VQE/QAOA cost functions, gradients, Adam.

Parity target: ``/root/reference/quantum_sim/engine/optimizer.py:28-559``
(ParameterBinding / auto_detect naming ``Gate[i].pj``, CostFunction
factories, parameter-shift ±π/2 with 1/(2 sin s) coefficient, central
finite difference, Adam with bias correction, convergence on |Δcost| < tol,
best-iterate selection, request_stop, barren-plateau variance analysis with
layer/qubit grouping and 1e-4 threshold).

Design differences — this module is the largest win over the reference:

* **Autodiff**: circuits compile with their parameter vector as a runtime
  input, so ``jax.grad`` differentiates straight through the gate matrices.
  One compiled value_and_grad program replaces 2P re-simulations per step
  (``gradient_method="autodiff"``).
* **Batched parameter-shift**: when requested (or for U3-style gates where
  the 2-point shift rule is not exact), all 2P shifted circuits evaluate as
  ONE vmapped device launch — no deepcopies, no Python loop
  (the reference re-simulates serially, ``optimizer.py:213-227``).
* **Batched plateau sampling**: all n_samples × 2P gradient evaluations run
  as chunked device batches.

Cost functions carry both a host callable ``(StateVector) -> float`` (drop-in
parity) and a traceable ``device_fn(psi, n)`` used inside compiled programs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .analysis import StateAnalysis
from .circuit import QuantumCircuit
from .gates import I_MATRIX, X_MATRIX, Y_MATRIX, Z_MATRIX
from .ops import program as prog
from .ops.apply import apply_gate
from .registry import GateRegistry
from .simulator import Simulator
from .state import StateVector
from .utils.xfer import to_device_complex

_PAULI_NP = {"I": I_MATRIX, "X": X_MATRIX, "Y": Y_MATRIX, "Z": Z_MATRIX}


# ---------------------------------------------------------------------------
# Parameter binding
# ---------------------------------------------------------------------------

@dataclass
class ParameterBinding:
    """Maps an optimization variable to a gate parameter slot."""

    gate_index: int
    param_index: int
    name: str = ""


class ParameterizedCircuitConfig:
    """A circuit plus the list of its tunable parameters."""

    def __init__(self, circuit: QuantumCircuit,
                 bindings: list[ParameterBinding]):
        self._circuit = circuit
        self._bindings = bindings

    @property
    def circuit(self) -> QuantumCircuit:
        return self._circuit

    @property
    def bindings(self) -> list[ParameterBinding]:
        return self._bindings

    @property
    def num_params(self) -> int:
        return len(self._bindings)

    def get_values(self) -> np.ndarray:
        vals = np.zeros(self.num_params)
        for i, b in enumerate(self._bindings):
            vals[i] = self._circuit.gates[b.gate_index].params[b.param_index]
        return vals

    def bind_values(self, values: np.ndarray) -> QuantumCircuit:
        """Copy of the circuit with parameters set (host path; the compiled
        path scatters values into the program parameter vector instead)."""
        qc = self._circuit.copy()
        for i, b in enumerate(self._bindings):
            qc.gates[b.gate_index].params[b.param_index] = float(values[i])
        return qc

    @classmethod
    def auto_detect(cls, circuit: QuantumCircuit
                    ) -> "ParameterizedCircuitConfig":
        """Bind every parameter of every registered parameterized gate,
        named ``Gate[i].pj``."""
        registry = GateRegistry.instance()
        bindings = []
        for gi, gate in enumerate(circuit.gates):
            try:
                gate_def = registry.get(gate.gate_name)
            except KeyError:
                continue
            for pi in range(gate_def.num_params):
                bindings.append(ParameterBinding(
                    gi, pi, f"{gate.gate_name}[{gi}].p{pi}"))
        return cls(circuit, bindings)

    # --- compiled-path plumbing -----------------------------------------

    def compiled(self):
        """(program, offsets) where offsets[i] is the program-param position
        of binding i — or None if any bound gate was baked statically."""
        program = prog.compile_circuit(self._circuit)
        offsets = []
        for b in self._bindings:
            off = program.param_offset_for(b.gate_index, b.param_index)
            if off is None:
                return program, None
            offsets.append(off)
        return program, np.asarray(offsets, dtype=np.int32)


class MPSParameterizedConfig(ParameterizedCircuitConfig):
    """A parameterized circuit whose cost evaluations run on the MPS
    engine (``mps.build_batched_cost_fn``) instead of a dense 2^n
    state — variational optimization at 50+ qubits, far past the
    amplitude engines' wall (and the reference's 16-qubit cap,
    ``/root/reference/quantum_sim/engine/circuit.py:130``).

    Works with every ``CircuitOptimizer`` surface that evaluates costs
    in batch: ``run``/``step`` with ``gradient_method`` of
    "parameter_shift" or "finite_difference", and the barren-plateau
    detectors.  The cost must be Hamiltonian-shaped (built by
    ``CostFunction.vqe_hamiltonian`` / ``qaoa_maxcut`` /
    ``z_expectation``, which carry their Pauli terms).  Reverse-mode
    paths ("autodiff", ``multi_start``) are rejected: differentiating
    through truncated SVDs divides by Schmidt-value gaps that circuits
    started from product states routinely make zero."""

    def __init__(self, circuit: QuantumCircuit,
                 bindings: list[ParameterBinding], chi: int = 64):
        super().__init__(circuit, bindings)
        if chi < 1:
            raise ValueError("chi must be >= 1")
        self.chi = chi

    engine = "mps"

    @classmethod
    def auto_detect(cls, circuit: QuantumCircuit,
                    chi: int = 64) -> "MPSParameterizedConfig":
        base = ParameterizedCircuitConfig.auto_detect(circuit)
        return cls(base.circuit, base.bindings, chi=chi)

    def compiled(self):
        raise ValueError(
            "MPSParameterizedConfig has no dense compiled program; use "
            "gradient_method='parameter_shift' or 'finite_difference' "
            "(autodiff/multi_start need the statevector engine)")


# ---------------------------------------------------------------------------
# Cost functions (host callable + traceable device body)
# ---------------------------------------------------------------------------

class DeviceCost:
    """A cost with a host API (StateVector -> float) and a traceable
    ``device_fn(psi, num_qubits) -> scalar`` for compiled programs.

    Hamiltonian-shaped costs additionally carry ``terms`` (the
    ``(coeff, pauli_string, qubits)`` list) and a scalar ``constant``
    offset, so engines that never materialize a 2^n state — the MPS
    variational path (``mps.build_batched_cost_fn``) — can evaluate the
    same cost from its operator description."""

    _counter = 0

    def __init__(self, host_fn: Callable[[StateVector], float],
                 device_fn: Callable | None = None,
                 key: tuple | None = None,
                 terms: list | None = None,
                 constant: float = 0.0):
        self._host_fn = host_fn
        self.device_fn = device_fn
        self.terms = terms
        self.constant = float(constant)
        if key is None:
            DeviceCost._counter += 1
            key = ("anon", DeviceCost._counter)
        self.key = key

    def __call__(self, state: StateVector) -> float:
        return self._host_fn(state)


def _pauli_string_device(psi, pauli_str: str, qubits: list[int], n: int):
    """<psi| P |psi> for a Pauli string applied via sequential single-qubit
    gate applications (no kron blow-up)."""
    opsi = psi
    for p, q in zip(pauli_str, qubits):
        if p == "I":
            continue
        mat = jnp.asarray(_PAULI_NP[p], dtype=psi.dtype)
        opsi = apply_gate(opsi, mat, (int(q),), n)
    # elementwise conj-sum: jnp.vdot would run at the default matmul
    # precision (TF32 on the GPU)
    return jnp.real(jnp.sum(jnp.conj(psi) * opsi))


class CostFunction:
    """Factories building DeviceCost objects (reference API shape)."""

    @staticmethod
    def expectation_value(observable: np.ndarray,
                          target_qubits: list[int]) -> DeviceCost:
        obs_np = np.asarray(observable, dtype=np.complex128)
        targets = tuple(int(q) for q in target_qubits)

        def host(state: StateVector) -> float:
            return float(np.real(StateAnalysis.expectation_value(
                state, obs_np, list(targets))))

        def device(psi, n):
            mat = jnp.asarray(obs_np, dtype=psi.dtype)
            opsi = apply_gate(psi, mat, targets, n)
            return jnp.real(jnp.sum(jnp.conj(psi) * opsi))

        return DeviceCost(host, device,
                          key=("expval", targets, obs_np.tobytes()))

    @staticmethod
    def state_fidelity(target_state: np.ndarray) -> DeviceCost:
        """Cost = 1 - |<target|psi>|^2."""
        target_np = np.asarray(target_state, dtype=np.complex128)

        def host(state: StateVector) -> float:
            return 1.0 - StateAnalysis.state_fidelity(target_np, state.data)

        def device(psi, n):
            target = jnp.asarray(target_np, dtype=psi.dtype)
            return 1.0 - jnp.abs(jnp.sum(jnp.conj(target) * psi)) ** 2

        return DeviceCost(host, device, key=("fid", target_np.tobytes()))

    @staticmethod
    def z_expectation(qubit: int) -> DeviceCost:
        # Via the Pauli-string dispatch so it also evaluates on n >= 30
        # PlanarStateVector states (same numerics as the dense matrix).
        return CostFunction.vqe_hamiltonian([(1.0, "Z", [qubit])])

    @staticmethod
    def vqe_hamiltonian(terms: list[tuple[float, str, list[int]]]
                        ) -> DeviceCost:
        """Cost = sum_i c_i <P_i> for Pauli strings P_i."""
        terms = [(float(c), str(p).upper(), [int(q) for q in qs])
                 for c, p, qs in terms]

        def host(state) -> float:
            # Unified Pauli-string dispatch: dense StateVector (kron +
            # gate trick) or n >= 30 PlanarStateVector (chunked signed-
            # permutation pass) — VQE Hamiltonians work at every n the
            # engine can hold. Identity factors drop out analytically.
            total = 0.0
            for coeff, pauli_str, qubits in terms:
                live = [(p, q) for p, q in zip(pauli_str, qubits)
                        if p != "I"]
                if not live:
                    total += coeff
                    continue
                total += coeff * StateAnalysis.pauli_string_expectation(
                    state, [q for _, q in live],
                    "".join(p for p, _ in live))
            return total

        def device(psi, n):
            total = jnp.zeros((), dtype=jnp.float32)
            for coeff, pauli_str, qubits in terms:
                total = total + coeff * _pauli_string_device(
                    psi, pauli_str, qubits, n)
            return total

        key = ("vqe", tuple((c, p, tuple(q)) for c, p, q in terms))
        return DeviceCost(host, device, key=key, terms=terms)

    @staticmethod
    def qaoa_maxcut(edges: list[tuple[int, int]]) -> DeviceCost:
        """C = sum_{(i,j) in E} (1 - <Z_i Z_j>) / 2 (maximize cut =
        minimize -C; this returns C as the reference does)."""
        edges = [(int(i), int(j)) for i, j in edges]
        terms = [(-0.5, "ZZ", [i, j]) for i, j in edges]
        zz_part = CostFunction.vqe_hamiltonian(terms)

        def host(state: StateVector) -> float:
            return len(edges) * 0.5 + zz_part(state)

        def device(psi, n):
            return len(edges) * 0.5 + zz_part.device_fn(psi, n)

        return DeviceCost(host, device, key=("maxcut", tuple(edges)),
                          terms=terms, constant=len(edges) * 0.5)


# ---------------------------------------------------------------------------
# Batched evaluation plumbing
# ---------------------------------------------------------------------------

_BATCH_COST_CACHE: dict[tuple, Callable] = {}


def _batched_cost_fn(program, cost: DeviceCost, offsets: np.ndarray):
    """jitted ``f(values_batch[B, K]) -> costs[B]`` evaluating the circuit
    + cost at many binding-value points in one launch."""
    key = ("bcost", program.compile_key, cost.key, offsets.tobytes())
    fn = _BATCH_COST_CACHE.get(key)
    if fn is None:
        base = jnp.asarray(program.initial_params)
        off = jnp.asarray(offsets)
        n = program.num_qubits

        def one(values):
            params = base.at[off].set(values.astype(base.dtype)) \
                if offsets.size else base
            psi = prog.forward_body(program, params)
            return cost.device_fn(psi, n)

        fn = jax.jit(jax.vmap(one))
        if len(_BATCH_COST_CACHE) > 64:
            _BATCH_COST_CACHE.pop(next(iter(_BATCH_COST_CACHE)))
        _BATCH_COST_CACHE[key] = fn
    return fn


def _value_and_grad_fn(program, cost: DeviceCost, offsets: np.ndarray):
    """jitted autodiff ``f(values[K]) -> (cost, grad[K])``."""
    key = ("vag", program.compile_key, cost.key, offsets.tobytes())
    fn = _BATCH_COST_CACHE.get(key)
    if fn is None:
        base = jnp.asarray(program.initial_params)
        off = jnp.asarray(offsets)
        n = program.num_qubits

        def scalar(values):
            params = base.at[off].set(values.astype(base.dtype)) \
                if offsets.size else base
            psi = prog.forward_body(program, params)
            return cost.device_fn(psi, n)

        fn = jax.jit(jax.value_and_grad(scalar))
        if len(_BATCH_COST_CACHE) > 64:
            _BATCH_COST_CACHE.pop(next(iter(_BATCH_COST_CACHE)))
        _BATCH_COST_CACHE[key] = fn
    return fn


def _multi_start_fn(program, cost: DeviceCost, offsets: np.ndarray,
                    n_iter: int):
    """jitted ``f(inits[S, K], lr, beta1, beta2) -> (best_values[S, K],
    best_costs[S], cost_histories[S, n_iter])`` — the ENTIRE Adam
    optimization of every start runs as one device program: a
    ``lax.scan`` over iterations of autodiff value_and_grad, vmapped
    over starts.  Best-iterate selection happens in-carry (matching
    ``CircuitOptimizer.run``'s best-of-history semantics).  The
    hyperparameters are runtime scalars; only (program, cost, offsets,
    n_iter) fork compiles."""
    key = ("mstart", program.compile_key, cost.key, offsets.tobytes(),
           n_iter)
    fn = _BATCH_COST_CACHE.get(key)
    if fn is None:
        base = jnp.asarray(program.initial_params)
        off = jnp.asarray(offsets)
        n = program.num_qubits

        def scalar(values):
            params = base.at[off].set(values.astype(base.dtype)) \
                if offsets.size else base
            psi = prog.forward_body(program, params)
            return cost.device_fn(psi, n)

        vag = jax.value_and_grad(scalar)

        def one_start(v0, lr, beta1, beta2):
            def body(carry, t):
                values, m, v, best_c, best_v = carry
                c, g = vag(values)
                better = c < best_c
                best_c = jnp.where(better, c, best_c)
                best_v = jnp.where(better, values, best_v)
                m = beta1 * m + (1 - beta1) * g
                v = beta2 * v + (1 - beta2) * g * g
                t1 = (t + 1).astype(jnp.float32)
                m_hat = m / (1 - jnp.power(beta1, t1))
                v_hat = v / (1 - jnp.power(beta2, t1))
                values = values - lr * m_hat / (jnp.sqrt(v_hat) + 1e-8)
                return (values, m, v, best_c, best_v), c

            zeros = jnp.zeros_like(v0)
            carry0 = (v0, zeros, zeros, jnp.float32(jnp.inf), v0)
            (values, _, _, best_c, best_v), costs = jax.lax.scan(
                body, carry0, jnp.arange(n_iter))
            final_c = scalar(values)
            better = final_c < best_c
            best_c = jnp.where(better, final_c, best_c)
            best_v = jnp.where(better, values, best_v)
            return best_v, best_c, costs

        fn = jax.jit(jax.vmap(one_start, in_axes=(0, None, None, None)))
        if len(_BATCH_COST_CACHE) > 64:
            _BATCH_COST_CACHE.pop(next(iter(_BATCH_COST_CACHE)))
        _BATCH_COST_CACHE[key] = fn
    return fn


def _shift_matrix(values: np.ndarray, shift: float) -> np.ndarray:
    """(2P, P) matrix of ±shift perturbed parameter vectors:
    rows [0..P) are +shift on param i, rows [P..2P) are -shift."""
    p = len(values)
    tiled = np.tile(values, (2 * p, 1))
    tiled[np.arange(p), np.arange(p)] += shift
    tiled[p + np.arange(p), np.arange(p)] -= shift
    return tiled


class GradientEstimator:
    """Gradient estimation for parameterized circuits."""

    @staticmethod
    def _batched_costs(config: ParameterizedCircuitConfig, cost_fn,
                       values_batch: np.ndarray,
                       seed: int | None = None) -> np.ndarray:
        """Evaluate the cost at each row of ``values_batch``. One device
        launch when the circuit and cost are traceable; falls back to
        per-row re-simulation otherwise (custom gates / Python costs).
        MPS-engine configs evaluate on the MPS variational path (no
        2^n state exists to fall back to)."""
        from .simulator import _is_huge

        if getattr(config, "engine", None) == "mps":
            if not isinstance(cost_fn, DeviceCost) or cost_fn.terms is None:
                raise ValueError(
                    "the MPS engine evaluates Hamiltonian-shaped costs "
                    "only (CostFunction.vqe_hamiltonian / qaoa_maxcut / "
                    "z_expectation carry their Pauli terms; there is no "
                    "dense state for host-callable costs)")
            from . import mps
            fn = mps.build_batched_cost_fn(
                config.circuit, config.bindings, cost_fn.terms,
                config.chi, constant=cost_fn.constant)
            return np.asarray(
                fn(jnp.asarray(values_batch, dtype=jnp.float32)),
                dtype=np.float64)

        huge = _is_huge(config.circuit)
        if (not huge and isinstance(cost_fn, DeviceCost)
                and cost_fn.device_fn is not None):
            program, offsets = config.compiled()
            if offsets is not None:
                fn = _batched_cost_fn(program, cost_fn, offsets)
                return np.asarray(fn(jnp.asarray(values_batch,
                                                 dtype=jnp.float32)),
                                  dtype=np.float64)
        sim = Simulator()
        out = np.zeros(len(values_batch))
        for i, vals in enumerate(values_batch):
            qc = config.bind_values(vals)
            state = sim.run(qc, shots=0, seed=seed).final_state
            out[i] = cost_fn(state)
            if huge:
                # Never hold two huge states at once: release this
                # row's buffer before the next forward.
                data = getattr(state, "state_data", None)
                if data is not None:
                    data.delete()
        return out

    @staticmethod
    def parameter_shift(config: ParameterizedCircuitConfig,
                        cost_fn, values: np.ndarray,
                        shift: float = np.pi / 2,
                        seed: int | None = None) -> np.ndarray:
        """grad_i = [f(θ_i + s) - f(θ_i - s)] / (2 sin s), all 2P circuit
        evaluations batched into one device launch."""
        p = len(values)
        if p == 0:
            return np.zeros(0)
        batch = _shift_matrix(np.asarray(values, dtype=np.float64), shift)
        costs = GradientEstimator._batched_costs(config, cost_fn, batch, seed)
        coeff = 1.0 / (2.0 * np.sin(shift))
        return (costs[:p] - costs[p:]) * coeff

    @staticmethod
    def finite_difference(config: ParameterizedCircuitConfig,
                          cost_fn, values: np.ndarray,
                          epsilon: float = 1e-4,
                          seed: int | None = None) -> np.ndarray:
        """Central finite difference, batched like parameter_shift."""
        p = len(values)
        if p == 0:
            return np.zeros(0)
        batch = _shift_matrix(np.asarray(values, dtype=np.float64), epsilon)
        costs = GradientEstimator._batched_costs(config, cost_fn, batch, seed)
        return (costs[:p] - costs[p:]) / (2 * epsilon)

    @staticmethod
    def autodiff(config: ParameterizedCircuitConfig, cost_fn: DeviceCost,
                 values: np.ndarray) -> tuple[float, np.ndarray]:
        """(cost, grad) by reverse-mode differentiation through the
        compiled circuit — exact, one program, any gate."""
        # Backend-independent guard (unlike simulator._is_huge, which
        # routes only on the GPU): reverse-mode residuals at n >= 30 need
        # several whole >= 8 GiB states resident on ANY backend.
        if config.circuit.num_qubits >= 30:
            raise ValueError(
                "autodiff cannot run on n >= 30 circuits: reverse-mode "
                "residuals need several whole states resident at once "
                "(>= 2x8 GiB); use parameter_shift, which re-simulates")
        program, offsets = config.compiled()
        if offsets is None or not isinstance(cost_fn, DeviceCost) \
                or cost_fn.device_fn is None:
            raise ValueError(
                "autodiff requires traceable gates and a DeviceCost")
        fn = _value_and_grad_fn(program, cost_fn, offsets)
        c, g = fn(jnp.asarray(values, dtype=jnp.float32))
        return float(c), np.asarray(g, dtype=np.float64)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class BarrenPlateauAnalysis:
    """Layer-wise barren plateau analysis result."""

    per_layer_variance: list[list[float]]
    per_layer_mean_variance: list[float]
    per_qubit_variance: list[float]
    depth_scaling: list[tuple[int, float]]
    overall_mean_variance: float
    overall_is_barren: bool
    threshold: float
    n_samples: int
    param_layer_map: list[int]


@dataclass
class OptimizationResult:
    """Result of a parameter optimization run."""

    optimal_values: np.ndarray
    optimal_cost: float
    history: list[tuple[np.ndarray, float]]
    converged: bool
    iterations: int


@dataclass
class MultiStartResult:
    """Result of a batched multi-start optimization.

    ``cost_histories[s, t]`` is start ``s``'s cost at its t-th visited
    point (pre-update, so ``cost_histories[s, 0]`` is the cost at the
    initialization)."""

    optimal_values: np.ndarray          # (K,) best parameters overall
    optimal_cost: float
    best_start: int
    start_values: np.ndarray            # (S, K) per-start best params
    start_costs: np.ndarray             # (S,) per-start best costs
    cost_histories: np.ndarray          # (S, iterations)
    iterations: int
    n_starts: int


# ---------------------------------------------------------------------------
# Adam optimizer
# ---------------------------------------------------------------------------

class CircuitOptimizer:
    """Adam over circuit parameters.

    ``gradient_method``: "parameter_shift" (batched ±π/2 rule, exact for
    rotation gates), "finite_difference", or "autodiff" (reverse-mode
    through the compiled circuit — fastest and exact for every gate).
    """

    def __init__(self, config: ParameterizedCircuitConfig,
                 cost_fn, learning_rate: float = 0.1,
                 beta1: float = 0.9, beta2: float = 0.999,
                 max_iterations: int = 100, tolerance: float = 1e-6,
                 gradient_method: str = "parameter_shift"):
        self._config = config
        self._cost_fn = cost_fn
        self._lr = learning_rate
        self._beta1 = beta1
        self._beta2 = beta2
        self._max_iter = max_iterations
        self._tol = tolerance
        self._grad_method = gradient_method

        n = config.num_params
        self._values = config.get_values().copy()
        self._m = np.zeros(n)
        self._v = np.zeros(n)
        self._t = 0
        self._history: list[tuple[np.ndarray, float]] = []
        self._stop_requested = False

    @property
    def values(self) -> np.ndarray:
        return self._values.copy()

    @property
    def history(self) -> list[tuple[np.ndarray, float]]:
        return self._history

    def request_stop(self) -> None:
        self._stop_requested = True

    def _evaluate_cost(self, values: np.ndarray,
                       seed: int | None = None) -> float:
        costs = GradientEstimator._batched_costs(
            self._config, self._cost_fn, values[None, :], seed)
        return float(costs[0])

    def step(self, seed: int | None = None) -> tuple[np.ndarray, float]:
        """One Adam step. Returns (values, cost at the new values).

        The reference's trace records the cost AFTER each update
        (``optimizer.py:369-372``), so the autodiff path's
        value_and_grad cost (at the PRE-update point) cannot replace the
        post-update evaluation without shifting the trace by one step.
        """
        self._t += 1

        if self._grad_method == "autodiff":
            _, grad = GradientEstimator.autodiff(
                self._config, self._cost_fn, self._values)
        elif self._grad_method == "finite_difference":
            grad = GradientEstimator.finite_difference(
                self._config, self._cost_fn, self._values, seed=seed)
        else:
            grad = GradientEstimator.parameter_shift(
                self._config, self._cost_fn, self._values, seed=seed)

        self._m = self._beta1 * self._m + (1 - self._beta1) * grad
        self._v = self._beta2 * self._v + (1 - self._beta2) * grad**2
        m_hat = self._m / (1 - self._beta1**self._t)
        v_hat = self._v / (1 - self._beta2**self._t)
        self._values = self._values - self._lr * m_hat / (
            np.sqrt(v_hat) + 1e-8)

        cost = self._evaluate_cost(self._values, seed)
        self._history.append((self._values.copy(), cost))
        return self._values.copy(), cost

    def run(self, callback: Callable[[int, np.ndarray, float], None]
            | None = None, seed: int | None = None) -> OptimizationResult:
        """Full optimization loop with convergence on |Δcost| < tol and
        best-iterate selection."""
        self._stop_requested = False
        converged = False

        for i in range(self._max_iter):
            if self._stop_requested:
                break
            values, cost = self.step(seed=seed)
            if callback is not None:
                callback(i, values, cost)
            if len(self._history) >= 2:
                if abs(cost - self._history[-2][1]) < self._tol:
                    converged = True
                    break

        best_idx = min(range(len(self._history)),
                       key=lambda j: self._history[j][1])
        return OptimizationResult(
            optimal_values=self._history[best_idx][0],
            optimal_cost=self._history[best_idx][1],
            history=self._history,
            converged=converged,
            iterations=len(self._history),
        )

    @classmethod
    def multi_start(cls, config: ParameterizedCircuitConfig,
                    cost_fn: DeviceCost, n_starts: int = 8,
                    max_iterations: int = 100,
                    learning_rate: float = 0.1,
                    beta1: float = 0.9, beta2: float = 0.999,
                    seed: int | None = None,
                    init_values: np.ndarray | None = None
                    ) -> MultiStartResult:
        """Optimize from ``n_starts`` random initializations IN ONE
        DEVICE LAUNCH: every start's full Adam loop (autodiff gradients,
        ``lax.scan`` over iterations) runs vmapped on the device, and
        the global best is selected on the host.  This is the batched
        escape hatch for the multi-modal/barren landscapes the
        reference's plateau analysis diagnoses
        (``/root/reference/quantum_sim/engine/optimizer.py:423-460``) —
        it can only detect them; this restarts through them.

        Initializations are uniform in [-pi, pi) (or ``init_values``
        of shape (n_starts, num_params)).  Requires traceable gates and
        a DeviceCost (same contract as ``gradient_method="autodiff"``).
        """
        if config.num_params == 0:
            raise ValueError("circuit has no parameters to optimize")
        if config.circuit.num_qubits >= 30:
            raise ValueError(
                "autodiff cannot run on n >= 30 circuits: reverse-mode "
                "residuals need several whole states resident at once")
        program, offsets = config.compiled()
        if offsets is None or not isinstance(cost_fn, DeviceCost) \
                or cost_fn.device_fn is None:
            raise ValueError(
                "multi_start requires traceable gates and a DeviceCost")
        if init_values is None:
            rng = np.random.default_rng(seed)
            init_values = rng.uniform(
                -np.pi, np.pi, size=(n_starts, config.num_params))
        else:
            init_values = np.asarray(init_values, dtype=np.float64)
            if init_values.shape != (n_starts, config.num_params):
                raise ValueError(
                    f"init_values must be ({n_starts}, "
                    f"{config.num_params}), got {init_values.shape}")
        fn = _multi_start_fn(program, cost_fn, offsets, max_iterations)
        best_v, best_c, costs = fn(
            jnp.asarray(init_values, dtype=jnp.float32),
            jnp.float32(learning_rate), jnp.float32(beta1),
            jnp.float32(beta2))
        best_v = np.asarray(best_v, dtype=np.float64)
        best_c = np.asarray(best_c, dtype=np.float64)
        costs = np.asarray(costs, dtype=np.float64)    # (S, n_iter)
        k = int(np.argmin(best_c))
        return MultiStartResult(
            optimal_values=best_v[k],
            optimal_cost=float(best_c[k]),
            best_start=k,
            start_values=best_v,
            start_costs=best_c,
            cost_histories=costs,
            iterations=max_iterations,
            n_starts=n_starts,
        )

    # --- barren plateau analysis ------------------------------------------

    def _gradient_samples(self, n_samples: int,
                          seed: int | None) -> np.ndarray:
        """(n_samples, P) parameter-shift gradients at random points —
        all points' shifted evaluations batched per point."""
        rng = np.random.default_rng(seed)
        n_params = self._config.num_params
        grads = np.zeros((n_samples, n_params))
        for s in range(n_samples):
            random_vals = rng.uniform(-np.pi, np.pi, size=n_params)
            grads[s] = GradientEstimator.parameter_shift(
                self._config, self._cost_fn, random_vals,
                seed=int(rng.integers(0, 2**63)))
        return grads

    def detect_barren_plateau(self, n_samples: int = 50,
                              seed: int | None = None) -> dict:
        """Gradient variance over random parameter points; barren when the
        mean variance falls below 1e-4."""
        grads = self._gradient_samples(n_samples, seed)
        per_param_var = np.var(grads, axis=0)
        mean_var = float(np.mean(per_param_var))
        return {
            "mean_variance": mean_var,
            "per_param": per_param_var.tolist(),
            "is_barren": mean_var < 1e-4,
        }

    def detect_barren_plateau_layered(self, n_samples: int = 50,
                                      seed: int | None = None
                                      ) -> BarrenPlateauAnalysis:
        """Variance grouped by the shared circuit-layer definition
        (``gate_to_layer_map``) and by first target qubit."""
        circuit = self._config.circuit
        g2l = circuit.gate_to_layer_map()
        param_layer_map: list[int] = []
        param_qubit_map: list[int] = []
        for binding in self._config.bindings:
            gate = circuit.gates[binding.gate_index]
            param_layer_map.append(g2l[binding.gate_index])
            param_qubit_map.append(
                gate.target_qubits[0] if gate.target_qubits else 0)

        grads = self._gradient_samples(n_samples, seed)
        per_param_var = np.var(grads, axis=0)

        layer_indices: dict[int, list[int]] = {}
        for pi, layer in enumerate(param_layer_map):
            layer_indices.setdefault(layer, []).append(pi)

        per_layer_variance: list[list[float]] = []
        per_layer_mean: list[float] = []
        depth_scaling: list[tuple[int, float]] = []
        for layer in sorted(layer_indices):
            layer_vars = [float(per_param_var[pi])
                          for pi in layer_indices[layer]]
            per_layer_variance.append(layer_vars)
            mean_v = float(np.mean(layer_vars))
            per_layer_mean.append(mean_v)
            depth_scaling.append((layer, mean_v))

        qubit_indices: dict[int, list[int]] = {}
        for pi, q in enumerate(param_qubit_map):
            qubit_indices.setdefault(q, []).append(pi)
        max_qubit = max(qubit_indices, default=0)
        per_qubit_variance = [
            float(np.mean([per_param_var[pi] for pi in qubit_indices[q]]))
            if q in qubit_indices else 0.0
            for q in range(max_qubit + 1)
        ]

        overall_mean = float(np.mean(per_param_var))
        return BarrenPlateauAnalysis(
            per_layer_variance=per_layer_variance,
            per_layer_mean_variance=per_layer_mean,
            per_qubit_variance=per_qubit_variance,
            depth_scaling=depth_scaling,
            overall_mean_variance=overall_mean,
            overall_is_barren=overall_mean < 1e-4,
            threshold=1e-4,
            n_samples=n_samples,
            param_layer_map=param_layer_map,
        )
