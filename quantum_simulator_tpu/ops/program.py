"""Circuit → compiled XLA program.

This is the accelerator-native replacement for the reference's
interpreted gate walk
(``/root/reference/quantum_sim/engine/simulator.py:55-68``): instead of
re-dispatching Python per gate per run, a circuit compiles ONCE per
*structure* into a jitted function

    ``f(params: f32[P]) -> complex[2^n]``

with every gate parameter a runtime input. Consequences:

* editing rotation angles (GUI sliders, optimizer steps) never recompiles;
* the whole circuit is differentiable — ``jax.grad`` through gate matrices
  gives exact gradients without parameter-shift re-simulation;
* noisy trajectories are the same program with per-gate stochastic Kraus
  selection (categorical draw + branch select), vmapped over PRNG keys —
  the batched replacement for the reference's per-shot re-simulation loop
  (``simulator.py:134-145``).

Compile results are cached keyed by (structure hash, noise key, dtype,
variant) — the jit analog of the reference's ``circuit_hash`` reference
invalidation (``reference.py:99-113``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CONFIG, on_gpu
from ..gates import GateType
from ..registry import GateRegistry
from .apply import (apply_cphase, apply_gate, basis_state_index,
                    make_basis_state)


@dataclass(frozen=True)
class ProgramOp:
    """One unitary in execution order (Measure/Barrier already dropped)."""

    gate_name: str
    targets: tuple[int, ...]
    param_offset: int
    num_params: int
    column_index: int  # index into the circuit's non-empty-column sequence
    static_matrix: np.ndarray | None  # baked matrix when not traceable
    jnp_builder: Callable | None
    gate_index: int = -1  # index into circuit.gates (for param remapping)
    # Controlled-phase-form diagonal too wide to materialize densely
    # (MCZ_k, k > 10): diag = ones except the all-targets-set entry = v.
    # Such ops carry NO matrix; executors apply them via bit-mask
    # elementwise passes (apply.apply_cphase / plan.DiagProductStep).
    cphase_value: complex | None = None


@dataclass(frozen=True)
class CircuitProgram:
    num_qubits: int
    initial_index: int
    ops: tuple[ProgramOp, ...]
    num_columns: int
    num_params: int
    initial_params: np.ndarray
    compile_key: tuple

    def param_offset_for(self, gate_index: int, param_index: int
                         ) -> int | None:
        """Program-param position for ``circuit.gates[gate_index]``'s
        ``param_index``-th parameter, or None if that gate's matrix was
        baked statically (no traceable builder)."""
        for op in self.ops:
            if op.gate_index == gate_index:
                if op.num_params == 0:
                    return None
                return op.param_offset + param_index
        return None

    def op_matrix(self, op: ProgramOp, params, dtype):
        if op.cphase_value is not None:
            raise NotImplementedError(
                f"{op.gate_name} on {len(op.targets)} qubits has no dense "
                f"matrix (2^{len(op.targets)} x 2^{len(op.targets)}); "
                "executors must route it through apply_cphase / the group "
                "plan's DiagProductStep instead of op_matrix")
        if op.static_matrix is not None:
            return jnp.asarray(op.static_matrix, dtype=dtype)
        p = [params[op.param_offset + j] for j in range(op.num_params)]
        return op.jnp_builder(*p).astype(dtype)


def compile_circuit(circuit) -> CircuitProgram:
    """Lower a QuantumCircuit to an ordered static op list + param vector."""
    registry = GateRegistry.instance()
    ops: list[ProgramOp] = []
    params: list[float] = []
    key_parts: list = [circuit.num_qubits, tuple(circuit.initial_states)]

    gate_ids = {id(g): gi for gi, g in enumerate(circuit.gates)}
    columns = circuit.get_ordered_gates()
    for col_idx, column in enumerate(columns):
        for inst in column:
            gd = registry.get(inst.gate_name)
            if gd.gate_type in (GateType.MEASUREMENT, GateType.BARRIER):
                continue
            gate_index = gate_ids.get(id(inst), -1)
            builder = gd.jnp_matrix_func
            if gd.num_params > 0 and builder is not None:
                if len(inst.params) != gd.num_params:
                    # an under-parameterized gate would silently shift
                    # every later gate's slot in the parameter vector
                    raise ValueError(
                        f"{inst.gate_name} takes {gd.num_params} "
                        f"parameter(s), got {len(inst.params)}")
                offset = len(params)
                params.extend(float(p) for p in inst.params)
                ops.append(ProgramOp(inst.gate_name, tuple(inst.target_qubits),
                                     offset, gd.num_params, col_idx, None,
                                     builder, gate_index))
                key_parts.append((inst.gate_name, tuple(inst.target_qubits),
                                  col_idx))
            elif getattr(gd, "cphase_value", None) is not None:
                # Wide controlled-phase diagonal (MCZ_k, k > 10): no
                # dense matrix exists; the op carries only the phase.
                ops.append(ProgramOp(inst.gate_name, tuple(inst.target_qubits),
                                     0, 0, col_idx, None, None, gate_index,
                                     cphase_value=gd.cphase_value))
                key_parts.append((inst.gate_name, tuple(inst.target_qubits),
                                  col_idx, complex(gd.cphase_value)))
            else:
                # Fixed gate, or a custom parameterized gate with a
                # host-only matrix_func: bake the matrix statically and
                # fold its values into the compile key.
                mat = np.asarray(gd.matrix_func(*inst.params),
                                 dtype=np.complex128)
                ops.append(ProgramOp(inst.gate_name, tuple(inst.target_qubits),
                                     0, 0, col_idx, mat, None, gate_index))
                key_parts.append((inst.gate_name, tuple(inst.target_qubits),
                                  col_idx, mat.tobytes()))

    # Measure/Barrier-only columns contribute no ops but DO change the
    # snapshot count of steps/trajectory programs — without this, two
    # such circuits collide in the compile cache and return the wrong
    # number of per-column states.
    key_parts.append(("columns", len(columns)))

    return CircuitProgram(
        num_qubits=circuit.num_qubits,
        initial_index=basis_state_index(circuit.initial_states),
        ops=tuple(ops),
        num_columns=len(columns),
        num_params=len(params),
        initial_params=np.asarray(params, dtype=np.float64),
        compile_key=tuple(key_parts),
    )


# ---------------------------------------------------------------------------
# Pure program bodies (traced once per structure)
# ---------------------------------------------------------------------------

def _apply_op(program: CircuitProgram, state, op: ProgramOp, params, dtype):
    """Apply one program op to a flat state: dense matrix contraction, or
    a bit-mask phase pass for matrix-less wide controlled-phase ops."""
    if op.cphase_value is not None:
        return apply_cphase(state, op.targets, op.cphase_value,
                            program.num_qubits)
    return apply_gate(state, program.op_matrix(op, params, dtype),
                      op.targets, program.num_qubits)


def _forward_body(program: CircuitProgram, params, dtype):
    n = program.num_qubits
    state = make_basis_state(n, program.initial_index, dtype)
    for op in program.ops:
        state = _apply_op(program, state, op, params, dtype)
    return state


def _steps_body(program: CircuitProgram, params, dtype):
    """Stacked per-column states, row 0 = initial state (the device analog
    of the reference's ``run_step_by_step`` generator, ``simulator.py:93``)."""
    n = program.num_qubits
    state = make_basis_state(n, program.initial_index, dtype)
    snapshots = [state]
    op_i = 0
    for col in range(program.num_columns):
        while op_i < len(program.ops) and program.ops[op_i].column_index == col:
            op = program.ops[op_i]
            state = _apply_op(program, state, op, params, dtype)
            op_i += 1
        snapshots.append(state)
    return jnp.stack(snapshots)


def _apply_channel_stochastic(state, kraus_stack, qubit, key, n):
    """Stochastic Kraus selection without materializing the branches.

    The branch probability ||K_i psi||^2 equals tr(K_i rho_q K_i^dag)
    where rho_q is the single-qubit reduced density matrix — ONE cheap
    pass over the state. Draw the branch from those, then apply ONLY the
    selected operator (a second pass). The reference applies every Kraus
    operator to a full state copy per draw (``noise.py:224-260``)."""
    hi = jax.lax.Precision.HIGHEST
    a = 1 << qubit
    b = 1 << (n - qubit - 1)
    st = state.reshape(a, 2, b)
    rho = jnp.einsum("aib,ajb->ij", st, jnp.conj(st), precision=hi)
    # norms_m = tr(K_m rho K_m^dag)
    norms = jnp.real(jnp.einsum("mij,jk,mik->m", kraus_stack, rho,
                                jnp.conj(kraus_stack), precision=hi))
    idx = jax.random.categorical(key, jnp.log(norms + 1e-30))
    k_sel = jnp.take(kraus_stack, idx, axis=0)
    out = jnp.einsum("ij,ajb->aib", k_sel, st, precision=hi).reshape(-1)
    norm = jnp.take(norms, idx)
    return out / jnp.sqrt(jnp.maximum(norm, 1e-30))


def _count_noise_draws(program: CircuitProgram, channels_for) -> int:
    total = 0
    for op in program.ops:
        total += len(channels_for(op.gate_name)) * len(op.targets)
    return total


def _monitored_body(program: CircuitProgram, channels_for, events,
                    params, key, dtype):
    """One monitored trajectory: Measure gates collapse mid-circuit.

    ``events`` is a static list of ``(op_position, qubit)`` pairs —
    the measure fires after exactly ``op_position`` program ops have
    applied, which reproduces the circuit's column/qubit ordering
    exactly (ops are emitted in ``get_ordered_gates`` order and a
    within-column measure commutes with that column's gates on other
    qubits).  Returns (final state, outcomes[int32, M])."""
    from .apply import collapse_qubit, prob_qubit_zero

    n = program.num_qubits
    state = make_basis_state(n, program.initial_index, dtype)
    total_draws = _count_noise_draws(program, channels_for) + len(events)
    keys = jax.random.split(key, max(1, total_draws))
    draw = 0
    ev_i = 0
    outcomes = []

    def measure(state, q, k):
        p0 = prob_qubit_zero(state, q, n)
        total = jnp.sum(jnp.abs(state) ** 2)
        bit = (jax.random.uniform(k) >= p0
               / jnp.maximum(total, 1e-30)).astype(jnp.int32)
        return collapse_qubit(state, q, bit, n), bit

    for pos in range(len(program.ops) + 1):
        while ev_i < len(events) and events[ev_i][0] == pos:
            state, bit = measure(state, events[ev_i][1], keys[draw])
            outcomes.append(bit)
            draw += 1
            ev_i += 1
        if pos == len(program.ops):
            break
        op = program.ops[pos]
        state = _apply_op(program, state, op, params, dtype)
        for kraus_np in channels_for(op.gate_name):
            kraus = jnp.asarray(kraus_np, dtype=dtype)
            for q in op.targets:
                if q >= n:
                    continue
                state = _apply_channel_stochastic(
                    state, kraus, q, keys[draw], n)
                draw += 1
    outs = (jnp.stack(outcomes).astype(jnp.int32) if outcomes
            else jnp.zeros((0,), jnp.int32))
    return state, outs


def _trajectory_body(program: CircuitProgram, channels_for, params, key,
                     dtype, record_columns: bool):
    n = program.num_qubits
    state = make_basis_state(n, program.initial_index, dtype)
    total_draws = max(1, _count_noise_draws(program, channels_for))
    keys = jax.random.split(key, total_draws)
    draw = 0
    snapshots = [state] if record_columns else None
    op_i = 0
    for col in range(program.num_columns):
        while op_i < len(program.ops) and program.ops[op_i].column_index == col:
            op = program.ops[op_i]
            state = _apply_op(program, state, op, params, dtype)
            for kraus_np in channels_for(op.gate_name):
                kraus = jnp.asarray(kraus_np, dtype=dtype)
                for q in op.targets:
                    if q >= n:
                        continue
                    state = _apply_channel_stochastic(
                        state, kraus, q, keys[draw], n)
                    draw += 1
            op_i += 1
        if record_columns:
            snapshots.append(state)
    if record_columns:
        return jnp.stack(snapshots)
    return state


# ---------------------------------------------------------------------------
# Compile cache
# ---------------------------------------------------------------------------

_CACHE: dict[tuple, Callable] = {}


def _cache_get(key, build):
    fn = _CACHE.get(key)
    if fn is None:
        if len(_CACHE) >= CONFIG.compile_cache_size:
            _CACHE.pop(next(iter(_CACHE)))
        fn = build()
        _CACHE[key] = fn
    return fn


def clear_compile_cache():
    _CACHE.clear()


# Routes on the GPU (config.on_gpu; the CPU keeps the per-gate programs
# everywhere, which its tests are written against). The forward and
# evolve programs take the group-matmul executor at every n; trajectory,
# monitored and steps bodies take the group/splice bodies from
# _PLAN_EXECUTOR_MIN_QUBITS up. Both choices come from H100 timings
# (scripts/route_timings.py; numbers in PERF.md): the plan forward won at
# every width timed (n = 8..20), the splice bodies at every width timed
# (n = 12, 16), and 12 is the smallest width timed.
_PLAN_EXECUTOR_MIN_QUBITS = 12


def forward_fn(program: CircuitProgram, dtype=None) -> Callable:
    """jitted ``f(params) -> state``."""
    dtype = dtype or CONFIG.dtype
    if on_gpu():
        from .plan import group_forward_fn

        return group_forward_fn(program, dtype)
    key = ("fwd", program.compile_key, str(dtype))
    return _cache_get(key, lambda: jax.jit(
        lambda params: _forward_body(program, params, dtype)))


def forward_body(program: CircuitProgram, params, dtype=None):
    """Traceable (un-jitted) forward pass — compose into larger programs
    (cost functions, vmapped parameter sweeps, autodiff)."""
    return _forward_body(program, params, dtype or CONFIG.dtype)


def evolve_fn(program: CircuitProgram, dtype=None) -> Callable:
    """jitted ``f(state, params) -> state`` applying the program to a
    PROVIDED state (rather than the circuit's initial basis state) — used
    for chained benchmarking and for composing circuits. Routes like
    forward_fn."""
    dtype = dtype or CONFIG.dtype
    use_plan = on_gpu()
    key = ("evolve", program.compile_key, str(dtype), use_plan)

    if use_plan:
        from .plan import group_evolve_body

        return _cache_get(key, lambda: jax.jit(
            lambda state, params: group_evolve_body(
                program, state, params, dtype)))

    def body(state, params):
        n = program.num_qubits
        for op in program.ops:
            state = _apply_op(program, state, op, params, dtype)
        return state

    return _cache_get(key, lambda: jax.jit(body))


def batched_forward_fn(program: CircuitProgram, dtype=None) -> Callable:
    """jitted ``f(params_batch[B, P]) -> states[B, 2^n]`` — evaluates the
    same circuit structure at many parameter points in one launch (the
    engine under batched parameter-shift gradients and plateau sampling)."""
    dtype = dtype or CONFIG.dtype
    key = ("vfwd", program.compile_key, str(dtype))
    return _cache_get(key, lambda: jax.jit(
        jax.vmap(lambda p: _forward_body(program, p, dtype))))


class _NoNoise:
    """Channel-free noise stand-in for reusing the trajectory bodies."""

    @staticmethod
    def kraus_stacks_for_gate(gate_name: str):
        return []

    @staticmethod
    def spec_key():
        return ()


def steps_fn(program: CircuitProgram, dtype=None) -> Callable:
    dtype = dtype or CONFIG.dtype
    key = ("steps", program.compile_key, str(dtype),
           _use_group_path(program))
    if _use_group_path(program):
        from .plan import group_trajectory_body

        return _cache_get(key, lambda: jax.jit(
            lambda params: group_trajectory_body(
                program, _NoNoise, params, jax.random.PRNGKey(0), dtype,
                record_columns=True)))
    return _cache_get(key, lambda: jax.jit(
        lambda params: _steps_body(program, params, dtype)))


def _use_group_path(program: CircuitProgram) -> bool:
    return program.num_qubits >= _PLAN_EXECUTOR_MIN_QUBITS and on_gpu()


def trajectory_fn(program: CircuitProgram, noise_model, dtype=None,
                  record_columns: bool = False) -> Callable:
    """jitted ``f(params, key) -> state`` with stochastic noise after every
    gate (per the NoiseModel's global + per-gate channel lists)."""
    dtype = dtype or CONFIG.dtype
    channels_for = noise_model.kraus_stacks_for_gate
    key = ("traj", program.compile_key, noise_model.spec_key(),
           str(dtype), record_columns, _use_group_path(program))
    if CONFIG.interactive and not record_columns and key not in _CACHE:
        # Edit-hot noisy rerun: the skeleton executor serves EVERY n
        # (the per-gate einsum program below recompiles per structure).
        from .unitary_traj import interactive_trajectory_fn

        fn = interactive_trajectory_fn(program, noise_model, dtype)
        if fn is not None:
            # NOT cached under the structure key — flipping
            # CONFIG.interactive off must restore the fused path.
            return fn
    if _use_group_path(program):
        body = _group_traj_body(program, noise_model, dtype, record_columns)
        return _cache_get(key, lambda: jax.jit(body))
    return _cache_get(key, lambda: jax.jit(
        lambda params, k: _trajectory_body(
            program, channels_for, params, k, dtype, record_columns)))


def monitored_trajectories_fn(program: CircuitProgram, noise_model,
                              events, dtype=None) -> Callable:
    """jitted ``f(params, keys[T]) -> (states[T, 2^n], outcomes[T, M])``
    — T monitored trajectories (mid-circuit collapse at the static
    ``(op_position, qubit)`` events, optional stochastic noise) in one
    vmapped launch.  Below the plan threshold this is the per-gate
    einsum body; from the threshold up on the GPU the collapse runs as spliced
    projectors through the group plan (``ops/monomial_traj``) whenever
    the noise channels are monomial (always true for the reference
    channel family and for noise-free monitored circuits)."""
    dtype = dtype or CONFIG.dtype
    channels_for = (noise_model.kraus_stacks_for_gate
                    if noise_model is not None
                    else _NoNoise.kraus_stacks_for_gate)
    spec = noise_model.spec_key() if noise_model is not None else ()
    if _use_group_path(program):
        from .monomial_traj import (
            monomial_insert_supported,
            monomial_monitored_body,
        )

        nm = noise_model if noise_model is not None else _NoNoise
        if not monomial_insert_supported(program, nm, tuple(events)):
            raise ValueError(
                "monitored group path needs monomial Kraus channels "
                "(the reference channel family); this noise model has "
                "a non-monomial custom channel — use MPSSimulator / "
                "Clifford monitored engines, or a width below "
                f"{_PLAN_EXECUTOR_MIN_QUBITS}")
        key = ("monitored-group", program.compile_key, spec, str(dtype),
               tuple(events))
        return _cache_get(key, lambda: jax.jit(jax.vmap(
            lambda params, k: monomial_monitored_body(
                program, nm, events, params, k, dtype),
            in_axes=(None, 0))))
    key = ("monitored", program.compile_key, spec, str(dtype),
           tuple(events))
    return _cache_get(key, lambda: jax.jit(jax.vmap(
        lambda params, k: _monitored_body(
            program, channels_for, events, params, k, dtype),
        in_axes=(None, 0))))


def batched_trajectories_fn(program: CircuitProgram, noise_model,
                            dtype=None, record_columns: bool = False
                            ) -> Callable:
    """jitted ``f(params, keys[T]) -> states[T, 2^n]`` — one compiled
    program evaluates every Monte-Carlo trajectory in parallel. This is the
    single batched primitive that replaces the reference's per-shot loops in
    ``run_with_noise`` / ``ensemble_density_matrix`` / fidelity sweeps /
    debugger trials / QEC threshold trials."""
    dtype = dtype or CONFIG.dtype
    channels_for = noise_model.kraus_stacks_for_gate
    key = ("vtraj", program.compile_key, noise_model.spec_key(),
           str(dtype), record_columns, _use_group_path(program))

    if CONFIG.interactive and not record_columns and key not in _CACHE:
        from .unitary_traj import interactive_trajectory_fn

        sfn = interactive_trajectory_fn(program, noise_model, dtype)
        if sfn is not None:
            # Edit-hot batches loop the skeleton executor per key
            # instead of compiling a fused batch
            # program for a structure the user is about to edit again.
            # NOT cached under the structure key (see trajectory_fn).
            import jax.numpy as _jnp

            return lambda params, keys: _jnp.stack(
                [sfn(params, keys[i]) for i in range(keys.shape[0])])

    def build():
        if _use_group_path(program):
            body = _group_traj_body(program, noise_model, dtype,
                                    record_columns)
        else:
            body = lambda params, k: _trajectory_body(
                program, channels_for, params, k, dtype, record_columns)
        return jax.jit(jax.vmap(body, in_axes=(None, 0)))

    return _cache_get(key, build)


def forward_route(program: CircuitProgram) -> str:
    """Which executor ``forward_fn`` runs for this program: ``"plan"``
    (the group-matmul executor) or ``"per-gate"``."""
    return "plan" if on_gpu() else "per-gate"


def trajectory_route(program: CircuitProgram, noise_model,
                     record_columns: bool = False) -> str:
    """Which body ``trajectory_fn`` / ``batched_trajectories_fn`` run:
    ``"per-gate"`` below the plan threshold (or off the GPU), else one
    of ``"unitary-splice"``, ``"monomial-splice"``, ``"fold"``,
    ``"group-per-gate"`` (see ``_group_traj_kind``)."""
    if not _use_group_path(program):
        return "per-gate"
    return _group_traj_kind(program, noise_model, record_columns)


def _group_traj_kind(program: CircuitProgram, noise_model,
                     record_columns: bool) -> str:
    from .bigtraj import fold_supported
    from .monomial_traj import monomial_insert_supported
    from .unitary_traj import unitary_insert_supported

    if record_columns:
        return "group-per-gate"
    if unitary_insert_supported(program, noise_model):
        return "unitary-splice"
    if monomial_insert_supported(program, noise_model):
        return "monomial-splice"
    if fold_supported(program):
        return "fold"
    return "group-per-gate"


def _group_traj_body(program: CircuitProgram, noise_model, dtype,
                     record_columns: bool) -> Callable:
    """Group-path trajectory body selector, fastest applicable first:

    1. mixed-unitary channels -> ``ops/unitary_traj`` (draws splice as
       unitaries into the plan's composition windows: ~per-column state
       passes instead of per-gate);
    2. monomial channels (amplitude damping, thermal relaxation, any
       mix with the mixed-unitary family) -> ``ops/monomial_traj``
       (state-dependent draws become classical given one basis sample
       per composition window — still ~per-column passes);
    3. otherwise the folded single-pass-per-gate executor
       (``ops/bigtraj.fold_trajectory_body``) when every op has a fold
       applier;
    4. otherwise the per-gate ``plan.group_trajectory_body`` (which
       also serves snapshot recording and >3-target dense gates)."""
    from .bigtraj import fold_trajectory_body
    from .monomial_traj import monomial_trajectory_body
    from .plan import group_trajectory_body
    from .unitary_traj import unitary_insert_trajectory_body

    kind = _group_traj_kind(program, noise_model, record_columns)
    if kind == "unitary-splice":
        return lambda params, k: unitary_insert_trajectory_body(
            program, noise_model, params, k, dtype)
    if kind == "monomial-splice":
        return lambda params, k: monomial_trajectory_body(
            program, noise_model, params, k, dtype)
    if kind == "fold":
        return lambda params, k: fold_trajectory_body(
            program, noise_model, params, k, dtype)
    return lambda params, k: group_trajectory_body(
        program, noise_model, params, k, dtype, record_columns)
