"""Mixed-unitary noise trajectories as random unitary insertions.

For channels whose Kraus operators are each proportional to a unitary
(depolarizing, bit-flip, phase-flip, 2q depolarizing — every channel
the fault-tolerance "circuit noise" family uses), the branch
probabilities ``p_m = ||K_m psi||^2 = c_m`` are STATE-INDEPENDENT and
the normalized post-branch operator ``K_m / sqrt(c_m)`` is exactly
unitary. Consequently a stochastic trajectory is just the ideal circuit
with independently drawn unitaries spliced in after each gate — no
per-draw density-matrix algebra, no renormalization, and crucially **no
per-gate whole-state pass**: the spliced ops feed the group-matmul plan
(``ops/plan.py``), which composes them into the SAME per-axis operator
stacks the ideal forward uses (one einsum pass per composition window
instead of one per gate+draw).

Motivation: the per-gate fold executor
(``ops/bigtraj.huge_trajectory_evolve``) is bandwidth-bound at one
whole-state pass per gate; this path runs the plan's ~per-column passes
instead.

This replaces the reference's per-shot Python resampling loop
(``/root/reference/quantum_sim/engine/simulator.py:134-145`` +
``noise.py:224-260``) for the mixed-unitary channel family; channels
that genuinely need state-dependent draws (amplitude damping, thermal
relaxation) stay on the fold path (``ops/bigtraj.py``).

Also extends trajectory support to CORRELATED 2-qubit mixed-unitary
channels (``TwoQubitDepolarizingNoise``): a (16, 4, 4) Pauli stack on a
2-target gate splices one drawn 2q unitary — the per-target trajectory
paths reject these by arity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import program as prog
from .bigtraj import phase_real_stack, trajectory_is_real
from .plan import (
    OperandOverrides,
    _planar_basis_state,
    _real_basis_state,
    build_group_operands,
    execute_group_plan,
    get_group_plan,
)

# Classification-only dummies for spliced ops: the plan reads
# static_matrix for realness/diagonality (plan._op_is_real /
# _op_is_diagonal); operand values come from OperandOverrides. Must be
# non-diagonal and non-SWAP so spliced ops land on the dense-matrix
# routes, with realness matching the injected draws.
_DUMMY_R1 = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)
_DUMMY_C1 = np.array([[1.0, 1.0], [1.0j, -1.0j]]) / np.sqrt(2)


def mixed_unitary_stack(stack: np.ndarray):
    """``(m, D, D)`` Kraus stack -> ``(probs, units)`` when every
    operator is proportional to a unitary (``K^H K = c I``) and the
    channel is trace-preserving, else None. ``units[m]`` is exactly
    unitary; ``probs[m] = c_m``."""
    st = np.asarray(stack, np.complex128)
    if st.ndim != 3 or st.shape[1] != st.shape[2]:
        return None
    d = st.shape[1]
    probs, units = [], []
    for K in st:
        M = K.conj().T @ K
        c = float(np.real(np.trace(M))) / d
        if c < 1e-12 or not np.allclose(M, c * np.eye(d), atol=1e-9):
            return None
        probs.append(c)
        units.append(K / np.sqrt(c))
    probs = np.asarray(probs)
    if not np.isclose(probs.sum(), 1.0, atol=1e-6):
        return None
    return probs, np.stack(units)


class _StackSpec(NamedTuple):
    probs: np.ndarray        # (m,) static branch probabilities
    units: np.ndarray        # (m, D, D) complex unitaries
    units_real: object       # (m, D, D) real (phase-real form) or None


class _Draw(NamedTuple):
    aug_index: int           # spliced op's index in aug.ops
    stack_id: int
    draw_index: int          # key index (fold-path-compatible schedule)


class UnitaryInsertSpec(NamedTuple):
    aug: prog.CircuitProgram
    draws: tuple
    stacks: tuple            # tuple[_StackSpec]
    total_draws: int
    real: bool               # whole trajectory stays real (phase-real)


_SPEC_CACHE: dict[tuple, UnitaryInsertSpec | None] = {}


def _dummy_op(targets, mat, column_index) -> prog.ProgramOp:
    return prog.ProgramOp("__MU_KRAUS__", tuple(targets), 0, 0,
                          column_index, mat, None, -1)


def unitary_insert_spec(program: prog.CircuitProgram, noise_model
                        ) -> UnitaryInsertSpec | None:
    """Host-side splice plan, or None when any channel on any gate is
    not mixed-unitary (those circuits stay on the fold path). Draw-key
    indices follow the fold path's schedule (per op: one draw per
    (stack, target) for 1q stacks) so the two paths share PRNG
    plumbing."""
    key = (program.compile_key, noise_model.spec_key())
    if key in _SPEC_CACHE:
        return _SPEC_CACHE[key]
    spec = _build_spec(program, noise_model)
    if len(_SPEC_CACHE) > 128:
        _SPEC_CACHE.pop(next(iter(_SPEC_CACHE)))
    _SPEC_CACHE[key] = spec
    return spec


def _build_spec(program, noise_model):
    real = trajectory_is_real(program, noise_model)
    stacks: list[_StackSpec] = []
    stack_ids: dict[tuple, int] = {}
    by_gate: dict[str, list[int] | None] = {}

    def stack_id_for(raw) -> int | None:
        skey = raw.tobytes()
        sid = stack_ids.get(skey)
        if sid is not None:
            return sid
        mu = mixed_unitary_stack(raw)
        if mu is None:
            return None
        probs, units = mu
        ur = phase_real_stack(units) if real else None
        sid = len(stacks)
        stacks.append(_StackSpec(probs, units.astype(np.complex64), ur))
        stack_ids[skey] = sid
        return sid

    aug_ops: list[prog.ProgramOp] = []
    draws: list[_Draw] = []
    draw = 0
    for op in program.ops:
        if op.gate_name not in by_gate:
            sids = []
            for raw in noise_model.kraus_stacks_for_gate(op.gate_name):
                sid = stack_id_for(np.asarray(raw))
                if sid is None:
                    sids = None
                    break
                sids.append(sid)
            by_gate[op.gate_name] = sids
        sids = by_gate[op.gate_name]
        if sids is None:
            return None
        aug_ops.append(op)
        k = len(op.targets)
        for sid in sids:
            d = stacks[sid].units.shape[1]
            if d == 2:
                for q in op.targets:
                    dummy = _DUMMY_R1 if real else _DUMMY_C1
                    draws.append(_Draw(len(aug_ops), sid, draw))
                    aug_ops.append(_dummy_op((q,), dummy,
                                             op.column_index))
                    draw += 1
            elif d == 1 << k:
                dummy = np.kron(_DUMMY_R1, _DUMMY_R1) if real \
                    else np.kron(_DUMMY_C1, _DUMMY_C1)
                if k != 2:
                    return None  # wide correlated stacks: unsupported
                draws.append(_Draw(len(aug_ops), sid, draw))
                aug_ops.append(_dummy_op(op.targets, dummy,
                                         op.column_index))
                draw += 1
            else:
                return None  # arity mismatch (2q stack on a 1q gate)

    aug = prog.CircuitProgram(
        num_qubits=program.num_qubits,
        initial_index=program.initial_index,
        ops=tuple(aug_ops),
        num_columns=program.num_columns,
        num_params=program.num_params,
        initial_params=program.initial_params,
        compile_key=program.compile_key + (
            ("mu-traj", noise_model.spec_key(), real),),
    )
    return UnitaryInsertSpec(aug, tuple(draws), tuple(stacks), draw, real)


def unitary_insert_supported(program, noise_model) -> bool:
    return unitary_insert_spec(program, noise_model) is not None


def unitary_insert_evolve_ok(program, noise_model) -> bool:
    """Gate for the HUGE-path splice route (``unitary_insert_evolve``):
    mixed-unitary noise AND a GenericStep-free aug plan. A GenericStep
    would (a) flatten the whole state to complex inside the chunked
    executor — the ~2x-state round trip the n >= 30 path exists to
    avoid — and (b) force the plan planar (``all_real=False``) while
    the caller built the state shape from ``trajectory_is_real``,
    crashing the einsum lowering for all-real circuits. Those circuits
    stay on the per-gate fold executor, whose 'bits' applier handles
    3-group-spanning dense gates."""
    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        return False
    from .plan import GenericStep

    plan = get_group_plan(spec.aug)
    return not any(isinstance(s, GenericStep) for s in plan.steps)


def _draw_overrides(spec: UnitaryInsertSpec, key) -> OperandOverrides:
    """One vectorized categorical per distinct stack; selections gather
    the (exactly unitary) branch operators into operand overrides."""
    keys = jax.random.split(key, max(1, spec.total_draws))
    pool_rows: list = []
    pool_map: dict[int, int] = {}
    per_op: dict[int, jnp.ndarray] = {}
    for sid, st in enumerate(spec.stacks):
        dlist = [d for d in spec.draws if d.stack_id == sid]
        if not dlist:
            continue
        kb = jnp.stack([keys[d.draw_index] for d in dlist])
        logits = jnp.asarray(np.log(st.probs), jnp.float32)
        sel = jax.vmap(
            lambda k_, lg=logits: jax.random.categorical(k_, lg))(kb)
        units = st.units_real if spec.real else st.units
        chosen = jnp.take(jnp.asarray(units), sel, axis=0)
        if st.units.shape[1] == 2:
            base_row = sum(r.shape[0] for r in pool_rows) \
                if pool_rows else 0
            pool_rows.append(chosen)
            for r, d in enumerate(dlist):
                pool_map[d.aug_index] = base_row + r
        else:
            for r, d in enumerate(dlist):
                per_op[d.aug_index] = chosen[r]
    return OperandOverrides(
        pool_rows=(jnp.concatenate(pool_rows).astype(jnp.complex64)
                   if pool_rows else None),
        pool_map=pool_map, per_op=per_op)


_CAT_BATCH = jax.jit(
    lambda keys, logits: jax.vmap(
        lambda k: jax.random.categorical(k, logits))(keys))


def _draw_overrides_host(spec: UnitaryInsertSpec, key) -> OperandOverrides:
    """NumPy twin of ``_draw_overrides`` for the interactive edit-hot
    path. The categorical draws stay ``jax.random`` (draw-exact vs the
    traced path) but run as ONE jitted CPU launch per stack with the
    draw count padded to a 64 bucket — ``jax.random.split`` is
    prefix-stable (split(key, n)[i] depends only on (key, i), verified
    in tests), so padding never changes a draw, and a 1-gate edit that
    crosses a bucket boundary at worst recompiles one tiny CPU draw
    program. Unit gathers and pool assembly are host NumPy."""
    from .plan import _host_cpu_device

    cpu = _host_cpu_device()
    pad = -(-max(1, spec.total_draws) // 64) * 64
    sels: dict[int, np.ndarray] = {}
    with jax.default_device(cpu):
        keys = jax.random.split(jax.device_put(key, cpu), pad)
        for sid, st in enumerate(spec.stacks):
            if not any(d.stack_id == sid for d in spec.draws):
                continue
            logits = jnp.asarray(np.log(st.probs), jnp.float32)
            sels[sid] = np.asarray(_CAT_BATCH(keys, logits))
    pool_rows: list = []
    pool_map: dict[int, int] = {}
    per_op: dict[int, np.ndarray] = {}
    for sid, st in enumerate(spec.stacks):
        dlist = [d for d in spec.draws if d.stack_id == sid]
        if not dlist:
            continue
        sel = sels[sid]
        units = np.asarray(st.units_real if spec.real else st.units)
        chosen = np.take(units, [int(sel[d.draw_index]) for d in dlist],
                         axis=0)
        if st.units.shape[1] == 2:
            base_row = sum(r.shape[0] for r in pool_rows) \
                if pool_rows else 0
            pool_rows.append(chosen)
            for r, d in enumerate(dlist):
                pool_map[d.aug_index] = base_row + r
        else:
            for r, d in enumerate(dlist):
                per_op[d.aug_index] = chosen[r]
    return OperandOverrides(
        pool_rows=(np.concatenate(pool_rows).astype(np.complex64)
                   if pool_rows else None),
        pool_map=pool_map, per_op=per_op)


def unitary_insert_trajectory_body(program, noise_model, params, key,
                                   dtype=None) -> jnp.ndarray:
    """Traceable ``(params, key) -> flat complex state``: ONE stochastic
    trajectory with every noise draw spliced as a unitary into the group
    plan. Vmappable over keys (``program.batched_trajectories_fn``
    routes here for mixed-unitary noise)."""
    from ..config import CONFIG

    dtype = dtype or CONFIG.dtype
    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has non-mixed-unitary channels; "
                         "use the fold path (ops/bigtraj.py)")
    aug = spec.aug
    plan = get_group_plan(aug)
    operands = build_group_operands(aug, plan, params, jnp.complex64,
                                    overrides=_draw_overrides(spec, key))
    planar = not plan.all_real
    x = (_planar_basis_state(plan.layout, aug.initial_index) if planar
         else _real_basis_state(plan.layout, aug.initial_index))
    x = execute_group_plan(plan, operands, aug, params, jnp.complex64, x,
                           planar=planar)
    if planar:
        flat = (x[0] + 1j * x[1]).reshape(-1)
    else:
        flat = x.reshape(-1).astype(jnp.complex64)
    # All spliced operators are exactly unitary, but f32 products drift
    # ~1e-6/op; one exact normalization matches the other paths'
    # ||psi|| = 1 contract.
    nsq = jnp.sum(jnp.real(flat) ** 2 + jnp.imag(flat) ** 2)
    return (flat / jnp.sqrt(jnp.maximum(nsq, 1e-30))).astype(dtype)


def interactive_trajectory_fn(program, noise_model, dtype=None):
    """``f(params, key) -> state`` for edit-hot NOISY runs: the splice
    draws happen eagerly on the host CPU backend and the state evolves
    through the skeleton-keyed executor (``plan._skeleton_executor``) —
    so a 1-gate edit reruns a noisy trajectory without a per-structure
    recompile, same as the ideal interactive path. None when the noise
    is not mixed-unitary, the aug plan needs a GenericStep, or no CPU
    backend exists. Norm drifts only by f32 rounding (all splices are
    exactly unitary); downstream sampling normalizes."""
    from ..config import CONFIG
    from .plan import _host_cpu_device, _skeleton_executor, plan_skeleton

    dtype = dtype or CONFIG.dtype
    spec = unitary_insert_spec(program, noise_model)
    cpu = _host_cpu_device()
    if spec is None or cpu is None:
        return None
    aug = spec.aug
    plan = get_group_plan(aug)
    skel = plan_skeleton(plan)
    if skel is None:
        return None
    fn = _skeleton_executor(skel, plan, dtype)
    dev = jax.devices()[0]

    def run(params, key):
        params_h = np.asarray(params)
        overrides = _draw_overrides_host(spec, key)
        operands = build_group_operands(aug, plan, params_h, dtype,
                                        overrides=overrides, xp=np)
        x0 = _planar_basis_state(plan.layout, aug.initial_index, xp=np)
        operands, x0 = jax.device_put((operands, x0), dev)
        return fn(operands, x0)

    return run


def unitary_insert_evolve(program, noise_model, params, key,
                          x: jnp.ndarray, dtype=None,
                          n_chunks: int | None = None) -> jnp.ndarray:
    """Chunked splice evolution of a PROVIDED grouped state — the huge
    (n >= 30) counterpart of ``unitary_insert_trajectory_body``, with
    the same signature as ``bigtraj.huge_trajectory_evolve`` so the
    huge-path donation/layout chain (``bigtraj._traj_apply_raw``) can
    swap it in for mixed-unitary noise. The chunked memory schedule is
    ``bigstate``'s; the plan composes gate+draw windows, so depth-2
    n=30 runs plan passes instead of one pass per gate+draw.

    No renormalization pass: every spliced operator is exactly unitary,
    so ||psi|| drifts only by f32 rounding (~1e-6 over typical depths),
    inside the sampling tolerance — and at n >= 30 one avoided pass is
    ~20-30 ms.

    Computes in f32 planes / complex64 only; ``dtype`` is accepted for
    signature symmetry with ``bigtraj.huge_trajectory_evolve`` and
    canonicalized (same contract — a complex128 whole state would not
    fit the huge path's memory budget anyway)."""
    del dtype  # canonicalized: c64 compute only (see docstring)
    from .bigstate import auto_chunks, execute_group_plan_chunked

    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has non-mixed-unitary channels; "
                         "use bigtraj.huge_trajectory_evolve")
    aug = spec.aug
    plan = get_group_plan(aug)
    planar = not plan.all_real
    if n_chunks is None:
        n_chunks = auto_chunks(program.num_qubits, planar=planar)
    operands = build_group_operands(aug, plan, params, jnp.complex64,
                                    overrides=_draw_overrides(spec, key))
    if n_chunks > 1:
        return execute_group_plan_chunked(plan, operands, aug, params,
                                          jnp.complex64, x, n_chunks,
                                          planar=planar)
    return execute_group_plan(plan, operands, aug, params, jnp.complex64,
                              x, planar=planar)
