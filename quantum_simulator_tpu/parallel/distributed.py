"""Distributed statevector engine: shard_map over a device mesh.

The amplitude vector of an n-qubit state is split across D = 2^g devices:
basis index = [g device bits | n-g local bits], preserving the engine's
qubit-0-is-MSB convention — qubit q < g lives in the device index, qubit
q >= g in the local block. (The reference has no distributed backend at
all; this is the new capability called out in SURVEY.md §5/§7.)

Execution model (hand-rolled shard_map, not GSPMD auto-sharding, so the
collective schedule is explicit and predictable):

* a gate whose targets are all *local* applies inside the shard with the
  standard segmented-einsum kernel — zero communication;
* a gate touching a *global* qubit first swaps that qubit with a local
  position. The swap exchanges the half-block where (local bit != device
  bit) between device pairs differing in that bit — ONE ``ppermute`` of
  half the local block, the minimum possible traffic for moving a qubit
  across the mesh;
* a **layout tracker** keeps the logical->physical qubit permutation and
  does NOT swap back after each gate: consecutive gates on a formerly
  global qubit pay the exchange once. The layout is restored to identity
  at the end of the program so the output sharding is canonical.

Everything is traceable and differentiable (``ppermute`` has a transpose
rule), so distributed VQE gradients flow through the collective schedule.
"""

from __future__ import annotations

import math
import os
import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..circuit import GateInstance, QuantumCircuit
from ..config import CONFIG
from ..ops import program as prog
from ..ops.apply import apply_gate
from ..utils.seeding import key_from_seed
from ..utils.xfer import to_host_complex

AMP_AXIS = "amp"


def shard_map_compat(f, mesh, in_specs, out_specs):
    """shard_map across jax API generations (check_vma vs check_rep)."""
    try:
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except (AttributeError, TypeError):  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map as _sm

        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)


def make_mesh(n_devices: int | None = None, axis_name: str = AMP_AXIS
              ) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (must be a power of 2
    for amplitude sharding)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices & (n_devices - 1):
        raise ValueError(f"n_devices must be a power of 2, got {n_devices}")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


# ---------------------------------------------------------------------------
# Shard-local primitives
# ---------------------------------------------------------------------------

def _swap_global_local(block: jnp.ndarray, g_pos: int, l_pos: int,
                       g: int, n_local: int, axis: str, n_devices: int
                       ) -> jnp.ndarray:
    """Physically exchange global qubit position ``g_pos`` (a device-index
    bit) with local position ``l_pos``.

    new(gbit=m, lbit=b) = old(gbit=b, lbit=m): each device keeps its half
    with local bit == its own device bit and trades the other half with
    the partner device across bit ``g_pos``.
    """
    bit_shift = g - 1 - g_pos  # device-index bit position (qubit 0 = MSB)
    mask = 1 << bit_shift
    my = jax.lax.axis_index(axis)
    my_bit = (my >> bit_shift) & 1

    l_idx = l_pos - g
    a = 1 << l_idx
    b = 1 << (n_local - l_idx - 1)
    b3 = block.reshape(a, 2, b)

    send = jnp.take(b3, 1 - my_bit, axis=1)   # half with lbit != my bit
    keep = jnp.take(b3, my_bit, axis=1)       # half with lbit == my bit
    perm = [(d, d ^ mask) for d in range(n_devices)]
    recv = jax.lax.ppermute(send, axis, perm)

    h0 = jnp.where(my_bit == 0, keep, recv)   # slot lbit = 0
    h1 = jnp.where(my_bit == 0, recv, keep)   # slot lbit = 1
    return jnp.stack([h0, h1], axis=1).reshape(block.shape)


class _Layout:
    """Tracks the logical-qubit -> physical-position permutation during
    trace-time program construction (host-side bookkeeping; the device
    code only sees the resulting static swap/apply schedule)."""

    def __init__(self, n: int):
        self.pos_of = list(range(n))   # logical qubit -> physical position
        self.qubit_at = list(range(n))  # physical position -> logical qubit

    def swap_positions(self, p1: int, p2: int):
        q1, q2 = self.qubit_at[p1], self.qubit_at[p2]
        self.qubit_at[p1], self.qubit_at[p2] = q2, q1
        self.pos_of[q1], self.pos_of[q2] = p2, p1


_SWAP_MAT = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


def _is_noswap_diag(op: prog.ProgramOp) -> bool:
    """Product-form diagonals (MCZ_k any width, CZ, CPhase): their action
    on a global (device-index) qubit is a per-shard SCALAR, so they never
    need ppermute swaps — including widths larger than the shard."""
    from ..ops.plan import _diag_product_value

    return op.gate_name == "CPhase" or _diag_product_value(op) is not None


def _is_noswap_1q_diag(op: prog.ProgramOp) -> bool:
    """1-target diagonals (Rz/Phase/Z/S/T...): on a global qubit they
    reduce to one per-shard scalar multiply — no swaps, no mask."""
    from ..ops.plan import _op_is_diagonal

    return len(op.targets) == 1 and _op_is_diagonal(op)


def _diag1_values(op: prog.ProgramOp, params):
    """(d0, d1) of a 1q diagonal: trace-time constants for static ops,
    traced scalars for Rz/Phase."""
    if op.static_matrix is not None:
        d = np.diagonal(op.static_matrix)
        return complex(d[0]), complex(d[1])
    if op.gate_name == "Rz":
        theta = params[op.param_offset]
        return jnp.exp(-0.5j * theta), jnp.exp(0.5j * theta)
    if op.gate_name == "Phase":
        phi = params[op.param_offset]
        return jnp.ones((), jnp.complex64), jnp.exp(1j * phi)
    raise ValueError(f"not a known 1q diagonal: {op.gate_name}")


def _build_schedule(program: prog.CircuitProgram, g: int,
                    noswap: set[int] = frozenset()) -> list[tuple]:
    """Host-side schedule: the layout-tracked swap/gate item list shared
    by the noiseless and noisy shard bodies (previously duplicated).

    Items:
      ("swap", g_pos, l_pos)    exchange device-index bit with local bit
      ("gate", op_i, local_ts)  apply program op at these local positions
      ("cphase", op_i, local_ts, global_ts)  product-form diagonal with
                                global targets: per-shard scalar x local
                                mask, NO swaps (ops listed in ``noswap``)
      ("gdiag1", op_i, g_pos)   1q diagonal on a global qubit: ONE
                                per-shard scalar multiply, NO swaps
      ("lswap", la, lb)         in-shard SWAP (restore phase only)
    Ends with the restore sequence bringing the layout back to identity so
    the output sharding is canonical.
    """
    n = program.num_qubits
    n_local = n - g
    max_arity = max((len(op.targets)
                     for oi, op in enumerate(program.ops)
                     if oi not in noswap), default=0)
    if max_arity > n_local:
        raise ValueError(
            f"a {max_arity}-qubit gate needs at least {max_arity} local "
            f"qubits per shard; n={n} over 2^{g} devices leaves only "
            f"{n_local} — use a smaller mesh")
    layout = _Layout(n)
    items: list[tuple] = []

    for oi, op in enumerate(program.ops):
        positions = [layout.pos_of[q] for q in op.targets]
        if oi in noswap and any(p < g for p in positions):
            if _is_noswap_diag(op):
                items.append(("cphase", oi,
                              tuple(sorted(p - g
                                           for p in positions if p >= g)),
                              tuple(sorted(p
                                           for p in positions if p < g))))
            else:  # 1q diagonal on a global qubit: scalar multiply
                items.append(("gdiag1", oi, positions[0]))
            continue
        for i, p in enumerate(positions):
            if p < g:
                # choose a local position not hosting another target
                taken = set(layout.pos_of[q] for q in op.targets)
                scratch = next(sp for sp in range(n - 1, g - 1, -1)
                               if sp not in taken)
                items.append(("swap", p, scratch))
                layout.swap_positions(p, scratch)
                positions[i] = scratch
        items.append(("gate", oi, tuple(p - g for p in positions)))

    # Restore identity layout.
    for p_target in range(g):
        if layout.qubit_at[p_target] == p_target:
            continue
        s = layout.pos_of[p_target]
        if s >= g:
            items.append(("swap", p_target, s))
            layout.swap_positions(p_target, s)
        else:
            # global<->global: route through a local scratch
            taken = {s, p_target}
            scratch = next(sp for sp in range(n - 1, g - 1, -1)
                           if sp not in taken)
            items.append(("swap", s, scratch))
            layout.swap_positions(s, scratch)
            items.append(("swap", p_target, scratch))
            layout.swap_positions(p_target, scratch)
    for p_target in range(g, n):
        while layout.qubit_at[p_target] != p_target:
            s = layout.pos_of[p_target]
            items.append(("lswap", p_target - g, s - g))
            layout.swap_positions(p_target, s)
    return items


def _cphase_op_value(op: prog.ProgramOp, params):
    """The product-form diagonal's phase v (trace-time constant for
    static ops; traced e^{i*phi} for CPhase)."""
    from ..ops.plan import _diag_product_value

    if op.gate_name == "CPhase" and op.num_params > 0:
        return jnp.exp(1j * params[op.param_offset])
    return _diag_product_value(op)


def _cphase_ind_and_value(op, local_ts, global_ts, params,
                          g: int, n_local: int, axis: str):
    """(indicator over the local block, phase v) for a product-form
    diagonal with device-index targets: ``gsel`` (all global target bits
    set in the shard id — one scalar per shard) times the local
    all-targets-set bit mask. Shared by the complex-block and planar
    shard bodies so the bit conventions live in ONE place."""
    v = _cphase_op_value(op, params)
    my = jax.lax.axis_index(axis)
    gsel = jnp.float32(1.0)
    for p in global_ts:
        gsel = gsel * ((my >> (g - 1 - p)) & 1).astype(jnp.float32)
    if not local_ts:
        return gsel, v  # scalar broadcasts over the block
    # Traced iota, NOT a numpy constant: a np mask of 2^n_local floats is
    # baked into the program as a multi-GiB literal PER cphase item
    # (measured: QFT-32's 34 cross-shard CPhases embedded 34 x 2 GiB of
    # constants and OOM-killed the host); the iota + bit-test chain fuses
    # into the block update and never materializes.
    idx = jax.lax.iota(jnp.uint32, 1 << n_local)
    mask = gsel
    for lp in local_ts:
        mask = mask * ((idx >> (n_local - 1 - lp)) & 1).astype(jnp.float32)
    return mask, v


def _apply_cphase_sharded(block, op, local_ts, global_ts, params,
                          g: int, n_local: int, axis: str):
    """``block *= 1 + (v-1) * ind`` on a flat complex shard block: the
    swap-free application of a product-form diagonal whose targets
    include device-index (global) qubits."""
    ind, v = _cphase_ind_and_value(op, local_ts, global_ts, params, g,
                                   n_local, axis)
    return block + (v - 1.0) * block * ind


def _gdiag1_scale(op, g_pos: int, params, g: int, axis: str,
                  dtype=jnp.complex64):
    """The per-shard complex scalar a 1q diagonal applies to a shard
    whose device-index bit at ``g_pos`` selects d0 or d1."""
    d0, d1 = _diag1_values(op, params)
    my = jax.lax.axis_index(axis)
    bit = (my >> (g - 1 - g_pos)) & 1
    return jnp.where(bit == 1, jnp.asarray(d1, dtype),
                     jnp.asarray(d0, dtype))


def _apply_gdiag1_sharded(block, op, g_pos: int, params, g: int, axis: str):
    """``block *= d[shard_bit]`` — a 1q diagonal on a device-index qubit
    is one complex scalar per shard."""
    return block * _gdiag1_scale(op, g_pos, params, g, axis, block.dtype)


# Shards at least this large run the group-matmul executor on gate runs
# between collectives instead of per-gate einsums (ROADMAP item 4).
_GROUPED_SHARD_MIN_QUBITS = 14


def _build_local_body(program: prog.CircuitProgram, g: int, n_devices: int,
                      axis: str, dtype,
                      take_state: bool = False) -> Callable:
    """Per-shard noiseless body: ``params -> local block (2^(n-g),)``.

    Gate runs between ppermute exchanges compose through the group-matmul
    plan (``ops/plan.py``) when the shard is large, so per-shard work has
    the same composed-operator efficiency as the single-chip path; XLA's
    latency-hiding scheduler overlaps the half-block ppermutes with
    whatever compute is dataflow-independent.

    ``take_state=True`` switches the signature to ``(block, params) ->
    block``: the program applies to an EXISTING local block instead of
    initializing |initial_index> — the building block for segmented
    deep-circuit runs (`sharded_apply_fn`).
    """
    n = program.num_qubits
    n_local = n - g
    if n_local < 1:
        raise ValueError("need at least 1 local qubit per shard")

    init_dev = program.initial_index >> n_local
    init_local = program.initial_index & ((1 << n_local) - 1)
    noswap = {oi for oi, op in enumerate(program.ops)
              if _is_noswap_diag(op) or _is_noswap_1q_diag(op)}
    schedule = _build_schedule(program, g, noswap)
    grouped = n_local >= _GROUPED_SHARD_MIN_QUBITS

    if not grouped:
        def body(*fn_args):
            from ..ops.apply import apply_cphase

            if take_state:
                block, params = fn_args
                block = block.astype(dtype)
            else:
                (params,) = fn_args
                my = jax.lax.axis_index(axis)
                amp0 = jnp.where(my == init_dev,
                                 jnp.ones((), dtype=dtype),
                                 jnp.zeros((), dtype))
                block = jnp.zeros(1 << n_local,
                                  dtype=dtype).at[init_local].set(amp0)
            swap_mat = jnp.asarray(_SWAP_MAT, dtype=dtype)
            for item in schedule:
                if item[0] == "swap":
                    block = _swap_global_local(block, item[1], item[2], g,
                                               n_local, axis, n_devices)
                elif item[0] == "cphase":
                    block = _apply_cphase_sharded(
                        block, program.ops[item[1]], item[2], item[3],
                        params, g, n_local, axis)
                elif item[0] == "gdiag1":
                    block = _apply_gdiag1_sharded(
                        block, program.ops[item[1]], item[2], params, g,
                        axis)
                elif item[0] == "gate":
                    op = program.ops[item[1]]
                    if op.cphase_value is not None:
                        block = apply_cphase(block, item[2],
                                             op.cphase_value, n_local)
                    else:
                        u = program.op_matrix(op, params, dtype)
                        block = apply_gate(block, u, item[2], n_local)
                else:  # lswap
                    block = apply_gate(block, swap_mat,
                                       (item[1], item[2]), n_local)
            return block

        return body

    # Grouped mode: planar (2, 2^n_local) float32 block; gate runs between
    # swaps become mini group plans (composed matmul steps).
    import dataclasses

    from ..ops.plan import (
        GroupLayout,
        build_group_plan,
        build_group_operands,
        execute_group_plan,
    )

    mini_layout = GroupLayout.for_qubits(n_local)

    def _local_op(oi: int, local_ts: tuple[int, ...]) -> prog.ProgramOp:
        if oi < 0:  # restore-phase in-shard SWAP
            return prog.ProgramOp(
                gate_name="SWAP", targets=local_ts, param_offset=0,
                num_params=0, column_index=0, static_matrix=_SWAP_MAT,
                jnp_builder=None, gate_index=-1)
        return dataclasses.replace(program.ops[oi], targets=local_ts)

    def _mini_program(gate_items: list[tuple]) -> prog.CircuitProgram:
        ops = tuple(_local_op(oi, local_ts)
                    for _, oi, local_ts in gate_items)
        return prog.CircuitProgram(
            num_qubits=n_local, initial_index=0, ops=ops,
            num_columns=len(ops), num_params=program.num_params,
            initial_params=program.initial_params, compile_key=())

    # Pre-split the schedule into swap items and gate runs, and pre-build
    # the mini plans (host-side, once per trace).
    segments: list[tuple] = []   # ("swap", gp, lp) | ("run", mini_prog, plan)
    run: list[tuple] = []

    def close_run():
        if run:
            mp = _mini_program(run)
            segments.append(("run", mp, build_group_plan(mp)))
            run.clear()

    for item in schedule:
        if item[0] == "swap":
            close_run()
            segments.append(item)
        elif item[0] in ("cphase", "gdiag1"):
            close_run()
            segments.append(item)
        elif item[0] == "gate":
            run.append(item)
        else:  # lswap -> in-shard SWAP gate inside the run
            run.append(("gate", -1, (item[1], item[2])))
    close_run()

    def body(*fn_args):
        if take_state:
            block, params = fn_args
            x = jnp.stack([jnp.real(block), jnp.imag(block)]) \
                   .astype(jnp.float32)
        else:
            (params,) = fn_args
            my = jax.lax.axis_index(axis)
            amp0 = jnp.where(my == init_dev, jnp.float32(1.0),
                             jnp.float32(0.0))
            # outer-product one-hot (a scatter into the big planar buffer
            # blows XLA compile time ~25x at large n — see
            # ops/plan._planar_basis_state)
            from ..ops.plan import _planar_basis_state

            x = (_planar_basis_state(mini_layout, init_local)
                 .reshape(2, 1 << n_local) * amp0)
        for seg in segments:
            if seg[0] == "swap":
                # the complex plane is one extra MSB on the flat planar
                # block: shift local coordinates by +1
                flat = x.reshape(-1)
                flat = _swap_global_local(flat, seg[1], seg[2] + 1, g,
                                          n_local + 1, axis, n_devices)
                x = flat.reshape(2, 1 << n_local)
            elif seg[0] == "cphase":
                # planar twin of _apply_cphase_sharded on the (2, L) block
                ind, v = _cphase_ind_and_value(
                    program.ops[seg[1]], seg[2], seg[3], params, g,
                    n_local, axis)
                vr = (jnp.real(v) - 1.0).astype(jnp.float32)
                vi = jnp.imag(v).astype(jnp.float32)
                xr, xi = x[0], x[1]
                x = jnp.stack([xr + ind * (vr * xr - vi * xi),
                               xi + ind * (vr * xi + vi * xr)])
            elif seg[0] == "gdiag1":
                scale = _gdiag1_scale(program.ops[seg[1]], seg[2], params,
                                      g, axis)
                sr = jnp.real(scale).astype(jnp.float32)
                si = jnp.imag(scale).astype(jnp.float32)
                x = jnp.stack([sr * x[0] - si * x[1],
                               si * x[0] + sr * x[1]])
            else:
                _, mp, plan = seg
                operands = build_group_operands(mp, plan, params, dtype)
                xs = x.reshape((2,) + tuple(mini_layout.axis_sizes))
                xs = execute_group_plan(plan, operands, mp, params, dtype,
                                        xs)
                x = xs.reshape(2, 1 << n_local)
        return (x[0] + 1j * x[1]).astype(dtype)

    return body


def local_forward_body(program: prog.CircuitProgram, g: int,
                       n_devices: int, axis: str, dtype) -> Callable:
    """Public per-shard forward body: ``params -> local amplitude block``.

    Compose this into larger shard_map programs (cost functions, VQE
    steps — see ``parallel/vqe.py``). ``g`` = log2(n_devices) device-index
    bits; the block has the 2^(n-g) least-significant amplitudes.
    """
    return _build_local_body(program, g, n_devices, axis, dtype)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _build_noisy_local_body(program: prog.CircuitProgram, noise_model,
                            g: int, n_devices: int, axis: str,
                            dtype) -> Callable:
    """Per-shard stochastic-trajectory body: ``(params, key) -> block``.

    Kraus channels apply to LOCAL qubit positions (the layout tracker
    moves global targets down first); branch probabilities are global
    norms (``psum`` over the mesh), and the categorical draw uses the
    replicated key so every shard selects the same branch.
    """
    n = program.num_qubits
    n_local = n - g
    init_dev = program.initial_index >> n_local
    init_local = program.initial_index & ((1 << n_local) - 1)
    # No-swap diagonals only for ops WITHOUT noise channels: per-target
    # Kraus application needs the target local, so noisy diagonals keep
    # the swap schedule (a wider-than-shard MCZ with attached noise is
    # rejected by the schedule's arity check with guidance).
    noswap = {oi for oi, op in enumerate(program.ops)
              if (_is_noswap_diag(op) or _is_noswap_1q_diag(op))
              and not noise_model.kraus_stacks_for_gate(op.gate_name)}
    schedule = _build_schedule(program, g, noswap)

    total_draws = 0
    for op in program.ops:
        total_draws += len(noise_model.kraus_stacks_for_gate(op.gate_name)) \
            * len(op.targets)
    total_draws = max(1, total_draws)

    def body(params, key):
        my = jax.lax.axis_index(axis)
        amp0 = jnp.where(my == init_dev,
                         jnp.ones((), dtype=dtype), jnp.zeros((), dtype))
        block = jnp.zeros(1 << n_local, dtype=dtype).at[init_local].set(amp0)
        keys = jax.random.split(key, total_draws)
        draw = 0
        hi = jax.lax.Precision.HIGHEST
        swap_mat = jnp.asarray(_SWAP_MAT, dtype=dtype)

        from ..ops.apply import apply_cphase

        for item in schedule:
            if item[0] == "swap":
                block = _swap_global_local(block, item[1], item[2], g,
                                           n_local, axis, n_devices)
                continue
            if item[0] == "lswap":
                block = apply_gate(block, swap_mat, (item[1], item[2]),
                                   n_local)
                continue
            if item[0] == "cphase":  # noise-free by construction
                block = _apply_cphase_sharded(
                    block, program.ops[item[1]], item[2], item[3],
                    params, g, n_local, axis)
                continue
            if item[0] == "gdiag1":  # noise-free by construction
                block = _apply_gdiag1_sharded(
                    block, program.ops[item[1]], item[2], params, g, axis)
                continue
            op = program.ops[item[1]]
            local_ts = item[2]
            if op.cphase_value is not None:
                block = apply_cphase(block, local_ts, op.cphase_value,
                                     n_local)
            else:
                u = program.op_matrix(op, params, dtype)
                block = apply_gate(block, u, local_ts, n_local)
            for kraus_np in noise_model.kraus_stacks_for_gate(op.gate_name):
                kraus = jnp.asarray(kraus_np, dtype=dtype)
                for lq in local_ts:
                    # Branch probabilities from the GLOBAL 1q reduced
                    # density matrix (local partial + psum), then apply
                    # only the drawn operator.
                    a = 1 << lq
                    b = 1 << (n_local - lq - 1)
                    st = block.reshape(a, 2, b)
                    rho = jax.lax.psum(
                        jnp.einsum("aib,ajb->ij", st, jnp.conj(st),
                                   precision=hi), axis)
                    norms = jnp.real(jnp.einsum(
                        "mij,jk,mik->m", kraus, rho, jnp.conj(kraus),
                        precision=hi))
                    idx = jax.random.categorical(
                        keys[draw], jnp.log(norms + 1e-30))
                    k_sel = jnp.take(kraus, idx, axis=0)
                    block = apply_gate(block, k_sel, (lq,), n_local)
                    block = block / jnp.sqrt(jnp.maximum(
                        jnp.take(norms, idx), 1e-30))
                    draw += 1
        return block

    return body


def sharded_trajectory_fn(program: prog.CircuitProgram, noise_model,
                          mesh: Mesh, dtype=None) -> Callable:
    """jitted ``f(params, key) -> sharded noisy state`` — one stochastic
    trajectory with every Kraus selection made consistently across the
    mesh (global branch norms by psum, replicated draw keys)."""
    dtype = dtype or CONFIG.dtype
    axis = mesh.axis_names[0]
    n_devices = mesh.shape[axis]
    g = int(math.log2(n_devices))
    if 2**g != n_devices:
        raise ValueError("mesh size must be a power of 2")
    body = _build_noisy_local_body(program, noise_model, g, n_devices,
                                   axis, dtype)
    fn = shard_map_compat(body, mesh=mesh, in_specs=(P(), P()),
                          out_specs=P(axis))
    return jax.jit(fn, out_shardings=NamedSharding(mesh, P(axis)))


def sharded_forward_fn(program: prog.CircuitProgram, mesh: Mesh,
                       dtype=None) -> Callable:
    """jitted ``f(params) -> global sharded state (2^n,)`` over ``mesh``."""
    dtype = dtype or CONFIG.dtype
    axis = mesh.axis_names[0]
    n_devices = mesh.shape[axis]
    g = int(math.log2(n_devices))
    if 2**g != n_devices:
        raise ValueError("mesh size must be a power of 2")

    body = _build_local_body(program, g, n_devices, axis, dtype)
    fn = shard_map_compat(body, mesh=mesh, in_specs=(P(),),
                          out_specs=P(axis))
    out_sharding = NamedSharding(mesh, P(axis))
    return jax.jit(fn, out_shardings=out_sharding)


def _qubit_bloch_body(n: int, g: int, axis: str,
                      n_devices: int) -> Callable:
    """Per-shard body computing every qubit's (z, Re c, Im c) in ONE
    program, where z = <Z_q> and c = sum_{j: bit_q=0} conj(x_j) x_{j^m}
    (so <X_q> = 2 Re c, <Y_q> = 2 Im c, and the reduced rho_q is
    [[ (1+z)/2, conj(c) ], [ c, (1-z)/2 ]]).

    Local qubits pair within the shard (zero communication); device-bit
    qubits pair across ONE ppermute of the block each. Output is float
    (n, 3) — complex never crosses the host boundary.
    """
    n_local = n - g

    def body(block):
        my = jax.lax.axis_index(axis)
        abs2 = jnp.abs(block) ** 2
        shard_prob = jnp.sum(abs2)
        rows = []
        for q in range(n):
            if q < g:
                bit_shift = g - 1 - q
                my_bit = (my >> bit_shift) & 1
                sign = 1.0 - 2.0 * my_bit.astype(jnp.float32)
                z = jax.lax.psum(sign * shard_prob, axis)
                perm = [(d, d ^ (1 << bit_shift))
                        for d in range(n_devices)]
                partner = jax.lax.ppermute(block, axis, perm)
                pair = jnp.sum(jnp.conj(block) * partner)
                zero = jnp.zeros((), pair.dtype)
                contrib = jnp.where(my_bit == 0, pair, zero)
                c = jax.lax.psum(contrib, axis)
            else:
                l_idx = q - g
                a = 1 << l_idx
                b = 1 << (n_local - l_idx - 1)
                b3 = block.reshape(a, 2, b)
                x0, x1 = b3[:, 0, :], b3[:, 1, :]
                z = jax.lax.psum(
                    jnp.sum(jnp.abs(x0) ** 2 - jnp.abs(x1) ** 2), axis)
                c = jax.lax.psum(jnp.sum(jnp.conj(x0) * x1), axis)
            rows.append(jnp.stack([z.astype(jnp.float32),
                                   jnp.real(c).astype(jnp.float32),
                                   jnp.imag(c).astype(jnp.float32)]))
        return jnp.stack(rows)

    return body


def sharded_apply_fn(program: prog.CircuitProgram, mesh: Mesh,
                     dtype=None) -> Callable:
    """jitted ``f(global_state, params) -> global sharded state``:
    applies an already-compiled program to an EXISTING mesh-sharded
    state (the state argument is donated).

    This is the segmented-execution primitive: a deep circuit whose
    columns repeat structurally (brickwork, Trotter steps, ansatz
    layers) splits into segments that share ONE compiled apply-fn and
    differ only in their param vectors — giving per-segment progress,
    checkpointing, and mid-circuit re-entry on runs that take hours
    (`scripts/mesh_stretch_check.py --segment-cols`). Breaks the
    reference's whole-circuit-per-process execution model
    (`/root/reference/quantum_sim/engine/simulator.py` runs start to
    finish in one call with no state re-entry).
    """
    dtype = dtype or CONFIG.dtype
    axis = mesh.axis_names[0]
    n_devices = mesh.shape[axis]
    g = int(math.log2(n_devices))
    if 2**g != n_devices:
        raise ValueError("mesh size must be a power of 2")

    body = _build_local_body(program, g, n_devices, axis, dtype,
                             take_state=True)
    fn = shard_map_compat(body, mesh=mesh, in_specs=(P(axis), P()),
                          out_specs=P(axis))
    out_sharding = NamedSharding(mesh, P(axis))
    return jax.jit(fn, out_shardings=out_sharding, donate_argnums=0)


def with_basis_rotation(circuit: QuantumCircuit,
                        basis: str) -> QuantumCircuit:
    """A copy of ``circuit`` with the measurement-basis rotation appended
    as gate columns: X = H on every qubit, Y = S_DAG then H (the same
    unitaries ``measurement.py``'s state rotation applies; reference
    semantics at ``measurement.py:91-98``)."""
    basis = str(getattr(basis, "value", basis)).upper()
    if basis not in ("Z", "X", "Y"):
        raise ValueError(f"unknown measurement basis {basis!r}")
    if basis == "Z":
        return circuit
    out = QuantumCircuit.from_dict(circuit.to_dict())
    col = 1 + max((g.column for g in out.gates), default=-1)
    if basis == "Y":
        for q in range(out.num_qubits):
            out.add_gate(GateInstance("S_DAG", [q], [], column=col))
        col += 1
    for q in range(out.num_qubits):
        out.add_gate(GateInstance("H", [q], [], column=col))
    return out


class DistributedStateVector:
    """An n-qubit state sharded across a device mesh."""

    def __init__(self, global_array: jax.Array, num_qubits: int, mesh: Mesh):
        self._data = global_array
        self._num_qubits = num_qubits
        self._mesh = mesh

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def device_data(self) -> jax.Array:
        return self._data

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def probabilities(self) -> np.ndarray:
        """Host copy of |amp|^2 (gathers across the mesh)."""
        return np.asarray(jnp.abs(self._data) ** 2, dtype=np.float64)

    @property
    def data(self) -> np.ndarray:
        """Host complex128 copy (gathers across the mesh)."""
        return to_host_complex(self._data)

    def norm(self) -> float:
        return float(jnp.sum(jnp.abs(self._data) ** 2))


def _check_mesh_amplitude_cap(circuit: QuantumCircuit, mesh: Mesh) -> None:
    """Per-mesh amplitude cap: each device holds 2^n / D amplitudes, so a
    D-device mesh extends the single-chip cap by log2(D) qubits. The
    circuit IR's own cap is structural only (config.max_circuit_qubits
    admits Clifford-engine widths); amplitude engines validate here."""
    from ..config import CONFIG

    n_dev = int(mesh.devices.size)
    cap = CONFIG.max_qubits + max(0, n_dev.bit_length() - 1)
    if circuit.num_qubits > cap:
        raise ValueError(
            f"num_qubits must be <= {cap} on a {n_dev}-device mesh "
            f"(= max_qubits {CONFIG.max_qubits} + log2(devices)), got "
            f"{circuit.num_qubits}")


class DistributedSimulator:
    """Circuit execution over a device mesh (forward path + sampling)."""

    def __init__(self, mesh: Mesh | None = None,
                 n_devices: int | None = None):
        self._mesh = mesh if mesh is not None else make_mesh(n_devices)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def run(self, circuit: QuantumCircuit) -> DistributedStateVector:
        _check_mesh_amplitude_cap(circuit, self._mesh)
        program = prog.compile_circuit(circuit)
        fn = sharded_forward_fn(program, self._mesh)
        state = fn(jnp.asarray(program.initial_params))
        return DistributedStateVector(state, circuit.num_qubits, self._mesh)

    def run_segmented(self, circuit: QuantumCircuit, segment_columns: int,
                      progress: Callable | None = None,
                      checkpoint_dir: str | None = None,
                      resume: bool = True) -> DistributedStateVector:
        """``run`` split into column segments of ``segment_columns``.

        Result is identical to ``run``; the point is operational:
        per-segment progress on multi-hour deep/wide runs, and ONE
        compile shared by every structurally identical segment
        (brickwork / Trotter / ansatz layers repeat, so a depth-40
        circuit compiles its 4-column period once instead of tracing
        950 schedule items in one program). ``progress(seg_idx,
        n_segments, wall_s)`` fires after each segment completes
        (synchronized).

        ``checkpoint_dir`` persists the sharded state after every
        segment (per-shard split-plane files — ``parallel/checkpoint``);
        with ``resume=True`` a rerun of the SAME circuit/segmenting/mesh
        picks up from the newest checkpoint instead of |init>. The
        checkpoint identity is the full ``circuit_hash`` (params
        included), so a changed circuit restarts from scratch rather
        than continuing the wrong state.
        """
        _check_mesh_amplitude_cap(circuit, self._mesh)
        if segment_columns < 1:
            raise ValueError("segment_columns must be >= 1")
        n = circuit.num_qubits
        n_cols = 1 + max((gt.column for gt in circuit.gates), default=-1)
        bounds = list(range(0, max(n_cols, 1), segment_columns))

        start_seg = 0
        ck_meta = None
        if checkpoint_dir:
            from . import checkpoint as ckpt

            ck_meta = {"circuit_hash": circuit.circuit_hash(),
                       "segment_columns": segment_columns,
                       "num_qubits": n,
                       "n_devices": int(
                           self._mesh.shape[self._mesh.axis_names[0]])}
            latest = ckpt.read_latest(checkpoint_dir) if resume and \
                os.path.isdir(checkpoint_dir) else None
            if latest is not None:
                man = ckpt.load_manifest(latest)
                if man["meta"].get("run") == ck_meta:
                    state = ckpt.load_sharded_state(latest, self._mesh)
                    start_seg = int(man["meta"]["next_segment"])

        if start_seg == 0:
            init = QuantumCircuit(n)
            init.initial_states = list(circuit.initial_states)
            state = self.run(init).device_data

        fns: dict[int, Callable] = {}
        n_segments = len(bounds)
        for si, lo in enumerate(bounds):
            if si < start_seg:
                continue
            hi = lo + segment_columns
            seg = QuantumCircuit(n)
            for gt in sorted(circuit.gates, key=lambda x: x.column):
                if lo <= gt.column < hi:
                    seg.add_gate(GateInstance(
                        gt.gate_name, list(gt.target_qubits),
                        list(gt.params), column=gt.column - lo))
            if not seg.gates:
                continue
            program = prog.compile_circuit(seg)
            key = seg.structure_hash()
            if key not in fns:
                fns[key] = sharded_apply_fn(program, self._mesh)
            t0 = time.perf_counter()
            state = fns[key](state, jnp.asarray(program.initial_params))
            if progress is not None:
                state.block_until_ready()
                progress(si, n_segments, time.perf_counter() - t0)
            if checkpoint_dir:
                from . import checkpoint as ckpt

                seg_name = f"seg_{si}"
                ckpt.save_sharded_state(
                    state, os.path.join(checkpoint_dir, seg_name),
                    meta={"run": ck_meta, "next_segment": si + 1})
                ckpt.write_latest(checkpoint_dir, seg_name)
        return DistributedStateVector(state, n, self._mesh)

    def run_noisy_trajectory(self, circuit: QuantumCircuit, noise_model,
                             seed: int | None = None
                             ) -> DistributedStateVector:
        """One stochastic-Kraus trajectory over the mesh."""
        _check_mesh_amplitude_cap(circuit, self._mesh)
        program = prog.compile_circuit(circuit)
        fn = sharded_trajectory_fn(program, noise_model, self._mesh)
        rng = np.random.default_rng(seed)
        key = key_from_seed(int(rng.integers(0, 2**63)))
        state = fn(jnp.asarray(program.initial_params), key)
        return DistributedStateVector(state, circuit.num_qubits, self._mesh)

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1024,
                       trajectories: int | None = None,
                       seed: int | None = None,
                       rng: np.random.Generator | None = None
                       ) -> dict[str, int]:
        """Noisy measurement counts on the mesh: the Monte-Carlo
        trajectory estimator ``Simulator.run_with_noise`` uses for huge
        states (``simulator.py:440-446``), at mesh scale.

        T stochastic-Kraus trajectories run through ONE compiled sharded
        trajectory program (fresh key per trajectory, params fixed) and
        each is sampled ~shots/T times shard-locally — no full-state
        gather anywhere. Default T = min(shots, 16): every trajectory
        is a full sharded forward, so shot-per-trajectory (reference
        semantics, ``/root/reference/quantum_sim/engine/simulator.py:
        134-145``) is the ``trajectories=shots`` extreme of the same
        estimator.
        """
        _check_mesh_amplitude_cap(circuit, self._mesh)
        if rng is None:
            rng = np.random.default_rng(seed)
        if noise_model is None or not noise_model.has_channels():
            return self.sample(self.run(circuit), shots, rng=rng)
        T = max(1, min(shots,
                       16 if trajectories is None else trajectories))
        program = prog.compile_circuit(circuit)
        fn = sharded_trajectory_fn(program, noise_model, self._mesh)
        params = jnp.asarray(program.initial_params)
        base, extra = divmod(shots, T)
        total: dict[str, int] = {}
        for i in range(T):
            take = base + (1 if i < extra else 0)
            if take == 0:
                break
            key = key_from_seed(int(rng.integers(0, 2**63)))
            state = DistributedStateVector(fn(params, key),
                                           circuit.num_qubits, self._mesh)
            for bits, cnt in self.sample(state, take, rng=rng).items():
                total[bits] = total.get(bits, 0) + cnt
        return total

    def qubit_density_matrices(self, state: DistributedStateVector
                               ) -> np.ndarray:
        """(n, 2, 2) single-qubit reduced density matrices of a sharded
        pure state, all qubits in ONE compiled program: local qubits
        pair in-shard, device-bit qubits pair across one ppermute each.
        No full-state gather; O(n) floats cross to the host.

        Reference analog: per-qubit ``partial_trace``
        (``/root/reference/quantum_sim/engine/state_vector.py:121-140``),
        which materializes rho on one host — impossible at mesh n.
        """
        n = state.num_qubits
        if not hasattr(self, "_bloch_fns"):
            self._bloch_fns = {}
        if n not in self._bloch_fns:   # one compile per qubit count
            axis = self._mesh.axis_names[0]
            n_devices = int(self._mesh.shape[axis])
            g = int(math.log2(n_devices))
            body = _qubit_bloch_body(n, g, axis, n_devices)
            self._bloch_fns[n] = jax.jit(shard_map_compat(
                body, mesh=self._mesh, in_specs=(P(axis),),
                out_specs=P()))
        zc = np.asarray(self._bloch_fns[n](state.device_data),
                        dtype=np.float64)
        rhos = np.empty((n, 2, 2), dtype=np.complex128)
        for q in range(n):
            z, cr, ci = zc[q]
            c = cr + 1j * ci          # sum_{j0} conj(x_j0) x_j1
            rhos[q] = [[(1 + z) / 2, np.conj(c)], [c, (1 - z) / 2]]
        return rhos

    def ensemble_qubit_density_matrices(self, circuit: QuantumCircuit,
                                        noise_model,
                                        n_trials: int = 50,
                                        seed: int | None = None
                                        ) -> np.ndarray:
        """(n, 2, 2) ensemble-averaged single-qubit reduced density
        matrices over stochastic-Kraus trajectories, at mesh scale —
        the sharded twin of ``Simulator.ensemble_qubit_density_matrices``
        (reference analog ``ensemble_density_matrix``,
        ``simulator.py:155-199``, which is 4^n and single-host). One
        compiled trajectory program + one compiled reduction program,
        reused across trials.
        """
        rng = np.random.default_rng(seed)
        n = circuit.num_qubits
        if noise_model is None or not noise_model.has_channels():
            return self.qubit_density_matrices(self.run(circuit))
        program = prog.compile_circuit(circuit)
        fn = sharded_trajectory_fn(program, noise_model, self._mesh)
        params = jnp.asarray(program.initial_params)
        acc = np.zeros((n, 2, 2), dtype=np.complex128)
        for _ in range(max(1, n_trials)):
            key = key_from_seed(int(rng.integers(0, 2**63)))
            state = DistributedStateVector(fn(params, key), n, self._mesh)
            acc += self.qubit_density_matrices(state)
        return acc / max(1, n_trials)

    def expectation_z(self, state: DistributedStateVector,
                      qubit: int) -> float:
        """<Z_qubit> on a sharded state — shard-local Z-parity signs
        (device-index bit or per-shard iota) + psum; no 2^n iota, no
        gather, O(2^(n-g)) per-shard work."""
        from .vqe import shard_local_z_sign

        n = state.num_qubits
        axis = self._mesh.axis_names[0]
        n_devices = self._mesh.shape[axis]
        g = int(math.log2(n_devices))

        def body(block):
            sign = shard_local_z_sign(qubit, n, g, axis)
            partial = jnp.sum(jnp.abs(block) ** 2 * sign)
            return jax.lax.psum(partial, axis)

        fn = shard_map_compat(body, mesh=self._mesh,
                              in_specs=(P(axis),), out_specs=P())
        return float(jax.jit(fn)(state.device_data))

    def fidelity(self, a: DistributedStateVector,
                 b: DistributedStateVector) -> float:
        """|<a|b>|^2 between two sharded states."""
        return float(jnp.abs(jnp.vdot(
            a.device_data, b.device_data,
            precision=jax.lax.Precision.HIGHEST)) ** 2)

    def expectation_pauli_string(self, state: DistributedStateVector,
                                 qubits, paulis: str) -> float:
        """<prod P_i> for a mixed X/Y/Z string on a sharded state. A
        Pauli string is a signed permutation, so

            <P> = Re[ i^k * sum_j conj(x[j ^ mask]) sign(j) x[j] ],

        evaluated shard-locally: the device-bit part of the XOR mask is
        ONE ppermute (each shard exchanges with its partner), local-bit
        flips are axis reversals of the exposed bit dims, signs ride a
        broadcast [1,-1] product — then a single psum. No gather, no
        rotation, no state copy. Same convention as
        ``PlanarStateVector.expectation_pauli_string`` (single-chip
        twin); reference anchor
        ``/root/reference/quantum_sim/engine/analysis.py:222-248``."""
        qubits = [int(q) for q in qubits]
        paulis = paulis.upper()
        if len(paulis) != len(qubits):
            raise ValueError(
                f"{len(qubits)} qubits but {len(paulis)} Paulis")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"duplicate qubits in {qubits}")
        if any(p not in "XYZ" for p in paulis):
            raise ValueError(f"Paulis must be X/Y/Z, got {paulis!r}")
        if not qubits:
            return 1.0
        n = state.num_qubits
        if min(qubits) < 0 or max(qubits) >= n:
            raise ValueError(f"qubits {qubits} out of range for n={n}")
        axis = self._mesh.axis_names[0]
        n_devices = self._mesh.shape[axis]
        g = int(math.log2(n_devices))
        nl = n - g  # local bits
        dev_flip = dev_sign = loc_flip = loc_sign = 0
        for q, p in zip(qubits, paulis):
            if q < g:
                bit = 1 << (g - 1 - q)
                if p in "XY":
                    dev_flip |= bit
                if p in "ZY":
                    dev_sign |= bit
            else:
                bit = 1 << (n - 1 - q)
                if p in "XY":
                    loc_flip |= bit
                if p in "ZY":
                    loc_sign |= bit
        k = paulis.count("Y")
        # Expose every masked local bit as its own size-2 dim once; flip
        # the X/Y dims, broadcast-multiply [1,-1] on the Z/Y dims.
        positions = [b for b in range(nl)
                     if (loc_flip | loc_sign) >> (nl - 1 - b) & 1]
        dims: list[int] = []
        flip_axes: list[int] = []
        sign_axes: list[int] = []
        prev = 0
        for b in positions:
            span = b - prev
            if span:
                dims.append(1 << span)
            if loc_flip >> (nl - 1 - b) & 1:
                flip_axes.append(len(dims))
            if loc_sign >> (nl - 1 - b) & 1:
                sign_axes.append(len(dims))
            dims.append(2)
            prev = b + 1
        if nl - prev:
            dims.append(1 << (nl - prev))
        dims_t = tuple(dims)

        def body(block):
            t = block
            if dev_flip:
                perm = [(s, s ^ dev_flip) for s in range(n_devices)]
                t = jax.lax.ppermute(t, axis, perm)
            if flip_axes:
                t = jnp.flip(t.reshape(dims_t),
                             axis=tuple(flip_axes)).reshape(-1)
            p = jnp.conj(t) * block
            if sign_axes:
                p = p.reshape(dims_t)
                pm = jnp.asarray([1.0, -1.0], p.real.dtype)
                for sa in sign_axes:
                    shape = [1] * len(dims_t)
                    shape[sa] = 2
                    p = p * pm.reshape(shape)
            s = jnp.sum(p)
            if dev_sign:
                my = jax.lax.axis_index(axis)
                par = jnp.zeros((), jnp.int32)
                for b in range(g):
                    if dev_sign >> (g - 1 - b) & 1:
                        par = par + ((my >> (g - 1 - b)) & 1)
                s = jnp.where(par % 2 == 1, -s, s)
            return (jax.lax.psum(jnp.real(s), axis),
                    jax.lax.psum(jnp.imag(s), axis))

        fn = shard_map_compat(body, mesh=self._mesh,
                              in_specs=(P(axis),), out_specs=(P(), P()))
        s_re, s_im = (float(v) for v in jax.jit(fn)(state.device_data))
        return (s_re, -s_im, -s_re, s_im)[k % 4]

    def sample(self, state: DistributedStateVector, shots: int,
               rng: np.random.Generator | None = None) -> dict[str, int]:
        """Measurement counts via a fully shard-local inverse-CDF sampler.

        Each shard owns a contiguous slice of the distribution and claims
        the draws whose first uniform lands in its interval. Within the
        shard a draw picks a tile of ``S`` amplitudes by a second uniform
        (scaled by the shard's mass, binary search over the tile sums)
        and its amplitude by a third (scaled by the tile's mass), so every
        level resolves in f32 whatever 2^n is — one uniform over the
        whole CDF could not tell single amplitudes apart once they fall
        below its f32 resolution. A psum combines the per-shot
        (shard id, local index) pairs — the full 2^n distribution is never
        materialized on any device or on the host.
        """
        rng = rng or np.random.default_rng()
        axis = self._mesh.axis_names[0]
        n_devices = self._mesh.shape[axis]
        n_local = state.num_qubits - int(math.log2(n_devices))
        uniforms = jnp.asarray(rng.random((3, shots), dtype=np.float64)
                               .astype(np.float32))
        tile = 1 << min(n_local, 14)
        batch = max(1, min(shots, 2048))

        def body(block, u):
            probs = jnp.abs(block) ** 2
            rows = probs.reshape(-1, tile)
            bsums = jnp.sum(rows, axis=1)
            local_sum = jnp.sum(bsums)
            sums = jax.lax.all_gather(local_sum, axis)          # (D,)
            my = jax.lax.axis_index(axis)
            # One shared cumsum defines every shard boundary: shard i owns
            # [bounds[i-1], bounds[i]). Computing prefixes with per-shard
            # masked sums instead would reassociate floats, opening 1-ulp
            # gaps/overlaps between adjacent shards' intervals.
            bounds = jnp.cumsum(sums)                           # (D,)
            prefix = jnp.where(my > 0, bounds[jnp.maximum(my - 1, 0)], 0.0)
            upper = bounds[my]
            total = bounds[n_devices - 1]
            u_scaled = u[0] * total
            claimed = (u_scaled >= prefix) & (
                (u_scaled < upper) | (my == n_devices - 1))
            bcdf = jnp.cumsum(bsums)
            b = jnp.clip(jnp.searchsorted(bcdf, u[1] * bcdf[-1],
                                          side="right"),
                         0, rows.shape[0] - 1)

            def in_tile(args):
                bb, uu = args
                tcdf = jnp.cumsum(jnp.take(rows, bb, axis=0), axis=1)
                return jax.vmap(lambda row, q: jnp.searchsorted(
                    row, q * row[-1], side="right"))(tcdf, uu)

            pad = (-shots) % batch
            j = jax.lax.map(in_tile, (
                jnp.pad(b, (0, pad)).reshape(-1, batch),
                jnp.pad(u[2], (0, pad)).reshape(-1, batch)))
            j = jnp.clip(j.reshape(-1)[:shots], 0, tile - 1)
            idx_local = (b * tile + j).astype(jnp.int32)
            shard_of = jax.lax.psum(
                jnp.where(claimed, my.astype(jnp.int32), 0), axis)
            local_of = jax.lax.psum(jnp.where(claimed, idx_local, 0), axis)
            return shard_of, local_of

        fn = shard_map_compat(body, mesh=self._mesh,
                              in_specs=(P(axis), P(None, None)),
                              out_specs=(P(), P()))
        shard_of, local_of = jax.jit(fn)(state.device_data, uniforms)
        shard_of = np.asarray(shard_of).astype(np.int64)
        local_of = np.asarray(local_of).astype(np.int64)
        global_idx = (shard_of << n_local) | local_of
        n = state.num_qubits
        from ..native import histogram_from_indices_native

        native = histogram_from_indices_native(global_idx, n)
        if native is not None:
            return native
        values, freq = np.unique(global_idx, return_counts=True)
        return {format(int(v), f"0{n}b"): int(c)
                for v, c in zip(values, freq)}

    def sample_with_basis(self, circuit: QuantumCircuit, shots: int,
                          basis: str = "Z",
                          rng: np.random.Generator | None = None,
                          readout_error=None) -> dict[str, int]:
        """Basis-rotated measurement counts on the mesh.

        Mirrors ``MeasurementEngine.sample_with_basis`` semantics
        (reference ``measurement.py:60-129``: X = H on every qubit,
        Y = S-dagger then H) by appending the rotation as ordinary gate
        columns, so the rotated forward runs the same sharded schedule
        and the sampler stays fully shard-local. Readout error supports
        only the reference's SHOT mode here (host-side bitstring
        corruption); distribution mode transforms the full 2^n
        probability vector, which a sharded state never materializes —
        a loud error beats silently gathering 32 GiB.
        """
        rotated = with_basis_rotation(circuit, basis)
        state = self.run(rotated)
        counts = self.sample(state, shots, rng=rng)
        if readout_error is not None:
            counts = readout_error.corrupt_counts(
                counts, rng or np.random.default_rng())
        return counts
