"""Group-matmul circuit executor: the large-n XLA workhorse.

The per-gate einsum program (``ops/apply.py``) moves the full 2^n state
through device memory once per gate, and its compile time grows with the
gate count. This executor partitions the n qubits into
ceil(n/7) groups of <= 7 bits and views the state as a planar float32
tensor ``(2, *axis_sizes)`` (re/im leading axis) with one axis of <= 128
per group. Then:

* any run of gates confined to ONE group composes (kron + matmul of
  small operators at trace time) into a single <=128x128 complex
  operator, applied as ONE einsum over that axis — the complex product
  rides a realified (2, 2, S, S) block operator so each step is exactly
  one matmul-shaped contraction over (re/im x axis), with no
  concat/slice/transpose plumbing (which would cost ~3x the minimum
  state traffic);
* a gate spanning two groups with a lone bit on one of them becomes ONE
  einsum contracting (re/im, sliced bit, op axis) against a
  (2, 2, 2, S, 2, S) blocked cross operator;
* **diagonal** gates spanning two groups (CPhase, CZ, MCZ — the bulk of
  QFT) never become matmuls: they accumulate into a per-axis-pair
  (S_a, S_b) diagonal and apply as ONE elementwise broadcast pass;
* **product-form** diagonals spanning ANY number of groups (MCZ_k of
  any width — Grover's oracle at every n) apply as ONE fused broadcast
  phase pass ``x += (v-1) * x * prod(per-axis bit masks)``;
* anything else (a non-diagonal gate touching 3 groups) falls back to
  the generic segmented-einsum apply for that gate only.

Composition windows are maximal: a pending per-axis operator stack is
only flushed when a later step genuinely fails to commute with it
(bit-level overlap tracking), so e.g. gates before and after a cross
step on untouched bits of the same axis still merge into one matmul.

Operators are built inside jit from the parameter vector (no recompile
on edits). Replaces the reference's per-gate ``np.tensordot`` walk
(``/root/reference/quantum_sim/engine/state_vector.py:41-74``) on the
GPU (``ops/program.py`` routes).
"""

from __future__ import annotations

import string
from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CONFIG
from . import program as prog
from .apply import apply_gate

GROUP_BITS = 7

_F32 = jnp.float32
_HI = jax.lax.Precision.HIGHEST

# Parameterized gates whose matrix is diagonal for every parameter value
# (static gates are checked numerically at plan time).
_DIAGONAL_PARAM_GATES = frozenset({"Rz", "Phase", "CPhase", "MCZ"})


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupLayout:
    """Qubits -> tensor axes. Axis 0 is the MOST significant group (may
    hold fewer than 7 bits); the last axis holds the 7 least significant
    qubits. qubit 0 = MSB of the basis index (engine convention)."""

    num_qubits: int
    axis_sizes: tuple[int, ...]        # tensor shape, most significant first
    axis_bits: tuple[int, ...]         # bits per axis

    @classmethod
    def for_qubits(cls, n: int) -> "GroupLayout":
        bits = []
        rem = n
        while rem > 0:
            take = min(GROUP_BITS, rem)
            bits.append(take)
            rem -= take
        # built from least significant; reverse to MSB-first
        bits = tuple(reversed(bits))
        return cls(num_qubits=n, axis_sizes=tuple(1 << b for b in bits),
                   axis_bits=bits)

    def axis_of(self, qubit: int) -> int:
        """Axis index holding this qubit."""
        bitpos = self.num_qubits - 1 - qubit  # bit position from LSB
        group_from_lsb = bitpos // GROUP_BITS
        return len(self.axis_bits) - 1 - group_from_lsb

    def pos_in_axis(self, qubit: int) -> int:
        """MSB-first bit position of the qubit within its axis."""
        bitpos = self.num_qubits - 1 - qubit
        within = bitpos % GROUP_BITS
        ax = self.axis_of(qubit)
        return self.axis_bits[ax] - 1 - within


# ---------------------------------------------------------------------------
# Plan structure
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AxisMatmulStep:
    """ONE einsum applying a composed operator to a tensor axis."""

    axis: int
    op_index: int   # into that axis's operator stack


@dataclass(frozen=True)
class CrossStep:
    """One sliced bit on ``slice_axis`` x an embedded operator block
    matrix on ``op_axis`` — ONE einsum against a blocked cross op."""

    slice_axis: int
    slice_pos: int          # MSB-first bit position within slice_axis
    op_axis: int
    index: int              # into the plan's cross-op list


@dataclass(frozen=True)
class BitPairStep:
    """A 2-qubit gate straddling two axes with NOTHING folded into it:
    acts on ONE bit of each axis, identity on every other bit. Executes
    as a K=4 two-bit einsum (bandwidth-bound) instead of the embedded
    K=2S cross matmul — and an exact SWAP (QFT's final swaps, the
    dominant cross population there) executes as a pure bit-dim
    transpose, which XLA fuses with ADJACENT swap transposes into one
    copy pass (QFT-30: 15 cross matmuls -> 3 transpose passes)."""

    slice_axis: int
    slice_pos: int          # MSB-first bit position within slice_axis
    op_axis: int
    op_pos: int             # MSB-first bit position within op_axis
    index: int              # into the plan's bitpair-spec/op lists


@dataclass(frozen=True)
class DiagPairStep:
    """Accumulated two-axis diagonal: ONE elementwise broadcast pass."""

    axis_a: int
    axis_b: int
    index: int              # into the plan's diag-op list


@dataclass(frozen=True)
class DiagProductStep:
    """Controlled-phase-form diagonal spanning ANY number of axes
    (MCZ_k / wide CZ: diag = ones except the all-targets-set entry = v).
    Applies as ONE fused broadcast-elementwise pass
    ``x += (v-1) * x * prod_ax mask_ax`` — no table, no matmul,
    bandwidth only. This is what keeps Grover's exact MCZ off the GenericStep
    whole-state-complex fallback once its targets span >= 3 groups
    (n >= 21), which at n >= 30 would hold whole-state complex temps."""

    axes: tuple[int, ...]   # involved axes, sorted
    index: int              # into the plan's prod-diag segment list


@dataclass(frozen=True)
class GenericStep:
    program_op: int         # fall back to segmented-einsum apply


@dataclass(frozen=True)
class DenseSegment:
    """Recipe for one composed per-axis operator: sub-columns (each a
    set of ops with disjoint bits -> kron) multiplied in order. Segments
    are stored in flush order, so the i-th segment of an axis IS that
    axis's operator-stack entry i."""

    axis: int
    subcolumns: tuple[tuple[int, ...], ...]   # program op indices


@dataclass(frozen=True)
class CrossSpec:
    op_index: int
    slice_axis: int
    op_axis: int
    # Folded predecessors (compose INTO the cross blocks instead of
    # flushing a separate full-state pass):
    #  * pre_op_subcolumns: pending ops on op_axis (any bits) — blocks @ M
    #  * pre_slice_ops: pending ops on slice_axis touching ONLY the sliced
    #    bit — B'_ik = sum_j B_ij u_jk
    pre_op_subcolumns: tuple[tuple[int, ...], ...] = ()
    pre_slice_ops: tuple[int, ...] = ()


@dataclass(frozen=True)
class BitPairSpec:
    op_index: int           # program op (a 2-target straddling gate)
    slice_axis: int         # which axis holds the sliced qubit (operand
    #                         build orders the 4x4 as [slice_q, op_q])
    is_swap: bool           # static matrix == SWAP: execute as a bit-dim
    #                         transpose (zero FLOPs, fuses with neighbors)


@dataclass(frozen=True)
class DiagSegment:
    axis_a: int
    axis_b: int
    index: int
    op_indices: tuple[int, ...]


@dataclass(frozen=True)
class DiagProductSegment:
    axes: tuple[int, ...]
    index: int
    op_index: int           # the program op (one per step; these are rare)


@dataclass(frozen=True)
class GroupPlan:
    layout: GroupLayout
    steps: tuple
    dense_segments: tuple[DenseSegment, ...]
    cross_specs: tuple[CrossSpec, ...]
    diag_segments: tuple[DiagSegment, ...]
    prod_segments: tuple[DiagProductSegment, ...] = ()
    bitpair_specs: tuple[BitPairSpec, ...] = ()
    # Static realness analysis (see _op_is_real): real composed operators
    # skip the 2x2 plane contraction (half the matmul FLOPs), and an
    # all-real plan evolves a REAL state from the basis start (half the
    # state traffic again — 4x total on Ry/CNOT/H-class circuits).
    dense_real: tuple[tuple[bool, ...], ...] = ()   # [axis][op_index]
    cross_real: tuple[bool, ...] = ()
    diag_real: tuple[bool, ...] = ()
    prod_real: tuple[bool, ...] = ()
    bitpair_real: tuple[bool, ...] = ()
    all_real: bool = False


def _op_is_diagonal(op: prog.ProgramOp) -> bool:
    if op.cphase_value is not None:
        return True
    if op.static_matrix is not None:
        m = op.static_matrix
        return bool(np.allclose(m, np.diag(np.diagonal(m))))
    return op.gate_name in _DIAGONAL_PARAM_GATES


def _diag_product_value(op: prog.ProgramOp) -> complex | None:
    """v for controlled-phase-form diagonals: diag = ones except the
    all-ones entry = v (MCZ_k: v=-1; wide CZ; custom controlled
    phases). None when the op is not of this form."""
    if op.cphase_value is not None:
        return complex(op.cphase_value)
    if op.static_matrix is None or not _op_is_diagonal(op):
        return None
    d = np.diagonal(op.static_matrix)
    if np.allclose(d[:-1], 1.0) and not np.isclose(d[-1], 1.0):
        return complex(d[-1])
    return None


# Parameterized gates whose matrix is real for EVERY parameter value
# (structural property — params are traced, so a numeric probe can't be
# used). Ry = [[cos, -sin], [sin, cos]]. Rx/Rz/Phase/CPhase/U3 are
# complex for generic parameters.
_REAL_PARAM_GATES = frozenset({"Ry"})

# Exact SWAP (target-order invariant), for BitPairSpec.is_swap.
_SWAP_MATRIX = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


def _op_is_real(op: prog.ProgramOp) -> bool:
    """True when the op's matrix is real for all parameter values (static
    matrices — incl. custom registered gates — are checked numerically)."""
    if op.cphase_value is not None:
        return bool(np.isclose(np.imag(op.cphase_value), 0.0))
    if op.static_matrix is not None:
        return bool(np.allclose(np.imag(op.static_matrix), 0.0))
    return op.gate_name in _REAL_PARAM_GATES


def build_group_plan(program: prog.CircuitProgram) -> GroupPlan:
    layout = GroupLayout.for_qubits(program.num_qubits)
    n_axes = len(layout.axis_sizes)
    steps: list = []
    dense_segments: list[DenseSegment] = []
    cross_specs: list[CrossSpec] = []
    diag_segments: list[DiagSegment] = []
    prod_segments: list[DiagProductSegment] = []
    bitpair_specs: list[BitPairSpec] = []
    counts = [0] * n_axes

    # pending composable work, with the bits it touches (for commutation)
    pend_dense: list[dict] = [{"ops": [], "bits": set()}
                              for _ in range(n_axes)]
    pend_diag: dict[tuple[int, int], dict] = {}

    def _subcolumns(ops_bits: list[tuple[int, set]]) -> tuple:
        subs: list[tuple[list[int], set]] = []
        for oi, bits in ops_bits:
            if subs and not (subs[-1][1] & bits):
                subs[-1][0].append(oi)
                subs[-1][1].update(bits)
            else:
                subs.append(([oi], set(bits)))
        return tuple(tuple(s[0]) for s in subs)

    def flush_dense(ax: int):
        p = pend_dense[ax]
        if not p["ops"]:
            return
        dense_segments.append(DenseSegment(
            axis=ax, subcolumns=_subcolumns(p["ops"])))
        steps.append(AxisMatmulStep(axis=ax, op_index=counts[ax]))
        counts[ax] += 1
        pend_dense[ax] = {"ops": [], "bits": set()}

    def flush_diag(pair: tuple[int, int]):
        p = pend_diag.pop(pair, None)
        if p is None or not p["ops"]:
            return
        idx = len(diag_segments)
        diag_segments.append(DiagSegment(
            axis_a=pair[0], axis_b=pair[1], index=idx,
            op_indices=tuple(p["ops"])))
        steps.append(DiagPairStep(axis_a=pair[0], axis_b=pair[1],
                                  index=idx))

    def flush_all():
        for pair in list(pend_diag):
            flush_diag(pair)
        for ax in range(n_axes):
            flush_dense(ax)

    for oi, op in enumerate(program.ops):
        bits_by_axis: dict[int, set] = {}
        for q in op.targets:
            bits_by_axis.setdefault(layout.axis_of(q), set()).add(
                layout.pos_in_axis(q))
        axes = sorted(bits_by_axis)

        if len(axes) == 1:
            ax = axes[0]
            for pair in list(pend_diag):
                if ax in pair and pend_diag[pair]["bits"].get(
                        ax, set()) & bits_by_axis[ax]:
                    flush_diag(pair)
            pend_dense[ax]["ops"].append((oi, bits_by_axis[ax]))
            pend_dense[ax]["bits"] |= bits_by_axis[ax]
            continue

        if len(axes) == 2 and _op_is_diagonal(op):
            a, b = axes
            for ax in (a, b):
                if pend_dense[ax]["bits"] & bits_by_axis[ax]:
                    flush_dense(ax)
            p = pend_diag.setdefault((a, b), {"ops": [], "bits": {}})
            p["ops"].append(oi)
            for ax in (a, b):
                p["bits"].setdefault(ax, set()).update(bits_by_axis[ax])
            continue

        if len(axes) >= 3 and _diag_product_value(op) is not None:
            # Controlled-phase-form diagonal across many axes: one fused
            # broadcast pass. Diagonals commute with pending diagonals
            # and with pending dense ops on DISJOINT bits; only dense
            # pendings overlapping this op's bits must flush first.
            for ax in axes:
                if pend_dense[ax]["bits"] & bits_by_axis[ax]:
                    flush_dense(ax)
            idx = len(prod_segments)
            prod_segments.append(DiagProductSegment(
                axes=tuple(axes), index=idx, op_index=oi))
            steps.append(DiagProductStep(axes=tuple(axes), index=idx))
            continue

        lone = [ax for ax in axes if len(bits_by_axis[ax]) == 1]
        if len(axes) == 2 and lone:
            # slice the lone-bit axis; when both qualify, put the operator
            # on the SMALLER axis (less matmul compute, same traffic)
            if len(lone) == 2:
                slice_axis = max(lone, key=lambda ax: layout.axis_sizes[ax])
            else:
                slice_axis = lone[0]
            op_axis = axes[0] if axes[0] != slice_axis else axes[1]
            for pair in list(pend_diag):
                if any(ax in pair and pend_diag[pair]["bits"].get(
                        ax, set()) & bits_by_axis[ax] for ax in axes):
                    flush_diag(pair)
            slice_q = next(q for q in op.targets
                           if layout.axis_of(q) == slice_axis)
            slice_pos = layout.pos_in_axis(slice_q)
            # Fold conflicting pendings into the cross instead of flushing
            # them as separate full-state passes.
            pre_op_subcols: tuple = ()
            pre_slice: tuple = ()
            p_op = pend_dense[op_axis]
            if p_op["bits"] & bits_by_axis[op_axis]:
                pre_op_subcols = _subcolumns(p_op["ops"])
                pend_dense[op_axis] = {"ops": [], "bits": set()}
            p_sl = pend_dense[slice_axis]
            if p_sl["bits"] & bits_by_axis[slice_axis]:
                if p_sl["bits"] <= {slice_pos}:
                    pre_slice = tuple(o for o, _ in p_sl["ops"])
                    pend_dense[slice_axis] = {"ops": [], "bits": set()}
                else:
                    flush_dense(slice_axis)
            if (not pre_op_subcols and not pre_slice
                    and len(op.targets) == 2):
                # Nothing folded and one bit per axis: the embedded
                # cross op would be identity on every other op-axis
                # bit — run it as a two-bit pass, not a K=2S matmul.
                op_q = next(q for q in op.targets
                            if layout.axis_of(q) == op_axis)
                is_swap = (op.static_matrix is not None
                           and np.allclose(op.static_matrix,
                                           _SWAP_MATRIX))
                bitpair_specs.append(BitPairSpec(
                    op_index=oi, slice_axis=slice_axis, is_swap=is_swap))
                steps.append(BitPairStep(
                    slice_axis=slice_axis, slice_pos=slice_pos,
                    op_axis=op_axis,
                    op_pos=layout.pos_in_axis(op_q),
                    index=len(bitpair_specs) - 1))
                continue
            cross_specs.append(CrossSpec(
                op_index=oi, slice_axis=slice_axis, op_axis=op_axis,
                pre_op_subcolumns=pre_op_subcols, pre_slice_ops=pre_slice))
            steps.append(CrossStep(
                slice_axis=slice_axis, slice_pos=slice_pos,
                op_axis=op_axis, index=len(cross_specs) - 1))
            continue

        flush_all()
        steps.append(GenericStep(program_op=oi))

    flush_all()

    # Peephole: merge ADJACENT AxisMatmulSteps on the same axis into one
    # composed step. Flush timing can split compositions that adjacency
    # makes legal again — e.g. QFT interleaves each H with cross-axis
    # CPhases, so every H flushes as its own dense pass while the diag
    # pairs bucket elsewhere; the final step list then carries runs of
    # 7 consecutive same-axis dense steps (QFT-30: 49 -> 31 steps).
    # Adjacent steps compose exactly (no reordering): the merged
    # segment's subcolumn list is the concatenation in step order.
    per_axis: list[list[DenseSegment]] = [[] for _ in range(n_axes)]
    for seg in dense_segments:
        per_axis[seg.axis].append(seg)
    resolved: list = []
    for st in steps:
        if isinstance(st, AxisMatmulStep):
            seg = per_axis[st.axis][st.op_index]
            if resolved and isinstance(resolved[-1], DenseSegment) \
                    and resolved[-1].axis == seg.axis:
                resolved[-1] = DenseSegment(
                    axis=seg.axis,
                    subcolumns=resolved[-1].subcolumns + seg.subcolumns)
            else:
                resolved.append(seg)
        else:
            resolved.append(st)
    steps = []
    dense_segments = []
    counters = [0] * n_axes
    for item in resolved:
        if isinstance(item, DenseSegment):
            steps.append(AxisMatmulStep(axis=item.axis,
                                        op_index=counters[item.axis]))
            counters[item.axis] += 1
            dense_segments.append(item)
        else:
            steps.append(item)

    def _real(oi: int) -> bool:
        return _op_is_real(program.ops[oi])

    dense_real_by_axis: list[list[bool]] = [[] for _ in range(n_axes)]
    for seg in dense_segments:  # flush order per axis == stack order
        dense_real_by_axis[seg.axis].append(
            all(_real(oi) for sub in seg.subcolumns for oi in sub))
    cross_real = tuple(
        _real(s.op_index)
        and all(_real(oi) for sub in s.pre_op_subcolumns for oi in sub)
        and all(_real(oi) for oi in s.pre_slice_ops)
        for s in cross_specs)
    diag_real = tuple(all(_real(oi) for oi in seg.op_indices)
                      for seg in diag_segments)
    prod_real = tuple(_real(seg.op_index) for seg in prod_segments)
    bitpair_real = tuple(_real(s.op_index) for s in bitpair_specs)
    all_real = (all(r for ax in dense_real_by_axis for r in ax)
                and all(cross_real) and all(diag_real) and all(prod_real)
                and all(bitpair_real)
                and not any(isinstance(s, GenericStep) for s in steps))

    return GroupPlan(layout=layout, steps=tuple(steps),
                     dense_segments=tuple(dense_segments),
                     cross_specs=tuple(cross_specs),
                     diag_segments=tuple(diag_segments),
                     prod_segments=tuple(prod_segments),
                     bitpair_specs=tuple(bitpair_specs),
                     dense_real=tuple(tuple(ax) for ax in dense_real_by_axis),
                     cross_real=cross_real, diag_real=diag_real,
                     prod_real=prod_real, bitpair_real=bitpair_real,
                     all_real=all_real)


# ---------------------------------------------------------------------------
# Operator building (inside jit, from the parameter vector)
# ---------------------------------------------------------------------------

def _reorder_gate_matrix(u: jnp.ndarray, pos: list[int]) -> jnp.ndarray:
    """Permute a gate matrix from target order to ascending-axis-position
    order (tiny host-planned transpose)."""
    k = len(pos)
    order = sorted(range(k), key=lambda i: pos[i])
    if order == list(range(k)):
        return u
    g = u.reshape((2,) * (2 * k))
    perm = tuple(order) + tuple(k + i for i in order)
    return g.transpose(perm).reshape(1 << k, 1 << k)


def _permute_matrix_bits(m: jnp.ndarray, bit_order: list[int]) -> jnp.ndarray:
    """Reorder a (2^B, 2^B) matrix whose row/col bits follow ``bit_order``
    into ascending bit order."""
    B = len(bit_order)
    ranks = sorted(bit_order)
    perm = [bit_order.index(p) for p in ranks]
    g = m.reshape((2,) * (2 * B))
    g = g.transpose(tuple(perm) + tuple(B + i for i in perm))
    return g.reshape(1 << B, 1 << B)


class OperandOverrides(NamedTuple):
    """Per-op matrix injection for trajectory executors whose operator
    values are traced draws rather than functions of ``params`` (the
    mixed-unitary noise-insertion path, ``ops/unitary_traj.py``).
    Override ops must carry a classification-only dummy
    ``static_matrix`` whose realness/diagonality matches the injected
    values (the plan reads the dummy; operands read the override)."""

    pool_rows: object                  # (D, 2, 2) traced 1q matrices
    pool_map: dict                     # op index -> row in pool_rows
    per_op: dict                       # op index -> dense traced matrix


class _GateMatrixPool:
    """Vectorized per-trace gate-matrix construction.

    The naive prelude builds every parameterized gate's matrix with its
    own ~6 scalar ops (cos/sin/stack), which at depth 40 x 16 qubits is
    ~1000 tiny XLA ops. Here all gates sharing a builder are constructed
    by ONE vmapped call (a gather + a handful of vectorized ops), and
    single-qubit matrices additionally live in one (P, 2, 2) pool so
    whole sub-columns can be gathered and kron-chained in batch.
    """

    def __init__(self, program: prog.CircuitProgram, params, dtype,
                 overrides: OperandOverrides | None = None, xp=jnp):
        self.program = program
        self.dtype = dtype
        self.xp = xp
        self._per_op: dict[int, jnp.ndarray] = {}
        self._lazy: dict[int, tuple] = {}
        self._overrides = overrides
        skip = (set(overrides.pool_map) | set(overrides.per_op)
                if overrides else set())

        # Grouping key includes the builder: ops sharing a name can carry
        # DIFFERENT builders (density.superop_program emits conjugated
        # column-side twins under the original gate_name so realness /
        # diagonal classification still applies); batching by name alone
        # would build the column ops with the row builder.
        by_name: dict[tuple, list[int]] = {}
        static_cache: dict[bytes, jnp.ndarray] = {}
        static_1q: dict[bytes, tuple[np.ndarray, int]] = {}
        for oi, op in enumerate(program.ops):
            if oi in skip:
                continue  # injected matrix: see OperandOverrides
            if op.cphase_value is not None:
                continue  # matrix-less wide diagonal: DiagProductStep only
            if op.static_matrix is None and op.num_params > 0:
                by_name.setdefault((op.gate_name, op.jnp_builder),
                                   []).append(oi)
            else:
                key = op.static_matrix.tobytes()
                mat = static_cache.get(key)
                if mat is None:
                    mat = xp.asarray(op.static_matrix, dtype=dtype)
                    static_cache[key] = mat
                self._per_op[oi] = mat
                if len(op.targets) == 1 and key not in static_1q:
                    static_1q[key] = (op.static_matrix, len(static_1q))

        # 1q pool: eye at row 0, one row block per vmapped builder stack,
        # one row per distinct static 1q matrix — assembled by concat,
        # never by per-gate slicing.
        self._pool_index: dict[int, int] = {}
        pool_parts = [np.eye(2, dtype=np.complex64)[None]]
        static_rows = 1
        for key, (mat, k) in static_1q.items():
            pool_parts.append(mat.astype(np.complex64)[None])
        pool_parts = [xp.asarray(np.concatenate(pool_parts), dtype=dtype)]
        base = 1 + len(static_1q)
        for oi, op in enumerate(program.ops):
            if oi in skip:
                continue
            if len(op.targets) == 1 and op.static_matrix is not None:
                self._pool_index[oi] = \
                    static_rows + static_1q[op.static_matrix.tobytes()][1]

        for name, indices in by_name.items():
            ops = [program.ops[i] for i in indices]
            np_count = ops[0].num_params
            builder = ops[0].jnp_builder
            if xp is not jnp:
                # Host (NumPy) build: per-op registry matrix_func — tiny
                # complex128 builds, microseconds each; no vmap needed.
                # Ops can carry a builder that is NOT the registry's for
                # their gate_name (density.superop_program emits
                # conjugated column-side twins under the original name —
                # see the grouping-key comment above): those must be
                # evaluated through their ACTUAL builder, eagerly on the
                # host CPU backend (a jnp array on the CPU backend
                # converts to numpy directly).
                from ..registry import GateRegistry

                reg = GateRegistry.instance()
                gd = reg.get(ops[0].gate_name)
                use_registry = gd.jnp_matrix_func is builder
                cpu = None if use_registry else _host_cpu_device()
                mats = []
                for op in ops:
                    p = [float(params[op.param_offset + j])
                         for j in range(np_count)]
                    if use_registry:
                        mats.append(np.asarray(gd.matrix_func(*p))
                                    .astype(dtype))
                    elif cpu is not None:
                        with jax.default_device(cpu):
                            mats.append(np.asarray(builder(*p))
                                        .astype(dtype))
                    else:  # pragma: no cover - no CPU backend
                        raise RuntimeError(
                            "NumPy operand build needs a host CPU "
                            "backend to evaluate a non-registry gate "
                            "builder")
                stack = np.stack(mats)
                for row, oi in enumerate(indices):
                    self._per_op[oi] = stack[row]
            elif len(indices) == 1:
                op = ops[0]
                p = [params[op.param_offset + j] for j in range(np_count)]
                stack = builder(*p).astype(dtype)[None]
                self._per_op[indices[0]] = stack[0]
            else:
                offs = np.array(
                    [[op.param_offset + j for j in range(np_count)]
                     for op in ops])
                cols = [params[jnp.asarray(offs[:, j])]
                        for j in range(np_count)]
                stack = jax.vmap(lambda *p: builder(*p))(*cols).astype(dtype)
                for row, oi in enumerate(indices):
                    # lazy slice: only ops used outside the batched paths
                    # materialize an extraction eqn
                    self._lazy[oi] = (stack, row)
            if len(ops[0].targets) == 1:
                for row, oi in enumerate(indices):
                    self._pool_index[oi] = base + row
                pool_parts.append(stack)
                base += len(indices)

        if overrides is not None and overrides.pool_map:
            rows = xp.asarray(overrides.pool_rows).astype(dtype)
            for oi, row in overrides.pool_map.items():
                self._pool_index[oi] = base + row
            pool_parts.append(rows)
            base += rows.shape[0]

        self.pool_1q = (xp.concatenate(pool_parts)
                        if len(self._pool_index) else None)

    def matrix(self, oi: int) -> jnp.ndarray:
        if self._overrides is not None:
            m = self._overrides.per_op.get(oi)
            if m is not None:
                return self.xp.asarray(m).astype(self.dtype)
            r = self._overrides.pool_map.get(oi)
            if r is not None:
                return self.xp.asarray(
                    self._overrides.pool_rows)[r].astype(self.dtype)
        cached = self._per_op.get(oi)
        if cached is None:
            stack, row = self._lazy[oi]
            cached = stack[row]
            self._per_op[oi] = cached
        return cached

    def pool_index(self, oi: int) -> int:
        return self._pool_index[oi]


def _einsum(xp, spec, *operands):
    """``xp.einsum`` at HIGHEST precision under jnp (a GPU would otherwise
    be free to run f32 products in TF32); NumPy is full precision."""
    if xp is np:
        return np.einsum(spec, *operands)
    return jnp.einsum(spec, *operands, precision=_HI)


def _tensordot(xp, a, b, axes):
    if xp is np:
        return np.tensordot(a, b, axes=axes)
    return jnp.tensordot(a, b, axes=axes, precision=_HI)


def _batched_1q_subcolumns(pool: _GateMatrixPool, tables: np.ndarray,
                           xp=jnp) -> jnp.ndarray:
    """(B, bits) pool-index tables -> (B, 2^bits, 2^bits) kron products
    (index 0 = identity) in bits-1 batched einsums."""
    gathered = xp.take(pool.pool_1q, xp.asarray(tables), axis=0)
    bits = tables.shape[1]
    acc = gathered[:, 0]
    size = 2
    for b in range(1, bits):
        # out[(r i), (c j)] = acc[r, c] * g[i, j]  (bit b is LESS
        # significant than everything accumulated so far)
        acc = _einsum(xp, "brc,bij->bricj", acc, gathered[:, b]).reshape(
            tables.shape[0], size * 2, size * 2)
        size *= 2
    return acc


def _subcolumn_operator(program: prog.CircuitProgram, pool,
                        op_indices: tuple[int, ...], layout: GroupLayout,
                        axis: int, dtype, xp=jnp) -> jnp.ndarray:
    """(S, S) operator = interleaved kron of the sub-column's gates (all
    bits disjoint) and identity on untouched bits."""
    bits = layout.axis_bits[axis]
    items: list[tuple[int, tuple[int, ...], jnp.ndarray]] = []
    covered: set[int] = set()
    for oi in op_indices:
        op = program.ops[oi]
        pos = [layout.pos_in_axis(q) for q in op.targets]
        u = pool.matrix(oi)
        u = _reorder_gate_matrix(u, pos)
        spos = tuple(sorted(pos))
        items.append((spos[0], spos, u))
        covered |= set(spos)
    run: list[int] = []
    for p in range(bits):
        if p in covered:
            if run:
                items.append((run[0], tuple(run),
                              xp.eye(1 << len(run), dtype=dtype)))
                run = []
        else:
            run.append(p)
    if run:
        items.append((run[0], tuple(run),
                      xp.eye(1 << len(run), dtype=dtype)))
    items.sort(key=lambda it: it[0])

    acc = None
    bit_order: list[int] = []
    for _, spos, u in items:
        bit_order.extend(spos)
        acc = u if acc is None else xp.kron(acc, u)
    if bit_order != sorted(bit_order):
        acc = _permute_matrix_bits(acc, bit_order)
    return acc


def _blocked(re: jnp.ndarray, im: jnp.ndarray, axis: int = 0,
             xp=jnp) -> jnp.ndarray:
    """Realified complex-multiply block tensor: stack [[re, -im], [im, re]]
    as two new leading (c, d) axes at ``axis``."""
    row0 = xp.stack([re, -im], axis=axis)
    row1 = xp.stack([im, re], axis=axis)
    return xp.stack([row0, row1], axis=axis)


def reorder_gate_targets(u, targets, qubit_order):
    """Permute a 2^k gate matrix from ``targets`` order to ``qubit_order``
    (first qubit = most significant bit of the matrix index)."""
    k = len(targets)
    order = [list(targets).index(q) for q in qubit_order]
    if order == list(range(k)):
        return u
    g = u.reshape((2,) * (2 * k))
    perm = tuple(order) + tuple(k + i for i in order)
    return g.transpose(perm).reshape(1 << k, 1 << k)


def cross_blocks(u4, pos, bits, xp=jnp):
    """2x2 nested list of (S, S) axis-embedded blocks of a cross gate:
    ``u4`` is the (2, gl, 2, gl) matrix with the SLICED bit leading on
    both sides; entry [i][kk] acts on the op axis within sliced-bit
    sector (out=i, in=kk)."""
    return [[_embed_in_axis(u4[i, :, kk, :], pos, bits, xp=xp)
             for kk in (0, 1)] for i in (0, 1)]


def cross_blocked_tensor(blocks, xp=jnp):
    """Stack cross blocks into the executor's complex (i, y, k, x) tensor
    (the single place that owns this axis convention)."""
    C = xp.stack([xp.stack(row, axis=0) for row in blocks], axis=0)
    return C.transpose(0, 2, 1, 3)


def make_prodslice_fn(facs, cre, cim, rank, axes, planar, ax, fpos, lead):
    """``f(blk, start)`` applying a controlled-phase-form diagonal to a
    state chunk sliced along involved axis ``ax``: the indicator factor
    at ``fpos`` is sliced alongside the chunk via the start hook (shared
    by the chunked ideal and trajectory executors)."""
    def f(blk, start):
        fsl = list(facs)
        fsl[fpos] = jax.lax.dynamic_slice_in_dim(facs[fpos], start,
                                                 blk.shape[ax + lead])
        return apply_prod_diag(blk, tuple(fsl), cre, cim, rank, axes,
                               planar)
    return f


def build_group_operands(program: prog.CircuitProgram, plan: GroupPlan,
                         params, dtype,
                         overrides: OperandOverrides | None = None,
                         xp=jnp):
    """Trace-time operator construction: per-axis blocked stacks
    (m, 2, 2, S, S) f32, blocked cross ops, blocked pair diagonals.
    ``overrides`` injects traced matrices for designated ops (the
    mixed-unitary trajectory path).

    ``xp=np`` builds the same pytree EAGERLY in NumPy (the interactive
    edit-hot path: ~1500 tiny eager jnp dispatches cost seconds on the
    CPU backend; the identical NumPy arithmetic costs milliseconds).
    The np mode is only for host params/overrides — traced values
    require xp=jnp."""
    layout = plan.layout
    pool = _GateMatrixPool(program, params, dtype, overrides, xp=xp)
    if xp is jnp:
        def _mm(a, b):
            return jnp.matmul(a, b, precision=_HI)
    else:
        _mm = np.matmul

    # Batch every all-1q sub-column of each axis-width class into one
    # gather + kron chain (the dominant sub-column shape in layered
    # circuits); anything containing a multi-qubit gate goes per-item.
    classes: dict[int, list[np.ndarray]] = {}
    class_ref: dict[tuple[int, int], int] = {}  # (seg#, sub#) -> row
    for si, seg in enumerate(plan.dense_segments):
        bits = layout.axis_bits[seg.axis]
        for bi, sub in enumerate(seg.subcolumns):
            if not all(len(program.ops[oi].targets) == 1 for oi in sub):
                continue
            table = np.zeros(bits, dtype=np.int32)
            for oi in sub:
                q = program.ops[oi].targets[0]
                table[layout.pos_in_axis(q)] = pool.pool_index(oi)
            class_ref[(si, bi)] = len(classes.setdefault(bits, []))
            classes[bits].append(table)
    batched: dict[int, jnp.ndarray] = {
        bits: _batched_1q_subcolumns(pool, np.stack(tables), xp=xp)
        for bits, tables in classes.items()}

    axis_lists: list[list] = [[] for _ in layout.axis_sizes]
    for si, seg in enumerate(plan.dense_segments):
        bits = layout.axis_bits[seg.axis]
        combined = None
        for bi, sub in enumerate(seg.subcolumns):
            row = class_ref.get((si, bi))
            if row is not None:
                sc = batched[bits][row]
            else:
                sc = _subcolumn_operator(program, pool, sub, layout,
                                         seg.axis, dtype, xp=xp)
            combined = sc if combined is None else _mm(sc, combined)
        axis_lists[seg.axis].append(combined)

    axis_stacks = []
    for ax, ops in enumerate(axis_lists):
        dim = layout.axis_sizes[ax]
        if not ops:
            ops = [xp.eye(dim, dtype=dtype)]
        st = xp.stack(ops)
        axis_stacks.append(_blocked(xp.real(st).astype(_F32),
                                    xp.imag(st).astype(_F32), axis=1,
                                    xp=xp))

    cross_ops = []
    for spec in plan.cross_specs:
        op = program.ops[spec.op_index]
        slice_q = next(q for q in op.targets
                       if layout.axis_of(q) == spec.slice_axis)
        op_qs = sorted((q for q in op.targets
                        if layout.axis_of(q) == spec.op_axis),
                       key=lambda q: layout.pos_in_axis(q))
        u = reorder_gate_targets(pool.matrix(spec.op_index), op.targets,
                                 [slice_q] + op_qs)
        gl = 1 << len(op_qs)
        u4 = u.reshape(2, gl, 2, gl)
        pos = tuple(layout.pos_in_axis(q) for q in op_qs)
        bits = layout.axis_bits[spec.op_axis]
        blocks = cross_blocks(u4, pos, bits, xp=xp)
        if spec.pre_slice_ops:
            # every folded slice op is a 1q gate on the sliced bit:
            # B'_ik = sum_j B_ij us_jk with us = product (in order)
            us = None
            for oi in spec.pre_slice_ops:
                m = pool.matrix(oi)
                us = m if us is None else _mm(m, us)
            blocks = [[blocks[i][0] * us[0, kk] + blocks[i][1] * us[1, kk]
                       for kk in (0, 1)] for i in (0, 1)]
        if spec.pre_op_subcolumns:
            # pending op_axis operator applies BEFORE the cross: blocks @ M
            m = None
            for sub in spec.pre_op_subcolumns:
                sc = _subcolumn_operator(program, pool, sub, layout,
                                         spec.op_axis, dtype, xp=xp)
                m = sc if m is None else _mm(sc, m)
            blocks = [[_mm(blocks[i][kk], m)
                       for kk in (0, 1)] for i in (0, 1)]
        C = cross_blocked_tensor(blocks, xp=xp)
        cross_ops.append(_blocked(xp.real(C).astype(_F32),
                                  xp.imag(C).astype(_F32), axis=0, xp=xp))

    bitpair_ops = []
    for spec in plan.bitpair_specs:
        if spec.is_swap:
            bitpair_ops.append(None)  # executes as a transpose
            continue
        op = program.ops[spec.op_index]
        slice_q = next(q for q in op.targets
                       if layout.axis_of(q) == spec.slice_axis)
        op_q = next(q for q in op.targets if q != slice_q)
        u = reorder_gate_targets(pool.matrix(spec.op_index), op.targets,
                                 [slice_q, op_q])
        u4 = u.reshape(2, 2, 2, 2)  # (i, j, k, l): out/in slice, op bits
        bitpair_ops.append(_blocked(xp.real(u4).astype(_F32),
                                    xp.imag(u4).astype(_F32), axis=0,
                                    xp=xp))

    prod_ops = []
    for seg in plan.prod_segments:
        op = program.ops[seg.op_index]
        v = _diag_product_value(op)
        facs = tuple(xp.asarray(m)
                     for _, m in _indicator_masks(op.targets, layout))
        prod_ops.append((facs, float(np.real(v - 1)),
                         float(np.imag(v - 1))))

    diag_ops = []
    for seg in plan.diag_segments:
        sa = layout.axis_sizes[seg.axis_a]
        sb = layout.axis_sizes[seg.axis_b]
        D = xp.ones((sa, sb), dtype=dtype)
        for oi in seg.op_indices:
            op = program.ops[oi]
            k = len(op.targets)
            if op.cphase_value is not None:
                # Matrix-less wide controlled phase (k = 11..14 can span
                # exactly two axes): synthesize the diag VECTOR — cheap
                # where the dense matrix is not.
                dv = np.ones(1 << k, np.complex128)
                dv[-1] = op.cphase_value
                d = xp.asarray(dv, dtype=dtype)
            else:
                d = xp.diagonal(pool.matrix(oi))
            code_a = np.zeros(sa, dtype=np.int32)
            code_b = np.zeros(sb, dtype=np.int32)
            for j, q in enumerate(op.targets):
                shift = k - 1 - j
                ax = layout.axis_of(q)
                p = layout.pos_in_axis(q)
                if ax == seg.axis_a:
                    ab = layout.axis_bits[seg.axis_a]
                    code_a |= (((np.arange(sa) >> (ab - 1 - p)) & 1)
                               << shift).astype(np.int32)
                else:
                    bb = layout.axis_bits[seg.axis_b]
                    code_b |= (((np.arange(sb) >> (bb - 1 - p)) & 1)
                               << shift).astype(np.int32)
            W = d[xp.asarray(code_a)[:, None] + xp.asarray(code_b)[None, :]]
            D = D * W
        diag_ops.append(_blocked(xp.real(D).astype(_F32),
                                 xp.imag(D).astype(_F32), axis=0, xp=xp))

    return axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops


# ---------------------------------------------------------------------------
# Execution: one einsum per step on a (2, *axis_sizes) planar state
# ---------------------------------------------------------------------------

_AXIS_LETTERS = "abefghjlmnopqrstuvwz"  # reserved: c d i k x y


def _planar_basis_state(layout: GroupLayout, index: int,
                        xp=jnp) -> jnp.ndarray:
    """(2, *axis_sizes) one-hot basis state as an outer product of tiny
    per-axis one-hot constants. NEVER scatter into the big buffer: a
    ``zeros(2^n).at[i].set`` blows XLA compile time up ~25x at n=28
    (measured 530s -> 17s at n=28 with this form)."""
    facs = [xp.asarray(np.array([1.0, 0.0], np.float32))]
    rem = index
    for bits, size in zip(layout.axis_bits[::-1], layout.axis_sizes[::-1]):
        v = np.zeros(size, np.float32)
        v[rem & (size - 1)] = 1.0
        facs.insert(1, xp.asarray(v))
        rem >>= bits
    letters = ("c" + _AXIS_LETTERS)[:len(layout.axis_sizes) + 1]
    spec = ",".join(letters) + "->" + letters
    return _einsum(xp, spec, *facs)


def _real_basis_state(layout: GroupLayout, index: int) -> jnp.ndarray:
    """(*axis_sizes,) one-hot REAL basis state (all-real evolution)."""
    facs = []
    rem = index
    for bits, size in zip(layout.axis_bits[::-1], layout.axis_sizes[::-1]):
        v = np.zeros(size, np.float32)
        v[rem & (size - 1)] = 1.0
        facs.insert(0, jnp.asarray(v))
        rem >>= bits
    letters = _AXIS_LETTERS[:len(layout.axis_sizes)]
    spec = ",".join(letters) + "->" + letters
    return jnp.einsum(spec, *facs, precision=_HI)


def _dense_spec(rank: int, axis: int, op_real: bool = False,
                planar: bool = True) -> str:
    """``op_real`` drops the complex 2x2 plane contraction (the operator
    operand is the real plane only — HALF the FLOPs); ``planar=False``
    additionally drops the state's plane axis (all-real evolution)."""
    subs = list(_AXIS_LETTERS[:rank])
    out = list(subs)
    out[axis] = "y"
    if op_real and not planar:
        return f"y{subs[axis]},{''.join(subs)}->{''.join(out)}"
    if op_real:
        return f"y{subs[axis]},d{''.join(subs)}->d{''.join(out)}"
    return f"cdy{subs[axis]},d{''.join(subs)}->c{''.join(out)}"


def _cross_spec(rank_new: int, bit_axis: int, op_axis_new: int,
                op_real: bool = False, planar: bool = True) -> str:
    subs = list(_AXIS_LETTERS[:rank_new])
    subs[bit_axis] = "k"
    subs[op_axis_new] = "x"
    out = list(subs)
    out[bit_axis] = "i"
    out[op_axis_new] = "y"
    if op_real and not planar:
        return f"iykx,{''.join(subs)}->{''.join(out)}"
    if op_real:
        return f"iykx,d{''.join(subs)}->d{''.join(out)}"
    return f"cdiykx,d{''.join(subs)}->c{''.join(out)}"


def _diag_spec(rank: int, axis_a: int, axis_b: int, op_real: bool = False,
               planar: bool = True) -> str:
    subs = "".join(_AXIS_LETTERS[:rank])
    if op_real and not planar:
        return f"{subs[axis_a]}{subs[axis_b]},{subs}->{subs}"
    if op_real:
        return f"{subs[axis_a]}{subs[axis_b]},d{subs}->d{subs}"
    return f"cd{subs[axis_a]}{subs[axis_b]},d{subs}->c{subs}"


def _split_axis_bit(shape: tuple[int, ...], axis: int, pos: int):
    """New shape exposing bit ``pos`` (MSB-first) of ``axis`` as its own
    dimension; returns (new_shape, bit_axis_index)."""
    bits = shape[axis].bit_length() - 1
    # MSB-first position ``pos`` has weight 2^(bits-1-pos) within the axis.
    pre = 1 << pos                # bits above (more significant)
    post = 1 << (bits - pos - 1)  # bits below
    new_shape = shape[:axis] + (pre, 2, post) + shape[axis + 1:]
    return new_shape, axis + 1


def _split_two_bits(shape: tuple[int, ...], ax_a: int, pos_a: int,
                    ax_b: int, pos_b: int):
    """Shape exposing bit ``pos_a`` of ``ax_a`` and bit ``pos_b`` of
    ``ax_b`` (MSB-first, distinct axes) as their own size-2 dims;
    returns (new_shape, idx_a, idx_b). Splits the higher axis first so
    the lower axis's index stays valid."""
    if ax_a > ax_b:
        new_shape, ia = _split_axis_bit(shape, ax_a, pos_a)
        new_shape, ib = _split_axis_bit(new_shape, ax_b, pos_b)
        return new_shape, ia + 2, ib
    new_shape, ib = _split_axis_bit(shape, ax_b, pos_b)
    new_shape, ia = _split_axis_bit(new_shape, ax_a, pos_a)
    return new_shape, ia, ib + 2


def apply_bitpair(x, plan, step, bitpair_ops, planar: bool):
    """Execute a BitPairStep on a (possibly chunk-sliced) state tensor:
    exact SWAPs transpose the two bit dims (XLA fuses runs of adjacent
    transposes into ONE copy pass); anything else is a K=4 einsum —
    bandwidth-bound either way, vs the K=2S cross matmul it replaces."""
    spec = plan.bitpair_specs[step.index]
    lead = x.ndim - len(plan.layout.axis_sizes)
    shape = x.shape[lead:]
    new_shape, bs, bo = _split_two_bits(shape, step.slice_axis,
                                        step.slice_pos, step.op_axis,
                                        step.op_pos)
    xr = x.reshape(x.shape[:lead] + new_shape)
    if spec.is_swap:
        perm = list(range(xr.ndim))
        perm[lead + bs], perm[lead + bo] = perm[lead + bo], perm[lead + bs]
        xr = jnp.transpose(xr, perm)
    else:
        real = plan.bitpair_real[step.index]
        q = bitpair_ops[step.index]
        q = q[0, 0] if real else q
        xr = jnp.einsum(_cross_spec(len(new_shape), bs, bo, real, planar),
                        q, xr, precision=_HI)
    return xr.reshape(x.shape)


def _indicator_masks(targets: tuple[int, ...], layout: GroupLayout
                     ) -> list[tuple[int, np.ndarray]]:
    """Per-axis all-targets-set indicator vectors (axis, (S,) f32 mask)
    for the axes the targets touch, in ascending axis order."""
    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    out = []
    for ax in sorted(by_axis):
        bits = layout.axis_bits[ax]
        size = layout.axis_sizes[ax]
        mask = np.ones(size, np.float32)
        for q in by_axis[ax]:
            bit = bits - 1 - layout.pos_in_axis(q)  # from LSB
            mask *= ((np.arange(size) >> bit) & 1).astype(np.float32)
        out.append((ax, mask))
    return out


def apply_cphase_grouped(xre, xim, targets: tuple[int, ...], v: complex,
                         layout: GroupLayout):
    """Controlled-phase-form diagonal on a grouped (re, im) state pair:
    one fused broadcast pass (the trajectory-path twin of
    DiagProductStep / apply.apply_cphase)."""
    rank = len(layout.axis_sizes)
    ind = None
    for ax, mask in _indicator_masks(targets, layout):
        shape = [1] * rank
        shape[ax] = mask.shape[0]
        f = jnp.asarray(mask).reshape(shape)
        ind = f if ind is None else ind * f
    vr = float(np.real(v)) - 1.0
    vi = float(np.imag(v))
    dre = vr * xre - vi * xim
    dim = vr * xim + vi * xre
    return xre + ind * dre, xim + ind * dim


def apply_prod_diag(x, facs, cre: float, cim: float, rank: int,
                    axes: tuple[int, ...], planar: bool) -> jnp.ndarray:
    """``x += (v-1) * x * prod mask_ax`` as one fused broadcast pass.
    ``facs`` are the per-involved-axis (S,) indicator vectors; they
    broadcast with 1-sized dims elsewhere, so this also works on CHUNKS
    whose uninvolved axes are sliced (the factor there is a 1-dim)."""
    ind = None
    for ax, m in zip(axes, facs):
        shape = [1] * rank
        shape[ax] = m.shape[0]
        f = m.reshape(shape)
        ind = f if ind is None else ind * f
    if not planar:
        # real state => plan guaranteed v real (cim == 0)
        return x + cre * (x * ind)
    xr, xi = x[0], x[1]
    tr = xr * ind
    ti = xi * ind
    return jnp.stack([xr + cre * tr - cim * ti,
                      xi + cre * ti + cim * tr])


def execute_group_plan(plan: GroupPlan, operands, program, params, dtype,
                       x: jnp.ndarray, planar: bool = True) -> jnp.ndarray:
    """Run all steps on the state ``x``: planar ``(2, *axis_sizes)`` by
    default, or a REAL ``(*axis_sizes,)`` state with ``planar=False``
    (valid only for ``plan.all_real`` — every operator real, so a real
    start stays real; half the bytes and half the FLOPs again)."""
    layout = plan.layout
    shape = tuple(layout.axis_sizes)
    rank = len(shape)
    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = operands
    lead = (2,) if planar else ()

    for step in plan.steps:
        if isinstance(step, BitPairStep):
            x = apply_bitpair(x, plan, step, bitpair_ops, planar)
        elif isinstance(step, AxisMatmulStep):
            real = plan.dense_real[step.axis][step.op_index]
            op = axis_stacks[step.axis][step.op_index]
            x = jnp.einsum(_dense_spec(rank, step.axis, real, planar),
                           op[0, 0] if real else op, x, precision=_HI)
        elif isinstance(step, CrossStep):
            real = plan.cross_real[step.index]
            new_shape, bit_axis = _split_axis_bit(shape, step.slice_axis,
                                                  step.slice_pos)
            o = step.op_axis + (2 if step.op_axis > step.slice_axis else 0)
            blk = cross_ops[step.index]
            xr = x.reshape(lead + new_shape)
            xr = jnp.einsum(
                _cross_spec(len(new_shape), bit_axis, o, real, planar),
                blk[0, 0] if real else blk, xr, precision=_HI)
            x = xr.reshape(lead + shape)
        elif isinstance(step, DiagPairStep):
            real = plan.diag_real[step.index]
            d = diag_ops[step.index]
            x = jnp.einsum(
                _diag_spec(rank, step.axis_a, step.axis_b, real, planar),
                d[0, 0] if real else d, x, precision=_HI)
        elif isinstance(step, DiagProductStep):
            facs, cre, cim = prod_ops[step.index]
            x = apply_prod_diag(x, facs, cre, cim, rank, step.axes, planar)
        else:  # GenericStep (never present when planar=False: all_real
            # plans exclude generic fallbacks)
            op = program.ops[step.program_op]
            u = program.op_matrix(op, params, dtype)
            flat = (x[0] + 1j * x[1]).reshape(-1).astype(dtype)
            flat = apply_gate(flat, u, op.targets, layout.num_qubits)
            shaped = flat.reshape(shape)
            x = jnp.stack([jnp.real(shaped).astype(_F32),
                           jnp.imag(shaped).astype(_F32)])
    return x


def count_state_passes(plan: GroupPlan) -> int:
    """Whole-state HBM read+write sweeps the executor performs: one per
    dense / cross / diag-pair step and per non-swap bit-pair step; a
    maximal RUN of adjacent swap bit-pairs counts as ONE pass (XLA fuses
    consecutive transposes into a single copy). DiagProductSteps are
    excluded (kept out of the bench's historical pass accounting)."""
    passes = 0
    prev_swap = False
    for s in plan.steps:
        if (isinstance(s, BitPairStep)
                and plan.bitpair_specs[s.index].is_swap):
            if not prev_swap:
                passes += 1
            prev_swap = True
            continue
        prev_swap = False
        if isinstance(s, (AxisMatmulStep, CrossStep, DiagPairStep,
                          BitPairStep)):
            passes += 1
    return passes


# ---------------------------------------------------------------------------
# Embedding helper (shared with the trajectory path)
# ---------------------------------------------------------------------------

_EMBED_MASKS: dict[tuple, np.ndarray] = {}


def _embed_masks(positions: tuple[int, ...], axis_bits: int) -> np.ndarray:
    """Static (4^k, S, S) 0/1 masks such that the embedding of a 2^k
    operator U at the given bit positions is sum_e U.flat[e] * masks[e].
    Cached per (positions, axis_bits) — these are compile-time constants,
    so the traced embedding is ONE small contraction per gate (keeps
    compile time linear in circuit depth)."""
    key = (positions, axis_bits)
    cached = _EMBED_MASKS.get(key)
    if cached is not None:
        return cached
    k = len(positions)
    dim = 1 << axis_bits
    masks = np.zeros((4**k, dim, dim), dtype=np.float32)
    # For each axis index pair (row, col): identity on non-target bits;
    # the target bits select which U entry contributes.
    idx = np.arange(dim)
    non_target_mask = 0
    for b in range(axis_bits):
        if b not in positions:
            non_target_mask |= 1 << (axis_bits - 1 - b)

    def target_code(v: int) -> int:
        code = 0
        for p in positions:
            code = (code << 1) | ((v >> (axis_bits - 1 - p)) & 1)
        return code

    for row in range(dim):
        cols = idx[(idx & non_target_mask) == (row & non_target_mask)]
        r_code = target_code(row)
        for col in cols:
            e = r_code * (1 << k) + target_code(int(col))
            masks[e, row, col] = 1.0
    _EMBED_MASKS[key] = masks
    return masks


def _embed_in_axis(u: jnp.ndarray, positions: tuple[int, ...],
                   axis_bits: int, xp=jnp) -> jnp.ndarray:
    """Embed a 2^k operator acting on the given MSB-first bit positions of
    an ``axis_bits``-bit axis into a (2^axis_bits, 2^axis_bits) operator.
    A real operator embeds real (half the work; no complex round trip)."""
    masks = xp.asarray(_embed_masks(positions, axis_bits))
    flat = u.reshape(-1)
    re = _tensordot(xp, xp.real(flat).astype(_F32), masks, 1)
    if not np.iscomplexobj(u):
        return re.astype(u.dtype)
    im = _tensordot(xp, xp.imag(flat).astype(_F32), masks, 1)
    return (re + 1j * im).astype(u.dtype)


# ---------------------------------------------------------------------------
# Per-gate grouped application (noisy-trajectory path: noise after every
# gate forbids composition, so these stay per-gate)
# ---------------------------------------------------------------------------

def _axis_matmul(xre, xim, lre, lim, axis: int, rank: int):
    """Contract operator (S, S) with tensor axis ``axis``: out[..a..] =
    sum_b op[a, b] x[..b..], preserving axis order.

    The complex product is ONE real matmul on a doubled axis:
    [re|im] contracted with the 2S x 2S block operator
    [[L_re, -L_im], [L_im, L_re]]."""
    letters = string.ascii_lowercase
    subs = list(letters[:rank])
    in_sub = "".join(subs)
    op_out, op_in = letters[rank], subs[axis]
    out_subs = list(subs)
    out_subs[axis] = op_out
    spec = f"{op_out}{op_in},{in_sub}->{''.join(out_subs)}"

    s = lre.shape[0]
    x2 = jnp.concatenate([xre, xim], axis=axis)
    block = jnp.concatenate([
        jnp.concatenate([lre, -lim], axis=1),
        jnp.concatenate([lim, lre], axis=1),
    ], axis=0)
    out = jnp.einsum(spec, block, x2, precision=_HI)
    idx_re = [slice(None)] * rank
    idx_re[axis] = slice(0, s)
    idx_im = [slice(None)] * rank
    idx_im[axis] = slice(s, 2 * s)
    return out[tuple(idx_re)], out[tuple(idx_im)]


def _apply_cross(xre, xim, blocks, slice_axis: int, slice_pos: int,
                 op_axis: int, shape: tuple[int, ...]):
    """Cross-axis gate as ONE complex matmul: the sliced bit merges with
    the operator axis (out[i] = sum_k Op_ik in[k] is a matmul over the
    combined 2S space). ``blocks``[i][k] are the four (S, S) operators."""
    new_shape, bit_axis = _split_axis_bit(shape, slice_axis, slice_pos)
    xr = xre.reshape(new_shape)
    xi = xim.reshape(new_shape)
    o = op_axis + (2 if op_axis > slice_axis else 0)

    if bit_axis < o:
        dest = o - 1
    else:
        dest = o
    xr = jnp.moveaxis(xr, bit_axis, dest)
    xi = jnp.moveaxis(xi, bit_axis, dest)
    # bit now sits immediately left of the op axis at (dest, dest+1)
    moved_shape = xr.shape
    s = moved_shape[dest + 1]
    merged_shape = (moved_shape[:dest] + (2 * s,)
                    + moved_shape[dest + 2:])
    xr = xr.reshape(merged_shape)
    xi = xi.reshape(merged_shape)

    full = jnp.concatenate([
        jnp.concatenate([blocks[0][0], blocks[0][1]], axis=1),
        jnp.concatenate([blocks[1][0], blocks[1][1]], axis=1),
    ], axis=0)
    xr, xi = _axis_matmul(xr, xi, jnp.real(full).astype(_F32),
                          jnp.imag(full).astype(_F32), dest,
                          len(merged_shape))

    xr = xr.reshape(moved_shape)
    xi = xi.reshape(moved_shape)
    xr = jnp.moveaxis(xr, dest, bit_axis)
    xi = jnp.moveaxis(xi, dest, bit_axis)
    return xr.reshape(shape), xi.reshape(shape)


def apply_gate_grouped(xre, xim, u, targets: tuple[int, ...],
                       layout: GroupLayout, dtype):
    """Apply one gate to a group-layout (re, im) state pair.

    Single-axis gates embed + matmul; two-axis gates with a lone bit on
    one axis use the 2x2-block cross mechanism; anything else falls back
    to the flat segmented-einsum apply.
    """
    rank = len(layout.axis_sizes)
    axes = sorted({layout.axis_of(q) for q in targets})
    k = len(targets)

    def ordered(u, qubit_order):
        g = u.reshape((2,) * (2 * k))
        order = [list(targets).index(q) for q in qubit_order]
        if order != list(range(k)):
            perm = tuple(order) + tuple(k + i for i in order)
            g = g.transpose(perm)
        return g.reshape(1 << k, 1 << k)

    if len(axes) == 1:
        ax = axes[0]
        qubits = sorted(targets, key=lambda q: layout.pos_in_axis(q))
        full = _embed_in_axis(ordered(u, qubits),
                              tuple(layout.pos_in_axis(q) for q in qubits),
                              layout.axis_bits[ax])
        return _axis_matmul(xre, xim, jnp.real(full).astype(_F32),
                            jnp.imag(full).astype(_F32), ax, rank)

    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    lone = [ax for ax in axes if len(by_axis[ax]) == 1]
    if len(axes) == 2 and lone:
        slice_axis = lone[0]
        op_axis = axes[0] if axes[0] != slice_axis else axes[1]
        slice_q = by_axis[slice_axis][0]
        op_qubits = sorted(by_axis[op_axis],
                           key=lambda q: layout.pos_in_axis(q))
        u4 = ordered(u, [slice_q] + op_qubits).reshape(
            2, 1 << len(op_qubits), 2, 1 << len(op_qubits))
        pos = tuple(layout.pos_in_axis(q) for q in op_qubits)
        bits = layout.axis_bits[op_axis]
        blocks = [[_embed_in_axis(u4[i, :, j, :], pos, bits)
                   for j in (0, 1)] for i in (0, 1)]
        return _apply_cross(xre, xim, blocks, slice_axis,
                            layout.pos_in_axis(slice_q), op_axis,
                            tuple(layout.axis_sizes))

    # Generic fallback: flat complex apply.
    flat = (xre + 1j * xim).reshape(-1).astype(dtype)
    flat = apply_gate(flat, u, targets, layout.num_qubits)
    shaped = flat.reshape(layout.axis_sizes)
    return jnp.real(shaped).astype(_F32), jnp.imag(shaped).astype(_F32)


def _rho_q_grouped(xre, xim, q: int, layout: GroupLayout):
    """Single-qubit reduced density matrix from a planar group state."""
    ax = layout.axis_of(q)
    pos = layout.pos_in_axis(q)
    shape = tuple(layout.axis_sizes)
    new_shape, bit_axis = _split_axis_bit(shape, ax, pos)
    yr = jnp.moveaxis(xre.reshape(new_shape), bit_axis, 0).reshape(2, -1)
    yi = jnp.moveaxis(xim.reshape(new_shape), bit_axis, 0).reshape(2, -1)
    mm = lambda a, b: jnp.matmul(a, b.T, precision=_HI)
    rr = mm(yr, yr) + mm(yi, yi)
    ri = mm(yi, yr) - mm(yr, yi)
    return rr + 1j * ri


def group_trajectory_body(program: prog.CircuitProgram, noise_model,
                          params, key, dtype=None,
                          record_columns: bool = False):
    """Stochastic-Kraus trajectory over the group layout: the large-n
    counterpart of ``ops/program._trajectory_body`` (which rides the
    einsum path that stops compiling around n=20)."""
    dtype = dtype or CONFIG.dtype
    layout = GroupLayout.for_qubits(program.num_qubits)
    shape = layout.axis_sizes

    total_draws = 0
    for op in program.ops:
        total_draws += len(noise_model.kraus_stacks_for_gate(op.gate_name)) \
            * len(op.targets)
    keys = jax.random.split(key, max(1, total_draws))
    draw = 0

    x0 = _planar_basis_state(layout, program.initial_index)
    xre, xim = x0[0], x0[1]
    snapshots = []

    def combine(a, b):
        return (a + 1j * b).reshape(-1).astype(dtype)

    if record_columns:
        snapshots.append(combine(xre, xim))

    op_i = 0
    for col in range(program.num_columns):
        while (op_i < len(program.ops)
               and program.ops[op_i].column_index == col):
            op = program.ops[op_i]
            if op.cphase_value is not None:
                xre, xim = apply_cphase_grouped(xre, xim, op.targets,
                                                op.cphase_value, layout)
            else:
                u = program.op_matrix(op, params, dtype)
                xre, xim = apply_gate_grouped(xre, xim, u, op.targets,
                                              layout, dtype)
            for kraus_np in noise_model.kraus_stacks_for_gate(op.gate_name):
                kraus = jnp.asarray(kraus_np, dtype=dtype)
                for q in op.targets:
                    # Branch probabilities from the 1q reduced density
                    # matrix (one cheap pass), then apply ONLY the drawn
                    # Kraus operator.
                    rho = _rho_q_grouped(xre, xim, q, layout)
                    norms = jnp.real(jnp.einsum(
                        "mij,jk,mik->m", kraus, rho, jnp.conj(kraus),
                        precision=_HI))
                    idx = jax.random.categorical(
                        keys[draw], jnp.log(norms + 1e-30))
                    k_sel = jnp.take(kraus, idx, axis=0)
                    xre, xim = apply_gate_grouped(xre, xim, k_sel, (q,),
                                                  layout, dtype)
                    inv = 1.0 / jnp.sqrt(jnp.maximum(
                        jnp.take(norms, idx), 1e-30))
                    xre = xre * inv
                    xim = xim * inv
                    draw += 1
            op_i += 1
        if record_columns:
            snapshots.append(combine(xre, xim))

    # Exact final normalization: each draw rescales by 1/sqrt(p_sel)
    # where p_sel is the f32 ESTIMATE of the post-apply norm; the ~1e-5
    # systematic per-draw error compounds over draws (measured 1.0039
    # at n=20 depth-4 depol). Branch probabilities are scale-invariant
    # (categorical over log p_m), so one exact division restores the
    # ||psi|| = 1 contract without changing any stochastic branch.
    if total_draws:
        inv_n = 1.0 / jnp.sqrt(jnp.sum(xre * xre) + jnp.sum(xim * xim))
        xre = xre * inv_n
        xim = xim * inv_n
        if record_columns:
            snapshots[-1] = combine(xre, xim)

    if record_columns:
        return jnp.stack(snapshots)
    return combine(xre, xim)


# ---------------------------------------------------------------------------
# Forward entry points
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict[tuple, Callable] = {}
_BUILT_PLANS: dict[tuple, GroupPlan] = {}


def get_group_plan(program: prog.CircuitProgram) -> GroupPlan:
    plan = _BUILT_PLANS.get(program.compile_key)
    if plan is None:
        plan = build_group_plan(program)
        if len(_BUILT_PLANS) > 128:
            _BUILT_PLANS.pop(next(iter(_BUILT_PLANS)))
        _BUILT_PLANS[program.compile_key] = plan
    return plan


def group_forward_body(program: prog.CircuitProgram, params, dtype=None):
    """Traceable forward pass via the group plan (compose into larger
    programs; ``group_forward_fn`` is its jitted form)."""
    dtype = dtype or CONFIG.dtype
    plan = get_group_plan(program)
    operands = build_group_operands(program, plan, params, dtype)
    if plan.all_real:
        # Every operator is real, so evolution from the (real) basis
        # state never leaves the reals: drop the imaginary plane
        # entirely — half the HBM traffic and half the remaining FLOPs.
        xr = _real_basis_state(plan.layout, program.initial_index)
        xr = execute_group_plan(plan, operands, program, params, dtype,
                                xr, planar=False)
        return xr.reshape(-1).astype(dtype)
    x = _planar_basis_state(plan.layout, program.initial_index)
    x = execute_group_plan(plan, operands, program, params, dtype, x)
    return (x[0] + 1j * x[1]).reshape(-1).astype(dtype)


def group_evolve_body(program: prog.CircuitProgram, state, params,
                      dtype=None):
    """Traceable ``(state, params) -> state`` applying the plan to a
    PROVIDED complex state (the group-path twin of program.evolve_fn)."""
    dtype = dtype or CONFIG.dtype
    plan = get_group_plan(program)
    shape = tuple(plan.layout.axis_sizes)
    operands = build_group_operands(program, plan, params, dtype)
    shaped = state.reshape(shape)
    x = jnp.stack([jnp.real(shaped).astype(_F32),
                   jnp.imag(shaped).astype(_F32)])
    x = execute_group_plan(plan, operands, program, params, dtype, x)
    return (x[0] + 1j * x[1]).reshape(-1).astype(dtype)


def group_forward_fn(program: prog.CircuitProgram, dtype=None) -> Callable:
    """jitted ``f(params) -> complex state (2^n,)`` via the group-matmul
    plan. Handles EVERY circuit (generic per-gate fallback for the rare
    3-group gates).

    With ``CONFIG.interactive`` set, a structure with no fused compiled
    program yet is served by the skeleton-keyed executor instead (see
    ``interactive_forward_fn``) — the editor's 1-gate-edit rerun skips
    the per-structure compile."""
    dtype = dtype or CONFIG.dtype
    key = ("group-plan", program.compile_key, str(dtype))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached

    if CONFIG.interactive:
        fn = interactive_forward_fn(program, dtype)
        if fn is not None:
            # Deliberately NOT cached under the structure key: flipping
            # CONFIG.interactive off must restore the fused path.
            return fn

    fn = jax.jit(lambda params: group_forward_body(program, params, dtype))
    if len(_PLAN_CACHE) > 64:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Interactive (edit-hot) forward path: skeleton-keyed executor reuse
# ---------------------------------------------------------------------------

_SKEL_CACHE: dict[tuple, Callable] = {}


def plan_skeleton(plan: GroupPlan):
    """Hashable structural class of a plan: the step sequence, swap
    flags, and axis sizes — exactly what the DEREALIFIED trace reads
    (see ``_derealify``). Two circuits with equal skeletons compile to
    the SAME XLA program once operands are runtime inputs — so a 1-gate
    edit that preserves the step sequence (the common editor case: the
    new gate joins an existing composition window) reuses the compiled
    executable instead of paying a fresh compile
    (SURVEY §7 recompilation management; the reference recompiles
    nothing because it interprets per-gate,
    ``/root/reference/quantum_sim/engine/state_vector.py:41-74``).

    Realness analysis is deliberately EXCLUDED: the interactive
    executor always runs planar with full blocked operators, so that
    adding the first complex gate to an all-real window (Ry circuit +
    one Rz — the archetypal edit) reuses the executable instead of
    recompiling. The 2x FLOP cost is milliseconds at editor scale; the
    avoided compile is tens of seconds.

    Returns None when the plan contains a GenericStep — its trace reads
    the program op itself, so it stays structure-keyed."""
    if any(isinstance(s, GenericStep) for s in plan.steps):
        return None
    return (tuple(plan.layout.axis_sizes), plan.steps,
            tuple(s.is_swap for s in plan.bitpair_specs))


def _derealify(plan: GroupPlan) -> GroupPlan:
    """Plan copy with every realness flag cleared: the executor trace
    then reads only skeleton fields. Operands are built realness-
    independent (full blocked stacks), so this is purely a trace-side
    canonicalization."""
    import dataclasses as _dc

    return _dc.replace(
        plan,
        dense_real=tuple(tuple(False for _ in ax) for ax in plan.dense_real),
        cross_real=tuple(False for _ in plan.cross_real),
        diag_real=tuple(False for _ in plan.diag_real),
        prod_real=tuple(False for _ in plan.prod_real),
        bitpair_real=tuple(False for _ in plan.bitpair_real),
        all_real=False,
    )


def _skeleton_executor(skel, plan: GroupPlan, dtype) -> Callable:
    """Jitted ``f(operands, x0) -> flat complex state`` for the plan's
    skeleton class. The (derealified) trace reads ONLY skeleton fields
    of ``plan``, so caching by skeleton is sound even though the
    closure captures one particular plan instance."""
    key = (skel, str(dtype))
    fn = _SKEL_CACHE.get(key)
    if fn is not None:
        return fn
    plan = _derealify(plan)

    def body(operands, x0):
        x = execute_group_plan(plan, operands, None, None, dtype, x0,
                               planar=True)
        return (x[0] + 1j * x[1]).reshape(-1).astype(dtype)

    fn = jax.jit(body)
    if len(_SKEL_CACHE) > 64:
        _SKEL_CACHE.pop(next(iter(_SKEL_CACHE)))
    _SKEL_CACHE[key] = fn
    return fn


def _host_cpu_device():
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def interactive_forward_fn(program: prog.CircuitProgram, dtype=None):
    """``f(params) -> state`` through a skeleton-compiled executor:
    operands build EAGERLY in host NumPy (small K<=128 matrices —
    milliseconds, where the same arithmetic as eager jnp-on-CPU
    dispatches costs seconds per fresh structure) and stream to the device
    as runtime f32 inputs (complex never crosses the host boundary).
    Falls back to None when the plan needs a GenericStep or no
    CPU backend exists.

    Not differentiable in ``params`` (they leave the trace); gradient
    users stay on ``group_forward_body``."""
    dtype = dtype or CONFIG.dtype
    plan = get_group_plan(program)
    skel = plan_skeleton(plan)
    cpu = _host_cpu_device()
    if skel is None or cpu is None:
        return None
    fn = _skeleton_executor(skel, plan, dtype)
    dev = jax.devices()[0]

    def run(params):
        params_h = np.asarray(params)
        operands = build_group_operands(program, plan, params_h, dtype,
                                        xp=np)
        x0 = _planar_basis_state(plan.layout, program.initial_index,
                                 xp=np)
        operands, x0 = jax.device_put((operands, x0), dev)
        return fn(operands, x0)

    return run
