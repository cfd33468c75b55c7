"""Noisy stochastic-Kraus trajectories on the huge-state path (n >= 30).

Reference semantics (``/root/reference/quantum_sim/engine/noise.py:224-260``):
after every gate, for every configured channel and each of the gate's
target qubits, compute branch probabilities ``p_m = ||K_m psi||^2``, draw
one branch, keep it, renormalize. The reference loops this per shot on a
NumPy state capped at n=16; ``ops/plan.group_trajectory_body`` already
batches it on device for n <= 29. This module extends it to the n >= 30
single-device regime, where whole-state complex temporaries are what the
memory budget cannot afford, with a schedule built around two ideas:

* **Draw folding.** The branch probabilities only need the reduced density
  matrix rho of the gate's target qubits (``p_m = tr(K_m rho K_m^+)``), and
  rho evolves under the gate and under each selected Kraus branch by
  2^k x 2^k *trace-side* algebra (``rho' = U rho U^+``, then
  ``rho'' = K rho' K^+ / p`` per draw). So the gate and ALL its draws
  collapse into one combined operator ``(K_sel.. K_sel1 / sqrt(p..)) @ U``
  that touches the state ONCE — instead of the naive
  gate + per-draw-apply + renormalize whole-state passes.
* **Rho pipelining.** Each apply pass also accumulates the NEXT unit's
  target rho from the chunks it just produced, so the reduction rides the
  same read. Steady state is ONE read+write state pass per gate — the
  bandwidth floor for per-gate stochastic noise.

Kraus stacks that are real up to a global phase per operator (all four
reference channels — Y realifies to ``-iY``) keep an all-real circuit's
state REAL: half the memory and traffic. A per-branch global phase is
unobservable: branch probabilities, downstream draws, marginals, samples
and reduced density matrices are all invariant under it.

Chunking uses the same in-place slice/update schedule as
``ops/bigstate.execute_group_plan_chunked`` (state donated and carried in
one buffer; peak = state + 2 chunk temps).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CONFIG
from .plan import (
    _HI,
    _F32,
    GroupLayout,
    _blocked,
    _cross_spec,
    _dense_spec,
    _embed_in_axis,
    _indicator_masks,
    _op_is_real,
    _planar_basis_state,
    _real_basis_state,
    _split_axis_bit,
    apply_prod_diag,
    cross_blocked_tensor,
    cross_blocks,
    make_prodslice_fn,
    reorder_gate_targets,
)
from .bigstate import _chunk_axis

_FOLD_MAX_TARGETS = 3  # joint-rho folding bound: 8x8 trace algebra


# ---------------------------------------------------------------------------
# Static analysis: phase-real Kraus stacks, real-trajectory detection
# ---------------------------------------------------------------------------

def phase_real_stack(stack: np.ndarray) -> np.ndarray | None:
    """``(m, 2, 2)`` complex Kraus stack -> real stack when every operator
    is real up to a global phase (else None). Multiplying one Kraus
    operator by a unit phase changes nothing observable: branch
    probabilities ``||K psi||^2`` and the post-branch state's density
    matrix are phase-invariant, so draws, marginals, samples and reduced
    density matrices are identical. ``Y -> -iY = [[0,-1],[1,0]]``."""
    out = []
    for K in np.asarray(stack):
        flat = K.reshape(-1)
        j = int(np.argmax(np.abs(flat)))
        a = flat[j]
        if abs(a) < 1e-30:
            out.append(np.zeros((2, 2)))
            continue
        R = K * (np.conj(a) / abs(a))
        if not np.allclose(R.imag, 0.0, atol=1e-10):
            return None
        out.append(R.real)
    return np.stack(out).astype(np.float32)


def trajectory_is_real(program, noise_model) -> bool:
    """True when the whole stochastic trajectory stays real: every circuit
    operator real (``plan._op_is_real``) and every Kraus stack phase-real."""
    if not all(_op_is_real(op) for op in program.ops):
        return False
    seen: set[str] = set()
    for op in program.ops:
        if op.gate_name in seen:
            continue
        seen.add(op.gate_name)
        for st in noise_model.kraus_stacks_for_gate(op.gate_name):
            if phase_real_stack(st) is None:
                return False
    return True


# ---------------------------------------------------------------------------
# Reduced-density-matrix reductions on (chunks of) the grouped state
# ---------------------------------------------------------------------------

def _expose_bits(shape: tuple[int, ...], tbits) -> tuple[tuple, dict]:
    """Reshape plan exposing each target bit (axis, MSB-first pos) of a
    grouped data shape as its own size-2 dimension. Returns
    ``(new_shape, {(axis, pos): new_axis_index})``."""
    by_axis: dict[int, list[int]] = {}
    for ax, p in tbits:
        by_axis.setdefault(ax, []).append(p)
    new_shape: list[int] = []
    index: dict[tuple[int, int], int] = {}
    for ax, size in enumerate(shape):
        bits = size.bit_length() - 1
        poss = sorted(by_axis.get(ax, []))
        prev = 0
        for p in poss:
            span = p - prev
            if span:
                new_shape.append(1 << span)
            index[(ax, p)] = len(new_shape)
            new_shape.append(2)
            prev = p + 1
        rem = bits - prev
        if rem > 0 or not poss:
            new_shape.append(1 << max(rem, 0))
    return tuple(new_shape), index


def _rho_from(blk: jnp.ndarray, lead: int, tbits, planar: bool):
    """k-qubit reduced density matrix of the target bits from a state
    chunk (full-rank view; chunk axes not in ``tbits``). ``tbits`` is in
    the op's target order — first target = MSB of the 2^k rho index,
    matching the gate-matrix convention. Returns complex64 (planar) or
    f32 (real state); partial sums over chunks add linearly."""
    data_shape = blk.shape[lead:]
    new_shape, index = _expose_bits(data_shape, tbits)
    k = len(tbits)
    bit_axes = [index[t] for t in tbits]
    nd = len(new_shape)
    shared = [chr(ord('a') + i) for i in range(nd)]
    P = [chr(ord('A') + i) for i in range(k)]
    R = [chr(ord('N') + i) for i in range(k)]
    in1 = list(shared)
    in2 = list(shared)
    for t in range(k):
        in1[bit_axes[t]] = P[t]
        in2[bit_axes[t]] = R[t]
    out = ''.join(P) + ''.join(R)
    spec = f"{''.join(in1)},{''.join(in2)}->{out}"
    dim = 1 << k
    if not planar:
        a = blk.reshape(new_shape)
        return jnp.einsum(spec, a, a, precision=_HI).reshape(dim, dim)
    a = blk.reshape((2,) + new_shape)
    spec_c = f"z{''.join(in1)},z{''.join(in2)}->{out}"
    rr = jnp.einsum(spec_c, a, a, precision=_HI)
    ri = (jnp.einsum(spec, a[1], a[0], precision=_HI)
          - jnp.einsum(spec, a[0], a[1], precision=_HI))
    return (rr + 1j * ri).astype(jnp.complex64).reshape(dim, dim)


def _valid_chunk_axis(shape: tuple[int, ...], involved: set[int]
                      ) -> int | None:
    """Chunkable axis: free of ``involved``, non-minor (minor-axis slices
    are strided; see ``bigstate._chunk_axis``), and wide enough for >= 4
    chunks."""
    ax = _chunk_axis(shape, involved)
    if ax is None or ax == len(shape) - 1 or shape[ax] < 4:
        return None
    return ax


def _norm_sq_chunked(x: jnp.ndarray, lead: int, n_chunks: int):
    """Read-only ||x||^2 over chunk slices (planar planes included via
    the leading dim: re^2 + im^2 sums are one f32 reduction)."""
    shape = x.shape[lead:]
    ax = _valid_chunk_axis(shape, set())
    if n_chunks <= 1 or ax is None:
        return jnp.sum(x * x)
    size = shape[ax]
    chunks = min(n_chunks, size)
    while size % chunks:
        chunks -= 1
    width = size // chunks
    tax = ax + lead
    sizes = x.shape[:tax] + (width,) + x.shape[tax + 1:]
    acc = jnp.float32(0.0)
    for i in range(chunks):
        starts = [0] * x.ndim
        starts[tax] = i * width
        blk = jax.lax.dynamic_slice(x, starts, sizes)
        acc = acc + jnp.sum(blk * blk)
    return acc


def _rho_standalone(x: jnp.ndarray, lead: int, n_chunks: int, tbits,
                    planar: bool):
    """Read-only chunked rho reduction over the whole state (no update
    pass — slices accumulate partial sums)."""
    shape = x.shape[lead:]
    ax = _valid_chunk_axis(shape, {a for a, _ in tbits})
    if n_chunks <= 1 or ax is None:
        return _rho_from(x, lead, tbits, planar)
    size = shape[ax]
    chunks = min(n_chunks, size)
    while size % chunks:  # powers of two; cover the whole axis
        chunks -= 1
    width = size // chunks
    tax = ax + lead
    sizes = x.shape[:tax] + (width,) + x.shape[tax + 1:]
    acc = None
    for i in range(chunks):
        starts = [0] * x.ndim
        starts[tax] = i * width
        blk = jax.lax.dynamic_slice(x, starts, sizes)
        part = _rho_from(blk, lead, tbits, planar)
        acc = part if acc is None else acc + part
    return acc


def _apply_pass(x: jnp.ndarray, lead: int, n_chunks: int, involved,
                fn: Callable, *, want_start: bool = False,
                reduce_tbits=None, planar: bool = True):
    """One in-place (slice -> transform -> update) chunked state pass,
    optionally accumulating the rho of ``reduce_tbits`` from the pass
    OUTPUT chunks (the next unit's draw input rides this pass's read).
    Returns ``(x, rho_or_None)``."""
    shape = x.shape[lead:]
    if n_chunks <= 1:
        blk = fn(x, 0) if want_start else fn(x)
        rho = (_rho_from(blk, lead, reduce_tbits, planar)
               if reduce_tbits is not None else None)
        return blk, rho
    fuse = reduce_tbits is not None
    inv = set(involved) | ({a for a, _ in reduce_tbits} if fuse else set())
    ax = _valid_chunk_axis(shape, inv)
    if ax is None and fuse:
        # No axis free of both the apply and the reduce bits: run the
        # apply alone, then a standalone (read-only) reduce pass.
        x2, _ = _apply_pass(x, lead, n_chunks, involved, fn,
                            want_start=want_start, planar=planar)
        return x2, _rho_standalone(x2, lead, n_chunks, reduce_tbits, planar)
    if ax is None:
        ax = _valid_chunk_axis(shape, set(involved))
    if ax is None:
        # Nothing chunkable (small-n layouts only): whole-state pass.
        blk = fn(x, 0) if want_start else fn(x)
        rho = (_rho_from(blk, lead, reduce_tbits, planar)
               if reduce_tbits is not None else None)
        return blk, rho
    size = shape[ax]
    chunks = min(n_chunks, size)
    while size % chunks:  # powers of two; cover the whole axis
        chunks -= 1
    width = size // chunks
    tax = ax + lead
    sizes = x.shape[:tax] + (width,) + x.shape[tax + 1:]
    acc = None
    for i in range(chunks):
        starts = [0] * x.ndim
        starts[tax] = i * width
        blk = jax.lax.dynamic_slice(x, starts, sizes)
        blk = fn(blk, i * width) if want_start else fn(blk)
        if fuse:
            part = _rho_from(blk, lead, reduce_tbits, planar)
            acc = part if acc is None else acc + part
        x = jax.lax.dynamic_update_slice(x, blk, starts)
    return x, acc


# ---------------------------------------------------------------------------
# Per-op appliers (traced-operator -> chunkable transform)
# ---------------------------------------------------------------------------

def _classify(layout: GroupLayout, op) -> str:
    """'axis' | 'cross' | 'bits' | 'prod' — or raise for shapes the huge
    path cannot apply without a whole-state complex fallback (which at
    n >= 30 would exceed HBM). 'bits' is the rare <= 3-target gate
    spanning 3 groups (or 2 groups with no lone-bit axis)."""
    if op.cphase_value is not None:
        return 'prod'
    kind = _matrix_kind(layout, op.targets)
    if kind != 'bits':
        return kind
    from .plan import _diag_product_value

    if _diag_product_value(op) is not None:
        return 'prod'
    if len(op.targets) <= _FOLD_MAX_TARGETS:
        return 'bits'
    raise ValueError(
        f"{op.gate_name} on {len(op.targets)} qubits {op.targets} is "
        "neither <= 3 targets nor controlled-phase-form; the n >= 30 "
        "trajectory path has no whole-state fallback for it (use the "
        "sharded engine)")


def _matrix_kind(layout: GroupLayout, targets) -> str:
    """'axis' | 'cross' | 'bits' by target structure alone — the applier
    classification for ops forced onto the dense-matrix route (folded
    controlled-phase diagonals, which ``_classify`` calls 'prod')."""
    axes_bits: dict[int, int] = {}
    for q in targets:
        axes_bits[layout.axis_of(q)] = axes_bits.get(layout.axis_of(q),
                                                     0) + 1
    if len(axes_bits) == 1:
        return 'axis'
    if len(axes_bits) == 2 and min(axes_bits.values()) == 1:
        return 'cross'
    return 'bits'


def _make_applier(layout: GroupLayout, op, kind: str, planar: bool):
    """Applier factory for matrix ops by kind (see _classify)."""
    if kind == 'axis':
        return _axis_applier(layout, op.targets, planar)
    if kind == 'cross':
        return _cross_applier(layout, op.targets, planar)
    return _bits_applier(layout, op.targets, planar)


def _axis_applier(layout: GroupLayout, targets, planar: bool):
    """-> (make(U) -> chunk_fn, involved axes) for targets in one axis:
    embed into the S x S axis operator, ONE einsum over that axis — a
    well-shaped matmul, where the bit-level contraction below pays
    transposes for interior bits despite ~100x fewer paper FLOPs."""
    ax = layout.axis_of(targets[0])
    qubits = sorted(targets, key=lambda q: layout.pos_in_axis(q))
    pos = tuple(layout.pos_in_axis(q) for q in qubits)
    bits = layout.axis_bits[ax]
    rank = len(layout.axis_sizes)
    spec = _dense_spec(rank, ax, not planar, planar)

    def make(u):
        full = _embed_in_axis(reorder_gate_targets(u, targets, qubits),
                              pos, bits)
        if planar:
            opnd = _blocked(jnp.real(full).astype(_F32),
                            jnp.imag(full).astype(_F32), axis=0)
        else:
            opnd = jnp.real(full).astype(_F32)

        def f(blk):
            return jnp.einsum(spec, opnd, blk, precision=_HI)

        return f

    return make, {ax}


def _cross_applier(layout: GroupLayout, targets, planar: bool):
    """-> (make(U) -> chunk_fn, involved) for a 2-axis gate with a lone
    bit on one axis (same blocked-cross einsum as ``plan.CrossStep``)."""
    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    axes = sorted(by_axis)
    lone = [ax for ax in axes if len(by_axis[ax]) == 1]
    if len(lone) == 2:
        slice_axis = max(lone, key=lambda ax: layout.axis_sizes[ax])
    else:
        slice_axis = lone[0]
    op_axis = axes[0] if axes[0] != slice_axis else axes[1]
    slice_q = by_axis[slice_axis][0]
    op_qs = sorted(by_axis[op_axis], key=lambda q: layout.pos_in_axis(q))
    slice_pos = layout.pos_in_axis(slice_q)
    gl = 1 << len(op_qs)
    pos = tuple(layout.pos_in_axis(q) for q in op_qs)
    bits = layout.axis_bits[op_axis]
    lead = 1 if planar else 0

    def make(u):
        u4 = reorder_gate_targets(u, targets, [slice_q] + op_qs).reshape(
            2, gl, 2, gl)
        C = cross_blocked_tensor(cross_blocks(u4, pos, bits))
        if planar:
            opnd = _blocked(jnp.real(C).astype(_F32),
                            jnp.imag(C).astype(_F32), axis=0)
        else:
            opnd = jnp.real(C).astype(_F32)

        def f(blk):
            bshape = blk.shape[lead:]
            new_shape, bit_axis = _split_axis_bit(bshape, slice_axis,
                                                  slice_pos)
            o = op_axis + (2 if op_axis > slice_axis else 0)
            xr = blk.reshape(blk.shape[:lead] + new_shape)
            xr = jnp.einsum(
                _cross_spec(len(new_shape), bit_axis, o, not planar,
                            planar),
                opnd, xr, precision=_HI)
            return xr.reshape(blk.shape)

        return f

    return make, {slice_axis, op_axis}


def _bits_applier(layout: GroupLayout, targets, planar: bool):
    """-> (make(U) -> chunk_fn, involved axes): apply a 2^k gate by
    contracting its rank-2k tensor directly against the k exposed state
    bits — the fallback for gates spanning 3 groups (no axis/cross
    form). XLA pays transposes for interior-bit contractions, so it
    only serves shapes the embedded forms cannot."""
    tbits = tuple((layout.axis_of(q), layout.pos_in_axis(q))
                  for q in targets)
    k = len(targets)
    lead = 1 if planar else 0
    involved = {ax for ax, _ in tbits}

    def make(u):
        ut = u.reshape((2,) * (2 * k))  # row bits (out), col bits (in);
        # first target = MSB, matching the gate-matrix convention
        if planar:
            opnd = _blocked(jnp.real(ut).astype(_F32),
                            jnp.imag(ut).astype(_F32), axis=0)
        else:
            opnd = jnp.real(ut).astype(_F32)

        def f(blk):
            data_shape = blk.shape[lead:]
            new_shape, index = _expose_bits(data_shape, tbits)
            bit_axes = [index[t] for t in tbits]
            nd = len(new_shape)
            # shared letters start at 'e': 'c'/'d' are the plane axes
            shared = [chr(ord('e') + i) for i in range(nd)]
            P = [chr(ord('A') + i) for i in range(k)]
            R = [chr(ord('N') + i) for i in range(k)]
            xin = list(shared)
            xout = list(shared)
            for t in range(k):
                xin[bit_axes[t]] = R[t]
                xout[bit_axes[t]] = P[t]
            opsub = ''.join(P) + ''.join(R)
            if planar:
                spec = (f"cd{opsub},d{''.join(xin)}"
                        f"->c{''.join(xout)}")
                xr = blk.reshape((2,) + new_shape)
            else:
                spec = f"{opsub},{''.join(xin)}->{''.join(xout)}"
                xr = blk.reshape(new_shape)
            out = jnp.einsum(spec, opnd, xr, precision=_HI)
            return out.reshape(blk.shape)

        return f

    return make, involved


def _prod_applier(layout: GroupLayout, targets, v: complex, planar: bool,
                  n_chunks: int):
    """-> (chunk_fn, involved, want_start) for a controlled-phase-form
    diagonal (wide MCZ / CZ): one fused broadcast pass; when every
    non-minor axis is involved, the largest involved axis is chunked with
    its indicator factor sliced alongside the state."""
    rank = len(layout.axis_sizes)
    shape = tuple(layout.axis_sizes)
    masks = _indicator_masks(targets, layout)
    axes_t = tuple(ax for ax, _ in masks)
    facs = tuple(jnp.asarray(m) for _, m in masks)
    cre = float(np.real(v)) - 1.0
    cim = float(np.imag(v))
    lead = 1 if planar else 0
    free = _chunk_axis(shape, set(axes_t))
    if n_chunks <= 1 or (free is not None and free != rank - 1):
        def f(blk):
            return apply_prod_diag(blk, facs, cre, cim, rank, axes_t,
                                   planar)

        return f, set(axes_t), False
    ax = max(axes_t, key=lambda a: shape[a])
    fpos = axes_t.index(ax)
    f = make_prodslice_fn(facs, cre, cim, rank, axes_t, planar, ax, fpos,
                          lead)
    return f, set(axes_t) - {ax}, True


# ---------------------------------------------------------------------------
# Trace-side Kraus draw algebra
# ---------------------------------------------------------------------------

def _embed_kraus_np(stack: np.ndarray, k: int, j: int) -> np.ndarray:
    """Embed a (m, 2, 2) stack at target position j of a k-qubit space
    (first target = MSB): static (m, 2^k, 2^k) host constants."""
    pre = np.eye(1 << j)
    post = np.eye(1 << (k - 1 - j))
    return np.stack([np.kron(np.kron(pre, K), post) for K in stack])


def _branch_norms(Kt, rho):
    """p_m = tr(K_m rho K_m^+) for a stacked (m, D, D) operator set."""
    n = jnp.einsum("mij,jk,mik->m", Kt, rho, jnp.conj(Kt), precision=_HI)
    return jnp.real(n)


def _draw_and_fold(Kt, rho, key):
    """One stochastic Kraus draw: returns (K_sel_scaled, rho_after).
    Matches ``plan.group_trajectory_body``'s clamping exactly."""
    norms = _branch_norms(Kt, rho)
    idx = jax.random.categorical(key, jnp.log(norms + 1e-30))
    p = jnp.maximum(jnp.take(norms, idx), 1e-30)
    Ksel = jnp.take(Kt, idx, axis=0) / jnp.sqrt(p)
    rho_after = jnp.matmul(
        jnp.matmul(Ksel, rho, precision=_HI),
        jnp.conj(Ksel).T, precision=_HI)
    return Ksel, rho_after


# ---------------------------------------------------------------------------
# The trajectory executor
# ---------------------------------------------------------------------------

def _initial_rho(program, targets, planar: bool):
    """rho of ``targets`` in the initial basis state |b> (pure one-hot)."""
    n = program.num_qubits
    v = 0
    for q in targets:
        v = (v << 1) | ((program.initial_index >> (n - 1 - q)) & 1)
    dim = 1 << len(targets)
    e = np.zeros((dim, dim), np.complex64 if planar else np.float32)
    e[v, v] = 1.0
    return jnp.asarray(e)


def huge_trajectory_evolve(program, noise_model, params, key,
                           x: jnp.ndarray, dtype=None,
                           n_chunks: int | None = None,
                           from_basis: bool = False) -> jnp.ndarray:
    """Traceable noisy-trajectory evolution of a provided grouped state
    (planar ``(2, *axes)`` or real ``(*axes,)`` — must match
    ``trajectory_is_real``). Draw order and clamping mirror
    ``plan.group_trajectory_body`` exactly (same key-split indices), so
    the two paths take identical stochastic branches for the same key.

    The executor computes in f32 planes / complex64 only; ``dtype`` is
    accepted for signature symmetry with the bigstate forwards and
    canonicalized so duplicate cache entries are never compiled."""
    dtype = jnp.complex64
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)
    lead = 1 if planar else 0
    if n_chunks is None:
        from .bigstate import auto_chunks

        n_chunks = auto_chunks(program.num_qubits, planar=planar)

    # --- host-side unit plan -------------------------------------------
    # unit: (kind, op_index, draw_base, channel_stacks)
    #   'fold'  — gate + all its draws as one combined operator
    #   'apply' — bare gate apply (wide ops), draws follow as 'kraus'
    #   'kraus' — one per-qubit draw+apply (needs that qubit's rho)
    units: list[tuple] = []
    kind_by_op: dict[int, str] = {}
    draw = 0
    stacks_cache: dict[str, list] = {}
    for oi, op in enumerate(program.ops):
        if op.gate_name not in stacks_cache:
            raw = noise_model.kraus_stacks_for_gate(op.gate_name)
            if planar:
                stacks_cache[op.gate_name] = [
                    np.asarray(st, np.complex64) for st in raw]
            else:
                stacks_cache[op.gate_name] = [
                    phase_real_stack(st) for st in raw]
        stacks = stacks_cache[op.gate_name]
        kind = _classify(layout, op)
        k = len(op.targets)
        # Small controlled-phase diagonals with channels fold too on the
        # UNCHUNKED path: the dense 2^k apply beats apply + per-qubit
        # rho/kraus passes. Chunked (n >= 30) keeps the prod applier —
        # a dense apply there could lose its only chunkable axis.
        fold_prod = (kind == 'prod' and n_chunks <= 1 and stacks
                     and k <= _FOLD_MAX_TARGETS)
        kind_by_op[oi] = _matrix_kind(layout, op.targets) \
            if fold_prod else kind
        if (kind != 'prod' or fold_prod) and k <= _FOLD_MAX_TARGETS:
            units.append(('fold', oi, draw, stacks))
            draw += len(stacks) * k
        else:
            units.append(('apply', oi, draw, None))
            for st in stacks:
                for q in op.targets:
                    units.append(('kraus', oi, draw, (st, q)))
                    draw += 1
    total_draws = draw
    keys = jax.random.split(key, max(1, total_draws))

    def tbits_of(qubits):
        return tuple((layout.axis_of(q), layout.pos_in_axis(q))
                     for q in qubits)

    def rho_need(unit):
        kind, oi, _, extra = unit
        op = program.ops[oi]
        if kind == 'fold':
            return tbits_of(op.targets) if extra else None
        if kind == 'kraus':
            return tbits_of((extra[1],))
        return None

    def op_matrix(op):
        if op.cphase_value is not None:
            # Controlled-phase op being folded densely (no op_matrix
            # form): identity with the all-ones entry = v
            # (target-order symmetric).
            m = np.eye(1 << len(op.targets), dtype=np.complex64)
            m[-1, -1] = complex(op.cphase_value)
            u = jnp.asarray(m)
        else:
            u = program.op_matrix(op, params, jnp.complex64)
        return jnp.real(u).astype(_F32) if not planar else u

    rho = None
    for ui, unit in enumerate(units):
        kind, oi, draw_base, extra = unit
        op = program.ops[oi]
        need = rho_need(unit)
        if need is not None and rho is None:
            if ui == 0 and from_basis:
                # x is the untouched basis state: its target rho is the
                # static pure one-hot — no reduction pass needed.
                qubits = (op.targets if kind == 'fold' else (extra[1],))
                rho = _initial_rho(program, qubits, planar)
            else:
                rho = _rho_standalone(x, lead, n_chunks, need, planar)
        want_start = False
        kind_m = kind_by_op[oi]
        if kind == 'fold':
            U = op_matrix(op)
            k = len(op.targets)
            if extra:  # channels present: fold every draw into U
                rho_c = jnp.matmul(
                    jnp.matmul(U, rho, precision=_HI),
                    jnp.conj(U).T, precision=_HI)
                Ue = U
                d = 0
                for st in extra:
                    for j in range(k):
                        Kt = jnp.asarray(_embed_kraus_np(st, k, j))
                        Ksel, rho_c = _draw_and_fold(
                            Kt, rho_c, keys[draw_base + d])
                        Ue = jnp.matmul(Ksel, Ue, precision=_HI)
                        d += 1
            else:
                Ue = U
            maker, involved = _make_applier(layout, op, kind_m, planar)
            fn = maker(Ue)
        elif kind == 'apply':
            if kind_m == 'prod':
                from .plan import _diag_product_value

                v = (op.cphase_value if op.cphase_value is not None
                     else _diag_product_value(op))
                fn, involved, want_start = _prod_applier(
                    layout, op.targets, v, planar, n_chunks)
            else:
                maker, involved = _make_applier(layout, op, kind_m, planar)
                fn = maker(op_matrix(op))
        else:  # 'kraus'
            st, q = extra
            Kt = jnp.asarray(st)
            Ksel, _ = _draw_and_fold(Kt, rho, keys[draw_base])
            maker, involved = _axis_applier(layout, (q,), planar)
            fn = maker(Ksel)
        next_need = rho_need(units[ui + 1]) if ui + 1 < len(units) else None
        x, rho = _apply_pass(x, lead, n_chunks, involved, fn,
                             want_start=want_start,
                             reduce_tbits=next_need, planar=planar)

    # Exact final normalization — same contract as
    # plan.group_trajectory_body: each draw rescaled by 1/sqrt(p_sel)
    # where p_sel is an f32 trace-algebra ESTIMATE, and the ~1e-5
    # per-draw systematic error compounds over draws. Branch choices are
    # scale-invariant, so one exact division restores ||psi|| = 1
    # without changing any stochastic branch. Chunked read + chunked
    # scale keep the pass inside the huge-path memory budget.
    if total_draws:
        nsq = _norm_sq_chunked(x, lead, n_chunks)
        inv_n = 1.0 / jnp.sqrt(jnp.maximum(nsq, 1e-30))
        x, _ = _apply_pass(x, lead, n_chunks, set(),
                           lambda blk: blk * inv_n, planar=planar)
    return x


def _evolve_body(program, noise_model):
    """Huge-path trajectory evolution selector: ``(params, key, x,
    n_chunks) -> x``. Mixed-unitary noise takes the splice path
    (``ops/unitary_traj.unitary_insert_evolve`` — plan composition
    windows, ~per-column passes); monomial channels (amplitude damping,
    thermal relaxation, mixes) take the basis-sample splice path
    (``ops/monomial_traj.monomial_insert_evolve`` — same plan windows
    plus one |psi|^2 reduction per window); anything else takes the
    per-gate fold executor with trace-side rho algebra."""
    from .monomial_traj import (
        monomial_insert_evolve,
        monomial_insert_evolve_ok,
    )
    from .unitary_traj import (
        unitary_insert_evolve,
        unitary_insert_evolve_ok,
    )

    if unitary_insert_evolve_ok(program, noise_model):
        return lambda params, key, x, n_chunks=None: \
            unitary_insert_evolve(program, noise_model, params, key, x,
                                  n_chunks=n_chunks)
    if monomial_insert_evolve_ok(program, noise_model):
        return lambda params, key, x, n_chunks=None: \
            monomial_insert_evolve(program, noise_model, params, key, x,
                                   n_chunks=n_chunks)
    return lambda params, key, x, n_chunks=None: \
        huge_trajectory_evolve(program, noise_model, params, key, x,
                               None, n_chunks, from_basis=True)


def huge_trajectory_state_body(program, noise_model, params, key,
                               dtype=None, n_chunks: int | None = None
                               ) -> tuple[jnp.ndarray, bool]:
    """Traceable ``(params, key) -> (state, planar)`` noisy trajectory
    from the basis state: the huge-path counterpart of
    ``plan.group_trajectory_body`` (which returns a flat complex vector —
    unaffordable at n >= 30)."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)
    x = (_planar_basis_state(layout, program.initial_index) if planar
         else _real_basis_state(layout, program.initial_index))
    x = _evolve_body(program, noise_model)(params, key, x, n_chunks)
    return x, planar


def fold_supported(program) -> bool:
    """True when every op has a fold-path applier (host-side check for
    routing): ``_classify`` raises only for > 3-target gates with no
    controlled-phase form — those fall back to the per-gate
    ``plan.group_trajectory_body`` (flat-apply fallback)."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    try:
        for op in program.ops:
            _classify(layout, op)
    except ValueError:
        return False
    return True


def fold_trajectory_body(program, noise_model, params, key, dtype=None):
    """Whole-state (unchunked) folded stochastic trajectory — the vmapped
    mid-n (n <= 29) counterpart of ``plan.group_trajectory_body`` with
    the same draw schedule but the gate + ALL its Kraus draws collapsed
    into ONE combined-operator state pass (plus a fused rho reduction
    riding the output), instead of the per-draw rho/apply/renormalize
    whole-state passes that made one n=24 noisy trajectory ~250x the
    cost of the ideal run. Circuits that stay real (all-real ops +
    phase-real Kraus stacks) additionally drop the imaginary plane —
    half the HBM traffic. Returns the flat complex state; same keys →
    same stochastic branches as the per-gate path.

    Reference hot loop being replaced (per-shot Python):
    ``/root/reference/quantum_sim/engine/simulator.py:134-145`` +
    ``noise.py:224-260``."""
    dtype = dtype or jnp.complex64
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)
    x = (_planar_basis_state(layout, program.initial_index) if planar
         else _real_basis_state(layout, program.initial_index))
    x = huge_trajectory_evolve(program, noise_model, params, key, x,
                               dtype, n_chunks=1, from_basis=True)
    if planar:
        return (x[0] + 1j * x[1]).reshape(-1).astype(dtype)
    return x.reshape(-1).astype(dtype)


# ---------------------------------------------------------------------------
# Axis grams (per-axis Gram matrices -> per-qubit reduced density matrices)
# ---------------------------------------------------------------------------

def axis_grams(x: jnp.ndarray, planar: bool):
    """Per-data-axis Gram matrices ``G_ax[p, q] = sum_rest psi[..p..]
    conj(psi[..q..])`` as (rr, ri) f32 pairs — each one read-only fused
    reduction (no whole-state temp). From ``G_ax`` every single-qubit
    (and same-axis multi-qubit) reduced density matrix follows by a tiny
    host partial trace: the scalable stand-in for per-qubit ensemble
    density matrices at n >= 30."""
    lead = 1 if planar else 0
    rank = x.ndim - lead
    outs = []
    for ax in range(rank):
        shared = [chr(ord('a') + i) for i in range(rank)]
        in1 = list(shared)
        in2 = list(shared)
        in1[ax] = 'X'
        in2[ax] = 'Y'
        spec = f"{''.join(in1)},{''.join(in2)}->XY"
        if planar:
            spec_c = f"z{''.join(in1)},z{''.join(in2)}->XY"
            rr = jnp.einsum(spec_c, x, x, precision=_HI)
            ri = (jnp.einsum(spec, x[1], x[0], precision=_HI)
                  - jnp.einsum(spec, x[0], x[1], precision=_HI))
        else:
            rr = jnp.einsum(spec, x, x, precision=_HI)
            ri = jnp.zeros_like(rr)
        outs.append((rr, ri))
    return tuple(outs)


def gram_to_qubit_rho(gram_rr: np.ndarray, gram_ri: np.ndarray,
                      axis_bits: int, pos: int) -> np.ndarray:
    """Partial-trace a (S, S) axis Gram down to the 2x2 reduced density
    matrix of the bit at MSB-first ``pos`` (host-side, tiny)."""
    G = np.asarray(gram_rr) + 1j * np.asarray(gram_ri)
    pre = 1 << pos
    post = 1 << (axis_bits - pos - 1)
    G6 = G.reshape(pre, 2, post, pre, 2, post)
    return np.einsum('aibajb->ij', G6)


def qubit_rhos_from_grams(grams, num_qubits: int) -> np.ndarray:
    """(n, 2, 2) complex per-qubit reduced density matrices from the
    per-axis Gram pairs returned by ``axis_grams``."""
    layout = GroupLayout.for_qubits(num_qubits)
    host = [(np.asarray(rr), np.asarray(ri)) for rr, ri in grams]
    out = np.empty((num_qubits, 2, 2), np.complex128)
    for q in range(num_qubits):
        ax = layout.axis_of(q)
        out[q] = gram_to_qubit_rho(host[ax][0], host[ax][1],
                                   layout.axis_bits[ax],
                                   layout.pos_in_axis(q))
    return out


# ---------------------------------------------------------------------------
# Measurement-basis rotation as composed per-axis passes
# ---------------------------------------------------------------------------

_H_NP = (1.0 / np.sqrt(2.0)) * np.array([[1.0, 1.0], [1.0, -1.0]])
# Y basis: S-dagger then H per qubit (reference measurement.py:91-98)
_HSD_NP = _H_NP @ np.diag([1.0, -1.0j])


def apply_basis_rotation(x: jnp.ndarray, basis: str, layout: GroupLayout,
                         n_chunks: int, planar: bool
                         ) -> tuple[jnp.ndarray, bool]:
    """Rotate a grouped state into the X or Y measurement basis with ONE
    composed kron operator pass per axis (H^k per axis for X; (H S+)^k
    for Y). A real state rotating to Y planarizes first (the rotation is
    complex). Returns ``(x, planar)``."""
    if basis == 'Z':
        return x, planar
    m = _H_NP if basis == 'X' else _HSD_NP
    rot_real = basis == 'X'
    if not rot_real and not planar:
        x = jnp.stack([x, jnp.zeros_like(x)])
        planar = True
    lead = 1 if planar else 0
    rank = len(layout.axis_sizes)
    for ax in range(rank):
        op = m
        for _ in range(layout.axis_bits[ax] - 1):
            op = np.kron(op, m)
        spec = _dense_spec(rank, ax, rot_real, planar)
        if planar and not rot_real:
            opnd = _blocked(jnp.asarray(op.real, _F32),
                            jnp.asarray(op.imag, _F32), axis=0)
        else:
            opnd = jnp.asarray(op.real, _F32)

        def fn(blk, opnd=opnd, spec=spec):
            return jnp.einsum(spec, opnd, blk, precision=_HI)

        x, _ = _apply_pass(x, lead, n_chunks, {ax}, fn, planar=planar)
    return x, planar


# ---------------------------------------------------------------------------
# Donation chain: init -> noisy apply -> stats (the n >= 30 dispatch plan)
# ---------------------------------------------------------------------------
#
# Same rationale as the ideal chain in ``bigstate.py``: a fused program
# RETURNING the state doubles peak memory, and a non-donated second
# dispatch consuming it stages a second copy. The state is donated
# through every dispatch, in the default layout (see ``bigstate.py``).

_TRAJ_CACHE: dict[tuple, object] = {}


def _traj_cache_put(key, value):
    if len(_TRAJ_CACHE) > 32:
        _TRAJ_CACHE.pop(next(iter(_TRAJ_CACHE)))
    _TRAJ_CACHE[key] = value
    return value


def _traj_state_shape(program, planar: bool) -> tuple[int, ...]:
    layout = GroupLayout.for_qubits(program.num_qubits)
    shape = tuple(layout.axis_sizes)
    return ((2,) + shape) if planar else shape


def _traj_init_fn(program, noise_model, dtype):
    """Cached jitted ``f() -> basis state``."""
    planar = not trajectory_is_real(program, noise_model)
    key_t = ("traj-init", program.compile_key, noise_model.spec_key(),
             str(dtype))
    cached = _TRAJ_CACHE.get(key_t)
    if cached is None:
        layout = GroupLayout.for_qubits(program.num_qubits)
        if planar:
            body = lambda: _planar_basis_state(  # noqa: E731
                layout, program.initial_index)
        else:
            body = lambda: _real_basis_state(  # noqa: E731
                layout, program.initial_index)
        cached = _traj_cache_put(key_t, jax.jit(body))
    return cached


def _traj_apply_fn(program, noise_model, dtype):
    """Cached jitted ``(params, key, x) -> x`` with the state donated. The
    basis-state first-rho shortcut applies: the chain always feeds the
    freshly initialized basis state."""
    key_t = ("traj-apply", program.compile_key, noise_model.spec_key(),
             str(dtype))
    cached = _TRAJ_CACHE.get(key_t)
    if cached is None:
        body = _evolve_body(program, noise_model)
        cached = _traj_cache_put(key_t, jax.jit(
            lambda params, key, x: body(params, key, x),
            donate_argnums=(2,)))
    return cached


def _traj_stats_fn(program, noise_model, shots: int, dtype,
                   keep_state: bool, want_grams: bool, basis: str = 'Z'):
    """Cached jitted stats dispatch consuming the trajectory state
    (donated). Returns ``(fn, threads_state)``. Variants:

    * ``keep_state=True``: ``f(x[, key]) -> (x, marginals[, idx])`` — the
      single-trajectory ``Simulator.run`` result (state threaded back).
    * ``keep_state=False, shots>0``: ``f(x, key) -> (x', idx)`` — per-shot
      sampling for ``run_with_noise``. ``basis`` rotates (in place, fused
      per-axis kron passes) before sampling — only valid with
      ``keep_state=False``, since rotation mutates the donated state.
    * ``want_grams=True``: additionally returns per-axis Gram pairs (the
      per-qubit-rho ingredient for ensemble reductions).

    ``threads_state``: even when the caller discards the state it is
    threaded back as output[0] so the donated input can ALIAS an output
    (bigstate's donation discipline) — without this XLA warns "donated
    buffers were not usable" and inserts whole-state copies. Callers
    must ``.delete()`` output[0] when ``threads_state`` and
    ``keep_state`` is False. The only non-threaded shape: a Y rotation
    of a REAL state planarizes (shape change — no alias possible).
    """
    from .bigstate import sample_state_indices, state_axis_marginals

    if basis != 'Z' and keep_state:
        raise ValueError("basis rotation mutates the donated state; use "
                         "keep_state=False (run a second chain for the "
                         "unrotated state)")
    planar = not trajectory_is_real(program, noise_model)
    # Post-rotation state aliases the donated input unless the rotation
    # changed its shape (Y planarizes a real state).
    threads_state = (not keep_state
                     and not (shots > 0 and basis == 'Y' and not planar))
    key_t = ("traj-stats", program.compile_key, noise_model.spec_key(),
             str(dtype), shots, keep_state, want_grams, basis)
    cached = _TRAJ_CACHE.get(key_t)
    if cached is not None:
        return cached, threads_state
    from .bigstate import sampling_probs_dtype

    sample_planar = planar or basis == 'Y'
    probs_dtype = sampling_probs_dtype(program.num_qubits, sample_planar)
    layout = GroupLayout.for_qubits(program.num_qubits)

    def body(x, key=None):
        outs = []
        thread = x if threads_state else None
        if keep_state:
            outs.append(x)
            outs.append(state_axis_marginals(x, planar))
        if want_grams:
            outs.append(axis_grams(x, planar))
        if shots > 0:
            from .bigstate import auto_chunks

            # Chunk for the POST-rotation realness: a Y rotation
            # planarizes a real state before its per-axis passes, so
            # the whole-state schedule that fit the 4 GiB real form
            # would allocate 2x 8 GiB planar temps at n=30.
            xs, pl = apply_basis_rotation(
                x, basis, layout,
                auto_chunks(program.num_qubits, planar=sample_planar),
                planar)
            if threads_state:
                # Thread the POST-rotation value: returning pre-rotation
                # x would force XLA to preserve it (a whole-state copy).
                thread = xs
            outs.append(sample_state_indices(xs, key, shots, planar=pl,
                                             probs_dtype=probs_dtype))
        if thread is not None:
            outs.insert(0, thread)
        return tuple(outs)

    if shots > 0:
        fn = jax.jit(lambda x, key: body(x, key), donate_argnums=(0,))
    else:
        fn = jax.jit(lambda x: body(x), donate_argnums=(0,))
    return _traj_cache_put(key_t, fn), threads_state


def huge_trajectory_sample_fn(program, noise_model, shots: int,
                              dtype=None, keep_state: bool = False,
                              basis: str = 'Z') -> tuple[Callable, bool]:
    """``(run, planar)`` where ``run(params, traj_key, sample_key)``
    executes ONE stochastic trajectory through the donation chain and
    returns ``idx`` (``keep_state=False``) or ``(x, marginals, idx)``
    (``keep_state=True``). Compiled once; re-invoked per trajectory with
    fresh keys. ``basis`` rotates before sampling (keep_state=False
    only)."""
    dtype = jnp.complex64  # executor is f32/c64-only; unify cache keys
    if shots <= 0 and not keep_state:
        raise ValueError(
            "shots=0 with keep_state=False would evolve the trajectory "
            "and return nothing; pass keep_state=True (state+marginals) "
            "or use huge_trajectory_gram_fn for ensemble reductions")
    planar = not trajectory_is_real(program, noise_model)

    def run(params, traj_key, sample_key):
        x = _traj_init_fn(program, noise_model, dtype)()
        x = _traj_apply_fn(program, noise_model, dtype)(params, traj_key, x)
        if shots > 0:
            fn, threads = _traj_stats_fn(program, noise_model, shots, dtype,
                                         keep_state, False, basis)
            out = fn(x, sample_key)
        else:
            fn, threads = _traj_stats_fn(program, noise_model, 0, dtype,
                                         keep_state, False, basis)
            out = fn(x)
        if keep_state:
            return out
        if threads:
            out[0].delete()  # aliased donation thread-through; free now
        return out[-1]

    return run, planar


def huge_monitored_sample_fn(program, noise_model, events: tuple,
                             shots: int, n_chunks: int | None = None
                             ) -> tuple[Callable, bool]:
    """``(run, planar)`` for n >= 30 MONITORED trajectories:
    ``run(params, traj_key, sample_key) -> (outcomes[M] i32, idx[shots]
    i32)`` (or just outcomes when ``shots == 0``). Mid-circuit
    projective collapse and Z-basis final sampling are FUSED into one
    jitted program — the whole-state buffer never crosses a jit
    boundary, so none of the donation/layout plumbing of the noise
    chain applies (only two tiny int32 vectors leave the device).
    Noise (if any) must be monomial — the reference channel family."""
    from .bigstate import sample_state_indices, sampling_probs_dtype
    from .monomial_traj import monomial_monitored_evolve, monomial_spec

    spec = monomial_spec(program, noise_model, tuple(events))
    if spec is None:
        raise ValueError(
            "huge monitored trajectories need monomial noise channels "
            "(the reference family) or a noise-free circuit")
    planar = not spec.real
    key_t = ("monitored-huge", program.compile_key,
             noise_model.spec_key(), tuple(events), shots, n_chunks)
    cached = _TRAJ_CACHE.get(key_t)
    if cached is not None:
        return cached, planar
    layout = GroupLayout.for_qubits(program.num_qubits)
    probs_dtype = sampling_probs_dtype(program.num_qubits, planar)

    if shots > 0:
        def body(params, traj_key, sample_key):
            x = (_planar_basis_state(layout, program.initial_index)
                 if planar else
                 _real_basis_state(layout, program.initial_index))
            x, outs = monomial_monitored_evolve(
                program, noise_model, events, params, traj_key, x,
                n_chunks)
            idx = sample_state_indices(x, sample_key, shots,
                                       planar=planar,
                                       probs_dtype=probs_dtype)
            return outs, idx
    else:
        def body(params, traj_key, sample_key):
            del sample_key
            x = (_planar_basis_state(layout, program.initial_index)
                 if planar else
                 _real_basis_state(layout, program.initial_index))
            _, outs = monomial_monitored_evolve(
                program, noise_model, events, params, traj_key, x,
                n_chunks)
            return outs

    return _traj_cache_put(key_t, jax.jit(body)), planar


def huge_trajectory_gram_fn(program, noise_model, dtype=None
                            ) -> tuple[Callable, bool]:
    """``(run, planar)`` where ``run(params, traj_key)`` executes one
    trajectory and returns only the per-axis Gram pairs (state consumed
    and freed) — the n >= 30 ensemble-reduction primitive."""
    dtype = dtype or CONFIG.dtype
    planar = not trajectory_is_real(program, noise_model)

    def run(params, traj_key):
        x = _traj_init_fn(program, noise_model, dtype)()
        x = _traj_apply_fn(program, noise_model, dtype)(params, traj_key, x)
        fn, threads = _traj_stats_fn(program, noise_model, 0, dtype,
                                     False, True)
        out = fn(x)
        if threads:
            out[0].delete()  # aliased donation thread-through; free now
        return out[-1]

    return run, planar
