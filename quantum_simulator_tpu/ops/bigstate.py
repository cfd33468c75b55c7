"""Huge-state execution: the donated n >= 30 route and chunked passes.

A dense group-plan step is one einsum whose input and output are each a
whole state — 2^(n+3) bytes planar f32 — and XLA allocates both. When
that 2x-state peak does not fit the device budget (``auto_chunks``), the
state is processed in chunks along an axis the step does not touch:
``dynamic_slice`` -> step einsum on the chunk -> ``dynamic_update_slice``
back. XLA keeps the carried state in one buffer and performs the update
in place, so peak memory is

    state (2^(n+3) planar bytes) + 2 chunk temps (state / n_chunks each)

instead of 2x state. The chunk einsums are the SAME contractions the
whole-state path runs (K=128/256), restricted to 1/n_chunks of the
uninvolved axis.

The complex state is never materialized here: callers consume the planar
(2, *axis_sizes) f32 tensor directly (probabilities = x[0]^2 + x[1]^2),
because a complex64 copy at n=30 is another 8 GiB.

This extends the single-device qubit ceiling past the reference's
documented 28-qubit / 8 GiB limit (``/root/reference/README.md:211-218``,
``resource_monitor.py:420-447``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..config import CONFIG
from .plan import (
    _HI,
    AxisMatmulStep,
    BitPairStep,
    CrossStep,
    DiagPairStep,
    DiagProductStep,
    _cross_spec,
    _dense_spec,
    _diag_spec,
    _planar_basis_state,
    _real_basis_state,
    _split_axis_bit,
    apply_bitpair,
    apply_prod_diag,
    build_group_operands,
    get_group_plan,
)

# Memory schedule, derived from one device budget (``bytes_limit``; see
# config.device_memory_budget). The whole-state executor needs ~2x the
# state plus operand stacks and runtime buffers, so it runs while that
# peak stays inside _WHOLE_STATE_FRACTION of the budget and chunks past
# it. The streaming sampler's f32 probs buffer (4 bytes/amplitude, plus
# the build's chunk temps) must fit beside the state inside
# _SAMPLING_FRACTION; past it only the within-tile buffer drops to bf16.
_WHOLE_STATE_FRACTION = 0.625
_SAMPLING_FRACTION = 0.8
_DEFAULT_CHUNKS = 8
# The huge route (donation chain, planar-only, streaming sampler) takes
# every state of at least this many bytes as complex64, whatever the
# budget: the ordinary path would hold a complex copy beside the planar
# one and hand the whole state to the host.
HUGE_STATE_BYTES = 1 << 33  # complex64 at n = 30


def _budget(budget: int | None) -> int:
    if budget is not None:
        return budget
    from ..config import device_memory_budget

    return device_memory_budget()


def is_huge_state(num_qubits: int) -> bool:
    """True when an ``num_qubits`` complex64 state takes the huge route
    (on the GPU; the CPU keeps the ordinary programs)."""
    from ..config import on_gpu

    return (8 << num_qubits) >= HUGE_STATE_BYTES and on_gpu()


def sampling_probs_dtype(num_qubits: int, planar: bool,
                         budget: int | None = None):
    """Within-tile probs-buffer dtype for the streaming samplers: bf16
    when the state plus an f32 probs build would not fit inside
    ``_SAMPLING_FRACTION`` of the device budget (block SELECTION stays
    f32-exact either way). ONE definition — the threshold must not fork
    across samplers."""
    amps = 1 << num_qubits
    state_bytes = 4 * (2 if planar else 1) * amps
    limit = _SAMPLING_FRACTION * _budget(budget)
    return (jnp.bfloat16 if state_bytes + 8 * amps > limit
            else jnp.float32)


def auto_chunks(num_qubits: int, planar: bool = True,
                budget: int | None = None) -> int:
    """1 (whole-state executor) while 2x the state fits the budget's
    whole-state share, else 8. ``planar=False`` halves the state-byte
    estimate for all-real evolutions (an f32 plane instead of two)."""
    state_bytes = (2 if planar else 1) << (num_qubits + 2)
    limit = _WHOLE_STATE_FRACTION * _budget(budget)
    return _DEFAULT_CHUNKS if 2 * state_bytes > limit else 1


def _chunk_axis(shape: tuple[int, ...], involved: set[int]) -> int | None:
    """Largest tensor axis not touched by the step (None if all touched).

    The MINOR-MOST axis is chosen only as a last resort: a chunk of the
    minor axis is a strided slice (rows of ``width`` contiguous elements
    a whole row apart), which breaks coalesced loads and stores and makes
    every slice/update round trip a gather-shaped copy. Non-minor chunks
    stay contiguous runs of at least one full minor row."""
    rank = len(shape)
    best = None
    for i, size in enumerate(shape):
        if i in involved or size < 2:
            continue
        if best is None:
            best = i
            continue
        # prefer non-minor axes; among equals prefer the larger axis
        cand_minor = i == rank - 1
        best_minor = best == rank - 1
        if (best_minor and not cand_minor) or (
                cand_minor == best_minor and size > shape[best]):
            best = i
    return best


def _chunked_pass(x: jnp.ndarray, involved: set[int], n_chunks: int,
                  apply_fn: Callable[..., jnp.ndarray],
                  lead: int = 1, pass_start: bool = False) -> jnp.ndarray:
    """Apply ``apply_fn`` (a full-rank state transform) chunk by chunk
    along an uninvolved axis, updating the carried state in place.
    ``lead`` = number of leading non-data axes (1 for the planar re/im
    plane, 0 for an all-real state). With ``pass_start`` the callback
    receives ``(block, chunk_start)`` so it can slice per-axis operands
    (e.g. DiagProductStep indicator factors) alongside the state."""
    shape = x.shape[lead:]  # drop any leading re/im plane axis
    ax = _chunk_axis(shape, involved)
    if ax is None or n_chunks <= 1:
        return apply_fn(x, 0) if pass_start else apply_fn(x)
    size = shape[ax]
    chunks = min(n_chunks, size)
    while size % chunks:  # axis sizes are powers of two; so are chunks
        chunks -= 1
    width = size // chunks
    tax = ax + lead  # tensor axis (past any leading re/im plane)
    sizes = x.shape[:tax] + (width,) + x.shape[tax + 1:]

    # Unrolled straight-line chunks with static offsets: XLA's copy
    # insertion performs every dynamic_update_slice in place (the
    # carried state stays one buffer; peak = state + 2 chunk temps).
    # The slice->einsum->update round trip costs ~3x the whole-state
    # pass traffic.
    for i in range(chunks):
        starts = [0] * x.ndim
        starts[tax] = i * width
        blk = jax.lax.dynamic_slice(x, starts, sizes)
        blk = apply_fn(blk, i * width) if pass_start else apply_fn(blk)
        x = jax.lax.dynamic_update_slice(x, blk, starts)
    return x


def execute_group_plan_chunked(plan, operands, program, params, dtype,
                               x: jnp.ndarray, n_chunks: int,
                               planar: bool = True) -> jnp.ndarray:
    """Run every plan step on the state ``x`` (planar, or real with
    ``planar=False`` for all-real plans) with passes chunked along an
    uninvolved axis (in-place carry). Identical math to
    ``plan.execute_group_plan``; only the memory schedule differs.

    Steps are grouped into WINDOWS of consecutive steps that still leave
    a common axis free: one slice/update round trip then covers every
    step in the window, so per-step HBM traffic drops from
    (2 + 4)·state (slice + einsum + update per step) toward the 2·state
    einsum floor — (2k + 4)/k·state for a k-step window. Windows
    preserve step order, and correctness needs exactly the window
    invariant the grouping enforces: no step in a window touches the
    chunk axis, so chunks evolve independently."""
    rank = len(plan.layout.axis_sizes)
    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = operands
    lead = 1 if planar else 0
    shape_d = tuple(plan.layout.axis_sizes)

    # Lower each step to ("fused", involved_axes, blk->blk) where
    # possible; prod-diags touching every axis and generic fallbacks
    # stay special.
    items: list[tuple] = []
    for step in plan.steps:
        if isinstance(step, BitPairStep):
            items.append(("fused", {step.slice_axis, step.op_axis},
                          lambda blk, step=step: apply_bitpair(
                              blk, plan, step, bitpair_ops, planar)))
        elif isinstance(step, AxisMatmulStep):
            real = plan.dense_real[step.axis][step.op_index]
            op = axis_stacks[step.axis][step.op_index]
            op = op[0, 0] if real else op
            spec = _dense_spec(rank, step.axis, real, planar)
            items.append(("fused", {step.axis},
                          lambda blk, op=op, spec=spec: jnp.einsum(
                              spec, op, blk, precision=_HI)))
        elif isinstance(step, CrossStep):
            real = plan.cross_real[step.index]
            cop = cross_ops[step.index]
            cop = cop[0, 0] if real else cop

            def cross_fn(blk, step=step, cop=cop, real=real):
                bshape = blk.shape[lead:]
                new_shape, bit_axis = _split_axis_bit(
                    bshape, step.slice_axis, step.slice_pos)
                o = step.op_axis + (2 if step.op_axis > step.slice_axis
                                    else 0)
                xr = blk.reshape(blk.shape[:lead] + new_shape)
                xr = jnp.einsum(
                    _cross_spec(len(new_shape), bit_axis, o, real, planar),
                    cop, xr, precision=_HI)
                return xr.reshape(blk.shape)

            items.append(("fused", {step.slice_axis, step.op_axis},
                          cross_fn))
        elif isinstance(step, DiagPairStep):
            real = plan.diag_real[step.index]
            d = diag_ops[step.index]
            d = d[0, 0] if real else d
            spec = _diag_spec(rank, step.axis_a, step.axis_b, real, planar)
            items.append(("fused", {step.axis_a, step.axis_b},
                          lambda blk, d=d, spec=spec: jnp.einsum(
                              spec, d, blk, precision=_HI)))
        elif isinstance(step, DiagProductStep):
            facs, cre, cim = prod_ops[step.index]
            free = _chunk_axis(shape_d, set(step.axes))
            # Route through the factor-slicing path not only when NO
            # axis is free but also when the only free axis is the
            # minor one (e.g. axes={0,1,2,3} of 5): chunking the minor
            # axis pads 8x (the QFT-30 OOM mode).
            if n_chunks <= 1 or (free is not None and free != rank - 1):
                items.append(("fused", set(step.axes),
                              lambda blk, facs=facs, cre=cre, cim=cim,
                              step=step: apply_prod_diag(
                                  blk, facs, cre, cim, rank, step.axes,
                                  planar)))
            else:
                items.append(("prodslice", step, (facs, cre, cim)))
        else:
            items.append(("generic", step))

    i = 0
    while i < len(items):
        kind = items[i][0]
        if kind == "generic":
            # GenericStep: a non-diagonal 3-group gate — whole-state
            # complex fallback. Cannot appear in brickwork/QFT/Grover
            # workloads; at n >= 30 the round-trip would exceed HBM,
            # acceptable for the rare generic case.
            from .apply import apply_gate

            op = program.ops[items[i][1].program_op]
            u = program.op_matrix(op, params, dtype)
            flat = (x[0] + 1j * x[1]).reshape(-1).astype(dtype)
            flat = apply_gate(flat, u, op.targets, plan.layout.num_qubits)
            shaped = flat.reshape(shape_d)
            x = jnp.stack([jnp.real(shaped).astype(jnp.float32),
                           jnp.imag(shaped).astype(jnp.float32)])
            i += 1
            continue
        if kind == "prodslice":
            # An MCZ touching every group (or every non-minor group):
            # elementwise, so chunk the largest involved axis — excluded
            # from `involved` so _chunked_pass picks it — and slice its
            # indicator factor alongside the state chunk via the start
            # hook.
            step, (facs, cre, cim) = items[i][1], items[i][2]
            ax = max(step.axes, key=lambda k: shape_d[k])
            fpos = step.axes.index(ax)
            from .plan import make_prodslice_fn

            prod_fn = make_prodslice_fn(facs, cre, cim, rank, step.axes,
                                        planar, ax, fpos, lead)
            x = _chunked_pass(x, set(step.axes) - {ax}, n_chunks,
                              prod_fn, lead=lead, pass_start=True)
            i += 1
            continue
        # Greedy window: extend while a non-minor axis of size >= 4
        # stays free. Chunk count clamps to the axis size (4 chunks =
        # 2x state/4 temps, still comfortably inside HBM), which lets
        # the size-4 top axis at n=30 serve as a window's free axis —
        # fewer windows, fewer slice/update round trips. (Round-2 note:
        # chunking the size-4 axis once ran 20x slower — that was the
        # MINOR-axis padding hole, since fixed in _chunk_axis; width
        # size/4 on a non-minor axis is pad-free.)
        def ok(inv):
            ax = _chunk_axis(shape_d, inv)
            return (ax is not None and ax != len(shape_d) - 1
                    and shape_d[ax] >= 4)

        involved = set(items[i][1])
        j = i + 1
        while j < len(items) and items[j][0] == "fused":
            cand = involved | items[j][1]
            if not ok(cand):
                break
            involved = cand
            j += 1
        fns = tuple(items[k][2] for k in range(i, j))

        def window_fn(blk, fns=fns):
            for f in fns:
                blk = f(blk)
            return blk

        x = _chunked_pass(x, involved, n_chunks, window_fn, lead=lead)
        i = j
    return x


def group_forward_state_body(program, params, dtype=None,
                             n_chunks: int | None = None
                             ) -> tuple[jnp.ndarray, bool]:
    """Traceable forward pass returning ``(x, planar)``: the PLANAR
    (2, *axis_sizes) f32 state, or — for an all-real plan — the bare REAL
    (*axis_sizes,) tensor with ``planar=False`` (at n=30 even stacking a
    zero imaginary plane is +4 GiB, so the zero plane is never built).
    ``planar`` is trace-static (a plan property). ``n_chunks=None`` picks
    the memory schedule from the qubit count."""
    dtype = dtype or CONFIG.dtype
    plan = get_group_plan(program)
    operands = build_group_operands(program, plan, params, dtype)
    if n_chunks is None:
        # Realness-aware: an all-real state is half the planar bytes,
        # so its whole-state schedule (2x state peak) fits where the
        # planar estimate would force chunking (no slice/update round
        # trips).
        n_chunks = auto_chunks(program.num_qubits,
                               planar=not plan.all_real)
    if plan.all_real:
        xr = _real_basis_state(plan.layout, program.initial_index)
        if n_chunks > 1:
            xr = execute_group_plan_chunked(plan, operands, program,
                                            params, dtype, xr, n_chunks,
                                            planar=False)
        else:
            from .plan import execute_group_plan

            xr = execute_group_plan(plan, operands, program, params,
                                    dtype, xr, planar=False)
        return xr, False
    x = _planar_basis_state(plan.layout, program.initial_index)
    if n_chunks > 1:
        return execute_group_plan_chunked(plan, operands, program, params,
                                          dtype, x, n_chunks), True
    from .plan import execute_group_plan

    return execute_group_plan(plan, operands, program, params, dtype, x), True


def group_forward_planar_body(program, params, dtype=None,
                              n_chunks: int | None = None) -> jnp.ndarray:
    """Traceable forward pass returning the PLANAR (2, *axis_sizes) f32
    state (no complex copy is ever built). For all-real plans this stacks
    a zero imaginary plane — callers that must avoid that extra
    whole-state write at n >= 30 use ``group_forward_state_body``."""
    x, planar = group_forward_state_body(program, params, dtype, n_chunks)
    return x if planar else jnp.stack([x, jnp.zeros_like(x)])


def planar_probabilities(x: jnp.ndarray) -> jnp.ndarray:
    """|amp|^2 vector (2^n,) f32 from a planar state — half the memory of
    going through a complex copy."""
    return (x[0] * x[0] + x[1] * x[1]).reshape(-1)


def planar_norm_sq(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(x * x)


def state_axis_marginals(x: jnp.ndarray, planar: bool
                         ) -> tuple[jnp.ndarray, ...]:
    """Per-data-axis probability marginals: for each tensor axis, the
    (axis_size,) f32 vector of |amp|^2 summed over every other axis (and
    the re/im plane when planar). Each marginal is a fused
    square+reduction — no whole-state temp — so the set costs a few
    bandwidth passes and O(sum axis_sizes) output. Per-qubit P(1) falls
    out on host by summing entries whose bit is set."""
    lead = 1 if planar else 0
    outs = []
    for ax in range(x.ndim - lead):
        axes = tuple(a for a in range(x.ndim) if a != ax + lead)
        outs.append(jnp.sum(x * x, axis=axes))
    return tuple(outs)


_ZSTRING_CACHE: dict[tuple, Callable] = {}


def _paulistring_fn(state_shape: tuple[int, ...], planar: bool,
                    perm_masks: tuple[tuple[int, int], ...],
                    sign_axes: tuple[int, ...], n_chunks: int
                    ) -> Callable:
    """Cached jitted ``f(x, *sign_vecs) -> (re, im)`` computing the inner
    sum of a general Pauli-string expectation,

        S = sum_j conj(x[j ^ mask]) * prod_ax sign_ax(j_ax) * x[j],

    as a read-only chunked pass (peak = state + a few chunk temps; the
    permuted copy is built PER CHUNK, never whole-state). ``perm_masks``
    is ((axis, xor_mask), ...) for axes carrying X/Y bits; ``sign_axes``
    orders the sign-vector operands ((-1)^parity of that axis's Z/Y
    bits). The chunk axis is chosen free of permutations (sign-only axes
    chunk fine — their vector slices alongside the state)."""
    key = (state_shape, planar, perm_masks, sign_axes, n_chunks)
    cached = _ZSTRING_CACHE.get(key)
    if cached is not None:
        return cached
    lead = 1 if planar else 0
    rank = len(state_shape) - lead
    shape = state_shape[lead:]
    perm_ax_set = {ax for ax, _ in perm_masks}
    # Chunk axis: non-minor, >= 4 wide, no permuted bits (Z-only fine).
    chunk_ax = None
    if n_chunks > 1:
        cands = [a for a in range(rank - 1)
                 if a not in perm_ax_set and shape[a] >= 4]
        if cands:
            chunk_ax = max(cands, key=lambda a: shape[a])

    def _inner(blk, sliced_vecs):
        # j -> j ^ mask along an axis is a reversal of that axis's masked
        # BIT dimensions: reshape the axis to (2,)*bits, jnp.flip the
        # masked ones, reshape back. Pure XLA `reverse` — no
        # whole-state gather.
        t = blk
        for ax, mask in perm_masks:
            bits = shape[ax].bit_length() - 1
            tax = ax + lead
            expanded = (t.shape[:tax] + (2,) * bits
                        + t.shape[tax + 1:])
            flip_dims = tuple(tax + b for b in range(bits)
                              if (mask >> (bits - 1 - b)) & 1)
            t = jnp.flip(t.reshape(expanded), axis=flip_dims)
            t = t.reshape(blk.shape)
        if planar:
            pr = t[0] * blk[0] + t[1] * blk[1]
            pi = t[0] * blk[1] - t[1] * blk[0]
        else:
            pr = t * blk
            pi = None
        for ax, v in zip(sign_axes, sliced_vecs):
            vshape = [1] * rank
            vshape[ax] = v.shape[0]
            pr = pr * v.reshape(vshape)
            if pi is not None:
                pi = pi * v.reshape(vshape)
        return jnp.sum(pr), (jnp.sum(pi) if pi is not None
                             else jnp.zeros((), pr.dtype))

    def body(x, *vecs):
        if chunk_ax is None:
            return _inner(x, vecs)
        size = shape[chunk_ax]
        chunks = min(n_chunks, size)
        width = size // chunks
        tax = chunk_ax + lead
        sizes = x.shape[:tax] + (width,) + x.shape[tax + 1:]
        acc_re = jnp.zeros((), jnp.float32)
        acc_im = jnp.zeros((), jnp.float32)
        for i in range(chunks):
            starts = [0] * x.ndim
            starts[tax] = i * width
            blk = jax.lax.dynamic_slice(x, starts, sizes)
            sliced = [
                (jax.lax.dynamic_slice_in_dim(v, i * width, width)
                 if ax == chunk_ax else v)
                for ax, v in zip(sign_axes, vecs)]
            r, m = _inner(blk, sliced)
            acc_re = acc_re + r
            acc_im = acc_im + m
        return acc_re, acc_im

    fn = jax.jit(body)
    if len(_ZSTRING_CACHE) > 64:
        _ZSTRING_CACHE.pop(next(iter(_ZSTRING_CACHE)))
    _ZSTRING_CACHE[key] = fn
    return fn


def _zstring_fn(state_shape: tuple[int, ...], planar: bool,
                axes: tuple[int, ...]) -> Callable:
    """Cached jitted ``f(x, *parity_vecs) -> scalar`` computing
    ``sum |amp|^2 * prod_ax parity_ax`` as ONE fused read-only reduction."""
    key = (state_shape, planar, axes)
    cached = _ZSTRING_CACHE.get(key)
    if cached is not None:
        return cached
    lead = 1 if planar else 0
    rank = len(state_shape) - lead

    def body(x, *vecs):
        y = x[0] * x[0] + x[1] * x[1] if planar else x * x
        for ax, v in zip(axes, vecs):
            shape = [1] * rank
            shape[ax] = v.shape[0]
            y = y * v.reshape(shape)
        return jnp.sum(y)

    fn = jax.jit(body)
    if len(_ZSTRING_CACHE) > 64:
        _ZSTRING_CACHE.pop(next(iter(_ZSTRING_CACHE)))
    _ZSTRING_CACHE[key] = fn
    return fn


# Jitted twins for host-facing calls on huge states: un-jitted, each
# elementwise op is its own dispatch whose whole-state operand is
# counted per USE in XLA's argument budget, and the multiply
# materializes a whole-state temp. Jitted, the mult fuses into the
# reduction / the reshape, so peak stays state + output.
_planar_norm_sq_jit = jax.jit(planar_norm_sq)
_planar_probabilities_jit = jax.jit(planar_probabilities)
_real_probabilities_jit = jax.jit(lambda x: (x * x).reshape(-1))
_axis_marginals_jit = jax.jit(state_axis_marginals, static_argnums=(1,))


# ---------------------------------------------------------------------------
# Huge-n sampling + host-facing state wrapper
# ---------------------------------------------------------------------------
#
# The huge path is a DONATION CHAIN of three dispatches:
#
#   init()               -> basis state           (the only big alloc)
#   apply(params, x)     -> evolved x             (x donated: output
#                                                  aliases input)
#   stats(x, key?)       -> (x, marginals, idx?)  (x donated and passed
#                                                  back through)
#
# A single fused program that RETURNS the state keeps the executor's
# whole-state carry alive as a temp next to a separate output buffer
# (2x state), and a non-donated second dispatch consuming the state
# stages a second copy of its argument. With donation both vanish:
# alias_size == state, temp == chunk buffers only, and peak stays
# state + probs + chunks. ``compiled.memory_analysis()`` of the apply
# program shows this (alias bytes == state bytes).
#
# The chain runs in the default (row-major) layout: on XLA:GPU the
# AUTO-layout AOT variant compiles to the same memory footprint and time
# (PERF.md), so no entry-layout pinning is needed.

_SAMPLE_CACHE: dict[tuple, Callable] = {}
_FWD_CACHE: dict[tuple, Callable] = {}


def _cache_put(cache: dict, key, value):
    if len(cache) > 32:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def _apply_body(program, plan, dtype, params, x):
    operands = build_group_operands(program, plan, params, dtype)
    n_chunks = auto_chunks(program.num_qubits, planar=not plan.all_real)
    if (program.compile_key and program.compile_key[0] == "superop"
            and program.num_qubits >= 30):
        # vec(rho) programs (density.superop_program) fuse differently:
        # the whole-state schedule at 2n >= 30 compiles whole-state
        # relayout temps; the chunked schedule bounds every temp to a
        # chunk.
        n_chunks = max(n_chunks, _DEFAULT_CHUNKS)
    if n_chunks <= 1:
        from .plan import execute_group_plan

        return execute_group_plan(plan, operands, program, params, dtype,
                                  x, planar=not plan.all_real)
    return execute_group_plan_chunked(
        plan, operands, program, params, dtype, x,
        n_chunks, planar=not plan.all_real)


def _huge_init_fn(program, dtype) -> Callable:
    """Cached jitted ``f() -> basis state`` (real for all-real plans)."""
    plan = get_group_plan(program)
    key_t = ("huge-init", program.compile_key, str(dtype))
    cached = _FWD_CACHE.get(key_t)
    if cached is None:
        if plan.all_real:
            body = lambda: _real_basis_state(plan.layout,  # noqa: E731
                                             program.initial_index)
        else:
            body = lambda: _planar_basis_state(plan.layout,  # noqa: E731
                                               program.initial_index)
        cached = _cache_put(_FWD_CACHE, key_t, jax.jit(body))
    return cached


def _huge_apply_fn(program, dtype) -> Callable:
    """``f(params, x) -> x`` running every plan step with the state
    DONATED (in place at the buffer level: the output aliases the
    input)."""
    plan = get_group_plan(program)
    key_t = ("huge-apply", program.compile_key, str(dtype))
    cached = _FWD_CACHE.get(key_t)
    if cached is None:
        cached = _cache_put(_FWD_CACHE, key_t, jax.jit(
            lambda params, x: _apply_body(program, plan, dtype, params, x),
            donate_argnums=(1,)))
    return cached


def _huge_stats_fn(program, shots: int, dtype) -> Callable:
    """Cached jitted ``f(x, key?) -> (x, marginals[, idx])`` with the
    state donated and threaded back out (aliased, not copied)."""
    plan = get_group_plan(program)
    planar = not plan.all_real
    key_t = ("huge-stats", program.compile_key, str(dtype), shots)
    cached = _SAMPLE_CACHE.get(key_t)
    if cached is None:
        # bf16 probs tier: when the state + an f32 probs buffer cannot
        # coexist in the device budget, quantize only the within-tile
        # sampling buffer (see sample_state_indices and
        # sampling_probs_dtype).
        probs_dtype = sampling_probs_dtype(program.num_qubits, planar)
        if shots > 0:
            def body(x, key):
                marg = state_axis_marginals(x, planar)
                idx = sample_state_indices(x, key, shots, planar=planar,
                                           probs_dtype=probs_dtype)
                return x, marg, idx
        else:
            def body(x):
                return x, state_axis_marginals(x, planar)
        cached = _cache_put(_SAMPLE_CACHE, key_t,
                            jax.jit(body, donate_argnums=(0,)))
    return cached


def huge_forward_fn(program, dtype=None) -> tuple[Callable, bool]:
    """``(f, planar)`` where ``f(params) -> (state, axis_marginals)``
    runs the donation chain (init -> apply -> stats; see the section
    comment above for the memory rationale). The state is the
    planar (2, *axis_sizes) f32 tensor, or the bare real (*axis_sizes,)
    tensor when the plan is all-real (``planar=False``)."""
    dtype = dtype or CONFIG.dtype
    planar = not get_group_plan(program).all_real

    def run(params):
        x = _huge_init_fn(program, dtype)()
        x = _huge_apply_fn(program, dtype)(params, x)
        return _huge_stats_fn(program, 0, dtype)(x)

    return run, planar


def huge_forward_sample_fn(program, shots: int, dtype=None
                           ) -> tuple[Callable, bool]:
    """``(f, planar)`` where ``f(params, key) -> (state, axis_marginals,
    (shots,) int32 indices)`` runs the donation chain with the two-level
    inverse-CDF sampler in the stats dispatch. Only the shot indices and
    the tiny marginals cross to host."""
    dtype = dtype or CONFIG.dtype
    planar = not get_group_plan(program).all_real

    def run(params, key):
        x = _huge_init_fn(program, dtype)()
        x = _huge_apply_fn(program, dtype)(params, x)
        return _huge_stats_fn(program, shots, dtype)(x, key)

    return run, planar


_SAMPLE_BATCH = 2048  # draws per tile-gather batch (bounds temp memory)


def sample_planar_indices(x: jnp.ndarray, key, shots: int) -> jnp.ndarray:
    """Two-level inverse-CDF sampler over a PLANAR (2, *axes) state."""
    return sample_state_indices(x, key, shots, planar=True)


def sample_state_indices(x: jnp.ndarray, key, shots: int,
                         planar: bool = True,
                         probs_dtype=jnp.float32) -> jnp.ndarray:
    """Traceable two-level inverse-CDF sampler over a planar (2, *axes)
    state — or, with ``planar=False``, a bare real (*axes,) state:
    ``shots`` basis indices (int32) without EVER materializing a large
    CDF — the n=30 requirement.

    A flat ``x.reshape(2, -1)`` would retile the whole state, whole-state
    CDFs cost a state's worth of memory, and tile gathers straight off
    the planar input can make XLA relayout the INPUT (gathers prefer a
    different minor dimension than the einsum executor's output). So:
    hierarchical sampling off a COMPUTED probs matrix, which costs one
    state/2 temp but zero input copies (the elementwise+reshape fusion
    writes the gather-friendly layout directly).

      level 1  probs = |amp|^2 as ONE (nblocks, S) fusion (S = trailing
               two data axes, 2^14 at n >= 21); per-block sums + tiny
               block CDF; each draw picks its block by binary search.
      level 2  row-gather each draw's S-wide block (batches of <=2048
               draws; batch x S f32 = 128 MiB), in-row CDF, binary
               search with a second, independent uniform scaled by the
               row's mass.

    Peak extra memory: state/2 + O(batch x S). Basis order: the planar
    data axes are MSB-first groups of the basis index
    (``plan.GroupLayout``), so C-order flattening = basis order, block
    ``b`` covers ``[b*S, (b+1)*S)``.

    The in-tile sums re-accumulate in a different order than the block
    reduction, so a draw can land one float-ulp past its tile's last
    interval; the final clip pins it to the tile edge (same tolerance as
    any float inverse-CDF). int32 indices cap this at n <= 31; the
    sharded engine owns anything larger.

    ``probs_dtype=bfloat16`` halves the probs buffer where the state and
    an f32 buffer would not fit the budget together. Block selection stays
    f32-exact (block sums accumulate in f32 straight off the state);
    only the within-tile placement quantizes each interval to bf16
    (~0.4% relative), far below shot noise at any realistic shot count.
    """
    data_shape = x.shape[1:] if planar else x.shape
    if len(data_shape) >= 3:
        tile_shape = data_shape[-2:]
        lead_shape = data_shape[:-2]
    else:
        tile_shape = data_shape[-1:]
        lead_shape = data_shape[:-1]
    S = 1
    for s in tile_shape:
        S *= s
    nblocks = 1
    for s in lead_shape:
        nblocks *= s
    # Build the flattened probs CHUNKED along the leading data axis with
    # in-place row updates, accumulating the per-block sums in f32 along
    # the way. When the state arrives in a non-default (AUTO) layout, a
    # whole-state square+flatten materializes BOTH the squared tensor in
    # the state's layout AND a relayouted flatten copy — 2x state/2
    # temps. Chunked, each chunk's square+transpose is a
    # transient 1/n_chunks-size temp and the only whole-size buffer is
    # probs itself. Chunks of the leading axis are CONTIGUOUS flat block
    # rows (C-order), so each chunk is one dynamic_update_slice on
    # axis 0. probs stays 3D (nblocks, *tile_shape): the per-draw (B, S)
    # flatten below is 1/nblocks the size and free to copy.
    sum_axes = tuple(range(1, 1 + len(tile_shape)))
    C = lead_shape[0] if lead_shape else 1
    if C > 1:
        n_chunks = min(C, 16)
        span = C // n_chunks
        rows_per = span * (nblocks // C)
        sl_axis = 1 if planar else 0

        def chunk_rows(start):
            xc = jax.lax.dynamic_slice_in_dim(x, start, span, axis=sl_axis)
            sqc = xc[0] * xc[0] + xc[1] * xc[1] if planar else xc * xc
            return sqc.reshape((rows_per,) + tile_shape)

        big = nblocks * S >= (1 << 26)
        if not big and probs_dtype == jnp.float32:
            # Small states: unrolled straight-line chunks.
            probs = jnp.zeros((nblocks,) + tile_shape, jnp.float32)
            bs_parts = []
            for c in range(n_chunks):
                rows = chunk_rows(c * span)
                bs_parts.append(jnp.sum(rows, axis=sum_axes))
                probs = jax.lax.dynamic_update_slice_in_dim(
                    probs, rows, c * rows_per, axis=0)
            bsums = jnp.concatenate(bs_parts)
        else:
            # Huge states (and the bf16 tier): unrolled, XLA hoists
            # every chunk's squared/convert temp so all n_chunks temps
            # are live at once. A fori_loop keeps exactly one chunk temp
            # live.
            def build(c, carry):
                probs, bsums = carry
                rows = chunk_rows(c * span)
                bsums = jax.lax.dynamic_update_slice_in_dim(
                    bsums, jnp.sum(rows, axis=sum_axes),
                    c * rows_per, axis=0)
                probs = jax.lax.dynamic_update_slice_in_dim(
                    probs, rows.astype(probs_dtype), c * rows_per, axis=0)
                return probs, bsums

            probs, bsums = jax.lax.fori_loop(
                0, n_chunks, build,
                (jnp.zeros((nblocks,) + tile_shape, probs_dtype),
                 jnp.zeros((nblocks,), jnp.float32)))
    else:
        sq = x[0] * x[0] + x[1] * x[1] if planar else x * x
        rows = sq.reshape((nblocks,) + tile_shape)
        bsums = jnp.sum(rows, axis=sum_axes)
        probs = rows.astype(probs_dtype)
    bcdf = jnp.cumsum(bsums)
    total = bcdf[-1]
    k_block, k_tile = jax.random.split(key)
    u = jax.random.uniform(k_block, (shots,), dtype=jnp.float32) * total
    b = jnp.clip(jnp.searchsorted(bcdf, u, side="right"), 0, nblocks - 1)
    # The in-tile position takes its OWN uniform, scaled by the tile's
    # mass. Reusing the remainder ``u - bcdf[b-1]`` would place draws
    # with the f32 resolution of the whole CDF (~6e-8), coarser than one
    # amplitude's probability once 2^n > 2^24: the low index bits would
    # come out (nearly) always 0.
    u_in = jax.random.uniform(k_tile, (shots,), dtype=jnp.float32)

    def batch_body(args):
        bb, uu = args
        tiles = jnp.take(probs, bb, axis=0)          # (B, *tile) gather
        tcdf = jnp.cumsum(tiles.reshape(len(uu), S).astype(jnp.float32),
                          axis=1)
        j = jax.vmap(lambda row, q: jnp.searchsorted(
            row, q * row[-1], side="right"))(tcdf, uu)
        return jnp.clip(j, 0, S - 1)

    batch = min(shots, _SAMPLE_BATCH)
    pad = (-shots) % batch
    bp = jnp.pad(b, (0, pad)).reshape(-1, batch)
    up = jnp.pad(u_in, (0, pad)).reshape(-1, batch)
    j = jax.lax.map(batch_body, (bp, up)).reshape(-1)[:shots]
    return b * S + j.astype(jnp.int32)


def huge_sample_fn(state_shape: tuple[int, ...], shots: int,
                   planar: bool = True) -> Callable:
    """Cached jitted ``f(state, key) -> (shots,) int32 indices``. Note:
    at n >= 30 prefer ``huge_forward_sample_fn`` — feeding an existing
    ~8 GiB state back through a jit boundary OOMs on this runtime (see
    that function's docstring)."""
    key_t = ("huge-sample", state_shape, shots, planar)
    cached = _SAMPLE_CACHE.get(key_t)
    if cached is None:
        cached = _cache_put(_SAMPLE_CACHE, key_t, jax.jit(
            lambda x, k: sample_state_indices(x, k, shots, planar=planar)))
    return cached


def qubit_probs_from_marginals(marginals, num_qubits: int):
    """(n,) per-qubit P(|1>) from per-axis probability marginals."""
    import numpy as np

    from .plan import GroupLayout

    layout = GroupLayout.for_qubits(num_qubits)
    host = [np.asarray(m) for m in marginals]
    p1 = np.empty(num_qubits)
    for q in range(num_qubits):
        ax = layout.axis_of(q)
        bit = layout.axis_bits[ax] - 1 - layout.pos_in_axis(q)
        idx = (np.arange(layout.axis_sizes[ax]) >> bit) & 1
        p1[q] = host[ax][idx == 1].sum()
    total = host[0].sum()
    return p1 / total if total > 0 else p1


class MarginalStateSummary:
    """Per-column snapshot summary for n >= 30 stepping: per-axis
    probability marginals only (a few KB), never a state copy. Yields the
    per-qubit probabilities every step-mode panel actually plots; the
    amplitudes themselves are structurally unaffordable per column at
    this scale (one whole-state copy per column).
    Reference analog: the per-column states of ``run_step_by_step``
    (``/root/reference/quantum_sim/engine/simulator.py:93-108``)."""

    def __init__(self, axis_marginals, num_qubits: int):
        self._marginals = axis_marginals
        self._num_qubits = num_qubits
        self._qp = None

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def axis_marginals(self):
        return self._marginals

    def qubit_probabilities(self):
        if self._qp is None:
            self._qp = qubit_probs_from_marginals(self._marginals,
                                                  self._num_qubits)
        return self._qp

    def expectation_z(self, qubit: int) -> float:
        return float(1.0 - 2.0 * self.qubit_probabilities()[qubit])

    @property
    def data(self):
        raise MemoryError(
            f"Per-column states at n={self._num_qubits} are marginal "
            "summaries only; use qubit_probabilities()/expectation_z, or "
            "Simulator.run for the final state.")


def _column_program(program, col: int):
    """Sub-program containing one column's ops (same parameter vector —
    offsets index the full params)."""
    from dataclasses import replace

    ops_c = tuple(op for op in program.ops if op.column_index == col)
    return replace(program, ops=ops_c,
                   compile_key=program.compile_key + ("col", col))


def huge_step_marginals_fn(program, dtype=None) -> tuple[Callable, int]:
    """``(f, num_columns)`` where ``f(params)`` executes the circuit
    column by column (chunked, in place — the carry never leaves the
    device) and returns per-axis marginals AFTER each column, plus the
    initial state's (index 0). ONE compiled program; peak memory is the
    executor carry + chunk temps, independent of column count."""
    dtype = dtype or CONFIG.dtype
    full_plan = get_group_plan(program)
    planar = not full_plan.all_real
    # One snapshot per program column INCLUDING op-free (Measure/Barrier
    # -only) columns, matching the dense steps_fn positional semantics:
    # an op-free column re-emits the previous marginals.
    col_programs = [_column_program(program, c)
                    for c in range(program.num_columns)]
    key_t = ("huge-steps", program.compile_key, str(dtype))
    cached = _FWD_CACHE.get(key_t)
    if cached is not None:
        return cached, program.num_columns
    n_chunks = auto_chunks(program.num_qubits, planar=planar)

    def body(params):
        if planar:
            x = _planar_basis_state(full_plan.layout, program.initial_index)
        else:
            x = _real_basis_state(full_plan.layout, program.initial_index)
        outs = [state_axis_marginals(x, planar)]
        for cp in col_programs:
            if not cp.ops:
                outs.append(outs[-1])
                continue
            plan_c = get_group_plan(cp)
            operands = build_group_operands(cp, plan_c, params, dtype)
            if n_chunks > 1:
                x = execute_group_plan_chunked(plan_c, operands, cp,
                                               params, dtype, x, n_chunks,
                                               planar=planar)
            else:
                from .plan import execute_group_plan

                x = execute_group_plan(plan_c, operands, cp, params,
                                       dtype, x, planar=planar)
            outs.append(state_axis_marginals(x, planar))
        return tuple(outs)

    cached = _cache_put(_FWD_CACHE, key_t, jax.jit(body))
    return cached, program.num_columns


class PlanarStateVector:
    """Host-facing wrapper over the huge-state executor's output — the
    n >= 30 stand-in for ``StateVector``, where a complex64 copy of the
    amplitudes would by itself exceed the remaining HBM. The underlying
    tensor is either planar (2, *axis_sizes) f32, or — for all-real
    circuits — the bare real (*axis_sizes,) f32 tensor (``planar=False``;
    half the memory, the n=30 brickwork case).

    Supports the cheap queries (norm, per-index amplitude, probability
    vector on device); anything needing the full complex vector on host
    raises with guidance instead of OOMing.
    """

    def __init__(self, state: jnp.ndarray, num_qubits: int,
                 planar: bool = True, axis_marginals=None):
        self._state = state
        self._planar = planar
        self._num_qubits = num_qubits
        self._axis_marginals = axis_marginals

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def is_planar(self) -> bool:
        return self._planar

    @property
    def state_data(self) -> jnp.ndarray:
        """The raw on-device tensor: (2, *axes) planar, or (*axes,) real."""
        return self._state

    @property
    def planar_data(self) -> jnp.ndarray:
        """(2, *axes) planar view. For a real state this STACKS a zero
        imaginary plane (a whole-state device write — fine below n=30,
        +8 GiB at n=30; prefer ``state_data`` there)."""
        if self._planar:
            return self._state
        return jnp.stack([self._state, jnp.zeros_like(self._state)])

    @property
    def data(self):
        raise MemoryError(
            f"A dense complex host copy of a {self._num_qubits}-qubit state "
            f"is {(16 << self._num_qubits) / 2**30:.0f} GiB; use "
            ".amplitude(index), .probabilities_device, or the sharded "
            "engine (parallel.DistributedSimulator) instead.")

    @property
    def probabilities_device(self) -> jnp.ndarray:
        """(2^n,) f32 on device (one fused kernel; 4 GiB output at n=30).

        Note: for a PLANAR n >= 30 state this is a non-donated dispatch
        that holds the state and a half-state output at once (see the
        donation-chain comment above); where memory is tight prefer
        ``qubit_probabilities()`` (tiny, precomputed) or sampling."""
        if self._planar:
            return _planar_probabilities_jit(self._state)
        return _real_probabilities_jit(self._state)

    def norm_sq(self) -> float:
        import numpy as np

        return float(np.asarray(_planar_norm_sq_jit(self._state)))

    def qubit_probabilities(self):
        """(n,) float array of per-qubit P(|1>) — the panel-level summary
        that stays cheap at any n. Uses the axis marginals captured in
        the forward program when available (required for planar n >= 30
        states — see ``huge_forward_fn``); otherwise computes them with
        one fused-reduction dispatch. Computed once and cached on the
        instance (the state is immutable)."""
        cached = getattr(self, "_qp_cache", None)
        if cached is not None:
            return cached
        self._qp_cache = qubit_probs_from_marginals(
            self._get_marginals(), self._num_qubits)
        return self._qp_cache

    def _get_marginals(self):
        """Host copies of the per-axis marginals, computed at most once
        (one fused-reduction dispatch when not captured in the forward
        program) and cached on the immutable state."""
        import numpy as np

        marg = self._axis_marginals
        if marg is None:
            marg = _axis_marginals_jit(self._state, self._planar)
            self._axis_marginals = marg
        host = getattr(self, "_marg_host", None)
        if host is None:
            host = [np.asarray(m) for m in marg]
            self._marg_host = host
        return host

    def expectation_z(self, qubit: int) -> float:
        """<Z_qubit> = 1 - 2 P(1) — free from the captured marginals."""
        return float(1.0 - 2.0 * self.qubit_probabilities()[qubit])

    @staticmethod
    def _axis_parity_vector(layout, ax: int, qubits) -> "np.ndarray":
        """(S_ax,) f32 vector of (-1)^(parity of this axis's queried
        bits) over the axis index."""
        import numpy as np

        bits = layout.axis_bits[ax]
        sel = 0
        for q in qubits:
            sel |= 1 << (bits - 1 - layout.pos_in_axis(q))
        v = np.arange(layout.axis_sizes[ax])
        pc = np.zeros_like(v)
        vv = v & sel
        while np.any(vv):
            pc += vv & 1
            vv >>= 1
        return np.where(pc % 2 == 1, -1.0, 1.0).astype(np.float32)

    def expectation_z_string(self, qubits) -> float:
        """<prod Z_q> for ANY qubit set.

        Same-group strings are free: each captured axis marginal holds
        that axis's full joint distribution (up to 7 qubits), so the
        parity is a 128-entry host sum. Cross-group strings run ONE
        fused parity-weighted reduction over the state on device
        (|amp|^2 times the broadcast product of per-axis +-1 vectors,
        summed — a single state read, no whole-state temp).
        Reference anchor: arbitrary expectations at any supported n,
        ``/root/reference/quantum_sim/engine/analysis.py:222-248``."""
        import numpy as np

        from .plan import GroupLayout

        qubits = sorted(set(int(q) for q in qubits))
        if not qubits:
            return 1.0
        if qubits[0] < 0 or qubits[-1] >= self._num_qubits:
            raise ValueError(
                f"qubits {qubits} out of range for n={self._num_qubits}")
        layout = GroupLayout.for_qubits(self._num_qubits)
        by_axis: dict[int, list[int]] = {}
        for q in qubits:
            by_axis.setdefault(layout.axis_of(q), []).append(q)
        if len(by_axis) == 1:
            ax, qs = next(iter(by_axis.items()))
            m = self._get_marginals()[ax]
            parity = self._axis_parity_vector(layout, ax, qs)
            total = m.sum()
            return float((m * parity).sum() / total) if total > 0 else 0.0
        axes = tuple(sorted(by_axis))
        vecs = [jnp.asarray(self._axis_parity_vector(layout, ax,
                                                     by_axis[ax]))
                for ax in axes]
        fn = _zstring_fn(self._state.shape, self._planar, axes)
        num = float(np.asarray(fn(self._state, *vecs)))
        total = float(self._get_marginals()[0].sum())
        return num / total if total > 0 else 0.0

    def expectation_pauli_string(self, qubits, paulis: str) -> float:
        """<prod_i P_i on qubit_i> for any mixed X/Y/Z string — the
        general Hamiltonian-term expectation at n >= 30 (transverse-field
        terms etc.). Evaluated WITHOUT rotating or copying the state:
        the string is a signed permutation, so

            <P> = Re[ i^k * sum_j conj(x[j ^ mask]) sign(j) x[j] ]

        with k = number of Y's; the sum runs as one chunked read-only
        pass (permuted copy built per chunk). For an all-real state an
        odd-Y string is exactly 0 (psi^T A psi = 0 for antisymmetric A).
        Reference anchor: arbitrary-observable expectations,
        ``/root/reference/quantum_sim/engine/analysis.py:222-248``."""
        import numpy as np

        from .plan import GroupLayout

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
        if min(qubits) < 0 or max(qubits) >= self._num_qubits:
            raise ValueError(
                f"qubits {qubits} out of range for n={self._num_qubits}")
        if all(p == "Z" for p in paulis):
            return self.expectation_z_string(qubits)
        k = sum(1 for p in paulis if p == "Y")
        if not self._planar and k % 2 == 1:
            return 0.0
        layout = GroupLayout.for_qubits(self._num_qubits)
        perm_by_axis: dict[int, int] = {}
        sign_by_axis: dict[int, list[int]] = {}
        for q, p in zip(qubits, paulis):
            ax = layout.axis_of(q)
            bit = 1 << (layout.axis_bits[ax] - 1 - layout.pos_in_axis(q))
            if p in "XY":
                perm_by_axis[ax] = perm_by_axis.get(ax, 0) ^ bit
            if p in "ZY":
                sign_by_axis.setdefault(ax, []).append(q)
        perm_masks = tuple(sorted(
            (ax, m) for ax, m in perm_by_axis.items() if m))
        sign_axes = tuple(sorted(sign_by_axis))
        vecs = [jnp.asarray(self._axis_parity_vector(layout, ax,
                                                     sign_by_axis[ax]))
                for ax in sign_axes]
        n_chunks = auto_chunks(self._num_qubits, planar=self._planar)
        fn = _paulistring_fn(self._state.shape, self._planar, perm_masks,
                             sign_axes, n_chunks)
        s_re, s_im = (float(np.asarray(v))
                      for v in fn(self._state, *vecs))
        e = ((s_re, -s_im, -s_re, s_im)[k % 4])
        total = float(self._get_marginals()[0].sum())
        return e / total if total > 0 else 0.0

    def amplitude(self, index: int) -> complex:
        """One basis amplitude (device gather, two floats to host)."""
        import numpy as np

        data_shape = self._state.shape[1:] if self._planar \
            else self._state.shape
        coords = []
        rem = index
        for size in reversed(data_shape):
            coords.append(rem % size)
            rem //= size
        coords = tuple(reversed(coords))
        if not self._planar:
            return complex(float(np.asarray(self._state[coords])), 0.0)
        pair = np.asarray(self._state[(slice(None),) + coords])
        return complex(pair[0], pair[1])

    def __repr__(self) -> str:
        data_shape = self._state.shape[1:] if self._planar \
            else self._state.shape
        return (f"PlanarStateVector(num_qubits={self._num_qubits}, "
                f"axes={data_shape}, planar={self._planar})")
