"""Pauli-frame QEC engine: threshold sweeps as pure GF(2) bit algebra.

The statevector QEC cycle (``qec.py``) is exact but costs O(2^n) per
trial.  For the workloads the reference's threshold sweep actually runs
(``/root/reference/quantum_sim/engine/qec.py:551-622``: stabilizer
codewords + stochastic Pauli noise + parity-check syndromes + Pauli
corrections) the entire cycle is determined by binary linear algebra on
the error bits alone — the stabilizer-frame ("Pauli-frame") reduction
used by large-scale QEC samplers.  This module implements that reduction
on the device: a trial is a row of X/Z error bits, a syndrome is a
parity-check matmul, a decode is a lookup-table gather (or a cumsum for
repetition codes), and a sweep over millions of trials is one batched
device launch with no 2^n state anywhere.

Exactness contract (locked in by ``tests/test_qec_frame.py``): for the
three reference codes, ``FrameQECSimulator.threshold_sweep`` consumes
PRNG keys and per-qubit uniform draws in EXACTLY the order
``QECSimulator.threshold_sweep`` does (``qec.py:454`` — one
``uniform(key, (data_qubits,))`` per trial, identical X/Z thresholds per
noise type), so with the same seed the two engines produce identical
per-trial success flags and Z_L signs — not merely matching statistics.

Why the 0/1 reduction is exact, not approximate: the sweep's ideal
states are logical-basis (Z_L- or X_L-eigenstate) stabilizer states, so
the corrected state is ``X^rx Z^rz |ideal>`` for residual bit-vectors
``rx = ex ^ cx``, ``rz = ez ^ cz``, and ``|<ideal| X^rx Z^rz |ideal>|^2``
is exactly 1 when the residual Pauli stabilizes the ideal state (zero
syndrome and trivial logical action on the readout component) and
exactly 0 otherwise.  ``<Z_L>`` after correction is exactly
``expected_sign * (-1)^parity(residual & L)``.  The statevector engine
computes these same values through 2^n-dimensional inner products; the
frame engine reads them off the bits.

Beyond parity, the frame engine scales where the statevector cannot:
``repetition_frame_spec(distance)`` builds bit-flip/phase-flip
repetition codes of ANY odd distance (the reference caps at d=3 / 5
qubits; the statevector engine at ~n=30), ``surface_code_frame_spec``
builds rotated surface codes [[d^2,1,d]] with exact minimum-weight
coset-leader decoding (d=3, 5), and trials shard over a device mesh.
R-round memory experiments run with per-round decoding
(``build_memory_fn``) or EXACT space-time maximum likelihood via
Walsh-Hadamard-diagonalized HMM inference — ``build_ml_memory_fn`` for
repetition chains, ``build_ml_css_memory_fn`` for any CSS sector
including the surface code's (degenerate ML: the final decision
integrates the posterior over whole stabilizer-equivalence classes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from .qec import (QECCode, ThresholdPoint, _coset_leader_lut,
                  _rotated_surface_geometry)
from .qec_matching import (union_find_decode_fn,
                           union_find_host_decode_fn)

_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Frame spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrameSpec:
    """Static GF(2) structure of a code, as consumed by the sweep kernel.

    ``comp_checks`` rows are parity checks over the X-error bits (the
    computational-frame syndrome, ``qec.py:458-460``); ``h_checks`` rows
    are parity checks over the Z-error bits (the H-rotated-frame
    syndrome, ``qec.py:461-466``).  ``logical_support`` is the qubit
    support of the logical readout operator; ``logical_in_h_frame``
    selects which residual component (X bits in the computational frame,
    Z bits in the H frame) flips that readout — mirroring
    ``QECCode.logical_z_in_h_frame`` (``qec.py:129``).

    ``decode`` is a traceable batched decoder:
    ``(syn_comp[T, nc], syn_h[T, nh]) -> (x_corr[T, dq], z_corr[T, dq])``
    with int32 0/1 entries.

    ``host_decode`` (optional) is the same contract as a plain numpy
    function.  Set it when ``decode`` hides a ``jax.pure_callback`` (the
    union-find specs): XLA compiles host callbacks maximal-on-device-0,
    and under a mesh the CPU in-process communicator then deadlocks at
    the next collective rendezvous (measured: 40 s watchdog abort) —
    so the sweep surface routes mesh runs through the SPLIT kernel
    (device draws -> host decode -> numpy parity algebra,
    ``build_frame_sweep_host_fn``) whenever ``host_decode`` is set.
    """

    name: str
    data_qubits: int
    comp_checks: np.ndarray          # (nc, dq) uint8
    h_checks: np.ndarray             # (nh, dq) uint8
    logical_support: np.ndarray      # (dq,) uint8
    logical_in_h_frame: bool
    decode: Callable = field(compare=False)
    host_decode: Callable | None = field(default=None, compare=False)

    def __post_init__(self):
        dq = self.data_qubits
        for mat, label in ((self.comp_checks, "comp_checks"),
                           (self.h_checks, "h_checks")):
            if mat.ndim != 2 or mat.shape[1] != dq:
                raise ValueError(f"{label} must be (n_checks, {dq}), "
                                 f"got {mat.shape}")
        if self.logical_support.shape != (dq,):
            raise ValueError("logical_support must be shape "
                             f"({dq},), got {self.logical_support.shape}")


def _checks_matrix(checks: list[list[int]], dq: int) -> np.ndarray:
    mat = np.zeros((len(checks), dq), dtype=np.uint8)
    for i, qubits in enumerate(checks):
        for q in qubits:
            if q >= dq:
                raise ValueError(f"check {qubits} touches non-data qubit {q}")
            mat[i, q] = 1
    return mat


def frame_spec_from_code(code: QECCode) -> FrameSpec:
    """Lift a statevector ``QECCode`` into a frame spec.

    The decoder is materialized as a lookup table by enumerating every
    syndrome through the code's own host decode table
    (``QECCode.decode_syndrome``), so frame decodes agree with
    statevector decodes by construction.
    """
    dq = code.data_qubits
    comp = _checks_matrix(code.comp_frame_checks(), dq)
    h = _checks_matrix(code.h_frame_checks(), dq)
    nc, nh = comp.shape[0], h.shape[0]
    n_syn = nc + nh
    lut_x = np.zeros((2 ** n_syn, dq), dtype=np.int32)
    lut_z = np.zeros((2 ** n_syn, dq), dtype=np.int32)
    for s in range(2 ** n_syn):
        bits = [(s >> i) & 1 for i in range(n_syn)]
        for gate_name, qubit in code.decode_syndrome(bits):
            if gate_name == "X":
                lut_x[s, qubit] = 1
            elif gate_name == "Z":
                lut_z[s, qubit] = 1

    pow_c = np.asarray([1 << i for i in range(nc)], dtype=np.int32)
    pow_h = np.asarray([1 << (nc + i) for i in range(nh)], dtype=np.int32)

    def decode(syn_comp, syn_h):
        idx = jnp.zeros(syn_comp.shape[:1], jnp.int32)
        if nc:
            idx = idx + syn_comp @ jnp.asarray(pow_c)
        if nh:
            idx = idx + syn_h @ jnp.asarray(pow_h)
        return (jnp.asarray(lut_x)[idx], jnp.asarray(lut_z)[idx])

    support = np.zeros(dq, dtype=np.uint8)
    for q in code.logical_z_operators():
        support[q] = 1
    return FrameSpec(
        name=code.name,
        data_qubits=dq,
        comp_checks=comp,
        h_checks=h,
        logical_support=support,
        logical_in_h_frame=code.logical_z_in_h_frame(),
        decode=decode,
    )


def repetition_frame_spec(distance: int,
                          kind: str = "bit_flip") -> FrameSpec:
    """Distance-``d`` repetition code, frame-native.

    ``kind="bit_flip"``: |0>_L = |0...0>, adjacent ZZ checks, corrects
    X errors — the d=3 case is exactly ``BitFlipCode`` (``qec.py:191``),
    and the two specs decode identically (tested).  ``kind="phase_flip"``
    is the H-conjugated twin (``qec.py:243``).  Decoding is maximum
    likelihood: the prefix-parity candidate consistent with the syndrome
    or its complement, whichever is lighter.  Odd distance keeps the
    decision unambiguous.
    """
    if distance < 3 or distance % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    if kind not in ("bit_flip", "phase_flip"):
        raise ValueError(f"unknown repetition kind: {kind}")
    d = distance
    checks = [[i, i + 1] for i in range(d - 1)]
    mat = _checks_matrix(checks, d)

    def _ml_error(syn):
        # Candidate error with bit 0 clear: e[i] = s[0] ^ ... ^ s[i-1].
        prefix = jnp.cumsum(syn, axis=1) & 1
        e0 = jnp.concatenate(
            [jnp.zeros_like(prefix[:, :1]), prefix], axis=1)
        weight = jnp.sum(e0, axis=1, keepdims=True)
        return jnp.where(2 * weight > d, 1 - e0, e0).astype(jnp.int32)

    if kind == "bit_flip":
        def decode(syn_comp, syn_h):
            ex = _ml_error(syn_comp)
            return ex, jnp.zeros_like(ex)
        comp, h = mat, np.zeros((0, d), np.uint8)
        in_h = False
    else:
        def decode(syn_comp, syn_h):
            ez = _ml_error(syn_h)
            return jnp.zeros_like(ez), ez
        comp, h = np.zeros((0, d), np.uint8), mat
        in_h = True

    return FrameSpec(
        name=f"Repetition-{kind} [{d},1,{d}]",
        data_qubits=d,
        comp_checks=comp,
        h_checks=h,
        logical_support=np.ones(d, dtype=np.uint8),
        logical_in_h_frame=in_h,
        decode=decode,
    )


def surface_code_frame_spec(distance: int,
                            decoder: str = "auto") -> FrameSpec:
    """Rotated surface code [[d^2, 1, d]], frame-native, any odd d.

    Shares ``qec._rotated_surface_geometry`` with the statevector
    ``RotatedSurfaceCode`` (so d=3 is draw-exact against it under the
    same seed).  Two decoders:

    - ``"exact"`` (d <= 5): exact minimum-weight per CSS sector via
      coset-leader tables (``qec._coset_leader_lut``) — 2^((d^2-1)/2)
      syndromes per sector: 16 at d=3, 4096 at d=5.
    - ``"union_find"`` (any d): the Delfosse-Nickerson matching decoder
      (``qec_matching``) as a ``pure_callback`` host batch — near-ML
      accuracy (within ~25% of the exact tables at d=3/5, test-locked)
      at near-linear cost, reaching d=7/9/11+ where tables are
      impossible.

    ``"auto"`` picks exact when the tables fit (d <= 5), union-find
    above.  Z-checks (detecting X errors) are the computational-frame
    checks; X-checks (detecting Z errors) read in the H frame; the
    logical readout is Z_L = Z on row 0, flipped by residual X bits.
    """
    if decoder not in ("auto", "exact", "union_find"):
        raise ValueError(f"unknown decoder: {decoder!r}")
    if decoder == "auto":
        decoder = "exact" if distance <= 5 else "union_find"
    if decoder == "exact" and distance > 5:
        raise ValueError(
            "coset-leader tables are 2^((d^2-1)/2) rows; the exact "
            "surface decoder is capped at d=5 (use decoder='union_find')")
    z_checks, x_checks, z_logical, _ = _rotated_surface_geometry(distance)
    dq = distance * distance
    comp = _checks_matrix(z_checks, dq)
    h = _checks_matrix(x_checks, dq)
    if decoder == "union_find":
        decode = union_find_decode_fn(comp, h)
        host_decode = union_find_host_decode_fn(comp, h)
    else:
        host_decode = None
        lut_x = _coset_leader_lut(comp)
        lut_z = _coset_leader_lut(h)
        nc, nh = comp.shape[0], h.shape[0]
        pow_c = np.asarray([1 << i for i in range(nc)], dtype=np.int32)
        pow_h = np.asarray([1 << i for i in range(nh)], dtype=np.int32)

        def decode(syn_comp, syn_h):
            idx_c = syn_comp @ jnp.asarray(pow_c)
            idx_h = syn_h @ jnp.asarray(pow_h)
            return jnp.asarray(lut_x)[idx_c], jnp.asarray(lut_z)[idx_h]

    support = np.zeros(dq, dtype=np.uint8)
    support[z_logical] = 1
    return FrameSpec(
        name=f"Surface [[{dq},1,{distance}]]",
        data_qubits=dq,
        comp_checks=comp,
        h_checks=h,
        logical_support=support,
        logical_in_h_frame=False,
        decode=decode,
        host_decode=host_decode,
    )


# ---------------------------------------------------------------------------
# Sweep kernel
# ---------------------------------------------------------------------------

def _draw_error_bits(r, p, noise_type: str):
    """Uniform draws -> (x_bits, z_bits); thresholds match
    ``qec._pauli_masks_from_draws`` (``qec.py:404-417``) exactly."""
    if noise_type == "bit_flip":
        x = r < p
        z = jnp.zeros_like(x)
    elif noise_type == "phase_flip":
        x = jnp.zeros_like(r < p)
        z = r < p
    elif noise_type == "depolarizing":
        x = r < 2 * p / 3
        z = (r >= p / 3) & (r < p)
    else:
        raise ValueError(f"Unknown noise type: {noise_type}")
    return x.astype(jnp.int32), z.astype(jnp.int32)


def build_frame_sweep_fn(spec: FrameSpec, noise_type: str):
    """jitted ``(p, keys[T, key_dim]) -> (ok_before, ok_after, flip)``.

    Per-trial int32 flags: ``ok_*`` is the exact 0/1 fidelity of the
    noisy/corrected state against the logical-basis ideal; ``flip`` is
    whether the corrected state's logical readout sign is inverted.
    ``p`` is a runtime scalar — one compile serves a whole sweep, same
    as ``build_cycle_fn`` (``qec.py:473``).  All parity reductions run
    at ``Precision.HIGHEST``: a reduced-precision default matmul (TF32
    on the GPU) would corrupt parities for wide codes.
    """
    dq = spec.data_qubits
    comp = jnp.asarray(spec.comp_checks, jnp.float32)
    h = jnp.asarray(spec.h_checks, jnp.float32)
    support = jnp.asarray(spec.logical_support, jnp.float32)
    decode = spec.decode
    in_h = spec.logical_in_h_frame

    def _syndrome(bits, checks):
        if checks.shape[0] == 0:
            return jnp.zeros((bits.shape[0], 0), jnp.int32)
        odd = jnp.matmul(bits.astype(jnp.float32), checks.T,
                         precision=_HI)
        return odd.astype(jnp.int32) & 1

    def _logical_parity(bits):
        overlap = jnp.matmul(bits.astype(jnp.float32), support,
                             precision=_HI)
        return overlap.astype(jnp.int32) & 1

    def _ok(x_bits, z_bits):
        """1 iff X^x Z^z fixes the logical-basis ideal up to phase:
        zero syndrome in both frames and trivial action on the logical
        readout.  The non-readout component needs only zero syndrome —
        its logical part acts as a phase on an eigenstate ideal (this
        is why a pure-Z residual never hurts bit-flip fidelity, matching
        the statevector engine's |<psi|P|psi>|^2)."""
        syn_ok = (jnp.all(_syndrome(x_bits, comp) == 0, axis=1)
                  & jnp.all(_syndrome(z_bits, h) == 0, axis=1))
        readout = z_bits if in_h else x_bits
        return (syn_ok & (_logical_parity(readout) == 0)).astype(jnp.int32)

    def sweep(p, keys):
        r = jax.vmap(lambda k: jax.random.uniform(k, (dq,)))(keys)
        ex, ez = _draw_error_bits(r, p, noise_type)
        ok_before = _ok(ex, ez)
        syn_c = _syndrome(ex, comp)
        syn_h = _syndrome(ez, h)
        cx, cz = decode(syn_c, syn_h)
        rx = ex ^ cx
        rz = ez ^ cz
        ok_after = _ok(rx, rz)
        flip = _logical_parity(rz if in_h else rx)
        return ok_before, ok_after, flip

    return jax.jit(sweep)


def build_frame_sweep_host_fn(spec: FrameSpec, noise_type: str):
    """``(p, keys) -> (ok_before, ok_after, flip)`` numpy — the SPLIT
    twin of :func:`build_frame_sweep_fn` for specs whose decoder is a
    host callback: the error draws run in one jitted (mesh-shardable,
    callback-free) launch, decoding goes through ``spec.host_decode``,
    and the parity algebra is exact numpy int matmuls.  Sweep methods
    route mesh runs here automatically (see ``FrameSpec.host_decode``).
    """
    if spec.host_decode is None:
        raise ValueError("spec has no host_decode")
    dq = spec.data_qubits
    comp = np.asarray(spec.comp_checks, np.int64)
    h = np.asarray(spec.h_checks, np.int64)
    support = np.asarray(spec.logical_support, np.int64)
    in_h = spec.logical_in_h_frame

    @jax.jit
    def draw(p, keys):
        r = jax.vmap(lambda k: jax.random.uniform(k, (dq,)))(keys)
        return _draw_error_bits(r, p, noise_type)

    def _syn(bits, checks):
        if checks.shape[0] == 0:
            return np.zeros((bits.shape[0], 0), np.int64)
        return (bits @ checks.T) & 1

    def _logical(bits):
        return (bits @ support) & 1

    def _ok(x_bits, z_bits):
        syn_ok = ((_syn(x_bits, comp) == 0).all(axis=1)
                  & (_syn(z_bits, h) == 0).all(axis=1))
        readout = z_bits if in_h else x_bits
        return (syn_ok & (_logical(readout) == 0)).astype(np.int32)

    def sweep(p, keys):
        ex, ez = map(lambda a: np.asarray(a, np.int64),
                     draw(jnp.float32(p), keys))
        ok_before = _ok(ex, ez)
        cx, cz = spec.host_decode(_syn(ex, comp), _syn(ez, h))
        rx = ex ^ np.asarray(cx, np.int64)
        rz = ez ^ np.asarray(cz, np.int64)
        ok_after = _ok(rx, rz)
        flip = _logical(rz if in_h else rx).astype(np.int32)
        return ok_before, ok_after, flip

    return sweep


def build_memory_fn(spec: FrameSpec, noise_type: str, n_rounds: int,
                    meas_error_prob: float = 0.0):
    """jitted ``(p, keys[T, key_dim]) -> failed[T]`` — an R-round memory
    experiment: each round injects fresh data errors, extracts the
    syndrome (optionally through a noisy readout that flips each
    syndrome bit with ``meas_error_prob``), decodes, and corrects; a
    final noiseless round closes the experiment.  ``failed`` is 1 when
    the surviving residual acts as a logical operator on the ideal
    state (the decode tables always return a correction with the
    observed syndrome, so after the final clean round the residual is
    in the normalizer and failure is a pure logical flip).

    Decoding is per-round (each round sees only its own syndrome) — the
    natural extension of the reference's single-cycle semantics
    (``/root/reference/quantum_sim/engine/qec.py:497-549``) to R rounds,
    not a space-time decoder: under measurement noise it is the
    uncorrelated-decoding baseline a matching decoder would be compared
    against.  The round loop is a ``lax.scan`` carrying the residual
    error bits; per-round randomness forks from each trial key via
    ``fold_in``."""
    dq = spec.data_qubits
    comp = jnp.asarray(spec.comp_checks, jnp.float32)
    h = jnp.asarray(spec.h_checks, jnp.float32)
    support = jnp.asarray(spec.logical_support, jnp.float32)
    decode = spec.decode
    in_h = spec.logical_in_h_frame
    nc, nh = comp.shape[0], h.shape[0]
    q = float(meas_error_prob)

    def _syndrome(bits, checks):
        if checks.shape[0] == 0:
            return jnp.zeros((bits.shape[0], 0), jnp.int32)
        odd = jnp.matmul(bits.astype(jnp.float32), checks.T,
                         precision=_HI)
        return odd.astype(jnp.int32) & 1

    def _logical_parity(bits):
        overlap = jnp.matmul(bits.astype(jnp.float32), support,
                             precision=_HI)
        return overlap.astype(jnp.int32) & 1

    def _decode_and_correct(rx, rz, meas_keys):
        """meas_keys: per-trial keys (T, key_dim) for readout flips."""
        syn_c = _syndrome(rx, comp)
        syn_h = _syndrome(rz, h)
        if q > 0.0:
            def flips(k, shape_cols):
                return (jax.random.uniform(k, (shape_cols,)) < q
                        ).astype(jnp.int32)

            if nc:
                kc = jax.vmap(lambda k: jax.random.fold_in(k, 0))(meas_keys)
                syn_c = syn_c ^ jax.vmap(flips, (0, None))(kc, nc)
            if nh:
                kh = jax.vmap(lambda k: jax.random.fold_in(k, 1))(meas_keys)
                syn_h = syn_h ^ jax.vmap(flips, (0, None))(kh, nh)
        cx, cz = decode(syn_c, syn_h)
        return rx ^ cx, rz ^ cz

    def memory(p, keys):
        T = keys.shape[0]
        rx0 = jnp.zeros((T, dq), jnp.int32)
        rz0 = jnp.zeros((T, dq), jnp.int32)

        def round_body(carry, r):
            rx, rz = carry
            round_keys = jax.vmap(jax.random.fold_in, (0, None))(keys, r)
            draw_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 1))(round_keys)
            r_uniform = jax.vmap(
                lambda k: jax.random.uniform(k, (dq,)))(draw_keys)
            ex, ez = _draw_error_bits(r_uniform, p, noise_type)
            rx = rx ^ ex
            rz = rz ^ ez
            meas_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 2))(round_keys)
            rx, rz = _decode_and_correct(rx, rz, meas_keys)
            return (rx, rz), None

        (rx, rz), _ = jax.lax.scan(
            round_body, (rx0, rz0), jnp.arange(n_rounds))
        # Final noiseless round: exact syndrome, decode, correct.
        syn_c = _syndrome(rx, comp)
        syn_h = _syndrome(rz, h)
        cx, cz = decode(syn_c, syn_h)
        rx = rx ^ cx
        rz = rz ^ cz
        return _logical_parity(rz if in_h else rx)

    return jax.jit(memory)


# ---------------------------------------------------------------------------
# Exact ML space-time decoder (repetition codes)
# ---------------------------------------------------------------------------

def _wht(a, d: int):
    """Walsh-Hadamard transform over the trailing 2^d axis of (T, 2^d)."""
    T = a.shape[0]
    for q in range(d):
        a = a.reshape(T, 2 ** (d - q - 1), 2, 2 ** q)
        a0, a1 = a[:, :, 0, :], a[:, :, 1, :]
        a = jnp.stack([a0 + a1, a0 - a1], axis=2)
    return a.reshape(T, 2 ** d)


def build_ml_memory_fn(distance: int, n_rounds: int,
                       return_trace: bool = False):
    """jitted ``(p, q, keys[T, key_dim]) -> (fail_ml, fail_final)`` —
    a distance-``d`` repetition-code memory experiment decoded by EXACT
    maximum likelihood over the full space-time error history.

    Protocol (the standard memory experiment, no mid-run correction):
    ``n_rounds`` rounds of [each data bit flips w.p. ``p``, then the
    d-1 adjacent-pair syndromes are read with each bit flipped w.p.
    ``q``], followed by a perfect data readout.  The decoder sees the
    noisy syndrome records plus the exact final syndrome and must
    predict the logical observable (data bit 0 of the cumulative error);
    ``fail_ml`` is 1 when the prediction is wrong.  ``fail_final`` is
    the single-shot baseline that ignores the history and min-weight
    decodes the final syndrome alone.

    Exactness: the posterior over cumulative-error strings X_r in
    GF(2)^d is a hidden Markov chain — the data-noise transition kernel
    ``K[X^Y] = prod_q p^{z_q}(1-p)^{1-z_q}`` is a convolution over
    GF(2)^d, which the Walsh-Hadamard transform diagonalizes with
    eigenvalues ``(1-2p)^popcount(w)``; the measurement likelihood is
    diagonal in X.  One forward pass is therefore R rounds of
    [WHT -> elementwise decay -> inverse WHT -> elementwise syndrome
    likelihood] on a (trials, 2^d) tensor — exact inference, shaped as
    the same batched transforms the simulator itself runs.  The final
    exact syndrome confines X_R to two candidates (the prefix-parity
    coset representatives); the decoder compares their forward
    posteriors.  Verified against brute-force posterior enumeration
    (``tests/test_qec_frame.py``).  Requires ``p < 0.5``; memory is
    O(trials * 2^d), so ``distance <= 16``.

    The phase-flip repetition code is the H-conjugated mirror: identical
    bit algebra with (p, syndromes) read in the H frame.
    """
    if distance < 3 or distance % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    if distance > 16:
        raise ValueError("ML decoder state is 2^d; distance capped at 16")
    d = distance
    dim = 2 ** d

    # Bit q of basis index i <-> data qubit q (internal convention).
    idx = np.arange(dim, dtype=np.int64)
    idx_bits = ((idx[:, None] >> np.arange(d)) & 1).astype(np.int8)
    # Syndrome parity of each basis string: par[i, c] = bit_c ^ bit_{c+1}.
    par = (idx_bits[:, :-1] ^ idx_bits[:, 1:]).astype(np.float32)
    popcount = idx_bits.sum(axis=1).astype(np.float32)
    pow2 = (2 ** np.arange(d)).astype(np.int32)

    def _prefix_candidate(syn):
        """Final-syndrome coset representative with bit 0 clear."""
        prefix = jnp.cumsum(syn, axis=1) & 1
        return jnp.concatenate(
            [jnp.zeros_like(prefix[:, :1]), prefix], axis=1)

    def run(p, q, keys):
        T = keys.shape[0]
        w_meas = q / (1.0 - q)          # q=0 -> 0; 0**0 == 1 below
        decay = jnp.power(1.0 - 2.0 * p, jnp.asarray(popcount))
        par_j = jnp.asarray(par)        # (dim, d-1)

        def gen_round(carry, r):
            X = carry
            round_keys = jax.vmap(jax.random.fold_in, (0, None))(keys, r)
            data_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 1))(round_keys)
            meas_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 2))(round_keys)
            flips = (jax.vmap(lambda k: jax.random.uniform(k, (d,)))(
                data_keys) < p).astype(jnp.int32)
            X = X ^ flips
            syn_true = X[:, :-1] ^ X[:, 1:]
            meas = (jax.vmap(lambda k: jax.random.uniform(k, (d - 1,)))(
                meas_keys) < q).astype(jnp.int32)
            return X, syn_true ^ meas

        X0 = jnp.zeros((T, d), jnp.int32)
        X_final, syndromes = jax.lax.scan(
            gen_round, X0, jnp.arange(n_rounds))       # (R, T, d-1)

        def decode_round(alpha, s_r):
            # GF(2) convolution with the data-noise kernel (WHT pair)...
            alpha = _wht(alpha, d) * decay
            alpha = _wht(alpha, d) / dim
            # ...then the diagonal measurement likelihood w^{#mismatches},
            # with #mismatches[t,i] = sum_c s[t,c] ^ par[i,c]
            #                       = sum_c (s + par - 2 s*par).
            s_sum = jnp.sum(s_r, axis=1, dtype=jnp.float32)[:, None]
            par_sum = jnp.sum(par_j, axis=1)[None, :]
            cross = jnp.matmul(s_r.astype(jnp.float32), par_j.T,
                               precision=_HI)
            n_mis = s_sum + par_sum - 2.0 * cross
            alpha = alpha * jnp.power(w_meas, n_mis)
            alpha = alpha / (jnp.sum(alpha, axis=1, keepdims=True) + 1e-30)
            return alpha, None

        alpha0 = jnp.zeros((T, dim), jnp.float32).at[:, 0].set(1.0)
        alpha, _ = jax.lax.scan(decode_round, alpha0, syndromes)

        syn_final = X_final[:, :-1] ^ X_final[:, 1:]
        e0 = _prefix_candidate(syn_final)               # bit 0 clear
        e1 = 1 - e0
        i0 = e0 @ jnp.asarray(pow2)
        i1 = e1 @ jnp.asarray(pow2)
        a0 = jnp.take_along_axis(alpha, i0[:, None], axis=1)[:, 0]
        a1 = jnp.take_along_axis(alpha, i1[:, None], axis=1)[:, 0]
        pred_ml = jnp.where(a0 >= a1, e0[:, 0], e1[:, 0])

        w0 = jnp.sum(e0, axis=1)
        pred_final = jnp.where(2 * w0 <= d, e0[:, 0], e1[:, 0])

        actual = X_final[:, 0]
        fails = ((pred_ml != actual).astype(jnp.int32),
                 (pred_final != actual).astype(jnp.int32))
        if return_trace:
            return fails + (syndromes, X_final)
        return fails

    return jax.jit(run)


def _gf2_nullspace(mat: np.ndarray) -> np.ndarray:
    """Basis of the GF(2) null space of an (m, n) 0/1 matrix, as rows."""
    a = (mat.astype(np.int8) % 2).copy()
    m, n = a.shape
    pivots: list[int] = []
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, m):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            continue
        a[[row, piv]] = a[[piv, row]]
        for r in range(m):
            if r != row and a[r, col]:
                a[r] ^= a[row]
        pivots.append(col)
        row += 1
        if row == m:
            break
    free = [c for c in range(n) if c not in pivots]
    basis = []
    for fc in free:
        v = np.zeros(n, np.int8)
        v[fc] = 1
        for i, pc in enumerate(pivots):
            v[pc] = a[i, fc]
        basis.append(v)
    return (np.asarray(basis, np.int8) if basis
            else np.zeros((0, n), np.int8))


def build_ml_css_memory_fn(checks: np.ndarray, logical_support: np.ndarray,
                           n_rounds: int, return_trace: bool = False):
    """jitted ``(p, q, keys[T, key_dim]) -> (fail_ml, fail_minw)`` — an
    R-round memory experiment for ONE CSS error sector of ANY code,
    decoded by EXACT maximum likelihood over the space-time history.

    Generalizes ``build_ml_memory_fn`` from the repetition chain to an
    arbitrary GF(2) parity-check matrix (e.g. the surface code's
    Z-sector via ``surface_code_frame_spec``): the forward pass is the
    same WHT-diagonalized hidden-Markov recursion over (trials, 2^dq)
    posteriors, and the final decision integrates the posterior over
    the WHOLE coset consistent with the exact final syndrome, split by
    logical class — for degenerate codes (kernel dim > 1, e.g. surface)
    this sums each class over its 2^(k-1) stabilizer-equivalent
    candidates, i.e. true degenerate ML, strictly more information than
    any single-candidate (min-weight / matching) rule.  ``fail_minw``
    is the single-shot coset-leader baseline on the same trials.

    Protocol per round: each data bit flips w.p. ``p``, then every
    syndrome bit is read flipped w.p. ``q``; after ``n_rounds`` rounds a
    perfect readout yields the exact final syndrome.  For the
    repetition-code checks this reproduces ``build_ml_memory_fn``
    draw-for-draw (test-locked).  Memory: O(trials * 2^dq); ``dq <= 14``.
    """
    checks = np.asarray(checks, np.uint8)
    support_np = np.asarray(logical_support, np.uint8)
    nch, dq = checks.shape
    if dq > 14:
        raise ValueError("posterior state is 2^dq; data qubits capped at 14")
    dim = 1 << dq
    lut = _coset_leader_lut(checks)                     # (2^nch, dq)
    kernel = _gf2_nullspace(checks)                     # (kdim, dq)
    kdim = kernel.shape[0]
    pow2 = (2 ** np.arange(dq)).astype(np.int64)
    basis_idx = kernel.astype(np.int64) @ pow2
    basis_par = (kernel.astype(np.int64) @ support_np.astype(np.int64)) % 2
    ker_idx = np.zeros(1 << kdim, np.int64)
    ker_par = np.zeros(1 << kdim, np.int32)
    for sub in range(1 << kdim):
        vi, vp = 0, 0
        for b in range(kdim):
            if (sub >> b) & 1:
                vi ^= int(basis_idx[b])
                vp ^= int(basis_par[b])
        ker_idx[sub] = vi
        ker_par[sub] = vp
    rep_idx = (lut.astype(np.int64) @ pow2).astype(np.int32)
    rep_par = ((lut.astype(np.int64)
                @ support_np.astype(np.int64)) % 2).astype(np.int32)

    idx = np.arange(dim, dtype=np.int64)
    idx_bits = ((idx[:, None] >> np.arange(dq)) & 1).astype(np.int8)
    par = ((idx_bits.astype(np.int64) @ checks.T.astype(np.int64)) % 2
           ).astype(np.float32)                         # (dim, nch)
    popcount = idx_bits.sum(axis=1).astype(np.float32)
    pow_syn = (2 ** np.arange(nch)).astype(np.int32)

    def run(p, q, keys):
        T = keys.shape[0]
        w_meas = q / (1.0 - q)          # q=0 -> 0; 0**0 == 1 below
        decay = jnp.power(1.0 - 2.0 * p, jnp.asarray(popcount))
        par_j = jnp.asarray(par)
        checks_f = jnp.asarray(checks.astype(np.float32))
        support_f = jnp.asarray(support_np.astype(np.float32))

        def _syn(X):
            odd = jnp.matmul(X.astype(jnp.float32), checks_f.T,
                             precision=_HI)
            return odd.astype(jnp.int32) & 1

        def gen_round(carry, r):
            X = carry
            round_keys = jax.vmap(jax.random.fold_in, (0, None))(keys, r)
            data_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 1))(round_keys)
            meas_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 2))(round_keys)
            flips = (jax.vmap(lambda k: jax.random.uniform(k, (dq,)))(
                data_keys) < p).astype(jnp.int32)
            X = X ^ flips
            meas = (jax.vmap(lambda k: jax.random.uniform(k, (nch,)))(
                meas_keys) < q).astype(jnp.int32)
            return X, _syn(X) ^ meas

        X0 = jnp.zeros((T, dq), jnp.int32)
        X_final, syndromes = jax.lax.scan(
            gen_round, X0, jnp.arange(n_rounds))        # (R, T, nch)

        def decode_round(alpha, s_r):
            alpha = _wht(alpha, dq) * decay
            alpha = _wht(alpha, dq) / dim
            s_sum = jnp.sum(s_r, axis=1, dtype=jnp.float32)[:, None]
            par_sum = jnp.sum(par_j, axis=1)[None, :]
            cross = jnp.matmul(s_r.astype(jnp.float32), par_j.T,
                               precision=_HI)
            n_mis = s_sum + par_sum - 2.0 * cross
            alpha = alpha * jnp.power(w_meas, n_mis)
            alpha = alpha / (jnp.sum(alpha, axis=1, keepdims=True) + 1e-30)
            return alpha, None

        alpha0 = jnp.zeros((T, dim), jnp.float32).at[:, 0].set(1.0)
        alpha, _ = jax.lax.scan(decode_round, alpha0, syndromes)

        s_int = _syn(X_final) @ jnp.asarray(pow_syn)    # (T,)
        r_idx = jnp.asarray(rep_idx)[s_int]
        r_par = jnp.asarray(rep_par)[s_int]
        cand = r_idx[:, None] ^ jnp.asarray(
            ker_idx.astype(np.int32))[None, :]          # (T, 2^kdim)
        cand_par = (r_par[:, None] ^ jnp.asarray(ker_par)[None, :]
                    ).astype(jnp.float32)
        mass = jnp.take_along_axis(alpha, cand, axis=1)
        m1 = jnp.sum(mass * cand_par, axis=1)
        m0 = jnp.sum(mass * (1.0 - cand_par), axis=1)
        pred_ml = (m1 > m0).astype(jnp.int32)

        def _log_par(X):
            overlap = jnp.matmul(X.astype(jnp.float32), support_f,
                                 precision=_HI)
            return overlap.astype(jnp.int32) & 1

        actual = _log_par(X_final)
        resid = X_final ^ jnp.asarray(lut)[s_int]
        fail_minw = (_log_par(resid) != 0).astype(jnp.int32)
        fails = ((pred_ml != actual).astype(jnp.int32), fail_minw)
        if return_trace:
            return fails + (syndromes, X_final)
        return fails

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Space-time matching memory (union-find — any matchable sector, any d)
# ---------------------------------------------------------------------------

def build_matching_memory_fn(checks: np.ndarray, logical_support: np.ndarray,
                             n_rounds: int):
    """``(p, q, keys[T, key_dim]) -> (fail_st, fail_single)`` — an
    R-round memory experiment for one CSS sector decoded by union-find
    matching over the SPACE-TIME detection-event graph
    (``qec_matching.space_time_graph``).

    Same protocol and per-trial key schedule as
    ``build_ml_css_memory_fn`` — under the same ``(p, q, keys)`` the
    generated syndromes and cumulative errors are draw-identical
    (test-locked), so the matching decoder is directly comparable to
    exact ML where ML is feasible.  Unlike ML's ``(trials, 2^dq)``
    posterior, matching needs no 2^dq state: d=7+ surface-code memory
    under measurement noise runs here and nowhere else in the framework.

    ``fail_st`` decodes all ``(R+1) * n_checks`` detection events jointly
    (measurement errors become vertical edges); ``fail_single`` is the
    union-find single-shot baseline that decodes only the exact final
    syndrome, on the same trials.  Syndrome generation runs jitted on
    device; decoding is the host C hot loop (``native/qsim_native.c``),
    so the function is NOT traceable — call it from host code.
    Reference anchor: the reference decodes each cycle independently
    from Python dicts (``/root/reference/quantum_sim/engine/qec.py:
    497-549``); space-time decoding is the capability its 3-qubit codes
    never needed.
    """
    from .qec_matching import (MatchingGraph, decode_batch,
                               space_time_decode_fn)

    checks_np = np.asarray(checks, np.uint8)
    support_np = np.asarray(logical_support, np.uint8)
    nch, dq = checks_np.shape
    R = n_rounds
    st_decode = space_time_decode_fn(checks_np, R)
    base_graph = MatchingGraph.from_checks(checks_np)
    checks_f = jnp.asarray(checks_np.astype(np.float32))

    def gen(p, q, keys):
        T = keys.shape[0]

        def _syn(X):
            odd = jnp.matmul(X.astype(jnp.float32), checks_f.T,
                             precision=_HI)
            return odd.astype(jnp.int32) & 1

        def gen_round(carry, r):
            X = carry
            round_keys = jax.vmap(jax.random.fold_in, (0, None))(keys, r)
            data_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 1))(round_keys)
            meas_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, 2))(round_keys)
            flips = (jax.vmap(lambda k: jax.random.uniform(k, (dq,)))(
                data_keys) < p).astype(jnp.int32)
            X = X ^ flips
            meas = (jax.vmap(lambda k: jax.random.uniform(k, (nch,)))(
                meas_keys) < q).astype(jnp.int32)
            return X, _syn(X) ^ meas

        X0 = jnp.zeros((T, dq), jnp.int32)
        X_final, syndromes = jax.lax.scan(
            gen_round, X0, jnp.arange(n_rounds))        # (R, T, nch)
        return X_final, syndromes

    gen_j = jax.jit(gen)

    def run(p, q, keys):
        X_final, syndromes = gen_j(jnp.float32(p), jnp.float32(q), keys)
        X_final = np.asarray(X_final, np.uint8)
        syn = np.moveaxis(np.asarray(syndromes, np.uint8), 0, 1)
        T = X_final.shape[0]
        final = (X_final @ checks_np.T) % 2              # exact readout
        det = np.empty((T, R + 1, nch), np.uint8)
        det[:, 0] = syn[:, 0]
        if R > 1:
            det[:, 1:R] = syn[:, 1:] ^ syn[:, :-1]
        det[:, R] = final ^ syn[:, R - 1]
        corr = st_decode(det.reshape(T, (R + 1) * nch)).astype(np.uint8)
        resid = X_final ^ corr
        if ((resid @ checks_np.T) % 2).any():            # invariant
            raise RuntimeError("space-time correction left a nonzero "
                               "final syndrome")
        fail_st = ((resid @ support_np) % 2).astype(np.int32)
        resid1 = X_final ^ decode_batch(base_graph, final).astype(np.uint8)
        fail_single = ((resid1 @ support_np) % 2).astype(np.int32)
        return fail_st, fail_single

    return run


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

_ml_fn_cache: dict[tuple, Callable] = {}


class FrameQECSimulator:
    """``QECSimulator``'s sweep surface on the Pauli-frame kernel.

    ``threshold_sweep`` mirrors ``QECSimulator.threshold_sweep``
    (``qec.py:585-619``) in API, RNG sequence, and every
    ``ThresholdPoint`` field; for the three reference codes the per-trial
    outcomes are bit-identical to the statevector engine under the same
    seed.  Unlike the statevector engine it runs arbitrary-distance
    repetition codes and millions of trials per launch.
    """

    def __init__(self, spec: FrameSpec):
        self._spec = spec
        self._sweep_fns: dict[str, Callable] = {}
        self._memory_fns: dict[tuple, Callable] = {}

    @classmethod
    def from_code(cls, code: QECCode) -> "FrameQECSimulator":
        return cls(frame_spec_from_code(code))

    @property
    def spec(self) -> FrameSpec:
        return self._spec

    def _sweep_fn(self, noise_type: str, mesh=None):
        """Mesh runs of a host-callback decoder take the SPLIT kernel
        (see ``FrameSpec.host_decode``) — a pure_callback inside a
        sharded program deadlocks the CPU in-process communicator."""
        split = mesh is not None and self._spec.host_decode is not None
        key = (noise_type, split)
        fn = self._sweep_fns.get(key)
        if fn is None:
            fn = (build_frame_sweep_host_fn(self._spec, noise_type)
                  if split else
                  build_frame_sweep_fn(self._spec, noise_type))
            self._sweep_fns[key] = fn
        return fn

    def sweep_raw(self, noise_prob: float, n_trials: int,
                  noise_type: str = "bit_flip",
                  keys: jnp.ndarray | None = None,
                  seed: int | None = None,
                  mesh: jax.sharding.Mesh | None = None):
        """One batched launch -> per-trial (ok_before, ok_after, flip).

        ``keys`` (T, key_dim) overrides seeding for draw-exact
        comparisons.  With ``mesh``, trials shard over the mesh's first
        axis (embarrassingly parallel — no collectives in the program).
        """
        if keys is None:
            rng = np.random.default_rng(seed)
            seeds = rng.integers(0, 2 ** 63, size=n_trials)
            keys = jnp.stack(
                [jax.random.PRNGKey(int(s)) for s in seeds])
        if mesh is not None:
            axis = mesh.axis_names[0]
            sharding = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(axis))
            keys = jax.device_put(keys, sharding)
        fn = self._sweep_fn(noise_type, mesh)
        return fn(jnp.float32(noise_prob), keys)

    def threshold_sweep(self, noise_probs: list[float], n_trials: int = 100,
                        noise_type: str = "bit_flip",
                        seed: int | None = None,
                        mesh: jax.sharding.Mesh | None = None
                        ) -> list[ThresholdPoint]:
        """Physical vs logical error rate, |0>_L / |1>_L alternating.

        RNG sequence matches the statevector sweep: one
        ``default_rng(seed)`` stream, ``n_trials`` 63-bit seeds drawn per
        ``p`` in order, one PRNG key per trial."""
        rng = np.random.default_rng(seed)
        fn = self._sweep_fn(noise_type, mesh)
        logicals = np.arange(n_trials) % 2
        expected_signs = np.where(logicals == 0, 1.0, -1.0)

        results = []
        for p in noise_probs:
            seeds = rng.integers(0, 2 ** 63, size=n_trials)
            keys = jnp.stack(
                [jax.random.PRNGKey(int(s)) for s in seeds])
            if mesh is not None:
                axis = mesh.axis_names[0]
                keys = jax.device_put(
                    keys, jax.sharding.NamedSharding(
                        mesh, jax.sharding.PartitionSpec(axis)))
            _, ok_after, flip = fn(jnp.float32(p), keys)
            ok_after = np.asarray(ok_after, dtype=np.float64)
            flip = np.asarray(flip, dtype=np.float64)

            z_exp = expected_signs * (1.0 - 2.0 * flip)
            successes = int(ok_after.sum())
            z_sign_correct = int(((z_exp * expected_signs) >= 0).sum())
            results.append(ThresholdPoint(
                physical_rate=float(p),
                logical_rate=1.0 - successes / n_trials,
                success_rate=successes / n_trials,
                avg_fidelity=float(ok_after.mean()),
                logical_z_fidelity=float(np.abs(z_exp).mean()),
                decoder_success_rate=z_sign_correct / n_trials,
                projection_logical_rate=float(1.0 - ok_after.mean()),
            ))
        return results

    def projection_logical_error(self, logical_state: int, noise_type: str,
                                 noise_prob: float, n_trials: int = 100,
                                 seed: int | None = None) -> dict:
        """Mirror of ``QECSimulator.projection_logical_error``
        (``qec.py:621-641``) — same RNG sequence, same report keys."""
        rng = np.random.default_rng(seed)
        seeds = rng.integers(0, 2 ** 63, size=n_trials)
        keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
        fn = self._sweep_fn(noise_type)
        _, ok_after, flip = fn(jnp.float32(noise_prob), keys)
        ok_after = np.asarray(ok_after, dtype=np.float64)
        flip = np.asarray(flip, dtype=np.float64)
        expected_sign = 1.0 if logical_state == 0 else -1.0
        z_exp = expected_sign * (1.0 - 2.0 * flip)
        mean_fid = float(ok_after.mean())
        return {
            "mean_fidelity": mean_fid,
            "logical_error_rate": 1.0 - mean_fid,
            "z_sign_error_rate": float(((z_exp * expected_sign) < 0).mean()),
            "n_trials": n_trials,
        }

    def memory_experiment(self, noise_prob: float, n_rounds: int,
                          n_trials: int = 1000,
                          noise_type: str = "bit_flip",
                          meas_error_prob: float = 0.0,
                          seed: int = 0,
                          mesh: jax.sharding.Mesh | None = None) -> dict:
        """R-round memory experiment (see ``build_memory_fn``).

        Returns the end-to-end logical failure probability and the
        per-round rate ``1 - (1 - P)**(1/R)`` (the standard conversion
        for fitting logical-error-per-round / Lambda scaling)."""
        if mesh is not None and self._spec.host_decode is not None:
            raise ValueError(
                "per-round memory with a host-callback decoder cannot "
                "shard over a mesh (pure_callback deadlocks the CPU "
                "in-process communicator); run without mesh, or use "
                "matching_memory_experiment (host space-time decoding)")
        key = (n_rounds, noise_type, float(meas_error_prob))
        fn = self._memory_fns.get(key)
        if fn is None:
            fn = build_memory_fn(self._spec, noise_type, n_rounds,
                                 meas_error_prob)
            self._memory_fns[key] = fn
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        if mesh is not None:
            axis = mesh.axis_names[0]
            keys = jax.device_put(
                keys, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(axis)))
        failed = np.asarray(fn(jnp.float32(noise_prob), keys),
                            dtype=np.float64)
        p_fail = float(failed.mean())
        per_round = 1.0 - (1.0 - min(p_fail, 1.0 - 1e-12)) ** (1.0 / n_rounds)
        return {
            "logical_failure_probability": p_fail,
            "per_round_logical_rate": per_round,
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def ml_memory_experiment(distance: int, noise_prob: float,
                             n_rounds: int, n_trials: int = 1000,
                             meas_error_prob: float = 0.0,
                             seed: int = 0,
                             mesh: jax.sharding.Mesh | None = None) -> dict:
        """Repetition-code memory decoded by the exact space-time ML
        decoder (``build_ml_memory_fn``), with the single-shot
        final-syndrome baseline measured on the SAME trials. ``p`` and
        ``q`` are runtime scalars — one compile serves a sweep."""
        fn = _ml_fn_cache.get((distance, n_rounds))
        if fn is None:
            fn = build_ml_memory_fn(distance, n_rounds)
            _ml_fn_cache[(distance, n_rounds)] = fn
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        if mesh is not None:
            axis = mesh.axis_names[0]
            keys = jax.device_put(
                keys, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(axis)))
        fail_ml, fail_final = fn(jnp.float32(noise_prob),
                                 jnp.float32(meas_error_prob), keys)
        p_ml = float(np.asarray(fail_ml, dtype=np.float64).mean())
        p_fin = float(np.asarray(fail_final, dtype=np.float64).mean())
        return {
            "ml_failure_probability": p_ml,
            "final_syndrome_failure_probability": p_fin,
            "per_round_ml_rate":
                1.0 - (1.0 - min(p_ml, 1.0 - 1e-12)) ** (1.0 / n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def ml_surface_memory_experiment(noise_prob: float, n_rounds: int,
                                     n_trials: int = 1000,
                                     meas_error_prob: float = 0.0,
                                     distance: int = 3,
                                     seed: int = 0,
                                     mesh: jax.sharding.Mesh | None = None
                                     ) -> dict:
        """d=3 rotated-surface-code memory (X-error sector) decoded by
        the exact DEGENERATE-ML space-time decoder
        (``build_ml_css_memory_fn``), with the single-shot coset-leader
        baseline measured on the same trials.  d=3 only: the posterior
        is (trials, 2^(d^2))."""
        if distance != 3:
            raise ValueError("ML surface memory is capped at d=3 "
                             "(posterior state is 2^(d^2))")
        key = ("surface", distance, n_rounds)
        fn = _ml_fn_cache.get(key)
        if fn is None:
            z_checks, _, z_logical, _ = _rotated_surface_geometry(distance)
            dq = distance * distance
            support = np.zeros(dq, dtype=np.uint8)
            support[z_logical] = 1
            fn = build_ml_css_memory_fn(
                _checks_matrix(z_checks, dq), support, n_rounds)
            _ml_fn_cache[key] = fn
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        if mesh is not None:
            axis = mesh.axis_names[0]
            keys = jax.device_put(
                keys, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(axis)))
        fail_ml, fail_minw = fn(jnp.float32(noise_prob),
                                jnp.float32(meas_error_prob), keys)
        p_ml = float(np.asarray(fail_ml, dtype=np.float64).mean())
        p_mw = float(np.asarray(fail_minw, dtype=np.float64).mean())
        return {
            "ml_failure_probability": p_ml,
            "final_syndrome_failure_probability": p_mw,
            "per_round_ml_rate":
                1.0 - (1.0 - min(p_ml, 1.0 - 1e-12)) ** (1.0 / n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def matching_memory_experiment(noise_prob: float, n_rounds: int,
                                   n_trials: int = 1000,
                                   meas_error_prob: float = 0.0,
                                   distance: int = 3,
                                   code: str = "surface",
                                   seed: int = 0) -> dict:
        """Memory experiment decoded by space-time union-find matching
        (``build_matching_memory_fn``) — any odd distance, no 2^dq
        posterior: the only decoder in the framework that serves d >= 7
        surface-code memory under measurement noise.  ``code`` picks the
        X-error sector: ``"surface"`` (rotated, Z-checks) or
        ``"repetition"`` (bit-flip chain; the logical observable is data
        bit 0, matching ``ml_memory_experiment``).  Reports the
        single-shot exact-final-syndrome union-find baseline on the same
        trials."""
        key = ("uf", code, distance, n_rounds)
        fn = _ml_fn_cache.get(key)
        if fn is None:
            if code == "surface":
                z_checks, _, z_logical, _ = _rotated_surface_geometry(
                    distance)
                dq = distance * distance
                checks = _checks_matrix(z_checks, dq)
                support = np.zeros(dq, dtype=np.uint8)
                support[z_logical] = 1
            elif code == "repetition":
                dq = distance
                checks = np.zeros((dq - 1, dq), dtype=np.uint8)
                for c in range(dq - 1):
                    checks[c, c] = checks[c, c + 1] = 1
                support = np.zeros(dq, dtype=np.uint8)
                support[0] = 1
            else:
                raise ValueError(f"unknown code: {code!r}")
            fn = build_matching_memory_fn(checks, support, n_rounds)
            _ml_fn_cache[key] = fn
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        fail_st, fail_single = fn(noise_prob, meas_error_prob, keys)
        p_st = float(np.asarray(fail_st, dtype=np.float64).mean())
        p_1 = float(np.asarray(fail_single, dtype=np.float64).mean())
        return {
            "matching_failure_probability": p_st,
            "final_syndrome_failure_probability": p_1,
            "per_round_matching_rate":
                1.0 - (1.0 - min(p_st, 1.0 - 1e-12)) ** (1.0 / n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "code": code,
            "meas_error_prob": float(meas_error_prob),
        }

    def throughput_sweep(self, noise_prob: float, n_trials: int,
                         noise_type: str = "bit_flip",
                         seed: int = 0,
                         mesh: jax.sharding.Mesh | None = None):
        """Max-rate variant for benchmarking: ONE key fans out to all
        trials via ``jax.random.split`` on device (host-side per-trial
        PRNGKey construction dominates at millions of trials).  Returns
        (logical_error_rate, success_count)."""
        fn = self._sweep_fn(noise_type, mesh)
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        if mesh is not None:
            axis = mesh.axis_names[0]
            keys = jax.device_put(
                keys, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(axis)))
        _, ok_after, _ = fn(jnp.float32(noise_prob), keys)
        successes = int(np.asarray(jnp.sum(ok_after)))
        return 1.0 - successes / n_trials, successes
