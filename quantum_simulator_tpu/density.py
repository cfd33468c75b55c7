"""Exact density-matrix simulation: deterministic noisy evolution.

The reference approximates noisy density matrices by Monte-Carlo
averaging over stochastic trajectories
(``/root/reference/quantum_sim/engine/simulator.py:155-199``); its
resource monitor's comparison table discusses exact DM simulators but it
does not contain one. This module adds the exact path: rho evolves as

    rho -> U rho U^dag                 per gate
    rho -> sum_m K_m rho K_m^dag       per noise channel per target

compiled into ONE XLA program per circuit structure (parameters stay
runtime inputs). Memory is O(4^n) so the practical single-chip cap is
n<=14 (a 16384^2 complex64 rho = 2 GiB — the same ceiling the reference
quotes for exact DM simulators at 8 GiB hosts, ``README.md:211-218``).

Left/right operator application reuses the statevector kernel: U acts on
rho's row index as a vmap over columns, and conj(U) on the column index
as a vmap over rows — every contraction is the same segmented-einsum
matmul path as the pure-state engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .circuit import QuantumCircuit
from .config import CONFIG
from .ops import program as prog
from .ops.apply import apply_gate
from .utils.xfer import to_host_complex

#: Exact DM state is O(4^n); the dense rho path caps here.
MAX_DM_QUBITS = 14
#: The vectorized-superoperator path treats vec(rho) as a 2n-qubit state
#: and rides the whole statevector engine (group plan, chunked huge
#: executor): n=15 is a 2^30 state — the single-chip ceiling.
MAX_SUPEROP_QUBITS = 15


def _apply_left(rho, u, targets, n):
    """rho -> U rho (contract the ROW index)."""
    return jax.vmap(lambda col: apply_gate(col, u, targets, n),
                    in_axes=1, out_axes=1)(rho)


def _apply_right_dag(rho, u, targets, n):
    """rho -> rho U^dag (contract the COLUMN index with conj(U))."""
    return jax.vmap(lambda row: apply_gate(row, jnp.conj(u), targets, n),
                    in_axes=0, out_axes=0)(rho)


def _apply_unitary(rho, u, targets, n):
    return _apply_right_dag(_apply_left(rho, u, targets, n), u, targets, n)


def _apply_channel(rho, kraus, targets, n):
    """rho -> sum_m K_m rho K_m^dag on ``targets`` (kraus: (M, 2^k, 2^k)
    for a k-qubit channel — one-qubit (M,2,2) or correlated two-qubit
    (M,4,4) stacks both route here)."""
    def one(k):
        return _apply_unitary(rho, k, tuple(targets), n)

    return jnp.sum(jax.vmap(one)(kraus), axis=0)


def _dm_body(program: prog.CircuitProgram, channels_for, params, dtype):
    n = program.num_qubits
    dim = 1 << n
    idx = program.initial_index
    one_hot = jnp.zeros(dim, dtype=dtype).at[idx].set(1.0)
    rho = jnp.einsum("i,j->ij", one_hot, jnp.conj(one_hot),
                     precision=jax.lax.Precision.HIGHEST)
    for op in program.ops:
        if op.cphase_value is not None:
            # Matrix-less controlled phase (MCZ_k, k > 10): D rho D^dag
            # for a product-form diagonal D is one elementwise pass:
            # rho[i, j] *= d_i * conj(d_j) with d = 1 + (v-1) * mask.
            mask = 0
            for q in op.targets:
                mask |= 1 << (n - 1 - q)  # qubit 0 = MSB
            hit = (jnp.arange(dim, dtype=jnp.uint32)
                   & jnp.uint32(mask)) == jnp.uint32(mask)
            d = jnp.where(hit, jnp.asarray(op.cphase_value, dtype),
                          jnp.ones((), dtype))
            rho = rho * d[:, None] * jnp.conj(d)[None, :]
        else:
            u = program.op_matrix(op, params, dtype)
            rho = _apply_unitary(rho, u, op.targets, n)
        for kraus_np in channels_for(op.gate_name):
            kraus = jnp.asarray(kraus_np, dtype=dtype)
            if kraus.shape[-1] == 4:
                # correlated two-qubit stack: fires once on the pair
                if len(op.targets) != 2:
                    raise ValueError(
                        "two-qubit Kraus channel configured for "
                        f"{len(op.targets)}-qubit gate {op.gate_name!r}")
                rho = _apply_channel(rho, kraus, op.targets, n)
            else:
                for q in op.targets:
                    rho = _apply_channel(rho, kraus, (q,), n)
    return rho


# ---------------------------------------------------------------------------
# Vectorized-superoperator route: vec(rho) as a 2n-qubit statevector
# ---------------------------------------------------------------------------
#
# vec(rho)[i * 2^n + j] = rho[i, j]: the row bits are qubits 0..n-1 of a
# 2n-qubit register (most significant — matching the engine's qubit-0=MSB
# convention) and the column bits are qubits n..2n-1. Then
#
#   rho -> U rho U^dag        ==  U on the row targets  AND
#                                 conj(U) on the mirrored column targets
#   rho -> sum_m K_m rho K_m^dag  ==  ONE static 4x4 superoperator
#                                 S = sum_m kron(K_m, conj(K_m)) acting on
#                                 the (q, q+n) qubit pair
#
# so exact noisy evolution compiles through the SAME group-matmul plan,
# composition windows, realness analysis, and (at 2n >= 30) the chunked
# in-place huge executor as pure states. Real circuits with real Kraus
# superoperators evolve a REAL vec(rho): n=15 exact DM = a 4 GiB f32
# tensor on one chip.


def superop_program(program: prog.CircuitProgram,
                    noise_model=None) -> prog.CircuitProgram:
    """Lower an n-qubit circuit program (+ optional noise model) to the
    equivalent 2n-qubit vec(rho) program."""
    from dataclasses import replace

    n = program.num_qubits
    ops2: list[prog.ProgramOp] = []
    super_cache: dict = {}
    # One conjugated builder PER DISTINCT original builder: every column
    # twin of e.g. Rz shares it, so _GateMatrixPool (which groups
    # parameterized ops by (gate_name, jnp_builder)) still batches all
    # column-side constructions into one vmapped call.
    conj_builders: dict = {}

    def _conj_builder_for(builder):
        cb = conj_builders.get(builder)
        if cb is None:
            def cb(*p, _b=builder):
                return jnp.conj(_b(*p))
            conj_builders[builder] = cb
        return cb

    for op in program.ops:
        col_targets = tuple(q + n for q in op.targets)
        if op.cphase_value is not None:
            ops2.append(op)
            ops2.append(replace(op, targets=col_targets,
                                cphase_value=np.conj(op.cphase_value)))
        elif op.static_matrix is not None:
            ops2.append(op)
            ops2.append(replace(op,
                                static_matrix=np.conj(op.static_matrix),
                                targets=col_targets))
        else:
            ops2.append(op)
            ops2.append(replace(op, targets=col_targets,
                                jnp_builder=_conj_builder_for(
                                    op.jnp_builder)))
        if noise_model is not None:
            for ci, st in enumerate(
                    noise_model.kraus_stacks_for_gate(op.gate_name)):
                ck = (op.gate_name, ci)
                S = super_cache.get(ck)
                if S is None:
                    S = sum(np.kron(K, np.conj(K))
                            for K in np.asarray(st, np.complex128))
                    super_cache[ck] = S
                if S.shape[0] == 16:
                    # correlated two-qubit channel: one 16x16 superop on
                    # (q1, q2, q1+n, q2+n) — kron order matches the
                    # row-major target significance convention
                    if len(op.targets) != 2:
                        raise ValueError(
                            "two-qubit Kraus channel configured for "
                            f"{len(op.targets)}-qubit gate "
                            f"{op.gate_name!r}")
                    q1, q2 = op.targets
                    ops2.append(prog.ProgramOp(
                        "__superop__", (q1, q2, q1 + n, q2 + n), 0, 0,
                        op.column_index, S, None, -1))
                else:
                    for q in op.targets:
                        ops2.append(prog.ProgramOp(
                            "__superop__", (q, q + n), 0, 0,
                            op.column_index, S, None, -1))
    noise_key = noise_model.spec_key() if noise_model is not None else ()
    return prog.CircuitProgram(
        num_qubits=2 * n,
        initial_index=(program.initial_index << n) | program.initial_index,
        ops=tuple(ops2),
        num_columns=program.num_columns,
        num_params=program.num_params,
        initial_params=program.initial_params,
        compile_key=("superop", program.compile_key, noise_key))


class SuperopDensityResult:
    """Result view for the 2n >= 30 vec(rho) huge path: diagonal-derived
    quantities (probabilities, trace, <Z>, sampling) plus purity — the
    full 2^n x 2^n rho would be a multi-GiB host copy and raises."""

    def __init__(self, num_qubits: int, state, planar: bool):
        self.num_qubits = num_qubits
        self._state = state
        self._planar = planar
        self._diag = None

    def _diagonal(self) -> np.ndarray:
        """(2^n,) complex host diagonal via ONE device gather."""
        if self._diag is not None:
            return self._diag
        from .ops.plan import GroupLayout

        n = self.num_qubits
        layout = GroupLayout.for_qubits(2 * n)
        d = np.arange(1 << n, dtype=np.int64)
        g = (d << n) | d
        coords = []
        rem = g.copy()
        for size in reversed(layout.axis_sizes):
            coords.append(jnp.asarray((rem % size).astype(np.int32)))
            rem //= size
        coords = tuple(reversed(coords))
        planar = self._planar

        def body(x, *cs):
            return x[(slice(None),) + cs] if planar else x[cs]

        out = np.asarray(jax.jit(body)(self._state, *coords))
        self._diag = (out[0] + 1j * out[1]) if planar \
            else out.astype(np.complex128)
        return self._diag

    @property
    def rho(self):
        raise MemoryError(
            f"the dense rho at n={self.num_qubits} is "
            f"{(1 << (2 * self.num_qubits)) * 8 / 2**30:.0f} GiB; use "
            ".probabilities/.purity()/.expectation_z()/sampling")

    @property
    def probabilities(self) -> np.ndarray:
        return np.maximum(np.real(self._diagonal()), 0.0)

    def purity(self) -> float:
        """tr(rho^2) = ||vec(rho)||^2 — free on the vectorized state."""
        from .ops.bigstate import _planar_norm_sq_jit

        return float(np.asarray(_planar_norm_sq_jit(self._state)))

    def trace(self) -> float:
        return float(np.real(self._diagonal()).sum())

    def expectation_z(self, qubit: int) -> float:
        probs = self.probabilities
        idx = np.arange(1 << self.num_qubits)
        sign = 1.0 - 2.0 * ((idx >> (self.num_qubits - 1 - qubit)) & 1)
        return float(np.sum(probs * sign) / max(probs.sum(), 1e-30))


@dataclass
class DensityMatrixResult:
    """Host-facing view over the device-resident density matrix."""

    num_qubits: int
    device_rho: jax.Array

    @property
    def rho(self) -> np.ndarray:
        return to_host_complex(self.device_rho)

    @property
    def probabilities(self) -> np.ndarray:
        return np.asarray(jnp.real(jnp.diagonal(self.device_rho)),
                          dtype=np.float64)

    def purity(self) -> float:
        r = self.device_rho
        return float(jnp.real(jnp.sum(r * jnp.conj(r).T)))

    def trace(self) -> float:
        return float(jnp.real(jnp.trace(self.device_rho)))

    def expectation_z(self, qubit: int) -> float:
        probs = self.probabilities
        idx = np.arange(1 << self.num_qubits)
        sign = 1.0 - 2.0 * ((idx >> (self.num_qubits - 1 - qubit)) & 1)
        return float(np.sum(probs * sign))


class DensityMatrixSimulator:
    """Exact (non-stochastic) noisy simulation: dense rho to n <= 14,
    vectorized-superoperator vec(rho) to n <= 15 single-chip (the
    superoperator program also runs on the sharded mesh engine for
    n = 16 — see tests/test_density.py)."""

    def __init__(self, noise_model=None):
        self.noise_model = noise_model

    def run(self, circuit: QuantumCircuit, dtype=None,
            method: str = "auto"):
        """``method``: 'auto' (dense to n<=14, superop at n=15),
        'dense', or 'superop'. Returns DensityMatrixResult, or
        SuperopDensityResult when vec(rho) takes the 2n >= 30 chunked
        huge path."""
        n = circuit.num_qubits
        if method == "auto":
            method = "dense" if n <= MAX_DM_QUBITS else "superop"
        if method == "superop":
            if n > MAX_SUPEROP_QUBITS:
                raise ValueError(
                    f"vec(rho) at n={n} is a {2 * n}-qubit state — past "
                    f"the single-chip ceiling (cap {MAX_SUPEROP_QUBITS}); "
                    "run the superop program on the sharded engine or use "
                    "Simulator.ensemble_qubit_density_matrices")
            return self._run_superop(circuit, dtype)
        if n > MAX_DM_QUBITS:
            raise ValueError(
                f"exact dense-rho simulation is O(4^n); n={n} exceeds "
                f"the cap of {MAX_DM_QUBITS} — method='superop' reaches "
                f"{MAX_SUPEROP_QUBITS}, Monte-Carlo "
                "(Simulator.ensemble_density_matrix) beyond")
        dtype = dtype or CONFIG.dtype
        program = prog.compile_circuit(circuit)
        if self.noise_model is not None:
            channels_for = self.noise_model.kraus_stacks_for_gate
            noise_key = self.noise_model.spec_key()
        else:
            channels_for = lambda name: []  # noqa: E731
            noise_key = ()
        key = ("dm", program.compile_key, noise_key, str(dtype))
        fn = prog._cache_get(key, lambda: jax.jit(
            lambda p: _dm_body(program, channels_for, p, dtype)))
        rho = fn(jnp.asarray(program.initial_params))
        return DensityMatrixResult(num_qubits=circuit.num_qubits,
                                   device_rho=rho)

    def _run_superop(self, circuit: QuantumCircuit, dtype=None):
        """vec(rho) through the statevector engine. Below the huge-state
        cliff this returns the full DensityMatrixResult (rho reshaped
        from the 2n-qubit vector); at 2n >= 30 it runs the chunked
        in-place executor and returns a SuperopDensityResult."""
        from .ops.bigstate import is_huge_state

        dtype = dtype or CONFIG.dtype
        n = circuit.num_qubits
        program = prog.compile_circuit(circuit)
        program2 = superop_program(program, self.noise_model)
        params = jnp.asarray(program2.initial_params)
        # Route like Simulator.run on the 2n-qubit vector's size: the
        # dense route below materializes the complex 2^2n vector plus an
        # eager reshape, while the huge route never goes complex.
        if is_huge_state(2 * n):
            from .ops.bigstate import huge_forward_fn

            fn, planar = huge_forward_fn(program2, dtype)
            x, _marg = fn(params)
            return SuperopDensityResult(n, x, planar)
        vec = prog.forward_fn(program2, dtype)(params)
        return DensityMatrixResult(
            num_qubits=n, device_rho=vec.reshape(1 << n, 1 << n))

    def sample(self, result: DensityMatrixResult, shots: int,
               rng: np.random.Generator | None = None,
               readout_error=None) -> dict[str, int]:
        """Measurement counts from the exact diagonal (optionally pushed
        through a readout confusion transform)."""
        from .measurement import counts_from_array

        rng = rng or np.random.default_rng()
        probs = result.probabilities
        probs = np.maximum(probs, 0.0)
        probs = probs / probs.sum()
        ro = readout_error
        if ro is None and self.noise_model is not None:
            ro = self.noise_model.readout_error
        if ro is not None:
            probs = np.asarray(
                ro.apply_to_distribution(probs, result.num_qubits))
        counts = rng.multinomial(shots, probs)
        return counts_from_array(counts, result.num_qubits)
