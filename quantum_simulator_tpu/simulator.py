"""Circuit execution orchestrator over compiled XLA programs.

Parity target: ``/root/reference/quantum_sim/engine/simulator.py:17-199``
(SimulationResult fields, ``run`` / ``run_step_by_step`` / ``run_with_noise``
/ ``ensemble_density_matrix`` semantics: measurement gates are sampling
markers, barriers are visual, noise fires after every gate, noisy runs
re-simulate per shot, the ensemble averages |psi><psi| over child-seeded
trials).

Design difference — the headline one: noisy shots and ensemble trials do
NOT loop. They are ONE compiled, vmapped trajectory program evaluated for
all Monte-Carlo samples in parallel on the accelerator
(``ops/program.py:batched_trajectories_fn``), with chunking to bound peak
HBM. The reference's cost of O(shots * gates * 2^n) Python/NumPy dispatches
becomes a single device launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Generator

import jax
import jax.numpy as jnp
import numpy as np

from .circuit import QuantumCircuit
from .config import CONFIG
from .measurement import (
    MeasurementBasis,
    MeasurementEngine,
    counts_from_array,
)
from .ops import program as prog
from .state import StateVector
from .utils.seeding import key_from_seed
from .utils.xfer import to_host_complex


@dataclass
class SimulationResult:
    """Result of a full simulation run."""

    final_state: StateVector
    measurement_counts: dict[str, int]
    step_states: list[StateVector] | None = None
    num_shots: int = 1024
    seed: int | None = None
    reference_state: StateVector | None = None


def _key_from_rng(rng: np.random.Generator) -> jax.Array:
    """Deterministic JAX key forked from a NumPy generator (SeedManager
    child-stream compatible: same master seed -> same key sequence)."""
    return key_from_seed(int(rng.integers(0, 2**63)))


def _traj_chunk_size(dim: int, n_kraus_branches: int = 4) -> int:
    """Trajectories per device launch, bounding peak memory to ~1 GiB."""
    bytes_per_traj = dim * 8 * max(2, n_kraus_branches)
    target = 1 << 30
    chunk = max(1, target // max(1, bytes_per_traj))
    # Round down to a power of two so chunk shapes (and compiled programs)
    # stay stable across calls.
    return 1 << (chunk.bit_length() - 1)


@partial(jax.jit, donate_argnums=(0,))
def _traj_acc_update(acc, chunk, start):
    """Write a trajectory chunk into the (donated) accumulator in place —
    never holds all chunks PLUS a concatenated copy (2x batch bytes, the
    n=24 batch-64 OOM)."""
    return jax.lax.dynamic_update_slice(acc, chunk, (start, 0))


def run_batched_trajectories(traj_fn, params, keys: jax.Array,
                             dim: int) -> jnp.ndarray:
    """Evaluate a vmapped trajectory fn over many keys with fixed-shape
    chunks to avoid HBM blowups and recompiles. Chunks are written into
    one donated accumulator: peak = batch + one chunk (+ its temps)."""
    total = keys.shape[0]
    chunk = min(_traj_chunk_size(dim), total)
    if chunk == total:
        return traj_fn(params, keys)
    n_chunks = total // chunk  # full chunks; remainder handled below
    # Accumulator created INSIDE a jit: it is born on the device
    # instead of being built on the host and copied over.
    acc = jax.jit(jnp.zeros, static_argnums=(0, 1))((total, dim),
                                                    CONFIG.dtype)
    for i in range(n_chunks):
        out = traj_fn(params, keys[i * chunk:(i + 1) * chunk])
        acc = _traj_acc_update(acc, out, jnp.int32(i * chunk))
    rem = total - n_chunks * chunk
    if rem:
        # One extra fixed-shape launch over the LAST `chunk` keys (keys
        # overlapping already-written rows produce identical states and
        # are sliced off) — same per-key results as exact chunking,
        # without a second compiled shape for the trajectory fn.
        out = traj_fn(params, keys[total - chunk:])
        acc = _traj_acc_update(acc, out[chunk - rem:],
                               jnp.int32(total - rem))
    return acc


def _is_huge(circuit: QuantumCircuit) -> bool:
    """ONE routing predicate for the n >= 30 single-device regime, shared
    by Simulator.run (routes to the donated huge path) and the
    per-snapshot API guards — keep them from drifting. Keyed on the
    state's size (``bigstate.HUGE_STATE_BYTES``), not on the memory
    schedule: whether the huge path then chunks is ``auto_chunks``'s
    call alone."""
    from .ops.bigstate import is_huge_state

    return is_huge_state(circuit.num_qubits)


def _check_amplitude_cap(circuit: QuantumCircuit) -> None:
    """Amplitude engines hold 2^n states; the circuit IR's structural cap
    is far looser (Clifford/frame engines). Enforce the memory cap here."""
    from .config import CONFIG

    if circuit.num_qubits > CONFIG.max_qubits:
        raise ValueError(
            f"num_qubits must be 1-{CONFIG.max_qubits} for amplitude "
            f"simulation, got {circuit.num_qubits} (Clifford circuits "
            "this wide can run on clifford.CliffordSimulator)")


class Simulator:
    """Executes a QuantumCircuit via compiled device programs."""

    def __init__(self, noise_model: object | None = None):
        self._noise_model = noise_model

    # ------------------------------------------------------------------
    # Core runs
    # ------------------------------------------------------------------

    def run(self, circuit: QuantumCircuit, shots: int = 1024,
            record_steps: bool = False,
            seed: int | None = None,
            rng: np.random.Generator | None = None,
            measurement_basis: MeasurementBasis = MeasurementBasis.Z
            ) -> SimulationResult:
        """Apply all gates (one compiled program), then sample measurements.

        With a noise model attached this runs ONE stochastic trajectory
        (reference `run` semantics); use ``run_with_noise`` for per-shot
        trajectory sampling.
        """
        _check_amplitude_cap(circuit)
        if rng is None:
            rng = np.random.default_rng(seed)

        program = prog.compile_circuit(circuit)

        if _is_huge(circuit):
            # n >= 30: never hold a whole-state complex copy; run the
            # donated planar executor + streaming sampler.
            return self._run_huge(circuit, program, shots, record_steps,
                                  seed, rng, measurement_basis)

        params = jnp.asarray(program.initial_params)
        noisy = self._noise_model is not None and self._noise_model.has_channels()

        if record_steps:
            if noisy:
                fn = prog.trajectory_fn(program, self._noise_model,
                                        record_columns=True)
                stacked = fn(params, _key_from_rng(rng))
            else:
                stacked = prog.steps_fn(program)(params)
            step_states = [
                StateVector.from_device_array(stacked[i], circuit.num_qubits)
                for i in range(1, stacked.shape[0])
            ]
            final = StateVector.from_device_array(stacked[-1],
                                                  circuit.num_qubits)
        else:
            step_states = None
            if noisy:
                fn = prog.trajectory_fn(program, self._noise_model)
                final_arr = fn(params, _key_from_rng(rng))
            else:
                final_arr = prog.forward_fn(program)(params)
            final = StateVector.from_device_array(final_arr,
                                                  circuit.num_qubits)

        has_measurement = any(g.gate_name == "Measure" for g in circuit.gates)
        if has_measurement or shots > 0:
            readout_err = None
            if self._noise_model is not None and hasattr(
                    self._noise_model, "readout_error"):
                readout_err = self._noise_model.readout_error
            counts = MeasurementEngine.sample_with_basis(
                final, shots, basis=measurement_basis,
                readout_error=readout_err, rng=rng)
        else:
            counts = {}

        return SimulationResult(
            final_state=final,
            measurement_counts=counts,
            step_states=step_states,
            num_shots=shots,
            seed=seed,
        )

    def _run_huge(self, circuit: QuantumCircuit, program, shots: int,
                  record_steps: bool, seed: int | None,
                  rng: np.random.Generator,
                  measurement_basis: MeasurementBasis) -> SimulationResult:
        """n >= 30 single-chip path: chunked in-place planar executor
        (``ops/bigstate.py``), streaming inverse-CDF sampling, and a
        ``PlanarStateVector`` result (no complex copy of the state is ever
        built — it alone would exceed the remaining HBM)."""
        from .ops.bigstate import (
            PlanarStateVector,
            huge_forward_fn,
            huge_forward_sample_fn,
        )

        noisy = self._noise_model is not None \
            and self._noise_model.has_channels()
        if record_steps:
            raise ValueError(
                f"record_steps would retain one {circuit.num_qubits}-qubit "
                "state per column; not supported on the single-chip "
                "huge-state path (run_step_by_step yields marginal "
                "snapshots instead).")
        if noisy:
            # ONE stochastic trajectory (reference `run` semantics) via
            # the per-gate chunked trajectory executor (ops/bigtraj.py).
            return self._run_huge_noisy(circuit, program, shots, seed,
                                        rng, measurement_basis)
        readout_err = None
        if self._noise_model is not None and hasattr(
                self._noise_model, "readout_error"):
            readout_err = self._noise_model.readout_error

        params = jnp.asarray(program.initial_params)
        sampling = shots > 0
        counts: dict[str, int] = {}
        # Sampling is FUSED into the forward jit (huge_forward_sample_fn):
        # at n=30 a second dispatch consuming the ~8 GiB state as an
        # argument OOMs on this runtime, so the state must never cross a
        # jit boundary. Order also matters for rotated bases: two huge
        # states cannot coexist in HBM, so run the rotated
        # forward+sample FIRST, free it, then the final state.
        if sampling and measurement_basis != MeasurementBasis.Z:
            # Basis rotation as extra gates on a circuit copy (H for X;
            # S† then H for Y) — the planar twin of
            # measurement.rotate_to_basis.
            from .circuit import GateInstance

            rotated = circuit.copy()
            col = max((g.column for g in rotated.gates), default=-1) + 1
            for q in range(rotated.num_qubits):
                if measurement_basis == MeasurementBasis.Y:
                    rotated.add_gate(GateInstance("S_DAG", [q], [],
                                                  column=col))
                    rotated.add_gate(GateInstance("H", [q], [],
                                                  column=col + 1))
                else:
                    rotated.add_gate(GateInstance("H", [q], [],
                                                  column=col))
            rprog = prog.compile_circuit(rotated)
            rfn, _ = huge_forward_sample_fn(rprog, shots)
            xs, _rm, idx = rfn(jnp.asarray(rprog.initial_params),
                               _key_from_rng(rng))
            counts = self._indices_to_counts(idx, circuit.num_qubits)
            xs.delete()
            fwd, planar = huge_forward_fn(program)
            x, marg = fwd(params)
        elif sampling:
            fn, planar = huge_forward_sample_fn(program, shots)
            x, marg, idx = fn(params, _key_from_rng(rng))
            counts = self._indices_to_counts(idx, circuit.num_qubits)
        else:
            fwd, planar = huge_forward_fn(program)
            x, marg = fwd(params)
        final = PlanarStateVector(x, circuit.num_qubits, planar=planar,
                                  axis_marginals=marg)
        if counts and readout_err is not None:
            # Shot-mode corruption works on sparse counts; the
            # distribution transform would need the dense 2^n vector.
            counts = readout_err.corrupt_counts(counts, rng)

        return SimulationResult(
            final_state=final,
            measurement_counts=counts,
            step_states=None,
            num_shots=shots,
            seed=seed,
        )

    def _run_huge_noisy(self, circuit: QuantumCircuit, program, shots: int,
                        seed: int | None, rng: np.random.Generator,
                        measurement_basis: MeasurementBasis
                        ) -> SimulationResult:
        """n >= 30 single stochastic trajectory: per-gate chunked passes
        with folded Kraus draws (``ops/bigtraj.py``), sampling fused into
        the donation chain. Reference semantics:
        ``/root/reference/quantum_sim/engine/noise.py:224-260`` applied
        after every gate, as in ``simulator.py:66-68``."""
        from .ops.bigstate import PlanarStateVector
        from .ops.bigtraj import huge_trajectory_sample_fn

        params = jnp.asarray(program.initial_params)
        traj_key = _key_from_rng(rng)
        sample_key = _key_from_rng(rng)
        basis = measurement_basis.name  # 'Z' | 'X' | 'Y'
        counts: dict[str, int] = {}
        if shots > 0 and basis != 'Z':
            # Rotation mutates the donated state, so sample first
            # (rotated, state consumed), then re-run the SAME trajectory
            # (same key -> identical stochastic branches) for the state.
            fn, _ = huge_trajectory_sample_fn(
                program, self._noise_model, shots, keep_state=False,
                basis=basis)
            idx = fn(params, traj_key, sample_key)
            counts = self._indices_to_counts(idx, circuit.num_qubits)
            fn2, planar = huge_trajectory_sample_fn(
                program, self._noise_model, 0, keep_state=True)
            x, marg = fn2(params, traj_key, sample_key)
        elif shots > 0:
            fn, planar = huge_trajectory_sample_fn(
                program, self._noise_model, shots, keep_state=True)
            x, marg, idx = fn(params, traj_key, sample_key)
            counts = self._indices_to_counts(idx, circuit.num_qubits)
        else:
            fn, planar = huge_trajectory_sample_fn(
                program, self._noise_model, 0, keep_state=True)
            x, marg = fn(params, traj_key, sample_key)
        readout_err = getattr(self._noise_model, "readout_error", None)
        if counts and readout_err is not None:
            counts = readout_err.corrupt_counts(counts, rng)
        final = PlanarStateVector(x, circuit.num_qubits, planar=planar,
                                  axis_marginals=marg)
        return SimulationResult(
            final_state=final,
            measurement_counts=counts,
            step_states=None,
            num_shots=shots,
            seed=seed,
        )

    def _monitored_huge(self, circuit: QuantumCircuit, program, noise,
                        events: tuple, sites, n_trajectories: int,
                        seed: int | None, final_shots: int):
        """n >= 30 monitored trajectories: one fused chunked program per
        trajectory (collapse projectors spliced through the plan windows
        + streaming Z sampler); only int32 outcome/sample vectors leave
        the device. Third return element: per-trajectory counts dicts
        (``final_shots`` each) — whole states cannot be retained here."""
        from .ops.bigtraj import huge_monitored_sample_fn
        from .ops.monomial_traj import monomial_monitored_evolve_ok
        from .ops.program import _NoNoise

        nm = noise if noise is not None else _NoNoise
        if not monomial_monitored_evolve_ok(program, nm, events):
            raise ValueError(
                "huge (n >= 30) monitored trajectories need monomial "
                "noise channels (the reference family) or no noise; "
                "use MPSSimulator / CliffordSimulator monitored engines "
                "for other channels")
        fn, _ = huge_monitored_sample_fn(program, nm, events,
                                         final_shots)
        rng = np.random.default_rng(seed)
        params = jnp.asarray(program.initial_params)
        outs_rows: list = []
        counts_list: list = []
        for _ in range(n_trajectories):
            traj_key = _key_from_rng(rng)
            sample_key = _key_from_rng(rng)
            if final_shots > 0:
                outs, idx = fn(params, traj_key, sample_key)
                counts_list.append(
                    self._indices_to_counts(idx, circuit.num_qubits))
            else:
                outs = fn(params, traj_key, sample_key)
            outs_rows.append(np.asarray(outs))
        return np.stack(outs_rows), sites, counts_list

    @staticmethod
    def _indices_to_counts(idx, num_qubits: int) -> dict[str, int]:
        """Only ``shots`` int32 indices cross to host."""
        vals, cnts = np.unique(np.asarray(idx), return_counts=True)
        return {format(int(v), f"0{num_qubits}b"): int(c)
                for v, c in zip(vals, cnts)}

    @staticmethod
    def _reject_huge(circuit: QuantumCircuit, what: str) -> None:
        """Per-column/per-trajectory state retention is a whole-state
        complex buffer per snapshot — structurally incompatible with the
        n >= 30 single-chip memory budget (Simulator.run's huge path
        never builds even ONE complex copy). Fail with guidance instead
        of an opaque device OOM."""
        if _is_huge(circuit):
            raise ValueError(
                f"{what} retains whole-state complex buffers and cannot "
                f"fit a {circuit.num_qubits}-qubit state on one chip; "
                "use Simulator.run (chunked huge-state path) or the "
                "sharded engine (parallel.DistributedSimulator)")

    def run_step_by_step(self, circuit: QuantumCircuit,
                         rng: np.random.Generator | None = None
                         ) -> Generator[tuple[StateVector, int], None, None]:
        """Yields (state, column_index) including the initial state at -1.

        At n >= 30 the yielded snapshots are ``MarginalStateSummary``
        objects (per-axis probability marginals -> per-qubit P(1)), not
        ``StateVector``s: retaining one whole-state complex buffer per
        column is structurally impossible on a single chip. The whole
        stepped run is ONE compiled program; the state evolves in place
        and only the tiny marginals cross to host."""
        _check_amplitude_cap(circuit)
        if _is_huge(circuit):
            if self._noise_model is not None \
                    and self._noise_model.has_channels():
                raise ValueError(
                    "step-by-step with noise retains per-column "
                    "trajectory state; at n >= 30 use Simulator.run "
                    "(single noisy trajectory) or run_with_noise")
            from .ops.bigstate import (
                MarginalStateSummary,
                huge_step_marginals_fn,
            )

            program = prog.compile_circuit(circuit)
            fn, _ = huge_step_marginals_fn(program)
            outs = fn(jnp.asarray(program.initial_params))
            for i, marg in enumerate(outs):
                yield (MarginalStateSummary(marg, circuit.num_qubits),
                       i - 1)
            return
        program = prog.compile_circuit(circuit)
        params = jnp.asarray(program.initial_params)
        noisy = self._noise_model is not None and self._noise_model.has_channels()
        if noisy:
            rng = rng or np.random.default_rng()
            fn = prog.trajectory_fn(program, self._noise_model,
                                    record_columns=True)
            stacked = fn(params, _key_from_rng(rng))
        else:
            stacked = prog.steps_fn(program)(params)
        for i in range(stacked.shape[0]):
            yield (StateVector.from_device_array(stacked[i],
                                                 circuit.num_qubits), i - 1)

    # ------------------------------------------------------------------
    # Monte-Carlo paths (batched on device)
    # ------------------------------------------------------------------

    def trajectory_states(self, circuit: QuantumCircuit, n_trajectories: int,
                          seed: int | None = None,
                          rng: np.random.Generator | None = None
                          ) -> jnp.ndarray:
        """(T, 2^n) final states of T stochastic trajectories — the batched
        primitive under run_with_noise / ensemble / sweeps / QEC trials."""
        _check_amplitude_cap(circuit)
        self._reject_huge(circuit, "trajectory_states")
        if rng is None:
            rng = np.random.default_rng(seed)
        program = prog.compile_circuit(circuit)
        params = jnp.asarray(program.initial_params)
        if self._noise_model is None or not self._noise_model.has_channels():
            state = prog.forward_fn(program)(params)
            return jnp.broadcast_to(state, (n_trajectories, state.shape[0]))
        base = _key_from_rng(rng)
        keys = jax.random.split(base, n_trajectories)
        fn = prog.batched_trajectories_fn(program, self._noise_model)
        return run_batched_trajectories(fn, params, keys,
                                        2**circuit.num_qubits)

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               final_shots: int | None = None):
        """T independent monitored trajectories on the exact engine:
        Measure gates collapse mid-circuit (projective draw + renorm)
        instead of being skipped, optionally interleaved with this
        simulator's stochastic noise channels — completing the
        monitored triad with ``CliffordSimulator`` /
        ``MPSSimulator.monitored_trajectories`` (the reference skips
        MEASUREMENT during evolution, ``simulator.py:61-65``).

        -> (outcomes[T, M] int array in Measure column order,
            sites [(column, qubit)] * M,
            states: list of T final ``StateVector``s).

        Below the plan threshold (``program._PLAN_EXECUTOR_MIN_QUBITS``)
        or off the GPU this runs the per-gate einsum path; from there up
        to n = 29 on the GPU the collapses run as spliced projectors
        through the group plan (``ops/monomial_traj``: a projective
        measurement is the monomial channel ``{|0><0|, |1><1|}``, whose
        outcome given the window's basis sample is the sampled bit), so
        generic monitored circuits keep the exact engine across the
        whole single-chip dense envelope.

        At n >= 30 (single-chip huge regime) T whole-state results
        cannot exist, so the third element becomes a list of T Z-basis
        measurement-count dicts (``final_shots`` each; ``[]`` when
        ``final_shots`` is None/0) — collapse, evolution, and sampling
        fuse into one chunked device program per trajectory
        (``ops/bigtraj.huge_monitored_sample_fn``); noise must be
        monomial (the reference channel family). ``final_shots`` is
        meaningful only there and rejected below n = 30 (the returned
        ``StateVector``s already carry full amplitudes).
        """
        from .gates import GateType
        from .registry import GateRegistry

        _check_amplitude_cap(circuit)
        if final_shots is not None and not _is_huge(circuit):
            raise ValueError(
                "final_shots is the n >= 30 replacement for returned "
                "states; below the huge threshold sample the returned "
                "StateVectors instead")
        program = prog.compile_circuit(circuit)
        registry = GateRegistry.instance()
        events: list[tuple[int, int]] = []
        sites: list[tuple[int, int]] = []
        pos = 0
        for column in circuit.get_ordered_gates():
            for gate in column:
                gdef = registry.get(gate.gate_name)
                if gdef.gate_type == GateType.MEASUREMENT:
                    events.append((pos, gate.target_qubits[0]))
                    sites.append((gate.column, gate.target_qubits[0]))
                elif gdef.gate_type != GateType.BARRIER:
                    pos += 1
        noise = (self._noise_model
                 if self._noise_model is not None
                 and self._noise_model.has_channels() else None)
        if _is_huge(circuit):
            return self._monitored_huge(circuit, program, noise,
                                        tuple(events), sites,
                                        n_trajectories, seed,
                                        final_shots or 0)
        fn = prog.monitored_trajectories_fn(program, noise, events)
        rng = np.random.default_rng(seed)
        keys = jax.random.split(_key_from_rng(rng), n_trajectories)
        params = jnp.asarray(program.initial_params)
        # Same fixed-shape chunking policy as run_batched_trajectories:
        # bound the vmapped working set (the T returned states are the
        # caller's, but the per-launch temps must not scale with T).
        total = n_trajectories
        chunk = min(_traj_chunk_size(2 ** circuit.num_qubits), total)
        states_out: list = []
        outs_parts: list = []
        start = 0
        while start < total:
            take = min(chunk, total - start)
            if take < chunk:
                # Re-run the last fixed-shape window; overlapping keys
                # reproduce already-collected trajectories and slice off.
                s, o = fn(params, keys[total - chunk:])
                s, o = s[chunk - take:], o[chunk - take:]
            else:
                s, o = fn(params, keys[start:start + chunk])
            outs_parts.append(np.asarray(o))
            states_out.extend(
                StateVector.from_device_array(s[i], circuit.num_qubits)
                for i in range(take))
            start += take
        return np.concatenate(outs_parts, axis=0), sites, states_out

    def run_with_noise(self, circuit: QuantumCircuit, shots: int = 1024,
                       seed: int | None = None,
                       rng: np.random.Generator | None = None,
                       trajectories: int | None = None
                       ) -> SimulationResult:
        """Per-shot stochastic trajectory + projective measure_all, all
        batched (reference loops shots times, ``simulator.py:134-145``).

        At n >= 30 (single-chip huge path) one trajectory is seconds of
        chunked whole-state passes, so shot-per-trajectory is replaced by
        ``trajectories`` stochastic trajectories (default
        ``min(shots, 16)``) each sampled ``~shots/trajectories`` times —
        the standard Monte-Carlo-trajectory estimator of the same noisy
        distribution. Pass ``trajectories=shots`` for exact reference
        semantics (one draw per trajectory)."""
        _check_amplitude_cap(circuit)
        if self._noise_model is None:
            return self.run(circuit, shots, seed=seed, rng=rng)
        if rng is None:
            rng = np.random.default_rng(seed)
        if _is_huge(circuit) and self._noise_model.has_channels():
            return self._run_with_noise_huge(circuit, shots, seed, rng,
                                             trajectories)

        # trajectories=None -> reference semantics (one stochastic
        # trajectory per shot, one draw each). An explicit smaller
        # count runs the same Monte-Carlo-trajectory estimator the huge
        # path uses: T trajectories, ~shots/T draws from each.
        T = shots if trajectories is None \
            else max(1, min(shots, trajectories))
        states = self.trajectory_states(circuit, T, rng=rng)
        probs = jnp.abs(states) ** 2
        probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
        dim = 2**circuit.num_qubits
        if T == shots:
            draw_key = _key_from_rng(rng)
            draws = jax.random.categorical(draw_key,
                                           jnp.log(probs + 1e-38),
                                           axis=-1)
            counts_array = np.bincount(np.asarray(draws), minlength=dim)
        else:
            base, extra = divmod(shots, T)
            counts_array = np.zeros(dim, dtype=np.int64)
            for i in range(T):
                take = base + (1 if i < extra else 0)
                if take == 0:
                    break
                draws = jax.random.categorical(
                    _key_from_rng(rng), jnp.log(probs[i] + 1e-38),
                    shape=(take,))
                counts_array += np.bincount(np.asarray(draws),
                                            minlength=dim)
        all_counts = counts_from_array(counts_array, circuit.num_qubits)
        # Readout corruption applies to noisy shots exactly as on the
        # huge path (_run_with_noise_huge) and the ideal run() path —
        # this dense path previously dropped it.
        readout_err = getattr(self._noise_model, "readout_error", None)
        if all_counts and readout_err is not None:
            all_counts = readout_err.corrupt_counts(all_counts, rng)

        final_state = StateVector.from_initial_states(circuit.initial_states)
        return SimulationResult(
            final_state=final_state,
            measurement_counts=all_counts,
            num_shots=shots,
            seed=seed,
        )

    def _run_with_noise_huge(self, circuit: QuantumCircuit, shots: int,
                             seed: int | None, rng: np.random.Generator,
                             trajectories: int | None) -> SimulationResult:
        """n >= 30: T sequential trajectory chains (one compiled program,
        fresh keys), each sampling ceil(shots/T) draws fused on device;
        only int32 shot indices cross to host. ``final_state`` is None —
        the reference returns a placeholder initial state
        (``simulator.py:146-153``), which at n >= 30 would itself be a
        multi-GiB allocation."""
        from .ops.bigtraj import huge_trajectory_sample_fn

        program = prog.compile_circuit(circuit)
        params = jnp.asarray(program.initial_params)
        T = max(1, min(shots, trajectories or min(shots, 16)))
        s_max = -(-shots // T) if shots > 0 else 0
        all_idx: list[np.ndarray] = []
        if s_max > 0:
            fn, _ = huge_trajectory_sample_fn(
                program, self._noise_model, s_max, keep_state=False)
            # Spread shots across ALL T trajectories (first `extra` take
            # one more) — never launch a multi-second whole-state chain
            # whose draws would all be discarded.
            base, extra = divmod(shots, T)
            for i in range(T):
                take = base + (1 if i < extra else 0)
                if take == 0:
                    break
                tk = _key_from_rng(rng)
                sk = _key_from_rng(rng)
                idx = np.asarray(fn(params, tk, sk))
                all_idx.append(idx[:take])
        counts: dict[str, int] = {}
        if all_idx:
            counts = self._indices_to_counts(
                np.concatenate(all_idx), circuit.num_qubits)
        readout_err = getattr(self._noise_model, "readout_error", None)
        if counts and readout_err is not None:
            counts = readout_err.corrupt_counts(counts, rng)
        return SimulationResult(
            final_state=None,
            measurement_counts=counts,
            num_shots=shots,
            seed=seed,
        )

    def ensemble_density_matrix(
        self,
        circuit: QuantumCircuit,
        n_trials: int = 50,
        seed: int | None = None,
    ) -> np.ndarray:
        """rho = (1/N) sum_i |psi_i><psi_i| over N stochastic trajectories,
        accumulated on device in one einsum."""
        _check_amplitude_cap(circuit)
        rng = np.random.default_rng(seed)
        states = self.trajectory_states(circuit, n_trials, rng=rng)
        rho = jnp.einsum("ti,tj->ij", states, jnp.conj(states),
                         precision=jax.lax.Precision.HIGHEST) / n_trials
        return to_host_complex(rho)

    def ensemble_qubit_density_matrices(
        self,
        circuit: QuantumCircuit,
        n_trials: int = 50,
        seed: int | None = None,
    ) -> np.ndarray:
        """(n, 2, 2) ensemble-averaged single-qubit reduced density
        matrices over N stochastic trajectories — the O(n)-output
        ensemble reduction that scales to any qubit count (the full
        ``ensemble_density_matrix`` is 4^n and caps at n<=14).

        Reference analog: ``ensemble_density_matrix``
        (``simulator.py:155-199``) followed by per-qubit partial traces
        (``state_vector.py:121-140``); here the partial trace is fused
        into the trajectory batch (n <= 29) or computed from per-axis
        Gram reductions on the chunked huge path (n >= 30)."""
        _check_amplitude_cap(circuit)
        rng = np.random.default_rng(seed)
        n = circuit.num_qubits
        if _is_huge(circuit):
            from .ops.bigtraj import (
                huge_trajectory_gram_fn,
                qubit_rhos_from_grams,
            )

            nm = self._noise_model
            if nm is None or not nm.has_channels():
                from .noise import NoiseModel

                nm = NoiseModel()  # channel-free trajectory = ideal run
                n_trials = 1
            program = prog.compile_circuit(circuit)
            params = jnp.asarray(program.initial_params)
            fn, _ = huge_trajectory_gram_fn(program, nm)
            acc = np.zeros((n, 2, 2), np.complex128)
            for _ in range(n_trials):
                grams = fn(params, _key_from_rng(rng))
                acc += qubit_rhos_from_grams(grams, n)
            return acc / n_trials
        states = self.trajectory_states(circuit, n_trials, rng=rng)
        dim = states.shape[-1]
        out = np.empty((n, 2, 2), np.complex128)
        for q in range(n):
            pre = 1 << q
            post = dim >> (q + 1)
            s4 = states.reshape(n_trials, pre, 2, post)
            rho = jnp.einsum("tapb,taqb->pq", s4, jnp.conj(s4),
                             precision=jax.lax.Precision.HIGHEST) / n_trials
            out[q] = to_host_complex(rho)
        return out
