"""View-models: the data/logic behind every visualization panel, headless.

The reference embeds panel computation inside 13 PyQt widgets
(``/root/reference/quantum_sim/gui/panels/`` — statevector table, Bloch
spheres, histogram, density matrix, entanglement graph, entropy evolution,
fidelity sweep, analysis dashboard, debugger, comparison, optimizer, QEC,
resource monitor). Here each panel's *model* is a plain class producing
plottable data structures, so the logic is unit-testable without a GUI
toolkit and any frontend (Qt, web, notebook) can render it. The Qt widgets
in ``gui/`` are thin views over these models.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

import numpy as np

from .analysis import (
    EntanglementEventDetector,
    StateAnalysis,
)
from .circuit import QuantumCircuit
from .measurement import MeasurementBasis, MeasurementEngine
from .noise import DepolarizingNoise, NoiseModel
from .simulator import Simulator
from .state import StateVector

# ---------------------------------------------------------------------------
# 1. State-vector table
# ---------------------------------------------------------------------------


@dataclass
class AmplitudeRow:
    index: int
    bitstring: str
    real: float
    imag: float
    magnitude: float
    phase: float
    probability: float


class StateVectorModel:
    """Amplitude table with optional nonzero filtering (statevector panel)."""

    @staticmethod
    def rows(state: StateVector, nonzero_only: bool = False,
             threshold: float = 1e-12) -> list[AmplitudeRow]:
        data = state.data
        n = state.num_qubits
        out = []
        for i, amp in enumerate(data):
            prob = float(abs(amp) ** 2)
            if nonzero_only and prob < threshold:
                continue
            out.append(AmplitudeRow(
                index=i,
                bitstring=format(i, f"0{n}b"),
                real=float(amp.real),
                imag=float(amp.imag),
                magnitude=float(abs(amp)),
                phase=float(np.angle(amp)),
                probability=prob,
            ))
        return out


# ---------------------------------------------------------------------------
# 2. Bloch spheres
# ---------------------------------------------------------------------------

_KNOWN_BLOCH_STATES = [
    ((0.0, 0.0, 1.0), "|0⟩"),
    ((0.0, 0.0, -1.0), "|1⟩"),
    ((1.0, 0.0, 0.0), "|+⟩"),
    ((-1.0, 0.0, 0.0), "|-⟩"),
    ((0.0, 1.0, 0.0), "|i⟩"),
    ((0.0, -1.0, 0.0), "|-i⟩"),
]


def identify_bloch_state(x: float, y: float, z: float,
                         threshold: float = 0.12) -> str | None:
    """Ket label when (x, y, z) is near a cardinal Bloch state."""
    for (sx, sy, sz), label in _KNOWN_BLOCH_STATES:
        if math.dist((x, y, z), (sx, sy, sz)) < threshold:
            return label
    return None


@dataclass
class BlochQubit:
    qubit: int
    x: float
    y: float
    z: float
    purity: float
    label: str | None


class BlochModel:
    """Per-qubit Bloch coordinates + trajectory recording (Bloch panel)."""

    def __init__(self):
        self._trajectories: dict[int, list[tuple[float, float, float]]] = {}

    @staticmethod
    def snapshot(state: StateVector) -> list[BlochQubit]:
        out = []
        for q in range(state.num_qubits):
            x, y, z = state.get_bloch_coordinates(q)
            r2 = x * x + y * y + z * z
            out.append(BlochQubit(
                qubit=q, x=x, y=y, z=z,
                purity=0.5 * (1 + r2),
                label=identify_bloch_state(x, y, z),
            ))
        return out

    def record_step(self, state: StateVector) -> None:
        for b in self.snapshot(state):
            self._trajectories.setdefault(b.qubit, []).append(
                (b.x, b.y, b.z))

    def trajectory(self, qubit: int) -> list[tuple[float, float, float]]:
        return list(self._trajectories.get(qubit, []))

    def faded_trajectory(self, qubit: int, min_alpha: float = 0.15
                         ) -> list[tuple[float, float, float, float]]:
        """Trajectory points with an alpha ramp (old -> faint, latest ->
        opaque) — the Bloch panel's step-mode trail (the reference fades
        its trajectory the same way, ``bloch_sphere.py:55-563``)."""
        pts = self._trajectories.get(qubit, [])
        k = len(pts)
        if k == 0:
            return []
        if k == 1:
            return [(pts[0][0], pts[0][1], pts[0][2], 1.0)]
        return [(x, y, z, min_alpha + (1.0 - min_alpha) * i / (k - 1))
                for i, (x, y, z) in enumerate(pts)]

    def reset(self) -> None:
        self._trajectories.clear()


# ---------------------------------------------------------------------------
# 3. Histogram
# ---------------------------------------------------------------------------

class HistogramModel:
    """Counts or probability bars in a chosen basis (histogram panel)."""

    @staticmethod
    def from_counts(counts: dict[str, int]) -> list[tuple[str, int, float]]:
        total = sum(counts.values()) or 1
        return [(b, c, c / total) for b, c in sorted(counts.items())]

    @staticmethod
    def from_state(state: StateVector, shots: int,
                   basis: MeasurementBasis = MeasurementBasis.Z,
                   readout_error=None, seed: int | None = None
                   ) -> list[tuple[str, int, float]]:
        counts = MeasurementEngine.sample_with_basis(
            state, shots, basis=basis, readout_error=readout_error,
            rng=np.random.default_rng(seed))
        return HistogramModel.from_counts(counts)


# ---------------------------------------------------------------------------
# 4. Density matrix
# ---------------------------------------------------------------------------

MAX_DENSITY_DISPLAY_QUBITS = 8


@dataclass
class DensityMatrixView:
    real: np.ndarray
    imag: np.ndarray
    magnitude: np.ndarray
    purity: float
    entropy: float
    num_qubits: int
    truncated: bool = False


class DensityMatrixModel:
    """Pure or ensemble density-matrix heatmap data (density panel).

    Ensemble results are cached by (circuit_hash, noise_key, trials), same
    invalidation policy as the reference (``density_matrix_panel.py:22``).
    """

    _CACHE_SLOTS = 4

    def __init__(self):
        self._cache: dict[tuple, DensityMatrixView] = {}

    @staticmethod
    def _truncated(n: int) -> DensityMatrixView:
        return DensityMatrixView(
            real=np.zeros((0, 0)), imag=np.zeros((0, 0)),
            magnitude=np.zeros((0, 0)), purity=1.0, entropy=0.0,
            num_qubits=n, truncated=True)

    @staticmethod
    def from_state(state: StateVector) -> DensityMatrixView:
        if state.num_qubits > MAX_DENSITY_DISPLAY_QUBITS:
            return DensityMatrixModel._truncated(state.num_qubits)
        rho = state.get_density_matrix()
        return DensityMatrixModel._view(rho, state.num_qubits)

    def _cache_put(self, key: tuple, view: DensityMatrixView):
        if len(self._cache) >= self._CACHE_SLOTS:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = view

    def ensemble(self, circuit: QuantumCircuit, noise_model: NoiseModel,
                 n_trials: int = 50, seed: int | None = None
                 ) -> DensityMatrixView:
        if circuit.num_qubits > MAX_DENSITY_DISPLAY_QUBITS:
            return self._truncated(circuit.num_qubits)
        key = (circuit.circuit_hash(), noise_model.spec_key(), n_trials,
               seed)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        rho = Simulator(noise_model=noise_model).ensemble_density_matrix(
            circuit, n_trials=n_trials, seed=seed)
        view = self._view(rho, circuit.num_qubits)
        self._cache_put(key, view)
        return view

    def exact(self, circuit: QuantumCircuit, noise_model: NoiseModel
              ) -> DensityMatrixView:
        """Deterministic channel evolution (density.py) — no Monte-Carlo
        sampling error. Display-capped like every other rho view (an
        n=14 rho is 3x 2 GiB of host float64 + a 16384^2 imshow)."""
        from .density import DensityMatrixSimulator

        if circuit.num_qubits > MAX_DENSITY_DISPLAY_QUBITS:
            return self._truncated(circuit.num_qubits)
        key = (circuit.circuit_hash(), noise_model.spec_key(), "exact")
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        res = DensityMatrixSimulator(noise_model=noise_model).run(circuit)
        view = self._view(res.rho, circuit.num_qubits)
        self._cache_put(key, view)
        return view

    @staticmethod
    def _view(rho: np.ndarray, n: int) -> DensityMatrixView:
        return DensityMatrixView(
            real=np.real(rho), imag=np.imag(rho), magnitude=np.abs(rho),
            purity=StateAnalysis.purity_dm(rho),
            entropy=StateAnalysis.von_neumann_entropy_dm(rho),
            num_qubits=n)


# ---------------------------------------------------------------------------
# 5. Entanglement graph
# ---------------------------------------------------------------------------

@dataclass
class EntanglementGraph:
    positions: list[tuple[float, float]]  # circular layout per qubit
    edges: list[tuple[int, int, float]]   # (i, j, weight)
    metric: str
    warning: str | None = None


class EntanglementGraphModel:
    """Circular qubit graph weighted by MI or concurrence."""

    @staticmethod
    def build(state: StateVector, metric: str = "mutual_information",
              threshold: float = 1e-4) -> EntanglementGraph:
        n = state.num_qubits
        positions = [
            (math.cos(2 * math.pi * q / n), math.sin(2 * math.pi * q / n))
            for q in range(n)
        ]
        warning = (f"O(n^2) pair analysis over {n} qubits may be slow"
                   if n > 10 else None)
        edges = []
        if metric == "mutual_information":
            mi = StateAnalysis.pairwise_mutual_information(state)
            for i in range(n):
                for j in range(i + 1, n):
                    if mi[i, j] > threshold:
                        edges.append((i, j, float(mi[i, j])))
        else:
            for i in range(n):
                for j in range(i + 1, n):
                    c = StateAnalysis.concurrence(state, i, j)
                    if c > threshold:
                        edges.append((i, j, c))
        return EntanglementGraph(positions=positions, edges=edges,
                                 metric=metric, warning=warning)


# ---------------------------------------------------------------------------
# 6. Entropy evolution
# ---------------------------------------------------------------------------

class EntropyEvolutionModel:
    """Entropy curves over step-by-step execution (entropy panel modes:
    Total / Per-Qubit / Bipartite / Entanglement Events)."""

    def __init__(self, epsilon: float = 0.01, persistence: int = 1):
        self.detector = EntanglementEventDetector(
            epsilon=epsilon, persistence=persistence)
        self.steps: list[int] = []
        self.total: list[float] = []
        self.per_qubit: list[list[float]] = []
        self.bipartite: list[float] = []

    def record_step(self, state: StateVector, step_index: int) -> list:
        n = state.num_qubits
        self.steps.append(step_index)
        self.total.append(StateAnalysis.von_neumann_entropy(state))
        self.per_qubit.append([
            StateAnalysis.entanglement_entropy(state, [q]) for q in range(n)
        ])
        half = list(range(n // 2)) if n > 1 else [0]
        self.bipartite.append(
            StateAnalysis.entanglement_entropy(state, half))
        return self.detector.process_step(state, step_index)

    def reset(self) -> None:
        self.detector.reset()
        self.steps.clear()
        self.total.clear()
        self.per_qubit.clear()
        self.bipartite.clear()


# ---------------------------------------------------------------------------
# 7. Fidelity noise sweep
# ---------------------------------------------------------------------------

@dataclass
class FidelitySweepPoint:
    noise_prob: float
    fidelity: float
    purity: float


class FidelitySweepModel:
    """Fidelity/purity vs depolarizing probability (fidelity panel);
    trials batched on device per point."""

    @staticmethod
    def sweep(circuit: QuantumCircuit, probabilities: list[float],
              trials: int = 50, seed: int | None = None
              ) -> list[FidelitySweepPoint]:
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        ideal = Simulator().run(circuit, shots=0, seed=seed).final_state
        ideal_dev = ideal.device_data
        points = []
        for p in probabilities:
            if float(p) == 0.0:
                points.append(FidelitySweepPoint(0.0, 1.0, 1.0))
                continue
            import jax

            hi = jax.lax.Precision.HIGHEST
            nm = NoiseModel()
            nm.add_global_noise(DepolarizingNoise(float(p)))
            states = Simulator(noise_model=nm).trajectory_states(
                circuit, trials, seed=int(rng.integers(0, 2**63)))
            overlaps = jnp.einsum("d,td->t", jnp.conj(ideal_dev), states,
                                  precision=hi)
            fids = np.asarray(jnp.abs(overlaps) ** 2, dtype=np.float64)
            # ensemble purity tr(rho^2) = mean_{t,t'} |<psi_t|psi_t'>|^2
            # (each trajectory is renormalized, so per-state norms are
            # identically 1 and say nothing about mixedness)
            gram = jnp.einsum("td,sd->ts", jnp.conj(states), states,
                              precision=hi)
            purity = float(np.asarray(
                jnp.mean(jnp.abs(gram) ** 2), dtype=np.float64))
            points.append(FidelitySweepPoint(
                float(p), float(fids.mean()), purity))
        return points


# ---------------------------------------------------------------------------
# 8. Analysis dashboard
# ---------------------------------------------------------------------------

@dataclass
class AnalysisDashboard:
    purity: float
    entropy: float
    nonzero_amplitudes: int
    fidelity_to_reference: float | None
    per_qubit_pauli: dict[str, dict[str, float]]
    bipartite_entropy: float
    pairwise_concurrence: dict[str, float]
    is_separable: bool


class AnalysisDashboardModel:
    """All the summary metrics the analysis panel displays."""

    MAX_PAULI_QUBITS = 8

    @staticmethod
    def build(state: StateVector, reference_manager=None
              ) -> AnalysisDashboard:
        n = state.num_qubits
        probs = state.probabilities
        fidelity = None
        if reference_manager is not None and reference_manager.has_reference:
            fidelity = reference_manager.fidelity_to_reference(state)

        pauli = {}
        for q in range(min(n, AnalysisDashboardModel.MAX_PAULI_QUBITS)):
            pauli[f"q{q}"] = {
                p: StateAnalysis.pauli_expectation(state, p, q)
                for p in ("X", "Y", "Z")
            }

        half = list(range(n // 2)) if n > 1 else [0]
        bipartite = StateAnalysis.entanglement_entropy(state, half)

        concurrence = {}
        mi = StateAnalysis.pairwise_mutual_information(state)
        separable = True
        for i in range(n):
            for j in range(i + 1, n):
                if mi[i, j] > 1e-6:
                    separable = False
                if n <= AnalysisDashboardModel.MAX_PAULI_QUBITS:
                    c = StateAnalysis.concurrence(state, i, j)
                    if c > 1e-6:
                        concurrence[f"q{i}-q{j}"] = c

        return AnalysisDashboard(
            purity=StateAnalysis.purity(state),
            entropy=StateAnalysis.von_neumann_entropy(state),
            nonzero_amplitudes=int(np.count_nonzero(probs > 1e-12)),
            fidelity_to_reference=fidelity,
            per_qubit_pauli=pauli,
            bipartite_entropy=bipartite,
            pairwise_concurrence=concurrence,
            is_separable=separable,
        )


# ---------------------------------------------------------------------------
# 12b. Debugger State Inspector + per-qubit noise heatmap
# ---------------------------------------------------------------------------

@dataclass
class InspectorRow:
    """One basis state in the debugger's State Inspector table."""

    index: int
    bitstring: str
    real: float
    imag: float
    probability: float
    ideal_probability: float | None
    delta: float | None          # actual - ideal probability


class DebuggerInspectorModel:
    """Data behind the debugger's State Inspector sub-tab and the
    per-qubit noise heatmap (the reference renders these in
    ``debugger_panel.py:286-520``; here the computation is headless and
    unit-tested, the panel just draws the rows/matrix)."""

    @staticmethod
    def amplitude_rows(snapshot, limit: int = 64,
                       threshold: float = 1e-9) -> list[InspectorRow]:
        """Top-probability basis states of the snapshot, actual vs ideal."""
        if snapshot is None:
            return []
        amps = snapshot.state.data
        probs = np.abs(amps) ** 2
        ideal = None
        if snapshot.ideal_state is not None:
            ideal = np.abs(snapshot.ideal_state.data) ** 2
        n = snapshot.state.num_qubits
        order = np.argsort(probs)[::-1]
        rows = []
        for i in order[:limit]:
            p = float(probs[i])
            ip = float(ideal[i]) if ideal is not None else None
            if p < threshold and (ip is None or ip < threshold):
                continue
            rows.append(InspectorRow(
                index=int(i),
                bitstring=format(int(i), f"0{n}b"),
                real=float(amps[i].real),
                imag=float(amps[i].imag),
                probability=p,
                ideal_probability=ip,
                delta=(p - ip) if ip is not None else None,
            ))
        return rows

    @staticmethod
    def noise_heatmap(impacts) -> np.ndarray:
        """(num_qubits, num_columns) per-qubit fidelity DROP matrix from
        ``CircuitDebugger.compute_noise_impact`` results."""
        if not impacts:
            return np.zeros((0, 0))
        mat = np.array([imp.per_qubit_fidelity for imp in impacts],
                       dtype=np.float64).T        # (n, C)
        return 1.0 - mat

    @staticmethod
    def heatmap_column_overlay(attribution) -> list[str]:
        """Per-column attribution labels ('12%', '—' for recovery) to
        overlay on the heatmap."""
        if attribution is None:
            return []
        out = []
        rec = attribution.is_recovery or [False] * len(
            attribution.column_attribution_pct)
        for pct, recovery in zip(attribution.column_attribution_pct, rec):
            out.append("—" if recovery else f"{pct:.0f}%")
        return out


# ---------------------------------------------------------------------------
# 13. Resource monitor
# ---------------------------------------------------------------------------

@dataclass
class ResourceSample:
    timestamp: float
    cpu_percent: float
    rss_bytes: int
    system_memory_percent: float


@dataclass
class SimulationTiming:
    label: str
    num_qubits: int
    elapsed_s: float
    timestamp: float = field(default_factory=time.time)


class ResourceMonitorModel:
    """Process CPU/RSS sampling + simulation timing records + the
    simulator-comparison memory table (resource monitor panel).

    Prefers psutil; without it, falls back to /proc readers (the
    portable analog of the reference's Windows-ctypes fallback,
    /root/reference/quantum_sim/gui/panels/resource_monitor.py:42-141)
    so ``sample()`` still returns real numbers on Linux.
    """

    def __init__(self, history_seconds: float = 120.0):
        self._history_seconds = history_seconds
        self.samples: list[ResourceSample] = []
        self.timings: list[SimulationTiming] = []
        self._last_cpu: tuple[float, float] | None = None  # (wall, cpu_s)
        try:
            import psutil

            self._proc = psutil.Process()
            self._psutil = psutil
        except ImportError:  # pragma: no cover
            self._proc = None
            self._psutil = None

    # --- /proc fallback readers ------------------------------------------

    @staticmethod
    def _proc_rss_bytes() -> int:
        """Resident set size from /proc/self/statm (field 2, pages)."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return 0

    @staticmethod
    def _proc_meminfo_percent() -> float:
        """System memory use from /proc/meminfo (1 - Available/Total)."""
        try:
            fields = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    fields[key] = int(rest.split()[0])  # kB
            total = fields["MemTotal"]
            avail = fields.get(
                "MemAvailable", fields.get("MemFree", 0))
            return 100.0 * (1.0 - avail / total) if total else 0.0
        except (OSError, ValueError, KeyError, IndexError):
            return 0.0

    def _proc_cpu_percent(self) -> float:
        """Process CPU%% between consecutive calls, from os.times()
        (utime+stime deltas over wall time, like psutil's estimator).
        First call primes the baseline and reports 0.0."""
        t = os.times()
        now = time.monotonic()
        cpu_s = t.user + t.system
        if self._last_cpu is None:
            self._last_cpu = (now, cpu_s)
            return 0.0
        wall0, cpu0 = self._last_cpu
        self._last_cpu = (now, cpu_s)
        dt = now - wall0
        return 100.0 * (cpu_s - cpu0) / dt if dt > 0 else 0.0

    def sample(self) -> ResourceSample | None:
        if self._proc is not None:
            s = ResourceSample(
                timestamp=time.time(),
                cpu_percent=self._proc.cpu_percent(interval=None),
                rss_bytes=self._proc.memory_info().rss,
                system_memory_percent=self._psutil.virtual_memory().percent,
            )
        elif os.path.exists("/proc/self/statm"):
            s = ResourceSample(
                timestamp=time.time(),
                cpu_percent=self._proc_cpu_percent(),
                rss_bytes=self._proc_rss_bytes(),
                system_memory_percent=self._proc_meminfo_percent(),
            )
        else:
            # No psutil and no /proc (macOS/Windows): report
            # unavailable rather than fabricated zeros.
            return None
        self.samples.append(s)
        cutoff = s.timestamp - self._history_seconds
        self.samples = [x for x in self.samples if x.timestamp >= cutoff]
        return s

    def record_simulation(self, label: str, num_qubits: int,
                          elapsed_s: float) -> None:
        self.timings.append(SimulationTiming(label, num_qubits, elapsed_s))

    @staticmethod
    def statevector_bytes(n_qubits: int, bytes_per_amp: int = 8) -> int:
        """complex64 on device (the reference assumes complex128 = 16 B)."""
        return (2**n_qubits) * bytes_per_amp

    @staticmethod
    def max_qubits_for_ram(ram_bytes: int, mode: str = "sv",
                           bytes_per_amp: int = 8) -> int:
        n = 1
        if mode == "dm":
            while (2 ** (2 * n)) * bytes_per_amp < ram_bytes:
                n += 1
        else:
            while (2**n) * bytes_per_amp < ram_bytes:
                n += 1
        return n - 1

    @classmethod
    def comparison_table(cls, ram_bytes: int | None = None
                         ) -> list[dict[str, object]]:
        """Max-qubit comparison: this engine (complex64 statevector) vs
        density-matrix sims, in ``ram_bytes`` (default: the device memory
        budget, ``config.device_memory_budget``)."""
        if ram_bytes is None:
            from .config import device_memory_budget

            ram_bytes = device_memory_budget()
        sv_max = cls.max_qubits_for_ram(ram_bytes, "sv")
        dm_max = cls.max_qubits_for_ram(ram_bytes, "dm")
        return [
            {"simulator": "This (statevector, sharded)",
             "method": "State Vector", "max_qubits": sv_max,
             "memory_bytes": cls.statevector_bytes(sv_max),
             "note": "scales further with mesh sharding"},
            {"simulator": "Density-matrix simulators",
             "method": "Density Matrix", "max_qubits": dm_max,
             "memory_bytes": (2 ** (2 * dm_max)) * 8,
             "note": "2^2n scaling"},
            {"simulator": "This (Clifford tableau engine)",
             "method": "Stabilizer Tableau", "max_qubits": 4096,
             # x and z bit planes (2n x n int32 each) + sign column
             "memory_bytes": 2 * (2 * 4096) * 4096 * 4 + 2 * 4096 * 4,
             "note": "O(n^2) bits — Clifford circuits only "
                     "(clifford.CliffordSimulator)"},
        ]
