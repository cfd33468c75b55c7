"""Qt panel widgets: thin views over the headless view-models.

Mirrors the reference's 13 visualization panels
(``/root/reference/quantum_sim/gui/panels/``). Each widget delegates its
computation to ``quantum_simulator_tpu.viewmodels`` (tested headless) and
only renders.
"""

from __future__ import annotations

import numpy as np
from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
from matplotlib.figure import Figure
from PyQt6.QtCore import Qt, QTimer
from PyQt6.QtWidgets import (
    QComboBox,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSpinBox,
    QTableWidget,
    QTableWidgetItem,
    QTextBrowser,
    QVBoxLayout,
    QWidget,
)

from ..measurement import MeasurementBasis
from ..viewmodels import (
    AnalysisDashboardModel,
    BlochModel,
    DensityMatrixModel,
    EntanglementGraphModel,
    EntropyEvolutionModel,
    FidelitySweepModel,
    HistogramModel,
    ResourceMonitorModel,
    StateVectorModel,
)


class _CanvasPanel(QWidget):
    """Base: a matplotlib canvas with an optional control row."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self._layout = QVBoxLayout(self)
        self.controls = QHBoxLayout()
        self._layout.addLayout(self.controls)
        self.figure = Figure(figsize=(5, 3.2))
        self.canvas = FigureCanvasQTAgg(self.figure)
        self._layout.addWidget(self.canvas)

    def axes(self):
        self.figure.clear()
        return self.figure.add_subplot(111)

    def redraw(self):
        self.canvas.draw_idle()


class StateVectorPanel(QWidget):
    """Amplitude table with in-row probability bars and a nonzero filter
    (panel 1 — the reference uses a custom paint delegate for the bars,
    ``state_vector_panel.py:19-236``; a text bar renders everywhere)."""

    BAR_WIDTH = 12

    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        controls = QHBoxLayout()
        self.nonzero_check = QComboBox()
        self.nonzero_check.addItems(["Nonzero only", "All basis states"])
        self.nonzero_check.currentIndexChanged.connect(
            lambda _: self._replot())
        controls.addWidget(self.nonzero_check)
        controls.addStretch(1)
        layout.addLayout(controls)
        self.table = QTableWidget(0, 7)
        self.table.setHorizontalHeaderLabels(
            ["Basis", "Re", "Im", "|amp|", "Phase", "Prob", ""])
        layout.addWidget(self.table)
        self._last_state = None

    def update_state(self, state) -> None:
        self._last_state = state
        self._replot()

    def _replot(self) -> None:
        if self._last_state is None:
            return
        nonzero = self.nonzero_check.currentIndex() == 0
        rows = StateVectorModel.rows(self._last_state,
                                     nonzero_only=nonzero)
        self.table.setRowCount(len(rows))
        for r, row in enumerate(rows):
            bar = "█" * round(row.probability * self.BAR_WIDTH)
            values = [f"|{row.bitstring}⟩", f"{row.real:+.4f}",
                      f"{row.imag:+.4f}", f"{row.magnitude:.4f}",
                      f"{row.phase:+.3f}", f"{row.probability:.4f}", bar]
            for c, v in enumerate(values):
                item = QTableWidgetItem(v)
                item.setFlags(Qt.ItemFlag.ItemIsEnabled)
                self.table.setItem(r, c, item)


class BlochSpherePanel(_CanvasPanel):
    """Per-qubit Bloch spheres: grid view of every qubit or a single-qubit
    view with the step-mode trajectory drawn as a fading trail + purity
    and known-state readout (panel 2 — the reference's grid/single toggle
    and faded trajectory live in ``bloch_sphere.py:55-563``)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.model = BlochModel()
        self._last_state = None
        bar = QHBoxLayout()
        self.view_combo = QComboBox()
        self.view_combo.addItems(["Grid", "Single"])
        self.view_combo.currentIndexChanged.connect(self._replot)
        self.qubit_spin = QSpinBox()
        self.qubit_spin.setRange(0, 31)
        self.qubit_spin.valueChanged.connect(self._replot)
        self.info = QLabel("")
        for w in (QLabel("View:"), self.view_combo, QLabel("Qubit:"),
                  self.qubit_spin, self.info):
            bar.addWidget(w)
        bar.addStretch(1)
        self._layout.insertLayout(0, bar)

    @staticmethod
    def _wire_sphere(ax):
        u = np.linspace(0, 2 * np.pi, 24)
        v = np.linspace(0, np.pi, 12)
        ax.plot_wireframe(np.outer(np.cos(u), np.sin(v)),
                          np.outer(np.sin(u), np.sin(v)),
                          np.outer(np.ones_like(u), np.cos(v)),
                          color="gray", alpha=0.15, lw=0.5)

    def update_state(self, state) -> None:
        self._last_state = state
        self._replot()

    def _replot(self, *_args) -> None:
        state = self._last_state
        if state is None:
            return
        snaps = self.model.snapshot(state)
        self.figure.clear()
        if self.view_combo.currentText() == "Single":
            q = min(self.qubit_spin.value(), len(snaps) - 1)
            b = snaps[q]
            ax = self.figure.add_subplot(111, projection="3d")
            self._wire_sphere(ax)
            trail = self.model.faded_trajectory(q)
            for i in range(1, len(trail)):
                x0, y0, z0, _ = trail[i - 1]
                x1, y1, z1, a = trail[i]
                ax.plot([x0, x1], [y0, y1], [z0, z1],
                        color="#fab387", alpha=a, lw=1.5)
            ax.quiver(0, 0, 0, b.x, b.y, b.z, color="#89b4fa", lw=2.5)
            title = f"q{b.qubit}"
            if b.label:
                title += f"  {b.label}"
            ax.set_title(title, fontsize=10)
            ax.set_axis_off()
            self.info.setText(
                f"({b.x:+.3f}, {b.y:+.3f}, {b.z:+.3f})  "
                f"purity {b.purity:.4f}"
                + (f"  ≈ {b.label}" if b.label else ""))
        else:
            n = len(snaps)
            cols = min(4, n)
            rows = -(-n // cols)
            for i, b in enumerate(snaps):
                ax = self.figure.add_subplot(rows, cols, i + 1,
                                             projection="3d")
                self._wire_sphere(ax)
                ax.quiver(0, 0, 0, b.x, b.y, b.z, color="#89b4fa", lw=2)
                title = f"q{b.qubit}"
                if b.label:
                    title += f" {b.label}"
                ax.set_title(title, fontsize=8)
                ax.set_axis_off()
            self.info.setText("")
        self.redraw()


class HistogramPanel(_CanvasPanel):
    """Measurement histogram with basis + shots controls (panel 3)."""

    def __init__(self, on_run_requested=None, parent=None):
        super().__init__(parent)
        self.basis_combo = QComboBox()
        for b in MeasurementBasis:
            self.basis_combo.addItem(b.value, b)
        self.shots_spin = QSpinBox()
        self.shots_spin.setRange(1, 1_000_000)
        self.shots_spin.setValue(1024)
        run_btn = QPushButton("Run")
        if on_run_requested is not None:
            run_btn.clicked.connect(
                lambda: on_run_requested(self.shots_spin.value(),
                                         self.basis_combo.currentData()))
        self.display_combo = QComboBox()
        self.display_combo.addItems(["Probability", "Counts"])
        self.display_combo.currentIndexChanged.connect(
            lambda _: self._replot())
        for w in (QLabel("Basis:"), self.basis_combo, QLabel("Shots:"),
                  self.shots_spin, run_btn, self.display_combo):
            self.controls.addWidget(w)
        self.controls.addStretch(1)
        self._last_counts: dict[str, int] | None = None

    def update_counts(self, counts: dict[str, int]) -> None:
        self._last_counts = counts
        self._replot()

    def _replot(self) -> None:
        if not self._last_counts:
            return
        bars = HistogramModel.from_counts(self._last_counts)
        ax = self.axes()
        labels = [b for b, _, _ in bars]
        if self.display_combo.currentText() == "Counts":
            ax.bar(labels, [c for _, c, _ in bars], color="#89b4fa")
            ax.set_ylabel("Counts")
        else:
            ax.bar(labels, [p for _, _, p in bars], color="#89b4fa")
            ax.set_ylabel("Probability")
        ax.tick_params(axis="x", rotation=60, labelsize=7)
        self.redraw()


class DensityMatrixPanel(_CanvasPanel):
    """Density-matrix heatmap with ensemble mode (panel 4)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.model = DensityMatrixModel()
        self.mode_combo = QComboBox()
        self.mode_combo.addItems(["Re", "Im", "|rho|"])
        self.info_label = QLabel("")
        self.controls.addWidget(QLabel("Component:"))
        self.controls.addWidget(self.mode_combo)
        self.controls.addWidget(self.info_label)
        self.controls.addStretch(1)

    def _show(self, view) -> None:
        if view.truncated:
            self.info_label.setText(
                f"{view.num_qubits} qubits: display capped at 8")
            return
        comp = self.mode_combo.currentText()
        data = {"Re": view.real, "Im": view.imag,
                "|rho|": view.magnitude}[comp]
        ax = self.axes()
        im = ax.imshow(data, cmap="magma")
        self.figure.colorbar(im, ax=ax, fraction=0.046)
        self.info_label.setText(
            f"purity={view.purity:.4f}  S(rho)={view.entropy:.4f} bits")
        self.redraw()

    def update_state(self, state) -> None:
        self._show(DensityMatrixModel.from_state(state))

    def update_ensemble(self, circuit, noise_model, trials=50, seed=None,
                        exact: bool = False):
        """Noisy rho: Monte-Carlo ensemble, or the deterministic exact
        channel evolution (density.py) when ``exact`` and n <= 14."""
        from ..density import MAX_DM_QUBITS

        if exact and circuit.num_qubits <= MAX_DM_QUBITS:
            self._show(self.model.exact(circuit, noise_model))
        else:
            self._show(self.model.ensemble(circuit, noise_model, trials,
                                           seed))


class EntanglementPanel(_CanvasPanel):
    """Circular entanglement graph (panel 5)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.metric_combo = QComboBox()
        self.metric_combo.addItems(["mutual_information", "concurrence"])
        self.controls.addWidget(QLabel("Metric:"))
        self.controls.addWidget(self.metric_combo)
        self.controls.addStretch(1)

    def update_state(self, state) -> None:
        graph = EntanglementGraphModel.build(
            state, metric=self.metric_combo.currentText())
        ax = self.axes()
        xs = [p[0] for p in graph.positions]
        ys = [p[1] for p in graph.positions]
        max_w = max((w for _, _, w in graph.edges), default=1.0)
        for i, j, w in graph.edges:
            ax.plot([xs[i], xs[j]], [ys[i], ys[j]], color="#f38ba8",
                    lw=0.5 + 3.0 * w / max_w, alpha=0.8)
        ax.scatter(xs, ys, s=300, color="#89b4fa", zorder=3)
        for q, (x, y) in enumerate(graph.positions):
            ax.text(x, y, f"q{q}", ha="center", va="center", zorder=4)
        ax.set_aspect("equal")
        ax.axis("off")
        if graph.warning:
            ax.set_title(graph.warning, fontsize=8)
        self.redraw()


class EntropyPanel(_CanvasPanel):
    """Entropy evolution over steps (panel 6)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.model = EntropyEvolutionModel()
        self.mode_combo = QComboBox()
        self.mode_combo.addItems(
            ["Per-Qubit", "Bipartite", "Total", "Entanglement Events"])
        self.controls.addWidget(QLabel("Mode:"))
        self.controls.addWidget(self.mode_combo)
        self.controls.addStretch(1)

    def record_step(self, state, step_index: int) -> None:
        self.model.record_step(state, step_index)
        self.refresh()

    def reset(self) -> None:
        self.model.reset()

    def refresh(self) -> None:
        ax = self.axes()
        mode = self.mode_combo.currentText()
        steps = self.model.steps
        if mode == "Per-Qubit" and self.model.per_qubit:
            arr = np.array(self.model.per_qubit)
            for q in range(arr.shape[1]):
                ax.plot(steps, arr[:, q], label=f"q{q}")
            ax.legend(fontsize=7)
        elif mode == "Bipartite":
            ax.plot(steps, self.model.bipartite, color="#89b4fa")
        elif mode == "Total":
            ax.plot(steps, self.model.total, color="#a6e3a1")
        else:
            for ev in self.model.detector.get_timeline():
                ax.axvline(ev.step, color="#f38ba8", alpha=0.6)
                ax.text(ev.step, 0.5, ev.event_type.value, rotation=90,
                        fontsize=7)
        ax.set_xlabel("Step")
        ax.set_ylabel("Entropy (bits)")
        self.redraw()


class FidelityPanel(_CanvasPanel):
    """Noise-sweep fidelity/purity curves (panel 7)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.trials_spin = QSpinBox()
        self.trials_spin.setRange(1, 500)
        self.trials_spin.setValue(50)
        self.controls.addWidget(QLabel("Trials:"))
        self.controls.addWidget(self.trials_spin)
        self.controls.addStretch(1)

    def run_sweep(self, circuit, probabilities=None, seed=None) -> None:
        probs = probabilities if probabilities is not None else \
            np.linspace(0.0, 0.3, 13).tolist()
        points = FidelitySweepModel.sweep(
            circuit, probs, trials=self.trials_spin.value(), seed=seed)
        ax = self.axes()
        ax.plot([p.noise_prob for p in points],
                [p.fidelity for p in points], "-o", label="fidelity",
                color="#89b4fa")
        ax.plot([p.noise_prob for p in points],
                [p.purity for p in points], "-s", label="purity",
                color="#a6e3a1")
        ax.axhline(0.99, ls="--", color="gray", lw=0.8)
        ax.axhline(2 / 3, ls=":", color="gray", lw=0.8)
        ax.set_xlabel("Noise probability")
        ax.legend(fontsize=8)
        self.redraw()


class AnalysisPanel(QWidget):
    """Summary metrics dashboard (panel 8)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        self.browser = QTextBrowser()
        layout.addWidget(self.browser)

    def update_state(self, state, reference_manager=None) -> None:
        d = AnalysisDashboardModel.build(state, reference_manager)
        lines = [
            f"<b>Purity:</b> {d.purity:.6f}",
            f"<b>Entropy:</b> {d.entropy:.6f} bits",
            f"<b>Nonzero amplitudes:</b> {d.nonzero_amplitudes}",
            f"<b>Bipartite entropy:</b> {d.bipartite_entropy:.4f} bits",
            f"<b>Separable:</b> {d.is_separable}",
        ]
        if d.fidelity_to_reference is not None:
            lines.insert(0, "<b>Fidelity vs reference:</b> "
                            f"{d.fidelity_to_reference:.6f}")
        lines.append("<b>Per-qubit Pauli:</b>")
        for q, vals in d.per_qubit_pauli.items():
            lines.append(
                f"&nbsp;&nbsp;{q}: X={vals['X']:+.3f} Y={vals['Y']:+.3f} "
                f"Z={vals['Z']:+.3f}")
        if d.pairwise_concurrence:
            lines.append("<b>Concurrence:</b> " + ", ".join(
                f"{k}={v:.3f}" for k, v in d.pairwise_concurrence.items()))
        self.browser.setHtml("<br>".join(lines))


class ResourceMonitorPanel(_CanvasPanel):
    """CPU/RSS monitor + simulator comparison (panel 13)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.model = ResourceMonitorModel()
        self.info = QTextBrowser()
        self._layout.addWidget(self.info)
        self._timer = QTimer(self)
        self._timer.timeout.connect(self._tick)
        self._timer.start(1000)
        from ..config import device_memory_budget

        budget = device_memory_budget()
        rows = self.model.comparison_table(budget)
        html = [f"<b>Max qubits in {budget / 2**30:.1f} GiB (the device "
                "memory budget):</b>"]
        for r in rows:
            html.append(f"{r['simulator']}: {r['max_qubits']} qubits "
                        f"({r['note']})")
        self.info.setHtml("<br>".join(html))

    def record_simulation(self, label, num_qubits, elapsed_s):
        self.model.record_simulation(label, num_qubits, elapsed_s)

    def _tick(self) -> None:
        self.model.sample()
        if not self.model.samples:
            return
        ax = self.axes()
        ts = [s.timestamp - self.model.samples[0].timestamp
              for s in self.model.samples]
        ax.plot(ts, [s.cpu_percent for s in self.model.samples],
                label="CPU %", color="#89b4fa")
        ax.plot(ts, [s.rss_bytes / 2**20 for s in self.model.samples],
                label="RSS MiB", color="#a6e3a1")
        ax.legend(fontsize=7)
        ax.set_xlabel("s")
        self.redraw()
