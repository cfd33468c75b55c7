"""Main application window: circuit view + tabbed panels + run pipeline.

Parity target: ``/root/reference/quantum_sim/gui/main_window.py:170-2063``
(menus/toolbar/status bar, tabbed visualization panels, run pipeline that
stores the ideal reference before an optional noisy run, step mode feeding
entropy/Bloch trajectories, noise dialog, seed dialog, experiment
export/import, benchmark runner, bridge toggle, theme switch, reference
invalidation on circuit change).
"""

from __future__ import annotations

import time

from PyQt6.QtCore import QTimer
from PyQt6.QtGui import QAction, QKeySequence
from PyQt6.QtWidgets import (
    QFileDialog,
    QInputDialog,
    QMainWindow,
    QMessageBox,
    QSplitter,
    QTabWidget,
)
from PyQt6.QtCore import Qt

from ..bridge import BridgeServer
from ..circuit import QuantumCircuit
from ..controller import CircuitController, SimulationController
from ..reference import ReferenceManager
from ..render import CircuitExporter
from ..simulator import Simulator
from ..utils.experiment import ExperimentConfig
from ..utils.seeding import SeedManager
from ..utils.serialization import CircuitSerializer
from ..utils.appconfig import AppConfig
from .advanced_panels import (
    ComparisonPanel,
    DebuggerPanel,
    OptimizerPanel,
    QECPanel,
)
from .editor_model import CircuitEditorModel
from .editor_scene import CircuitEditorView, CircuitScene, TargetDialog
from .dialogs import (
    AboutDialog,
    AlgorithmDialog,
    CustomGateDialog,
    GateParamDialog,
    NoiseConfigDialog,
)
from .panels import (
    AnalysisPanel,
    BlochSpherePanel,
    DensityMatrixPanel,
    EntanglementPanel,
    EntropyPanel,
    FidelityPanel,
    HistogramPanel,
    ResourceMonitorPanel,
    StateVectorPanel,
)
from .themes.theme_manager import ThemeManager


class MainWindow(QMainWindow):
    """Application shell wiring controllers, panels, and the bridge."""

    def __init__(self, config: AppConfig | None = None):
        super().__init__()
        self.setWindowTitle("Quantum Simulator")
        self.config = config or AppConfig.load()
        self.resize(self.config.window_width, self.config.window_height)

        self.seed_manager = SeedManager(42)
        self.reference_manager = ReferenceManager()
        self.noise_model = None
        self.last_result = None

        self.circuit_controller = CircuitController(
            QuantumCircuit(self.config.default_qubits))
        self.sim_controller = SimulationController()
        self.theme_manager = ThemeManager(self.config.theme)
        self.bridge_server: BridgeServer | None = None

        self._build_ui()
        self._build_menus()
        self._build_toolbar()
        self.circuit_controller.on_circuit_changed(self._on_circuit_changed)
        self.statusBar().showMessage("Ready")

    def _build_toolbar(self) -> None:
        from PyQt6.QtWidgets import QLabel, QSpinBox, QToolBar

        bar = QToolBar("Main")
        self.addToolBar(bar)
        bar.addAction("Run", self._on_run_simulation)
        bar.addAction("Step", self._on_step_mode)
        bar.addAction("Debug", self._on_debug_circuit)
        bar.addSeparator()
        bar.addWidget(QLabel(" Qubits: "))
        self.qubit_spin = QSpinBox()
        self.qubit_spin.setRange(1, self.config.max_qubits)
        self.qubit_spin.setValue(self.circuit_controller.circuit.num_qubits)
        self.qubit_spin.valueChanged.connect(
            self.circuit_controller.set_qubit_count)
        bar.addWidget(self.qubit_spin)
        bar.addSeparator()
        self.noise_indicator = QLabel(" noise: off ")
        bar.addWidget(self.noise_indicator)

    def _refresh_noise_indicator(self) -> None:
        if self.noise_model is None or not self.noise_model.has_noise():
            self.noise_indicator.setText(" noise: off ")
        else:
            names = [type(ch).__name__.replace("Noise", "")
                     for ch in self.noise_model.global_channels]
            self.noise_indicator.setText(
                " noise: " + (", ".join(names) or "per-gate") + " ")

    # --- UI construction ---------------------------------------------------

    def _build_ui(self) -> None:
        splitter = QSplitter(Qt.Orientation.Vertical)
        self.editor_model = CircuitEditorModel(self.circuit_controller)
        self.circuit_scene = CircuitScene(self.editor_model)
        self.circuit_view = CircuitEditorView(self.circuit_scene)
        splitter.addWidget(self.circuit_view)
        self.circuit_scene.gate_activated.connect(self._edit_gate_params)

        self.tabs = QTabWidget()
        self.statevector_panel = StateVectorPanel()
        self.bloch_panel = BlochSpherePanel()
        self.histogram_panel = HistogramPanel(
            on_run_requested=self._run_with_shots)
        self.density_panel = DensityMatrixPanel()
        self.entanglement_panel = EntanglementPanel()
        self.entropy_panel = EntropyPanel()
        self.fidelity_panel = FidelityPanel()
        self.analysis_panel = AnalysisPanel()
        self.debugger_panel = DebuggerPanel()
        self.comparison_panel = ComparisonPanel()
        self.optimizer_panel = OptimizerPanel(
            circuit_supplier=lambda: self.circuit_controller.circuit)
        self.qec_panel = QECPanel()
        self.resource_panel = ResourceMonitorPanel()
        for name, panel in [
            ("State Vector", self.statevector_panel),
            ("Bloch", self.bloch_panel),
            ("Histogram", self.histogram_panel),
            ("Density Matrix", self.density_panel),
            ("Entanglement", self.entanglement_panel),
            ("Entropy", self.entropy_panel),
            ("Fidelity", self.fidelity_panel),
            ("Analysis", self.analysis_panel),
            ("Debugger", self.debugger_panel),
            ("Comparison", self.comparison_panel),
            ("Optimizer", self.optimizer_panel),
            ("QEC", self.qec_panel),
            ("Resources", self.resource_panel),
        ]:
            self.tabs.addTab(panel, name)
        splitter.addWidget(self.tabs)
        splitter.setSizes([400, 500])
        self.setCentralWidget(splitter)

        # Docks: gate palette (left) + properties editor (right).
        from PyQt6.QtWidgets import QDockWidget

        from .docks import GatePalette, PropertiesPanel

        self.gate_palette = GatePalette()
        palette_dock = QDockWidget("Gates", self)
        palette_dock.setWidget(self.gate_palette)
        self.addDockWidget(Qt.DockWidgetArea.LeftDockWidgetArea,
                           palette_dock)
        self.gate_palette.gate_chosen.connect(self._select_palette_gate)

        self.properties_panel = PropertiesPanel()
        props_dock = QDockWidget("Properties", self)
        props_dock.setWidget(self.properties_panel)
        self.addDockWidget(Qt.DockWidgetArea.RightDockWidgetArea,
                           props_dock)
        self.circuit_scene.selection_changed_gates.connect(
            lambda gates: self.properties_panel.set_gate(
                gates[0] if gates else None,
                self.circuit_controller.circuit.num_qubits))
        self.properties_panel.params_changed.connect(
            self.circuit_controller.update_gate_params)
        self.properties_panel.targets_changed.connect(
            self._on_targets_edited)

    def _select_palette_gate(self, name: str) -> None:
        """Palette click: place the gate at the next free column (drag
        onto a specific wire for precise placement)."""
        model = self.editor_model
        column = model.num_columns()
        plan = model.plan_drop(name, model.column_x(column),
                               model.qubit_y(0))
        if not plan.valid:
            self.statusBar().showMessage(f"Cannot place {name}: "
                                         f"{plan.reason}")
            return
        targets = None
        if plan.needs_target_dialog:
            dialog = TargetDialog(name, plan.targets,
                                  model.circuit.num_qubits, self)
            if not dialog.exec():
                return
            targets = dialog.targets()
        model.commit_drop(plan, targets)

    def _on_targets_edited(self, gate, targets) -> None:
        """Properties-panel target edits get the same duplicate/occupancy
        validation as drops and drags."""
        if len(set(targets)) != len(targets):
            self.statusBar().showMessage("Target qubits must be distinct")
            return
        n = self.circuit_controller.circuit.num_qubits
        if not all(0 <= q < n for q in targets):
            self.statusBar().showMessage("Target qubit out of range")
            return
        if not self.editor_model.cell_free(gate.column, targets,
                                           exclude=gate):
            self.statusBar().showMessage("Cell already occupied")
            return
        self.circuit_controller.move_gate(gate, gate.column, list(targets))

    def _edit_gate_params(self, gate) -> None:
        """Double-clicked gate: parameter dialog -> undoable update."""
        from ..registry import GateRegistry

        gate_def = GateRegistry.instance().get(gate.gate_name)
        if gate_def.num_params == 0:
            return
        dialog = GateParamDialog(gate_def, list(gate.params), self)
        if dialog.exec():
            self.circuit_controller.update_gate_params(
                gate, dialog.values())

    def _build_menus(self) -> None:
        def act(menu, text, slot, shortcut=None):
            action = QAction(text, self)
            action.triggered.connect(slot)
            if shortcut:
                action.setShortcut(QKeySequence(shortcut))
            menu.addAction(action)
            return action

        file_menu = self.menuBar().addMenu("&File")
        act(file_menu, "Open circuit…", self._open_circuit, "Ctrl+O")
        act(file_menu, "Save circuit…", self._save_circuit, "Ctrl+S")
        self.recent_menu = file_menu.addMenu("Open recent")
        self._rebuild_recent_menu()
        act(file_menu, "Export PNG…", lambda: self._export_image("png"))
        act(file_menu, "Export SVG…", lambda: self._export_image("svg"))
        file_menu.addSeparator()
        act(file_menu, "Export experiment…", self._export_experiment)
        act(file_menu, "Import experiment…", self._import_experiment)
        file_menu.addSeparator()
        act(file_menu, "Quit", self.close, "Ctrl+Q")

        edit_menu = self.menuBar().addMenu("&Edit")
        act(edit_menu, "Undo", self.circuit_controller.undo, "Ctrl+Z")
        act(edit_menu, "Redo", self.circuit_controller.redo, "Ctrl+Y")
        act(edit_menu, "Custom gate…", self._custom_gate)

        run_menu = self.menuBar().addMenu("&Run")
        act(run_menu, "Run simulation", self._on_run_simulation, "F5")
        act(run_menu, "Step mode", self._on_step_mode, "F6")
        act(run_menu, "Debug circuit", self._on_debug_circuit, "F7")
        act(run_menu, "Configure noise…", self._configure_noise)
        act(run_menu, "Set seed…", self._set_seed)
        act(run_menu, "Run benchmarks", self._run_benchmarks)

        tools_menu = self.menuBar().addMenu("&Tools")
        act(tools_menu, "Algorithm templates…", self._algorithm_dialog)
        self.bridge_action = act(tools_menu, "Start bridge server",
                                 self._toggle_bridge)
        act(tools_menu, "Toggle theme", self._toggle_theme)

        help_menu = self.menuBar().addMenu("&Help")
        act(help_menu, "About", lambda: AboutDialog(self).exec())

    # --- run pipeline -------------------------------------------------------

    def _on_run_simulation(self) -> None:
        self._run_with_shots(self.config.default_shots)

    def _run_with_shots(self, shots: int, basis=None) -> None:
        from ..measurement import MeasurementBasis

        circuit = self.circuit_controller.circuit
        basis = basis or MeasurementBasis.Z
        rng = self.seed_manager.create_child_rng()
        t0 = time.perf_counter()
        try:
            # Ideal pass first: establishes the fidelity reference.
            ideal = Simulator().run(circuit, shots=0, rng=rng)
            self.reference_manager.store(
                ideal.final_state, circuit_hash=circuit.circuit_hash())
            if self.noise_model is not None:
                sim = Simulator(noise_model=self.noise_model)
                result = sim.run_with_noise(circuit, shots=shots,
                                            rng=rng)
                display_state = ideal.final_state
            else:
                result = Simulator().run(circuit, shots=shots, rng=rng,
                                         measurement_basis=basis)
                display_state = result.final_state
        except Exception as e:  # noqa: BLE001
            QMessageBox.critical(self, "Simulation error", str(e))
            return
        elapsed = time.perf_counter() - t0
        self.last_result = result
        self.resource_panel.record_simulation(
            "run", circuit.num_qubits, elapsed)
        self._update_panels(display_state, result.measurement_counts)
        self.statusBar().showMessage(
            f"Run complete in {elapsed*1000:.1f} ms "
            f"({shots} shots, n={circuit.num_qubits})")

    def _on_debug_circuit(self) -> None:
        """Populate the debugger panel (snapshots, attribution, heatmap),
        sharing the editor's breakpoint set."""
        circuit = self.circuit_controller.circuit
        self.debugger_panel.breakpoints = set(self.editor_model.breakpoints)
        try:
            seed = self.seed_manager.seed
            self.debugger_panel.run_debug(
                circuit, self.noise_model,
                seed=seed if seed is not None else 42)
        except Exception as e:  # noqa: BLE001
            QMessageBox.critical(self, "Debug error", str(e))
            return
        self.tabs.setCurrentWidget(self.debugger_panel)
        self.statusBar().showMessage("Debug running…")

    def _on_step_mode(self) -> None:
        circuit = self.circuit_controller.circuit
        self.entropy_panel.reset()
        self.bloch_panel.model.reset()
        steps = list(Simulator(noise_model=self.noise_model)
                     .run_step_by_step(circuit))
        self._step_iter = iter(steps)
        self._step_timer = QTimer(self)
        self._step_timer.setInterval(max(1, self.config.step_delay_ms))
        self._step_timer.timeout.connect(self._advance_step)
        self._step_timer.start()

    def _advance_step(self) -> None:
        try:
            state, col = next(self._step_iter)
        except StopIteration:
            self._step_timer.stop()
            self.statusBar().showMessage("Step mode complete")
            return
        self.entropy_panel.record_step(state, col)
        self.bloch_panel.model.record_step(state)
        self.bloch_panel.update_state(state)
        self.editor_model.set_debug_column(col if col >= 0 else None)
        self.circuit_scene.rebuild()
        self.statusBar().showMessage(f"Step: column {col}")

    def _update_panels(self, state, counts) -> None:
        self.statevector_panel.update_state(state)
        self.bloch_panel.update_state(state)
        if counts:
            self.histogram_panel.update_counts(counts)
        self.density_panel.update_state(state)
        self.entanglement_panel.update_state(state)
        self.analysis_panel.update_state(state, self.reference_manager)

    def _on_circuit_changed(self) -> None:
        if self.bridge_server is not None and self.bridge_server.is_running:
            # the controller may have swapped in a NEW circuit object
            self.bridge_server.handler.set_circuit(
                self.circuit_controller.circuit)
        invalidated = self.reference_manager.check_invalidation(
            self.circuit_controller.circuit.circuit_hash())
        if invalidated:
            self.statusBar().showMessage(
                "Circuit changed: fidelity reference invalidated")

    # --- dialogs & actions ---------------------------------------------------

    def _configure_noise(self) -> None:
        dialog = NoiseConfigDialog(self.noise_model, self)
        if dialog.exec():
            self.noise_model = dialog.build_noise_model()
            self._refresh_noise_indicator()
            if (self.bridge_server is not None
                    and self.bridge_server.is_running):
                self.bridge_server.handler.set_noise_model(self.noise_model)

    def _set_seed(self) -> None:
        current = self.seed_manager.seed
        seed, ok = QInputDialog.getInt(
            self, "Seed", "Master seed:",
            current if current is not None else 42)
        if ok:
            self.seed_manager.set_seed(seed)

    def _algorithm_dialog(self) -> None:
        dialog = AlgorithmDialog(self)
        if dialog.exec():
            self.circuit_controller.circuit = dialog.build_circuit()

    def _custom_gate(self) -> None:
        CustomGateDialog(self).exec()
        self.gate_palette.refresh()
        self.circuit_scene.rebuild()

    def _run_benchmarks(self) -> None:
        from ..benchmarks import BenchmarkSuite

        results = BenchmarkSuite.run_all(noise_model=self.noise_model,
                                         seed=42)
        lines = [f"{'✔' if r.passed else '✘'} {r.name}: {r.details}"
                 for r in results]
        QMessageBox.information(self, "Benchmarks", "\n".join(lines))

    def _toggle_bridge(self) -> None:
        if self.bridge_server is None or not self.bridge_server.is_running:
            self.bridge_server = BridgeServer()
            self.bridge_server.handler.set_circuit(
                self.circuit_controller.circuit)
            self.bridge_server.handler.set_noise_model(self.noise_model)
            self.bridge_server.start()
            self.bridge_action.setText("Stop bridge server")
            self.statusBar().showMessage(
                f"Bridge listening on port {self.bridge_server.port}")
        else:
            self.bridge_server.stop()
            self.bridge_action.setText("Start bridge server")
            self.statusBar().showMessage("Bridge stopped")

    def _toggle_theme(self) -> None:
        from PyQt6.QtWidgets import QApplication

        theme = self.theme_manager.toggle(QApplication.instance())
        self.config.theme = theme
        self.circuit_scene.rebuild()

    # --- files -----------------------------------------------------------------

    def _rebuild_recent_menu(self) -> None:
        self.recent_menu.clear()
        for path in self.config.recent_files:
            action = QAction(path, self)
            action.triggered.connect(
                lambda _, p=path: self._open_recent(p))
            self.recent_menu.addAction(action)
        self.recent_menu.setEnabled(bool(self.config.recent_files))

    def _open_recent(self, path: str) -> None:
        try:
            self.circuit_controller.circuit = CircuitSerializer.load(path)
        except Exception as e:  # corrupt/invalid file must not kill the app
            QMessageBox.warning(self, "Open circuit", f"{path}:\n{e}")
            return
        self.config.add_recent_file(path)
        self._rebuild_recent_menu()

    def _open_circuit(self) -> None:
        path, _ = QFileDialog.getOpenFileName(
            self, "Open circuit", self.config.last_directory,
            "Circuits (*.qsim *.json)")
        if path:
            self._open_recent(path)

    def _save_circuit(self) -> None:
        path, _ = QFileDialog.getSaveFileName(
            self, "Save circuit", self.config.last_directory,
            "Circuits (*.qsim *.json)")
        if path:
            CircuitSerializer.save(self.circuit_controller.circuit, path)
            self.config.add_recent_file(path)

    def _export_image(self, fmt: str) -> None:
        path, _ = QFileDialog.getSaveFileName(
            self, f"Export {fmt.upper()}", f"circuit.{fmt}",
            f"{fmt.upper()} (*.{fmt})")
        if not path:
            return
        if fmt == "png":
            CircuitExporter.export_png(self.circuit_controller.circuit,
                                       path, theme=self.config.theme)
        else:
            CircuitExporter.export_svg(self.circuit_controller.circuit,
                                       path, theme=self.config.theme)

    def _export_experiment(self) -> None:
        path, _ = QFileDialog.getSaveFileName(
            self, "Export experiment", "experiment.json", "JSON (*.json)")
        if not path:
            return
        cfg = ExperimentConfig.from_current(
            self.circuit_controller.circuit,
            noise_model=self.noise_model,
            seed=self.seed_manager.seed,
            shots=self.config.default_shots,
            result=self.last_result,
        )
        cfg.save(path)

    def _import_experiment(self) -> None:
        from ..noise import NoiseModel

        path, _ = QFileDialog.getOpenFileName(
            self, "Import experiment", "", "JSON (*.json)")
        if not path:
            return
        cfg = ExperimentConfig.load(path)
        if cfg.circuit:
            self.circuit_controller.circuit = QuantumCircuit.from_dict(
                cfg.circuit)
        if cfg.noise_model:
            self.noise_model = NoiseModel.from_dict(cfg.noise_model)
        if cfg.seed is not None:
            self.seed_manager.set_seed(cfg.seed)

    def closeEvent(self, event) -> None:  # noqa: N802 - Qt naming
        self.config.window_width = self.width()
        self.config.window_height = self.height()
        try:
            self.config.save()
        except OSError:
            pass
        if self.bridge_server is not None:
            self.bridge_server.stop()
        super().closeEvent(event)
