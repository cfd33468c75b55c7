"""Async simulation runner: keeps the UI thread free during runs.

Parity target: ``/root/reference/quantum_sim/controller/simulation_controller.py:16-294``
(worker thread running full or step-by-step simulation, stop flag,
progress percentage, finished/step/error callbacks, join-with-timeout).
Plain ``threading`` instead of QThread; callbacks instead of signals.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..circuit import QuantumCircuit
from ..simulator import SimulationResult, Simulator
from ..state import StateVector


class SimulationController:
    """Runs simulations on a worker thread with observer callbacks."""

    def __init__(self):
        self._noise_model = None
        self._step_delay_ms = 0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        # Observer callbacks (a GUI connects its signals here).
        self.on_finished: Callable[[SimulationResult], None] | None = None
        self.on_step_updated: Callable[[StateVector, int], None] | None = None
        self.on_error: Callable[[str], None] | None = None
        self.on_progress: Callable[[int], None] | None = None

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def set_noise_model(self, noise_model) -> None:
        self._noise_model = noise_model

    def set_step_delay(self, delay_ms: int) -> None:
        self._step_delay_ms = max(0, int(delay_ms))

    # --- runs ------------------------------------------------------------

    def run_simulation(self, circuit: QuantumCircuit,
                       shots: int = 1024, seed: int | None = None) -> None:
        self._start(lambda: self._run_full(circuit, shots, seed))

    def run_step_by_step(self, circuit: QuantumCircuit,
                         shots: int = 1024,
                         seed: int | None = None) -> None:
        self._start(lambda: self._run_steps(circuit, shots, seed))

    def stop_simulation(self) -> None:
        self._stop_event.set()

    def join(self, timeout: float = 10.0) -> None:
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                # join timed out (e.g. a long first device compile in
                # flight): keep the handle, or is_running would lie and
                # _start would un-cancel this worker with a second one
                return
            self._thread = None

    # --- internals ----------------------------------------------------------

    def _start(self, target: Callable[[], None]) -> None:
        if self.is_running:
            raise RuntimeError("Simulation already running")
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._guarded, args=(target,),
                                        name="simulation-worker",
                                        daemon=True)
        self._thread.start()

    def _guarded(self, target: Callable[[], None]) -> None:
        try:
            target()
        except Exception as e:  # noqa: BLE001 - surfaced via callback
            if self.on_error is not None:
                self.on_error(str(e))

    def _run_full(self, circuit, shots, seed) -> None:
        sim = Simulator(noise_model=self._noise_model)
        if self.on_progress is not None:
            self.on_progress(10)
        if self._noise_model is not None and shots > 0:
            result = sim.run_with_noise(circuit, shots=shots, seed=seed)
        else:
            result = sim.run(circuit, shots=shots, seed=seed)
        if self.on_progress is not None:
            self.on_progress(100)
        if not self._stop_event.is_set() and self.on_finished is not None:
            self.on_finished(result)

    def _run_steps(self, circuit, shots, seed) -> None:
        import numpy as np

        sim = Simulator(noise_model=self._noise_model)
        total = max(1, circuit.depth() + 1)
        done = 0
        final_state = None
        rng = np.random.default_rng(seed) if seed is not None else None
        for state, col in sim.run_step_by_step(circuit, rng=rng):
            if self._stop_event.is_set():
                return
            if self.on_step_updated is not None:
                self.on_step_updated(state, col)
            done += 1
            if self.on_progress is not None:
                self.on_progress(min(99, int(100 * done / total)))
            final_state = state
            if self._step_delay_ms:
                time.sleep(self._step_delay_ms / 1000.0)
        result = SimulationResult(
            final_state=final_state,
            measurement_counts={},
            num_shots=shots,
            seed=seed,
        )
        if self.on_progress is not None:
            self.on_progress(100)
        if self.on_finished is not None:
            self.on_finished(result)
