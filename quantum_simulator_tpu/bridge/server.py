"""Live Bridge TCP server: 12-command JSON control API.

Parity target: ``/root/reference/quantum_sim/bridge/server.py:30-429``
(same 12 commands with the same param/response payloads: ping,
get_circuit, set_circuit, add_gate, clear_circuit, run, get_state,
get_result, set_noise, clear_noise, get_analysis, sweep_parameter;
reflection dispatch to ``_cmd_<action>``; multi-client newline framing).

Design differences: the event loop is a plain ``selectors`` thread (no
Qt); ``sweep_parameter`` evaluates all trials of a sweep point as one
batched trajectory launch instead of a Python loop per trial.
"""

from __future__ import annotations

import logging
import selectors
import socket
import threading
from types import SimpleNamespace

import jax
import numpy as np

from .protocol import DEFAULT_HOST, DEFAULT_PORT, BridgeMessage

logger = logging.getLogger(__name__)


class BridgeCommandHandler:
    """Processes bridge commands against a circuit/noise/result context."""

    def __init__(self):
        self._circuit = None
        self._noise_model = None
        self._last_result = None
        self._ideal_state = None

    # -- context setters (GUI or embedding app wires these) --

    def set_circuit(self, circuit):
        self._circuit = circuit
        self._invalidate()

    def _invalidate(self):
        """A circuit change orphans the last result and the fidelity
        reference (the circuit_hash-invalidation rule the GUI's
        ReferenceManager applies; the bridge context must match)."""
        self._last_result = None
        self._ideal_state = None

    def set_noise_model(self, noise_model):
        self._noise_model = noise_model

    def set_last_result(self, result):
        self._last_result = result

    def set_ideal_state(self, state):
        self._ideal_state = state

    # -- dispatch --

    def handle(self, msg: BridgeMessage) -> BridgeMessage:
        handler = getattr(self, f"_cmd_{msg.action}", None)
        if handler is None:
            return BridgeMessage.error_response(
                msg.id, f"Unknown action: {msg.action}")
        try:
            return handler(msg)
        except Exception as e:  # noqa: BLE001 - API returns errors
            logger.error("Bridge command '%s' failed: %s", msg.action, e,
                         exc_info=True)
            return BridgeMessage.error_response(msg.id, str(e))

    # -- commands --

    def _cmd_ping(self, msg: BridgeMessage) -> BridgeMessage:
        return BridgeMessage.ok_response(msg.id, {"pong": True})

    def _cmd_get_circuit(self, msg: BridgeMessage) -> BridgeMessage:
        if self._circuit is None:
            return BridgeMessage.error_response(msg.id, "No circuit loaded")
        return BridgeMessage.ok_response(msg.id, self._circuit.to_dict())

    def _cmd_set_circuit(self, msg: BridgeMessage) -> BridgeMessage:
        from ..circuit import QuantumCircuit

        circuit_dict = msg.params.get("circuit")
        if circuit_dict is None:
            return BridgeMessage.error_response(msg.id,
                                                "Missing 'circuit' param")
        self._circuit = QuantumCircuit.from_dict(circuit_dict)
        self._invalidate()
        return BridgeMessage.ok_response(msg.id, {
            "num_qubits": self._circuit.num_qubits,
            "gate_count": self._circuit.gate_count(),
        })

    def _cmd_add_gate(self, msg: BridgeMessage) -> BridgeMessage:
        from ..circuit import GateInstance

        if self._circuit is None:
            return BridgeMessage.error_response(msg.id, "No circuit loaded")
        p = msg.params
        self._circuit.add_gate(GateInstance(
            gate_name=p.get("gate_name", "H"),
            target_qubits=p.get("target_qubits", [0]),
            params=p.get("params", []),
            column=p.get("column", 0),
        ))
        self._invalidate()
        return BridgeMessage.ok_response(msg.id, {
            "gate_count": self._circuit.gate_count()})

    def _cmd_clear_circuit(self, msg: BridgeMessage) -> BridgeMessage:
        if self._circuit is None:
            return BridgeMessage.error_response(msg.id, "No circuit loaded")
        self._circuit.clear()
        self._invalidate()
        return BridgeMessage.ok_response(msg.id)

    def _cmd_run(self, msg: BridgeMessage) -> BridgeMessage:
        from ..simulator import Simulator

        if self._circuit is None:
            return BridgeMessage.error_response(msg.id, "No circuit loaded")
        shots = msg.params.get("shots", 1024)
        seed = msg.params.get("seed")
        engine = msg.params.get("engine", "statevector")

        if engine == "mps":
            # Wide-circuit extension (no reference analog): counts via
            # the bond-dimension-chi MPS engine — the bridge serves
            # 50+ qubit circuits where no dense state exists.
            # get_state stays statevector-only by design.
            from ..mps import MPSSimulator

            mps_sim = MPSSimulator(chi=int(msg.params.get("chi", 64)))
            if (self._noise_model is not None
                    and self._noise_model.has_channels() and shots > 0):
                counts, trunc = mps_sim.run_with_noise(
                    self._circuit, self._noise_model, shots=shots,
                    seed=seed)
            else:
                counts, state = mps_sim.run(
                    self._circuit, shots=shots, seed=seed,
                    readout_error=getattr(self._noise_model,
                                          "readout_error", None))
                trunc = state.truncation_weight
            # Keep get_result serving the LATEST run (final_state=None
            # marks "no dense state" for get_state/get_analysis).
            self._last_result = SimpleNamespace(
                measurement_counts=counts, num_shots=shots, seed=seed,
                final_state=None)
            return BridgeMessage.ok_response(msg.id, {
                "measurement_counts": counts,
                "num_shots": shots,
                "seed": seed,
                "engine": "mps",
                "truncation_weight": float(trunc),
            })
        if engine != "statevector":
            return BridgeMessage.error_response(
                msg.id, f"unknown engine {engine!r} "
                        "(statevector or mps)")

        sim = Simulator(noise_model=self._noise_model)
        if self._noise_model is not None and shots > 0:
            result = sim.run_with_noise(self._circuit, shots=shots,
                                        seed=seed)
        else:
            result = sim.run(self._circuit, shots=shots, seed=seed)

        self._last_result = result
        if self._noise_model is None:
            self._ideal_state = result.final_state

        return BridgeMessage.ok_response(msg.id, {
            "measurement_counts": result.measurement_counts,
            "num_shots": result.num_shots,
            "seed": result.seed,
        })

    def _cmd_get_state(self, msg: BridgeMessage) -> BridgeMessage:
        """Full state, or a window of it.

        Optional params ``offset``/``length`` return an amplitude window
        plus ``total`` (extension beyond the reference's always-full
        payload, ``/root/reference/quantum_sim/bridge/server.py:145-160``
        — a full n=24 JSON state is ~1 GiB; windows keep the newline-
        framed protocol usable at large n). No params = full state,
        byte-compatible with the reference."""
        if self._last_result is None:
            return BridgeMessage.error_response(msg.id,
                                                "No simulation result")
        sv = self._last_result.final_state
        if sv is None:
            return BridgeMessage.error_response(
                msg.id, "No dense state: the last run used the MPS "
                        "engine (counts via get_result)")
        total = 2 ** sv.num_qubits
        offset = int(msg.params.get("offset", 0))
        length = msg.params.get("length")
        if offset or length is not None:
            if not 0 <= offset < total:
                return BridgeMessage.error_response(
                    msg.id, f"offset {offset} out of range [0, {total})")
            length = total - offset if length is None else int(length)
            length = max(0, min(length, total - offset))
            from ..utils.xfer import to_host_complex

            # slice ON DEVICE: converting sv.data would transfer the
            # whole 2^n state per request, defeating the windowing
            window = to_host_complex(
                sv.device_data[offset:offset + length])
            return BridgeMessage.ok_response(msg.id, {
                "num_qubits": sv.num_qubits,
                "offset": offset,
                "total": total,
                "amplitudes": [{"re": float(a.real), "im": float(a.imag)}
                               for a in window],
                "probabilities": (np.abs(window) ** 2).tolist(),
            })
        data = sv.data
        amplitudes = [{"re": float(a.real), "im": float(a.imag)}
                      for a in data]
        return BridgeMessage.ok_response(msg.id, {
            "num_qubits": sv.num_qubits,
            "amplitudes": amplitudes,
            "probabilities": sv.probabilities.tolist(),
        })

    def _cmd_get_result(self, msg: BridgeMessage) -> BridgeMessage:
        if self._last_result is None:
            return BridgeMessage.error_response(msg.id,
                                                "No simulation result")
        r = self._last_result
        return BridgeMessage.ok_response(msg.id, {
            "measurement_counts": r.measurement_counts,
            "num_shots": r.num_shots,
            "seed": r.seed,
        })

    def _cmd_set_noise(self, msg: BridgeMessage) -> BridgeMessage:
        from ..noise import NoiseModel

        noise_dict = msg.params.get("noise_model")
        if noise_dict is None:
            return BridgeMessage.error_response(
                msg.id, "Missing 'noise_model' param")
        self._noise_model = NoiseModel.from_dict(noise_dict)
        return BridgeMessage.ok_response(msg.id)

    def _cmd_clear_noise(self, msg: BridgeMessage) -> BridgeMessage:
        self._noise_model = None
        return BridgeMessage.ok_response(msg.id)

    def _cmd_get_analysis(self, msg: BridgeMessage) -> BridgeMessage:
        from ..analysis import StateAnalysis

        if self._last_result is None:
            return BridgeMessage.error_response(msg.id,
                                                "No simulation result")
        state = self._last_result.final_state
        if state is None:
            return BridgeMessage.error_response(
                msg.id, "No dense state: the last run used the MPS "
                        "engine (counts via get_result)")
        metrics = msg.params.get("metrics",
                                 ["fidelity", "entropy", "purity"])
        data: dict = {}
        for m in metrics:
            if m == "fidelity" and self._ideal_state is not None:
                data["fidelity"] = StateAnalysis.process_fidelity(
                    self._ideal_state, state)
            elif m == "entropy":
                data["entropy"] = StateAnalysis.von_neumann_entropy(state)
            elif m == "purity":
                data["purity"] = StateAnalysis.purity(state)
            elif m == "pauli":
                data["pauli"] = {
                    f"q{q}": {
                        "X": StateAnalysis.pauli_expectation(state, "X", q),
                        "Y": StateAnalysis.pauli_expectation(state, "Y", q),
                        "Z": StateAnalysis.pauli_expectation(state, "Z", q),
                    }
                    for q in range(state.num_qubits)
                }
        return BridgeMessage.ok_response(msg.id, data)

    def _cmd_sweep_parameter(self, msg: BridgeMessage) -> BridgeMessage:
        """Depolarizing-noise sweep: fidelity + purity per value; every
        sweep point's trials run as ONE batched trajectory launch."""
        import jax.numpy as jnp

        from ..noise import DepolarizingNoise, NoiseModel
        from ..simulator import Simulator

        if self._circuit is None:
            return BridgeMessage.error_response(msg.id, "No circuit loaded")

        values = msg.params.get("values", [0.01, 0.05, 0.1])
        seed = msg.params.get("seed")
        trials = msg.params.get("trials", 50)
        try:
            n_trials = max(1, int(trials))
        except (TypeError, ValueError):
            n_trials = 50

        rng = np.random.default_rng(seed)
        ideal = Simulator().run(
            self._circuit, shots=0,
            rng=np.random.default_rng(rng.integers(0, 2**63))).final_state
        ideal_dev = ideal.device_data

        sweep_results = []
        for val in values:
            if float(val) == 0.0:
                sweep_results.append({"value": val, "fidelity": 1.0,
                                      "purity": 1.0})
                continue
            model = NoiseModel()
            model.add_global_noise(DepolarizingNoise(float(val)))
            sim = Simulator(noise_model=model)
            states = sim.trajectory_states(
                self._circuit, n_trials,
                seed=int(rng.integers(0, 2**63)))
            overlaps = jnp.einsum("d,td->t", jnp.conj(ideal_dev), states,
                                  precision=jax.lax.Precision.HIGHEST)
            fids = np.asarray(jnp.abs(overlaps) ** 2, dtype=np.float64)
            norms = np.asarray(jnp.sum(jnp.abs(states) ** 2, axis=1),
                               dtype=np.float64)
            sweep_results.append({
                "value": val,
                "fidelity": float(fids.mean()),
                "purity": float((norms**2).mean()),
                "trials": n_trials,
            })

        return BridgeMessage.ok_response(msg.id, {"sweep": sweep_results})


class BridgeServer:
    """Threaded selectors event loop serving BridgeCommandHandler.

    Multi-client, newline-framed; single worker thread so command handling
    is race-free by construction (SURVEY.md §5: keep the control plane
    single-threaded).
    """

    def __init__(self, handler: BridgeCommandHandler | None = None,
                 host: str = DEFAULT_HOST, port: int = DEFAULT_PORT):
        self.handler = handler or BridgeCommandHandler()
        self._host = host
        self._port = port
        self._selector: selectors.DefaultSelector | None = None
        self._server_sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = threading.Event()
        self._buffers: dict[int, bytes] = {}

    @property
    def port(self) -> int:
        return self._port

    @property
    def is_running(self) -> bool:
        return self._running.is_set()

    def start(self) -> None:
        if self._running.is_set():
            return
        self._server_sock = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
        self._server_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     1)
        self._server_sock.bind((self._host, self._port))
        # Ephemeral-port support for tests (port=0).
        self._port = self._server_sock.getsockname()[1]
        self._server_sock.listen(8)
        self._server_sock.setblocking(False)
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._server_sock, selectors.EVENT_READ,
                                data="accept")
        self._running.set()
        self._thread = threading.Thread(target=self._loop,
                                        name="bridge-server", daemon=True)
        self._thread.start()
        logger.info("Bridge server listening on %s:%d", self._host,
                    self._port)

    def stop(self) -> None:
        self._running.clear()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=3.0)
            if thread.is_alive():
                # A long command is still executing; the loop thread owns
                # the selector/sockets and will close them in its finally
                # block when it exits. Nulling them here would crash the
                # still-running thread.
                logger.warning("bridge loop still busy; resources will be "
                               "released when the command finishes")
                return
        self._cleanup()

    def _cleanup(self) -> None:
        if self._selector is not None:
            for key in list(self._selector.get_map().values()):
                try:
                    key.fileobj.close()
                except OSError:
                    pass
            self._selector.close()
            self._selector = None
        self._server_sock = None
        self._buffers.clear()

    def _loop(self) -> None:
        try:
            while self._running.is_set():
                events = self._selector.select(timeout=0.2)
                for key, _ in events:
                    if key.data == "accept":
                        self._accept()
                    else:
                        self._read_client(key.fileobj)
        finally:
            if not self._running.is_set() and self._thread is None:
                # stop() already returned after a join timeout: this
                # thread owns the cleanup now.
                self._cleanup()

    def _accept(self) -> None:
        try:
            conn, addr = self._server_sock.accept()
        except OSError:
            return
        conn.setblocking(False)
        self._selector.register(conn, selectors.EVENT_READ, data="client")
        self._buffers[conn.fileno()] = b""
        logger.info("Bridge client connected: %s", addr)

    def _disconnect(self, conn: socket.socket) -> None:
        self._buffers.pop(conn.fileno(), None)
        try:
            self._selector.unregister(conn)
        except (KeyError, ValueError):
            pass
        conn.close()

    def _read_client(self, conn: socket.socket) -> None:
        fd = conn.fileno()
        try:
            chunk = conn.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._disconnect(conn)
            return
        if not chunk:
            self._disconnect(conn)
            return
        self._buffers[fd] = self._buffers.get(fd, b"") + chunk
        while b"\n" in self._buffers.get(fd, b""):
            line, self._buffers[fd] = self._buffers[fd].split(b"\n", 1)
            if not line.strip():
                continue
            try:
                msg = BridgeMessage.from_json(line.decode("utf-8"))
                response = self.handler.handle(msg)
            except Exception as e:  # noqa: BLE001
                response = BridgeMessage.error_response("", str(e))
            try:
                conn.sendall(response.to_bytes())
            except OSError:
                self._disconnect(conn)
                return
