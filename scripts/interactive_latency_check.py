"""Interactive edit->run latency check.

Measures, on the current default backend (run it on the GPU):

0. unless ``--skip-subprocess``: a FIRST-PROCESS cold run in a child
   process, started before this process opens the device (one JAX
   process per card); it fills the persistent compilation cache
   (config.py), so step 1 below is a second process's cold first run —
   the persistent cache must make it cheap (target <= 10 s);
1. cold first run of an n=16 depth-8 circuit through the skeleton
   executor (one compile per skeleton CLASS, not per structure);
2. warm 1-gate-edit rerun: add one gate, recompile the program IR,
   rerun — must reuse the compiled executor (target < 2 s);
3. a second, different 1-gate edit (complex gate into a real window —
   the realness-flip case that used to force a recompile);
4. noisy (depolarizing) cold + warm-edit runs through the
   unitary-splice interactive path (target < 2 s for the edit);
5. for contrast, the fused per-structure path's compile cost for the
   same edit (what the editor used to pay).

Prints one JSON line; ``--out PATH`` also writes it to a file.

Usage: python scripts/interactive_latency_check.py [--skip-fused]
       [--skip-subprocess] [--out PATH] [--child n16-cold]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(n, depth, seed, edit=0):
    from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit

    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q], [float(rng.uniform(0, 3))],
                                    column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    if edit >= 1:  # 1-gate edit: extra Ry joins the last rotation column
        c.add_gate(GateInstance("Ry", [n // 2], [0.77], column=col))
    if edit >= 2:  # realness-flip edit: first complex gate in the circuit
        c.add_gate(GateInstance("Rz", [n // 3], [0.33], column=col))
    return c


def _child_cold_run(n: int, depth: int) -> int:
    """Subprocess entry: one cold interactive run, prints the seconds."""
    import time as _t

    from quantum_simulator_tpu.config import CONFIG
    from quantum_simulator_tpu.simulator import Simulator

    CONFIG.interactive = True
    sim = Simulator()
    t0 = _t.perf_counter()
    res = sim.run(build(n, depth, 3), shots=64, seed=0)
    assert sum(res.measurement_counts.values()) == 64
    print(json.dumps({"cold_s": round(_t.perf_counter() - t0, 3)}))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-fused", action="store_true",
                    help="skip the fused-path recompile contrast run")
    ap.add_argument("--skip-subprocess", action="store_true",
                    help="skip the second-process cold-run measurement")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-n", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.child == "n16-cold":
        return _child_cold_run(args.n, args.depth)

    first_process_cold = None
    if not args.skip_subprocess:
        # The child runs to completion BEFORE this process touches the
        # device: a JAX process reserves most of the card's memory, so
        # two at once would starve each other. A failing child fails
        # the check.
        import subprocess

        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--child", "n16-cold", "-n", str(args.n),
             "--depth", str(args.depth)],
            capture_output=True, text=True, timeout=1200, check=True)
        first_process_cold = json.loads(
            proc.stdout.strip().splitlines()[-1])["cold_s"]

    import jax

    from quantum_simulator_tpu.config import CONFIG
    from quantum_simulator_tpu.simulator import Simulator

    CONFIG.interactive = True
    sim = Simulator()
    out = {"platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind,
           "n": args.n, "depth": args.depth}

    def timed_run(circuit):
        t0 = time.perf_counter()
        res = sim.run(circuit, shots=64, seed=0)
        assert sum(res.measurement_counts.values()) == 64
        return time.perf_counter() - t0

    out["cold_first_run_s"] = round(timed_run(build(args.n, args.depth, 3)), 3)
    if first_process_cold is not None:
        out["first_process_cold_s"] = first_process_cold
        out["second_process_cold_s"] = out["cold_first_run_s"]
        out["second_process_cold_under_10s"] = (
            out["second_process_cold_s"] <= 10.0)
    out["warm_same_structure_s"] = round(
        timed_run(build(args.n, args.depth, 3)), 3)
    out["warm_1gate_edit_s"] = round(
        timed_run(build(args.n, args.depth, 3, edit=1)), 3)
    out["warm_realness_flip_edit_s"] = round(
        timed_run(build(args.n, args.depth, 3, edit=2)), 3)
    out["edit_under_2s"] = (out["warm_1gate_edit_s"] < 2.0
                            and out["warm_realness_flip_edit_s"] < 2.0)

    # Noisy single-trajectory reruns (the GUI's run-with-noise panel):
    # the splice path draws eagerly on the host and reuses the same
    # skeleton-compiled executor.
    from quantum_simulator_tpu.noise import DepolarizingNoise, NoiseModel

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nsim = Simulator(noise_model=nm)

    def timed_noisy(circuit):
        t0 = time.perf_counter()
        res = nsim.run(circuit, shots=64, seed=0)
        assert sum(res.measurement_counts.values()) == 64
        return time.perf_counter() - t0

    out["noisy_cold_first_run_s"] = round(
        timed_noisy(build(args.n, args.depth, 3)), 3)
    out["noisy_warm_1gate_edit_s"] = round(
        timed_noisy(build(args.n, args.depth, 3, edit=1)), 3)
    out["noisy_edit_under_2s"] = out["noisy_warm_1gate_edit_s"] < 2.0
    out["edit_under_2s"] = (out["edit_under_2s"]
                            and out["noisy_edit_under_2s"])

    if not args.skip_fused:
        # What the editor used to pay: fused per-structure compile of
        # the SAME edited circuit.
        CONFIG.interactive = False
        out["fused_recompile_s"] = round(
            timed_run(build(args.n, args.depth, 3, edit=1)), 3)
        CONFIG.interactive = True

    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    if not out["edit_under_2s"]:
        print("WARNING: edit->run latency target (<2 s) missed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
