"""On-card monitored-trajectory acceptance.

Drives ``Simulator.monitored_trajectories`` on the GPU in the two
regimes the reference cannot represent at all
(``/root/reference/quantum_sim/engine/simulator.py:61-65`` skips
MEASUREMENT during evolution; n caps at 16):

1. **n=24 group path** (below the huge route: collapse as spliced projectors,
   ``ops/monomial_traj``): GHZ-24 with mid-circuit measurements on
   q0/q1 — outcomes must be equal in every trajectory and the final
   state must be the collapsed product state; then a noisy (depol)
   brickwork-24 for monitored-throughput timing.
2. **n=30 fused huge path** (``ops/bigtraj.huge_monitored_sample_fn``):
   GHZ-30, mid-circuit measures on q0/q1, ``final_shots`` Z samples —
   every sample must equal the recorded collapse branch exactly.

Prints one JSON line; ``--out PATH`` also writes the full record.

Usage: python scripts/monitored_check.py [--skip-huge] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def ghz(n: int, measure_at: int):
    from quantum_simulator_tpu.circuit import GateInstance, QuantumCircuit

    c = QuantumCircuit(n)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(n - 1):
        c.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    c.add_gate(GateInstance("Measure", [0], [], column=measure_at))
    c.add_gate(GateInstance("Measure", [1], [], column=measure_at))
    return c


def brickwork_measured(n: int, depth: int, seed: int):
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
        if layer == depth // 2:
            # mid-circuit monitor row: every 6th qubit
            for q in range(0, n, 6):
                c.add_gate(GateInstance("Measure", [q], [], column=col))
            col += 1
    return c


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-huge", action="store_true")
    ap.add_argument("--trajectories", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from quantum_simulator_tpu.noise import DepolarizingNoise, NoiseModel
    from quantum_simulator_tpu.simulator import Simulator

    out: dict = {"platform": jax.devices()[0].platform,
                 "device_kind": jax.devices()[0].device_kind}

    # --- 1a. GHZ-24 correctness through the group monitored path ------
    n = 24
    t0 = time.perf_counter()
    outs, sites, states = Simulator().monitored_trajectories(
        ghz(n, measure_at=n), n_trajectories=8, seed=3)
    dt = time.perf_counter() - t0
    assert outs.shape == (8, 2), outs.shape
    assert (outs[:, 0] == outs[:, 1]).all(), "GHZ collapse uncorrelated"
    for t in range(8):
        b = int(outs[t, 0])
        idx = (2 ** n - 1) if b else 0
        probs = states[t].probabilities
        assert probs[idx] > 0.999, (t, b, float(probs[idx]))
    out["ghz24_group_path"] = {
        "trajectories": 8, "seconds_cold": round(dt, 2),
        "outcomes_correlated": True, "collapsed_state_exact": True,
        "branch_counts": [int((outs[:, 0] == 0).sum()),
                          int((outs[:, 0] == 1).sum())],
    }
    print(f"[monitored] GHZ-24 group path OK ({dt:.1f} s cold, "
          f"branches {out['ghz24_group_path']['branch_counts']})",
          file=sys.stderr, flush=True)
    for s in states:
        s.device_data.delete()

    # --- 1b. noisy monitored brickwork-24 throughput ------------------
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.01))
    c = brickwork_measured(24, 4, seed=5)
    sim = Simulator(noise_model=nm)
    T = args.trajectories
    t0 = time.perf_counter()
    outs, sites, states = sim.monitored_trajectories(c, n_trajectories=T,
                                                     seed=7)
    cold = time.perf_counter() - t0
    for s in states:
        s.device_data.delete()
    t0 = time.perf_counter()
    outs, sites, states = sim.monitored_trajectories(c, n_trajectories=T,
                                                     seed=8)
    warm = time.perf_counter() - t0
    m = outs.shape[1]
    freqs = outs.mean(axis=0).round(3).tolist()
    for s in states:
        s.device_data.delete()
    out["noisy_brickwork24"] = {
        "trajectories": T, "monitor_sites": m,
        "seconds_cold": round(cold, 2), "seconds_warm": round(warm, 2),
        "traj_per_sec_warm": round(T / warm, 2),
        "outcome_freqs": freqs,
    }
    print(f"[monitored] noisy brickwork-24 ({m} monitor sites): "
          f"{T / warm:.2f} traj/s warm ({warm:.2f} s; cold {cold:.1f} s)",
          file=sys.stderr, flush=True)

    # --- 2. n=30 fused huge path --------------------------------------
    if not args.skip_huge:
        n = 30
        t0 = time.perf_counter()
        outs, sites, counts = Simulator().monitored_trajectories(
            ghz(n, measure_at=n), n_trajectories=3, seed=11,
            final_shots=256)
        cold = time.perf_counter() - t0
        assert outs.shape == (3, 2)
        assert (outs[:, 0] == outs[:, 1]).all()
        for t in range(3):
            b = int(outs[t, 0])
            want = format((2 ** n - 1) if b else 0, f"0{n}b")
            assert counts[t] == {want: 256}, (t, counts[t])
        t0 = time.perf_counter()
        outs2, _, counts2 = Simulator().monitored_trajectories(
            ghz(n, measure_at=n), n_trajectories=3, seed=12,
            final_shots=256)
        warm = time.perf_counter() - t0
        out["ghz30_huge_path"] = {
            "trajectories": 3, "final_shots": 256,
            "seconds_cold": round(cold, 2), "seconds_warm": round(warm, 2),
            "seconds_per_traj_warm": round(warm / 3, 2),
            "samples_match_collapse_exactly": True,
            "branches": [int(b) for b in outs[:, 0]] + [
                int(b) for b in outs2[:, 0]],
        }
        print(f"[monitored] GHZ-30 huge path OK: {warm / 3:.2f} s/traj "
              f"warm (cold {cold:.1f} s), 256 samples/traj all equal to "
              f"the collapse branch", file=sys.stderr, flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
