"""QEC memory experiments at scale on the Pauli-frame engine.

The reference's QEC subsystem runs single cycles of three small codes
through a 2^n statevector (``/root/reference/quantum_sim/engine/qec.py``,
capped at Steane's 13 qubits).  The frame engine drops the state
entirely — a trial is a row of error bits — so this example does what
the reference never could:

1. a threshold sweep of repetition codes at distances 3..25, millions of
   trials per point if asked;
2. an R-round memory experiment per distance, decoded by the EXACT
   space-time maximum-likelihood decoder (Walsh-Hadamard transfer
   matrices over the (trials, 2^d) posterior), against the single-shot
   baseline;
3. a Lambda fit: the factor by which each +2 of distance suppresses the
   per-round logical error rate;
4. (``--surface``) rotated-surface-code memory at the same distances,
   decoded by space-time union-find matching on the detection-event
   graph (``qec_matching``) — no 2^(d^2) posterior, so d=7/9 memory
   under measurement noise runs where ML enumeration is impossible.

Run:  python examples/qec_memory.py [--trials 4096] [--rounds 10]
          [--p 0.03] [--distances 3,5,7,9] [--surface]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quantum_simulator_tpu.qec_frame import (  # noqa: E402
    FrameQECSimulator,
    repetition_frame_spec,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--p", type=float, default=0.03,
                    help="physical error rate (also the readout flip rate)")
    ap.add_argument("--distances", type=str, default="3,5,7,9")
    ap.add_argument("--surface", action="store_true",
                    help="also run rotated-surface-code memory decoded "
                         "by space-time union-find matching")
    ap.add_argument("--circuit", action="store_true",
                    help="also run CIRCUIT-LEVEL surface memory: real "
                         "extraction circuits as noisy Clifford "
                         "trajectories, decoded on the measured "
                         "detector error model (p is per-gate here — "
                         "try 0.002-0.01)")
    args = ap.parse_args()
    distances = [int(d) for d in args.distances.split(",")]

    print(f"-- threshold sweep (single round, {args.trials} trials/point)")
    for d in distances:
        sim = FrameQECSimulator(repetition_frame_spec(d, "bit_flip"))
        t0 = time.perf_counter()
        rate, _ = sim.throughput_sweep(args.p, args.trials, "bit_flip",
                                       seed=d)
        dt = time.perf_counter() - t0
        print(f"   d={d:2d}: logical={rate:.2e}   "
              f"({args.trials / dt:,.0f} trials/s)")

    print(f"-- {args.rounds}-round memory, p=q={args.p}, "
          f"exact space-time ML vs single-shot")
    per_round = {}
    for d in distances:
        res = FrameQECSimulator.ml_memory_experiment(
            distance=d, noise_prob=args.p, n_rounds=args.rounds,
            n_trials=args.trials, meas_error_prob=args.p, seed=d)
        per_round[d] = res["per_round_ml_rate"]
        print(f"   d={d:2d}: ML {res['ml_failure_probability']:.4f}  "
              f"single-shot {res['final_syndrome_failure_probability']:.4f}"
              f"  (per-round ML {res['per_round_ml_rate']:.2e})")

    lams = []
    for a, b in zip(distances, distances[1:]):
        if per_round[b] > 0:
            lams.append(per_round[a] / per_round[b])
    if lams:
        print(f"-- Lambda (error suppression per +2 distance): "
              + ", ".join(f"{l:.1f}x" for l in lams))
    else:
        print("-- Lambda: larger distances had zero failures at "
              f"{args.trials} trials — raise --trials or --p to resolve")

    if args.surface:
        print(f"-- surface-code {args.rounds}-round memory, p=q={args.p}, "
              f"space-time union-find matching vs single-shot")
        sp_round = {}
        for d in distances:
            if d % 2 == 0:
                continue
            res = FrameQECSimulator.matching_memory_experiment(
                noise_prob=args.p, n_rounds=args.rounds,
                n_trials=args.trials, meas_error_prob=args.p,
                distance=d, code="surface", seed=d)
            sp_round[d] = res["per_round_matching_rate"]
            print(f"   d={d:2d}: matching "
                  f"{res['matching_failure_probability']:.4f}  single-shot "
                  f"{res['final_syndrome_failure_probability']:.4f}"
                  f"  (per-round {res['per_round_matching_rate']:.2e})")
        ds = sorted(sp_round)
        lams = []
        for a, b in zip(ds, ds[1:]):
            if sp_round[b] > 0:
                lams.append(f"{sp_round[a] / sp_round[b]:.1f}x")
            elif sp_round[a] > 0:
                lams.append("inf (zero failures at the larger d)")
        if lams:
            print("-- surface Lambda: " + ", ".join(lams))

    if args.circuit:
        from quantum_simulator_tpu.qec_circuit import circuit_level_memory
        print(f"-- CIRCUIT-LEVEL surface memory, p={args.p}/gate, "
              f"{args.rounds} rounds, DEM-matched")
        for d in distances:
            if d % 2 == 0:
                continue
            res = circuit_level_memory(
                distance=d, n_rounds=args.rounds, noise_prob=args.p,
                n_trials=args.trials, seed=d)
            print(f"   d={d:2d}: logical "
                  f"{res['logical_failure_probability']:.4f}  "
                  f"uncorrected {res['raw_failure_probability']:.4f}  "
                  f"({res['n_qubits']} qubits, "
                  f"det fraction {res['detection_fraction']:.3f})")


if __name__ == "__main__":
    main()
