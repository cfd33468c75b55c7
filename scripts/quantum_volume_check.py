"""Quantum-volume-at-scale check.

Runs the heavy-output quantum-volume protocol far beyond the
reference's 8-qubit cap
(``/root/reference/quantum_sim/engine/analysis.py:538-622`` loops
``Simulator.run`` once per trial per width): here every width's trials
are vmapped lanes of ONE compiled program — on the GPU the ideal forward
is the group-matmul plan and the noisy lane the unitary-splice
trajectory body (``analysis.BenchmarkAnalysis.quantum_volume_at_scale``).

Prints the achieved QV = 2^m as one JSON line; with ``--out PATH`` it
also writes per-width heavy-output probabilities (mean, stderr, ideal
control) and the 2/3 threshold verdict per width, after every width.

Usage:
  python scripts/quantum_volume_check.py \
      [--widths 4,8,12,16,20] [--trials 50] [--noise-p 0.002] [--chunk 10]
      [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="4,8,12,16,20",
                    help="comma-separated circuit widths")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--noise-p", type=float, default=0.002,
                    help="global depolarizing probability per gate")
    ap.add_argument("--chunk", type=int, default=10,
                    help="vmapped trial lanes per launch (memory bound)")
    ap.add_argument("--trajectories", type=int, default=1,
                    help="noisy trajectories averaged per trial")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from quantum_simulator_tpu.analysis import BenchmarkAnalysis
    from quantum_simulator_tpu.noise import DepolarizingNoise, NoiseModel

    widths = tuple(int(w) for w in args.widths.split(","))
    nm = None
    if args.noise_p > 0:
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(args.noise_p))

    out = args.out

    partial: list[dict] = []

    def _flush_width(row: dict) -> None:
        # Persist after every width: a timeout must not lose completed
        # widths.
        partial.append(row)
        print(f"[qv] width {row['width']:>2}: heavy-output "
              f"{row['heavy_output_mean']:.4f} +- "
              f"{row['heavy_output_stderr']:.4f} "
              f"(ideal {row['heavy_output_ideal_mean']:.4f}) "
              f"{'PASS' if row['passed'] else 'fail'} "
              f"[{row['seconds']:.1f} s]", file=sys.stderr, flush=True)
        if out:
            with open(out, "w") as f:
                json.dump({"partial": True, "results_per_width": partial},
                          f, indent=1)

    t0 = time.perf_counter()
    res = BenchmarkAnalysis.quantum_volume_at_scale(
        widths=widths, num_trials=args.trials, noise_model=nm,
        seed=args.seed, chunk=args.chunk,
        trajectories_per_trial=args.trajectories, on_width=_flush_width)
    res["platform"] = jax.devices()[0].platform
    res["device_kind"] = jax.devices()[0].device_kind
    res["noise"] = ({"channel": "depolarizing", "p": args.noise_p}
                    if nm else None)
    res["total_seconds"] = round(time.perf_counter() - t0, 1)

    print(f"[qv] quantum volume 2^{res['log2_qv']} = "
          f"{res['quantum_volume']}", file=sys.stderr)

    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {out}", file=sys.stderr)
    print(json.dumps({"quantum_volume": res["quantum_volume"],
                      "log2_qv": res["log2_qv"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
