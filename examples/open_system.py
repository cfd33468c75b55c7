"""Open-system dynamics across both Lindblad engines.

1. A 3-qubit driven-dissipative chain on the EXACT dense integrator
   (``lindblad.py``: matrix-free RK4 on the 4^n density matrix), and
   the same model on the MPS trajectory unraveling
   (``lindblad_mps.py``) — the two curves agree within trajectory
   statistics, which is the cross-engine contract locked by
   ``tests/test_lindblad_mps.py``.
2. The SAME physics at 40 qubits — a TFIM chain losing energy through
   per-site amplitude damping — where no dense solver can exist
   (4^40 entries).  Trajectories are one vmapped launch; steps past the
   bond-growth fixed point run under one ``lax.scan``.

Run:  python examples/open_system.py [--n 40] [--chi 16] [--traj 16]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from quantum_simulator_tpu.lindblad import LindbladSimulator  # noqa: E402
from quantum_simulator_tpu.lindblad_mps import MPSLindbladSimulator  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--chi", type=int, default=16)
    ap.add_argument("--traj", type=int, default=16)
    ap.add_argument("--t", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()

    print("-- 3-qubit cross-check: dense RK4 vs MPS trajectories")
    H = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2])] + \
        [(0.6, "X", [q]) for q in range(3)]
    J = [(0.3, "sigma_minus", 0), (0.2, "z", 2)]
    obs = [("Z", [0]), ("X", [1])]
    dense = LindbladSimulator(3, H, J).evolve(
        1.0, 100, observables=obs, record_every=25)
    mps = MPSLindbladSimulator(3, H, J, chi=8).evolve(
        1.0, 100, n_trajectories=300, initial=[0, 0, 0],
        observables=obs, record_every=25, seed=0)
    for k, lbl in enumerate(mps.observable_labels):
        print(f"   {lbl:10s} dense {np.round(dense.expectations[k], 3)}")
        print(f"   {'':10s} mps   {np.round(mps.expectations[k], 3)} "
              f"(stderr {np.round(mps.stderr[k], 3)})")

    n = args.n
    print(f"-- {n}-qubit damped TFIM quench (chi={args.chi}, "
          f"{args.traj} trajectories) — no dense solver exists here")
    Hn = [(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)] + \
         [(0.5, "X", [i]) for i in range(n)]
    Jn = [(0.1, "sigma_minus", q) for q in range(n)]
    mid = n // 2
    t0 = time.perf_counter()
    rec = max(1, args.steps // 4)
    while args.steps % rec:          # largest divisor <= steps // 4
        rec -= 1
    res = MPSLindbladSimulator(n, Hn, Jn, chi=args.chi).evolve(
        args.t, args.steps, n_trajectories=args.traj,
        observables=[("Z", [mid]), ("ZZ", [mid, mid + 1])],
        record_every=rec, seed=1)
    dt = time.perf_counter() - t0
    for k, lbl in enumerate(res.observable_labels):
        print(f"   {lbl:14s} {np.round(res.expectations[k], 4)}")
    print(f"   times {np.round(res.times, 3)}  "
          f"(wall {dt:.0f}s, mean discarded Schmidt weight "
          f"{res.truncation_weight:.2e})")


if __name__ == "__main__":
    main()
