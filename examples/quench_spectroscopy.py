"""Quench spectroscopy: excitation gaps from dynamical correlators.

Three framework engines compose into one physics workflow:

1. ``dmrg.dmrg_ground_state`` finds the TFIM ground state |0> as an MPS;
2. ``correlators.mps_two_point_correlator`` seeded with that state
   computes ``C(t) = <0| Z_mid(t) Z_mid |0>`` — for an eigenstate start
   the signal is a sum of ``e^{-i (E_k - E_0) t}`` phases weighted by
   ``|<k| Z |0>|^2``, so its spectrum IS the excitation spectrum;
3. ``dmrg.dmrg_excited_states`` computes the same gaps variationally —
   the FFT peak of (2) must land on the gap of (3).

Run:  python examples/quench_spectroscopy.py [--n 10] [--chi 32]
          [--t 20] [--steps 800]
(defaults measured: FFT peak 1.2551 vs strongest exact line 1.1672 —
within one 0.31 bin; DMRG gap = lowest exact line to 4 decimals)
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from quantum_simulator_tpu.correlators import mps_two_point_correlator  # noqa: E402
from quantum_simulator_tpu.dmrg import (dmrg_excited_states,  # noqa: E402
                                        dmrg_ground_state)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--chi", type=int, default=32,
                help="bond cap; the operator lightcone grows with t, so "
                     "spectroscopy windows need chi ~ the exact cut rank "
                     "(2^(n/2) at n=10) or the truncated signal decays "
                     "into a low-frequency artifact")
    ap.add_argument("--t", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--g", type=float, default=1.5,
                    help="transverse field (paramagnetic for g > 1)")
    args = ap.parse_args()
    n, g = args.n, args.g
    terms = [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)] \
        + [(-g, "X", [i]) for i in range(n)]

    t0 = time.perf_counter()
    gs = dmrg_ground_state(terms, n, chi=args.chi, sweeps=8)
    print(f"-- DMRG ground state: E0 = {gs.energy:.6f} "
          f"({time.perf_counter() - t0:.0f}s, "
          f"truncation {gs.truncation_weight:.1e})")

    t0 = time.perf_counter()
    spec = dmrg_excited_states(terms, n, n_states=2, chi=args.chi,
                               sweeps=8)
    gap = spec[1].energy - spec[0].energy
    print(f"-- DMRG first gap: E1 - E0 = {gap:.4f} "
          f"({time.perf_counter() - t0:.0f}s)")

    mid = n // 2
    t0 = time.perf_counter()
    times, C = mps_two_point_correlator(
        n, terms, args.t, args.steps, mid, mid, chi=args.chi,
        initial=gs.state, record_every=1)
    print(f"-- C(t) = <0|Z_{mid}(t) Z_{mid}|0> over {len(times)} points "
          f"({time.perf_counter() - t0:.0f}s)")

    # For an eigenstate start C(t) = sum_k |<k|Z|0>|^2 e^{-i(E_k-E0)t}:
    # the signal's spectrum IS the local spectral function.  Hann-window
    # against finite-time leakage.  NB numpy's forward FFT projects on
    # e^{-2 pi i f t}, so the e^{-i omega t} phases land at NEGATIVE
    # fftfreq bins — read the line positions there.
    sig = C - C.mean()
    win = np.hanning(len(sig))
    freqs = np.fft.fftfreq(len(times), d=times[1] - times[0]) * 2 * np.pi
    amp = np.abs(np.fft.fft(sig * win))
    neg = freqs < 0
    peak = -freqs[neg][np.argmax(amp[neg])]
    print(f"-- strongest spectral line (Hann FFT): omega = {peak:.4f} "
          f"(bin width {freqs[1] - freqs[0]:.4f})")

    if n <= 12:     # exact lines from the dense eigendecomposition
        from quantum_simulator_tpu.lindblad import _pauli_term_matrix

        def embed(pstr, qubits):
            full = ["I"] * n
            for ch, q in zip(pstr, qubits):
                full[q] = ch
            return _pauli_term_matrix("".join(full))

        H = sum(c * embed(p, q) for c, p, q in terms)
        w_, v_ = np.linalg.eigh(H)
        weights = np.abs(v_.conj().T @ (embed("Z", [mid]) @ v_[:, 0])) ** 2
        lines = w_ - w_[0]
        top = np.argsort(weights[1:])[::-1][:3] + 1
        print("-- exact lines (omega, weight): "
              + ", ".join(f"({lines[k]:.4f}, {weights[k]:.3f})"
                          for k in top))
        strongest = lines[top[0]]
        print(f"-- FFT peak vs strongest exact line: {peak:.4f} vs "
              f"{strongest:.4f} (|diff| {abs(peak - strongest):.4f}, "
              f"<= one bin: {abs(peak - strongest) <= freqs[1] - freqs[0]})")
        print(f"-- DMRG gap vs lowest exact line: {gap:.4f} vs "
              f"{lines[1]:.4f}")


if __name__ == "__main__":
    main()
