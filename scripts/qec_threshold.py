"""QEC threshold analysis: logical vs physical error rate.

CLI- and JSON-compatible with ``/root/reference/scripts/qec_threshold.py``,
rebuilt on this engine: each sweep point's trials run as one batched
device launch and the noise probability is a runtime scalar, so the whole
15-point sweep reuses a single compiled cycle program.

Usage:
    python scripts/qec_threshold.py --codes bit_flip,steane --noise bit_flip

Extension (defaults unchanged): ``--engine frame`` runs the sweep on
the Pauli-frame engine (``quantum_simulator_tpu/qec_frame.py``) — same
per-trial outcomes for the reference codes under the same seed, but pure
GF(2) bit algebra, so it also accepts codes the statevector engine cannot
hold: arbitrary-odd-distance repetition codes (``--codes repetition:25`` /
``phase_repetition:25``) and rotated surface codes at any odd distance
(``--codes surface:9``; exact coset-leader decoding at d<=5, union-find
matching above; plain ``surface`` = d=3 runs on either engine).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from quantum_sim.engine.qec import (  # noqa: E402
    BitFlipCode,
    PhaseFlipCode,
    QECSimulator,
    RotatedSurfaceCode,
    SteaneCode,
)

CODE_MAP = {
    "bit_flip": BitFlipCode,
    "phase_flip": PhaseFlipCode,
    "steane": SteaneCode,
    "surface": RotatedSurfaceCode,
}


def _parse_code(name: str):
    """'bit_flip' -> (class, None) | 'repetition:11' -> (kind, distance)."""
    if name in CODE_MAP:
        return name, None
    for prefix, kind in (("repetition:", "bit_flip"),
                         ("phase_repetition:", "phase_flip"),
                         ("surface:", "surface")):
        if name.startswith(prefix):
            try:
                distance = int(name[len(prefix):])
            except ValueError:
                return None, None
            if distance < 3 or distance % 2 == 0:
                return None, None
            return kind, distance
    return None, None


def _make_sim(code_name: str, engine: str):
    """-> (simulator, metadata dict). Frame engine mirrors the sweep API."""
    from quantum_simulator_tpu.qec_frame import (
        FrameQECSimulator, frame_spec_from_code, repetition_frame_spec,
        surface_code_frame_spec)

    kind, distance = _parse_code(code_name)
    if distance is not None:
        if engine != "frame":
            raise SystemExit(
                f"{code_name} requires --engine frame (the statevector "
                "engine cannot hold arbitrary-distance codes)")
        if kind == "surface":
            # ML-parity syndromes need no ancillas (RotatedSurfaceCode).
            spec = surface_code_frame_spec(distance)
            ancillas = 0
        else:
            spec = repetition_frame_spec(distance, kind)
            ancillas = distance - 1
        meta = {"code": spec.name, "data_qubits": spec.data_qubits,
                "total_qubits": spec.data_qubits + ancillas,
                "code_distance": distance}
        return FrameQECSimulator(spec), meta

    code = CODE_MAP[code_name]()
    meta = {"code": code.name, "data_qubits": code.data_qubits,
            "total_qubits": code.total_qubits,
            "code_distance": code.code_distance}
    if engine == "frame":
        return FrameQECSimulator(frame_spec_from_code(code)), meta
    return QECSimulator(code), meta


def run_threshold(code_name: str, noise_type: str, n_trials: int,
                  seed: int, engine: str = "statevector") -> dict:
    sim, meta = _make_sim(code_name, engine)
    noise_probs = np.linspace(0.001, 0.3, 15).tolist()

    results = sim.threshold_sweep(noise_probs, n_trials=n_trials,
                                  noise_type=noise_type, seed=seed)

    sweep_data = [{
        "physical_rate": tp.physical_rate,
        "logical_rate": tp.logical_rate,
        "success_rate": tp.success_rate,
        "avg_fidelity": tp.avg_fidelity,
        "logical_z_fidelity": tp.logical_z_fidelity,
        "decoder_success_rate": tp.decoder_success_rate,
    } for tp in results]

    threshold_p = None
    for tp in results:
        if tp.logical_rate < tp.physical_rate:
            threshold_p = tp.physical_rate

    return {
        "code": meta["code"],
        "code_key": code_name,
        "noise_type": noise_type,
        "n_trials": n_trials,
        "data_qubits": meta["data_qubits"],
        "total_qubits": meta["total_qubits"],
        "code_distance": meta["code_distance"],
        "estimated_threshold": threshold_p,
        "sweep": sweep_data,
    }


def main():
    parser = argparse.ArgumentParser(description="QEC threshold analysis")
    parser.add_argument(
        "--codes", type=str, default="bit_flip,steane",
        help="Comma-separated code names: bit_flip, phase_flip, steane, "
             "surface (d=3), surface:D / repetition:D / phase_repetition:D")
    parser.add_argument("--noise", type=str, default="bit_flip",
                        choices=["bit_flip", "phase_flip", "depolarizing"])
    parser.add_argument("--trials", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument(
        "--engine", type=str, default="statevector",
        choices=["statevector", "frame"],
        help="frame = Pauli-frame GF(2) engine (draw-exact vs statevector "
             "for the reference codes; required for repetition:D codes)")
    args = parser.parse_args()

    code_names = [c.strip() for c in args.codes.split(",")]
    for name in code_names:
        kind, distance = _parse_code(name)
        if kind is None:
            print(f"Unknown code: {name}. Available: {list(CODE_MAP)} "
                  "or repetition:D / phase_repetition:D / surface:D "
                  "(odd D >= 3)")
            sys.exit(1)

    print(f"Running QEC threshold: codes={code_names}, noise={args.noise}, "
          f"trials={args.trials}, seed={args.seed}, engine={args.engine}")

    all_results = []
    for code_name in code_names:
        print(f"  Sweeping {code_name}...")
        result = run_threshold(code_name, args.noise, args.trials, args.seed,
                               engine=args.engine)
        all_results.append(result)
        est = result["estimated_threshold"]
        print(f"    {result['code']}: threshold ~ {est if est else 'N/A'}")

    output = {
        "experiment": "qec_threshold",
        "noise_type": args.noise,
        "seed": args.seed,
        "engine": args.engine,
        "codes": all_results,
    }

    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
        print(f"Results saved to {args.output}")
    else:
        print(json.dumps(output, indent=2))


if __name__ == "__main__":
    main()
