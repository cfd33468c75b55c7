#!/usr/bin/env python3
"""Smoke run of the simulator's main path on one GPU.

Drives the public API in ONE process on the first GPU and checks every
phase against the plain NumPy reference in ``tests/oracle.py`` (complex128
per-gate ``tensordot``, qubit 0 = MSB) or against exact analytic values:

  ideal      Simulator.run: n=16 depth-40 Ry/CNOT brickwork, n=24 depth-8
             Ry/Rz + CNOT (complex), 4096 shots each
  huge       Simulator.run on the donated huge route: QFT-30 on a basis
             input, Grover-30 (3 iterations), n=31 all-real brickwork with
             10k shots
  noisy      trajectory_states / run_with_noise at n=20, batch 256, on the
             splice routes: depolarizing 0.05 and amplitude damping 0.05
  monitored  monitored trajectories of GHZ-24 with 4 monitor sites
  bridge     BridgeServer + SimulatorClient on 127.0.0.1: set_circuit + run
             at n=20

The state path is complex64 / float32 with Precision.HIGHEST on every
contraction (no TF32), so each tolerance below is an f32 rounding bound,
stated beside its check. Each phase prints its route and its cold
(compile + run) and warm seconds. Any failed phase makes the run exit
nonzero without printing the final JSON line.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # DistributedSimulator on 4 cards

It refuses to run (exit 2) when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Widths of every phase; a CPU rehearsal may shrink them.
SIZES = {
    "ideal": ((16, 40, False), (24, 8, True)),  # (n, depth, complex)
    "huge_n": 30,
    "huge_real_n": 31,
    "noisy_n": 20,
    "batch": 256,
    "ghz_n": 24,
    "monitored_T": 64,
    "bridge_n": 20,
    "qft_mesh_n": 32,
    "brick_mesh_n": 28,
    "vqe_n": 20,
}


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class CheckFailed(AssertionError):
    pass


def check(name, ok, detail=""):
    log(f"    [{'ok' if ok else 'FAIL'}] {name} {detail}")
    if not ok:
        raise CheckFailed(f"{name}: {detail}")


def twice(fn, before_warm=None):
    """(cold result, warm result, cold s, warm s): the cold call
    includes compilation, the warm one reuses the compiled programs."""
    t0 = time.perf_counter()
    cold = fn()
    t1 = time.perf_counter()
    if before_warm is not None:
        before_warm(cold)
    t2 = time.perf_counter()
    warm = fn()
    t3 = time.perf_counter()
    return cold, warm, t1 - t0, t3 - t2


def phase_line(name, route, cold, warm, extra=""):
    log(f"phase={name} route={route} cold_s={cold:.3f} warm_s={warm:.3f} "
        f"compile_s={max(cold - warm, 0.0):.3f} {extra}".rstrip())


# ---------------------------------------------------------------------------
# Phases (one card)
# ---------------------------------------------------------------------------

def phase_ideal(oracle):
    from quantum_simulator_tpu import Simulator
    from quantum_simulator_tpu.ops import program as prog

    shots = 4096
    for n, depth, cplx in SIZES["ideal"]:
        c = oracle.brickwork_circuit(n, depth, seed=n, complex_=cplx)
        route = prog.forward_route(prog.compile_circuit(c))
        res, _, cold, warm = twice(
            lambda: Simulator().run(c, shots=shots, seed=7))
        got = res.final_state.data
        ref = oracle.run_circuit(c)
        err = float(np.abs(got - ref).max())
        fid = oracle.fidelity(got, ref)
        phase_line(f"ideal-n{n}{'-complex' if cplx else ''}", route,
                   cold, warm)
        check("route is the plan executor", route == "plan", route)
        # f32 amplitudes through ~depth state passes: each pass rounds
        # at ~6e-8 relative; 1e-5 absolute leaves >10x margin.
        check("max |d amp| <= 1e-5", err <= 1e-5, f"{err:.3e}")
        check("fidelity >= 1 - 1e-5", fid >= 1 - 1e-5, f"{1 - fid:.3e}")
        total = sum(res.measurement_counts.values())
        check("shot total", total == shots, str(total))
        bits = min(8, n)
        p = oracle.coarse_distribution(np.abs(ref) ** 2, n, bits)
        q = oracle.coarse_distribution(res.measurement_counts, n, bits)
        d, bound = oracle.tvd(p, q), oracle.tvd_bound(p, shots)
        # Sampling noise only: the bound is exceeded with prob <= 1e-6.
        check(f"TVD(top-{bits}-qubit marginal) <= bound", d <= bound,
              f"{d:.4f} <= {bound:.4f}")


def phase_huge(oracle):
    from quantum_simulator_tpu import Simulator
    from quantum_simulator_tpu.algorithms import AlgorithmTemplate
    from quantum_simulator_tpu.ops.bigstate import auto_chunks
    from quantum_simulator_tpu.simulator import _is_huge

    def release(res):
        res.final_state.state_data.delete()

    # QFT-30 on a basis input.
    n, shots = SIZES["huge_n"], 4096
    x = 0x2A5F3C1 % (1 << n)
    c = oracle.qft_circuit(n, x)
    route = f"huge(chunks={auto_chunks(n)})" if _is_huge(c) else "ordinary"
    _, res, cold, warm = twice(
        lambda: Simulator().run(c, shots=shots, seed=3), release)
    phase_line("huge-qft30", route, cold, warm)
    check("route is huge", _is_huge(c), route)
    ks = sorted(int(s, 2) for s in res.measurement_counts)[:32]
    check("sampled indices", len(ks) == min(32, 1 << n), str(len(ks)))
    got = np.array([res.final_state.amplitude(k) for k in ks])
    ref = oracle.qft_amplitudes(n, x, ks)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    # |amp| = 2^-15 everywhere; f32 phases accumulate over 465 CPhase
    # rotations and 30 H layers -> relative error well under 1e-3.
    check("DFT amplitudes at sampled indices (rel <= 1e-3)", rel <= 1e-3,
          f"{rel:.3e}")
    qp = np.asarray(res.final_state.qubit_probabilities())
    check("exact marginals = 0.5 (abs <= 1e-4)",
          bool(np.abs(qp - 0.5).max() <= 1e-4),
          f"{np.abs(qp - 0.5).max():.2e}")
    freq = np.array([sum(cnt for s, cnt in res.measurement_counts.items()
                         if s[q] == "1") for q in range(n)]) / shots
    sigma = 0.5 / math.sqrt(shots)
    worst = int(np.argmax(np.abs(freq - 0.5)))
    check("sampled marginals 0.5 +- 5 sigma",
          bool(np.abs(freq - 0.5).max() <= 5 * sigma),
          f"max dev {abs(freq[worst] - 0.5):.4f} (qubit {worst}) vs "
          f"{5 * sigma:.4f}")
    release(res)

    # Grover-30, 3 iterations: exact marked amplitude.
    marked = 123456789 % (1 << n)
    g = AlgorithmTemplate.grover_search(n, marked_state=marked,
                                        num_iterations=3)
    _, res, cold, warm = twice(
        lambda: Simulator().run(g, shots=0, seed=1), release)
    phase_line("huge-grover30", route, cold, warm)
    amp = abs(res.final_state.amplitude(marked))
    expect = oracle.grover_amplitude(n, 3)
    rel = abs(amp - expect) / expect
    # Six whole-state H layers and three MCZ phase passes in f32.
    check("|marked amp| = sin(7 asin(2^(-n/2))) (rel <= 1e-3)", rel <= 1e-3,
          f"{amp:.6e} vs {expect:.6e}")
    release(res)

    # n=31 all-real brickwork, 10k shots.
    n, shots = SIZES["huge_real_n"], 10_000
    c = oracle.brickwork_circuit(n, 8, seed=31)
    _, res, cold, warm = twice(
        lambda: Simulator().run(c, shots=shots, seed=5), release)
    route = f"huge(chunks={auto_chunks(n, planar=False)})"
    phase_line("huge-brickwork31-real", route, cold, warm)
    st = res.final_state
    check("real state (no imaginary plane)", not st.is_planar)
    # One f32 reduction over 2^31 squares.
    check("norm (abs <= 1e-4)", abs(st.norm_sq() - 1) <= 1e-4,
          f"{st.norm_sq():.7f}")
    total = sum(res.measurement_counts.values())
    check("shot total", total == shots, str(total))
    qp = np.asarray(st.qubit_probabilities())
    freq = np.array([sum(cnt for s, cnt in res.measurement_counts.items()
                         if s[q] == "1") for q in range(n)]) / shots
    sig = np.sqrt(qp * (1 - qp) / shots) + 1e-9
    z = float(np.abs(freq - qp).max() / sig.max())
    check("sampled vs exact marginals within 5 sigma",
          bool(np.all(np.abs(freq - qp) <= 5 * sig + 1e-6)), f"{z:.2f}")
    release(res)


def _z_per_trajectory(states, n):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def zs(s):
        p = jnp.abs(s) ** 2
        out = []
        for q in range(n):
            pq = p.reshape(s.shape[0], 1 << q, 2, -1).sum(axis=(1, 3))
            out.append(pq[:, 0] - pq[:, 1])
        return jnp.stack(out, axis=1)

    return np.asarray(zs(states), dtype=np.float64)


def phase_noisy(oracle):
    import jax
    import jax.numpy as jnp

    from quantum_simulator_tpu import (AmplitudeDampingNoise,
                                       DepolarizingNoise, GateInstance,
                                       NoiseModel, QuantumCircuit, Simulator)
    from quantum_simulator_tpu.config import CONFIG
    from quantum_simulator_tpu.ops import program as prog
    from quantum_simulator_tpu.ops.plan import group_trajectory_body
    from quantum_simulator_tpu.utils.seeding import key_from_seed

    n, T = SIZES["noisy_n"], SIZES["batch"]
    rng = np.random.default_rng(20)
    thetas = rng.uniform(0, np.pi, size=(3, n))
    prod = QuantumCircuit(n)
    for col in range(3):
        for q in range(n):
            prod.add_gate(GateInstance("Ry", [q], [float(thetas[col, q])],
                                       column=col))
    brick = oracle.brickwork_circuit(n, 8, seed=21, complex_=True)
    ideal = jnp.asarray(oracle.run_circuit(brick).astype(np.complex64))

    def model(ch):
        nm = NoiseModel()
        nm.add_global_noise(ch)
        return nm

    for label, ch, want in (
            ("depolarizing", DepolarizingNoise(0.05), "unitary-splice"),
            ("amplitude-damping", AmplitudeDampingNoise(0.05),
             "monomial-splice")):
        nm = model(ch)
        sim = Simulator(noise_model=nm)
        route = prog.trajectory_route(prog.compile_circuit(prod), nm)
        states, _, cold, warm = twice(
            lambda: sim.trajectory_states(prod, T, seed=11))
        phase_line(f"noisy-{label}-n{n}-b{T}", route, cold, warm)
        check("splice route", route == want, route)
        z = _z_per_trajectory(states, n)
        kraus = [np.asarray(k) for k in ch.get_kraus_operators()]
        ref = np.array([oracle.kraus_qubit_z(thetas[:, q], kraus)
                        for q in range(n)])
        mean = z.mean(axis=0)
        sig = z.std(axis=0, ddof=1) / math.sqrt(T) + 1e-5
        worst = float(np.max(np.abs(mean - ref) / sig))
        # Monte-Carlo error of T trajectories (1e-5 floor: f32 <Z>).
        check("per-qubit <Z> vs 2x2 Kraus rho within 5 sigma",
              worst <= 5.0, f"max {worst:.2f} sigma")
        del states

        # Same circuit and batch as above: reuses the compiled program.
        res = sim.run_with_noise(prod, shots=T, seed=12)
        total = sum(res.measurement_counts.values())
        check("run_with_noise shot total", total == T, str(total))

        # p = 0: every trajectory is the ideal state.
        sim0 = Simulator(noise_model=model(type(ch)(0.0)))
        states0 = sim0.trajectory_states(brick, T, seed=13)
        err = float(jnp.max(jnp.abs(states0 - ideal[None])))
        # Same f32 pass bound as the ideal phase.
        check("p=0: every trajectory equals the ideal state (<= 1e-5)",
              err <= 1e-5, f"{err:.3e}")
        del states0

    # Depolarizing draws are exact against the per-gate group executor
    # for the same keys (mixed-unitary branch choice is state-free). A
    # shallower brickwork keeps the per-gate reference's compile short.
    nm = model(DepolarizingNoise(0.05))
    shallow = oracle.brickwork_circuit(n, 4, seed=23, complex_=True)
    program = prog.compile_circuit(shallow)
    params = jnp.asarray(program.initial_params)
    states = Simulator(noise_model=nm).trajectory_states(shallow, 16,
                                                         seed=14)
    # trajectory_states splits its base key into one key per trajectory.
    base = key_from_seed(int(np.random.default_rng(14).integers(0, 2**63)))
    keys = jax.random.split(base, 16)
    ref_fn = jax.jit(jax.vmap(lambda k: group_trajectory_body(
        program, nm, params, k, CONFIG.dtype)))
    ref = np.asarray(ref_fn(keys))
    got = np.asarray(states)
    fids = [oracle.fidelity(a, b) for a, b in zip(got, ref)]
    # Identical Kraus draws; only f32 composition order differs.
    check("depolarizing draw-exact vs group_trajectory_body "
          "(fidelity >= 1 - 1e-5, 16 keys)",
          min(fids) >= 1 - 1e-5, f"{1 - min(fids):.3e}")


def phase_monitored(oracle):
    from quantum_simulator_tpu import Simulator
    from quantum_simulator_tpu.ops import program as prog

    n, T = SIZES["ghz_n"], SIZES["monitored_T"]
    sites = (0, n // 3, (2 * n) // 3, n - 1)
    c = oracle.ghz_circuit(n, monitor=sites)
    route = ("monomial-splice" if prog._use_group_path(
        prog.compile_circuit(c)) else "per-gate")
    out, _, cold, warm = twice(
        lambda: Simulator().monitored_trajectories(c, n_trajectories=T,
                                                   seed=17))
    outcomes, got_sites, states = out
    phase_line(f"monitored-ghz{n}-sites{len(sites)}-T{T}", route, cold,
               warm)
    check("group route", route == "monomial-splice", route)
    outcomes = np.asarray(outcomes)
    check("outcome shape", outcomes.shape == (T, len(sites)),
          str(outcomes.shape))
    check("all monitored outcomes in a trajectory are equal",
          bool(np.all(outcomes == outcomes[:, :1])))
    p0 = float(np.mean(outcomes[:, 0] == 0))
    sigma = 0.5 / math.sqrt(T)
    check("P(0) = 0.5 +- 5 sigma", abs(p0 - 0.5) <= 5 * sigma,
          f"{p0:.3f} +- {5 * sigma:.3f}")
    for i in range(4):
        want = 0 if outcomes[i, 0] == 0 else (1 << n) - 1
        p = states[i].probabilities
        check(f"trajectory {i} collapsed onto |{'0' if want == 0 else '1'}"
              "...>", abs(p[want] - 1) <= 1e-5, f"{p[want]:.7f}")


def phase_bridge(oracle):
    from quantum_simulator_tpu.bridge.client import SimulatorClient
    from quantum_simulator_tpu.bridge.server import BridgeServer
    from quantum_simulator_tpu.ops import program as prog

    n, shots = SIZES["bridge_n"], 4096
    c = oracle.brickwork_circuit(n, 12, seed=22, complex_=True)
    route = prog.forward_route(prog.compile_circuit(c))
    server = BridgeServer(host="127.0.0.1", port=0)
    server.start()
    try:
        with SimulatorClient(port=server.port, timeout=900.0) as client:
            client.set_circuit(c.to_dict())
            r1, r2, cold, warm = twice(
                lambda: client.run(shots=shots, seed=9))
    finally:
        server.stop()
    phase_line(f"bridge-n{n}", route, cold, warm)
    counts = r2["measurement_counts"]
    total = sum(counts.values())
    check("counts total equals shots", total == shots, str(total))
    check("seeded runs agree", r1["measurement_counts"] == counts)
    bits = min(8, n)
    p = oracle.coarse_distribution(np.abs(oracle.run_circuit(c)) ** 2, n,
                                   bits)
    q = oracle.coarse_distribution(counts, n, bits)
    d, bound = oracle.tvd(p, q), oracle.tvd_bound(p, shots)
    check(f"TVD(top-{bits}-qubit marginal) vs ideal <= bound", d <= bound,
          f"{d:.4f} <= {bound:.4f}")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(oracle):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantum_simulator_tpu import (DepolarizingNoise, NoiseModel,
                                       Simulator)
    from quantum_simulator_tpu.parallel.distributed import (
        AMP_AXIS, DistributedSimulator, shard_map_compat)
    from quantum_simulator_tpu.parallel.vqe import (make_vqe_mesh,
                                                    sharded_vqe_step)

    devs = jax.devices()
    check("four cards visible", len(devs) >= 4, str(len(devs)))
    dsim = DistributedSimulator(n_devices=4)
    mesh = dsim.mesh

    def on_four(arr, what):
        ds = arr.sharding.device_set
        check(f"{what} sharded over 4 cards", len(ds) == 4,
              str(sorted(d.id for d in ds)))

    # QFT-32 on a basis input vs the analytic DFT state, overlap taken
    # shard-locally (no gather of the 32 GiB state).
    n = SIZES["qft_mesh_n"]
    x = 0x9E3779B1 % (1 << n)
    c = oracle.qft_circuit(n, x)
    _, st, cold, warm = twice(lambda: dsim.run(c),
                              lambda s: s.device_data.delete())
    phase_line("four-cards-qft32", "sharded", cold, warm)
    on_four(st.device_data, "QFT-32 state")
    n_local = n - 2

    def overlap(block):
        dev = jax.lax.axis_index(AMP_AXIS).astype(jnp.uint32)
        k = (dev << n_local) | jax.lax.iota(jnp.uint32, 1 << n_local)
        xk = k * jnp.uint32(x)  # mod 2^32 by uint32 wraparound
        if n < 32:
            xk = xk & jnp.uint32((1 << n) - 1)
        hi = (xk >> 16).astype(jnp.float32) / 65536.0
        lo = (xk & 0xFFFF).astype(jnp.float32) / 4294967296.0
        # phase = (x k mod 2^n) / 2^n, split in two f32-exact halves.
        ang = 2 * jnp.pi * (hi + lo) * (2.0 ** (32 - n))
        a_re = jnp.cos(ang) / math.sqrt(2.0 ** n)
        a_im = jnp.sin(ang) / math.sqrt(2.0 ** n)
        re = jnp.sum(a_re * block.real + a_im * block.imag)
        im = jnp.sum(a_re * block.imag - a_im * block.real)
        return jax.lax.psum(jnp.stack([re, im]), AMP_AXIS)

    ov = jax.jit(shard_map_compat(overlap, mesh, (P(AMP_AXIS),), P()))(
        st.device_data)
    fid = float(ov[0] ** 2 + ov[1] ** 2)
    # The MESH32 acceptance bound: f32 phases over 496 CPhase rotations.
    check("QFT-32 fidelity vs analytic DFT >= 1 - 1e-4", fid >= 1 - 1e-4,
          f"{1 - fid:.3e}")
    st.device_data.delete()

    # n=28 complex brickwork: sharded vs the single-card Simulator.
    n = SIZES["brick_mesh_n"]
    c = oracle.brickwork_circuit(n, 8, seed=28, complex_=True)
    _, st, cold, warm = twice(lambda: dsim.run(c),
                              lambda s: s.device_data.delete())
    phase_line("four-cards-brickwork28", "sharded", cold, warm)
    on_four(st.device_data, "n=28 state")
    single = Simulator().run(c, shots=0).final_state.device_data
    check("single-card reference on device 0",
          single.sharding.device_set == {devs[0]})
    err = float(jnp.max(jnp.abs(
        jax.device_put(single, st.device_data.sharding) - st.device_data)))
    # Same f32 pass bound as the single-card ideal phase.
    check("max |d amp| sharded vs single card <= 1e-5", err <= 1e-5,
          f"{err:.3e}")
    del single
    st.device_data.delete()

    # Sharded noisy shots keep their total.
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.02))
    cn = oracle.brickwork_circuit(n, 4, seed=29)
    shots = 1000
    counts, _, cold, warm = twice(lambda: dsim.run_with_noise(
        cn, nm, shots=shots, trajectories=4, seed=30))
    phase_line("four-cards-run_with_noise28", "sharded", cold, warm)
    total = sum(counts.values())
    check("sharded run_with_noise shot total", total == shots, str(total))

    # One sharded VQE step vs the single-device cost.
    n = SIZES["vqe_n"]
    cv = oracle.brickwork_circuit(n, 6, seed=20)
    vmesh = make_vqe_mesh(4)
    vqe = sharded_vqe_step(cv, vmesh, observable=[(1.0, [0]), (0.5, [3, 7])])
    (_, cost), _, cold, warm = twice(lambda: vqe.step(vqe.init))
    phase_line("four-cards-vqe-step20", f"mesh{dict(vmesh.shape)}", cold,
               warm)
    psi = oracle.run_circuit(cv)
    p = np.abs(psi) ** 2
    idx = np.arange(1 << n)
    z = lambda q: 1 - 2 * ((idx >> (n - 1 - q)) & 1)  # noqa: E731
    want = float(np.sum(p * z(0)) + 0.5 * np.sum(p * z(3) * z(7)))
    single = Simulator().run(cv, shots=0).final_state.probabilities
    got_single = float(np.sum(single * z(0))
                       + 0.5 * np.sum(single * z(3) * z(7)))
    # f32 sums over 2^20 probabilities.
    check("sharded VQE cost vs single-device cost (abs <= 1e-5)",
          abs(float(cost) - got_single) <= 1e-5,
          f"{float(cost):.7f} vs {got_single:.7f} (oracle {want:.7f})")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the DistributedSimulator phase on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    from quantum_simulator_tpu.config import device_memory_budget

    smi = nvidia_smi()
    log(f"device kind={devs[0].device_kind} platform={devs[0].platform} "
        f"count={len(devs)} bytes_limit={device_memory_budget()} "
        f"nvidia-smi: {smi}")
    if args.four_cards:
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("ideal", phase_ideal), ("huge", phase_huge),
                  ("noisy", phase_noisy), ("monitored", phase_monitored),
                  ("bridge", phase_bridge)]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(oracle)
        except Exception:  # reported, and the run then exits nonzero
            traceback.print_exc()
            failed.append(name)
            log(f"phase={name} FAILED")
        log(f"phase={name} wall_s={time.perf_counter() - t0:.1f}")
    log(f"total_s={time.perf_counter() - t_all:.1f}")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    log(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
