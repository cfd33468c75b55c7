"""Timings that set the GPU route thresholds and the huge-state layout.

Run on a GPU (one process, one card):

    python scripts/route_timings.py [--sections forward,traj,layout,passes]

Sections:

  forward  plan executor vs per-gate einsum program, n = 8, 12, 16, 20
           (brickwork depth 40, the ``bench.py`` circuit; complex too at
           n = 16): warm seconds
           per ``forward`` call and cold (compile + first call) seconds.
           Decides whether the GPU forward needs a threshold.
  traj     splice trajectory bodies vs the per-gate trajectory body,
           n = 12, 16, 20, batch 256, depolarizing 0.05 and amplitude
           damping 0.05 (brickwork depth 8), through the production
           chunked runner. Sets ``_PLAN_EXECUTOR_MIN_QUBITS``.
  layout   the n=30 huge apply program compiled with AUTO entry layouts
           vs the plain donated jit the huge route uses: whether it
           compiles, its
           ``memory_analysis()``, and warm apply seconds (QFT-30 planar,
           brickwork-30 real).
  passes   one XLA dense step (AxisMatmulStep) and one cross step
           (CrossStep) per pass at n = 28 and 30, real and planar forms:
           seconds per pass, effective GB/s (read + write of the state)
           and TFLOP/s (the step's multiply-adds).

Every line names the device; the card's name and power limit come from
``nvidia-smi``. Timings are host clock around ``block_until_ready``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


# Sizes of each section (a CPU rehearsal may shrink them).
FORWARD_NS = (8, 12, 16, 20)
TRAJ_NS = (12, 16, 20)
TRAJ_BATCH = 256
LAYOUT_N = 30
PASS_NS = (28, 30)


def log(*parts):
    print(*parts, flush=True)


def warm_median(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn()
        jax_block(r)
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def jax_block(r):
    import jax

    jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready")
        else a, r)


def cold(fn):
    t0 = time.perf_counter()
    jax_block(fn())
    return time.perf_counter() - t0


def section_forward():
    import jax
    import jax.numpy as jnp
    import oracle

    from quantum_simulator_tpu.ops import program as prog
    from quantum_simulator_tpu.ops.plan import group_forward_fn

    for n in FORWARD_NS:
        for cplx in (False, True) if n == 16 else (False,):
            c = oracle.brickwork_circuit(n, 40, seed=n, complex_=cplx)
            p = prog.compile_circuit(c)
            params = jnp.asarray(p.initial_params)
            plan_fn = group_forward_fn(p, jnp.complex64)
            gate_fn = jax.jit(lambda q, p=p: prog._forward_body(
                p, q, jnp.complex64))
            row = {}
            for name, fn in (("plan", plan_fn), ("per-gate", gate_fn)):
                row[name + "_cold"] = cold(lambda: fn(params))
                row[name] = warm_median(lambda: fn(params), 20)
            log(f"forward n={n} {'complex' if cplx else 'real'} "
                f"plan_warm_ms={row['plan'] * 1e3:.3f} "
                f"pergate_warm_ms={row['per-gate'] * 1e3:.3f} "
                f"plan_cold_s={row['plan_cold']:.2f} "
                f"pergate_cold_s={row['per-gate_cold']:.2f}")


def section_traj():
    import jax
    import jax.numpy as jnp
    import oracle

    from quantum_simulator_tpu import (AmplitudeDampingNoise,
                                       DepolarizingNoise, NoiseModel)
    from quantum_simulator_tpu.ops import program as prog
    from quantum_simulator_tpu.simulator import run_batched_trajectories

    T = TRAJ_BATCH
    for n in TRAJ_NS:
        c = oracle.brickwork_circuit(n, 8, seed=n)
        p = prog.compile_circuit(c)
        params = jnp.asarray(p.initial_params)
        keys = jax.random.split(jax.random.PRNGKey(0), T)
        for label, ch in (("depolarizing", DepolarizingNoise(0.05)),
                          ("amplitude-damping", AmplitudeDampingNoise(0.05))):
            nm = NoiseModel()
            nm.add_global_noise(ch)
            group_body = prog._group_traj_body(p, nm, jnp.complex64, False)
            kind = prog._group_traj_kind(p, nm, False)
            gate_body = (lambda q, k, p=p, nm=nm: prog._trajectory_body(
                p, nm.kraus_stacks_for_gate, q, k, jnp.complex64, False))
            row = {}
            for name, body in ((kind, group_body), ("per-gate", gate_body)):
                fn = jax.jit(jax.vmap(body, in_axes=(None, 0)))
                run = (lambda fn=fn: run_batched_trajectories(
                    fn, params, keys, 1 << n))
                row[name + "_cold"] = cold(run)
                row[name] = warm_median(run, 3)
            log(f"traj n={n} {label} batch={T} "
                f"{kind}_warm_s={row[kind]:.4f} "
                f"pergate_warm_s={row['per-gate']:.4f} "
                f"{kind}_traj_per_s={T / row[kind]:.1f} "
                f"pergate_traj_per_s={T / row['per-gate']:.1f} "
                f"{kind}_cold_s={row[kind + '_cold']:.2f} "
                f"pergate_cold_s={row['per-gate_cold']:.2f}")


def _mem(compiled):
    m = compiled.memory_analysis()
    gib = 1 << 30
    return (f"arg_gib={m.argument_size_in_bytes / gib:.3f} "
            f"out_gib={m.output_size_in_bytes / gib:.3f} "
            f"alias_gib={m.alias_size_in_bytes / gib:.3f} "
            f"temp_gib={m.temp_size_in_bytes / gib:.3f}")


def section_layout():
    import jax
    import jax.numpy as jnp
    import oracle

    from quantum_simulator_tpu.ops import bigstate
    from quantum_simulator_tpu.ops import program as prog
    from quantum_simulator_tpu.ops.plan import (_planar_basis_state,
                                                _real_basis_state,
                                                get_group_plan)

    n = LAYOUT_N
    cases = (("qft30", oracle.qft_circuit(n, 0x2A5F3C1)),
             ("brickwork30-real", oracle.brickwork_circuit(n, 8, seed=30)))
    for label, c in cases:
        p = prog.compile_circuit(c)
        plan = get_group_plan(p)
        shape = tuple(plan.layout.axis_sizes)
        if not plan.all_real:
            shape = (2,) + shape
        sds = (jax.ShapeDtypeStruct((len(p.initial_params),), jnp.float32),
               jax.ShapeDtypeStruct(shape, jnp.float32))
        params = jnp.asarray(p.initial_params, jnp.float32)
        init = (_real_basis_state if plan.all_real
                else _planar_basis_state)
        chunks = bigstate.auto_chunks(n, planar=not plan.all_real)
        plain = jax.jit(
            lambda q, x, p=p, plan=plan: bigstate._apply_body(
                p, plan, jnp.complex64, q, x),
            donate_argnums=(1,)).lower(*sds).compile()
        log(f"layout {label} chunks={chunks} plain {_mem(plain)}")
        x = jax.jit(lambda: init(plan.layout, p.initial_index))()
        x = plain(params, x)
        x.block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            x = plain(params, x)
            x.block_until_ready()
            ts.append(time.perf_counter() - t0)
        log(f"layout {label} plain apply_warm_s={min(ts):.4f}")
        x.delete()
        try:
            t0 = time.perf_counter()
            from jax.experimental.layout import Format, Layout

            auto = jax.jit(
                lambda q, x, p=p, plan=plan: bigstate._apply_body(
                    p, plan, jnp.complex64, q, x),
                in_shardings=(Format(), Format(Layout.AUTO)),
                out_shardings=Format(Layout.AUTO),
                donate_argnums=(1,)).lower(*sds).compile()
            log(f"layout {label} auto compiled in "
                f"{time.perf_counter() - t0:.1f}s {_mem(auto)} "
                f"entry={auto.input_formats[0][1]}")
        except Exception as e:  # noqa: BLE001 - the finding is the error
            log(f"layout {label} auto FAILED {type(e).__name__}: "
                f"{str(e).splitlines()[0][:300]}")
            continue
        fmt_x = auto.input_formats[0][1]
        x = jax.jit(lambda: init(plan.layout, p.initial_index),
                    out_shardings=fmt_x)()
        x = auto(params, x)
        x.block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            x = auto(params, x)
            x.block_until_ready()
            ts.append(time.perf_counter() - t0)
        log(f"layout {label} auto apply_warm_s={min(ts):.4f}")
        x.delete()


def section_passes():
    import jax
    import jax.numpy as jnp
    import oracle

    from quantum_simulator_tpu.ops import program as prog
    from quantum_simulator_tpu.ops.plan import (_HI, AxisMatmulStep,
                                                CrossStep, _cross_spec,
                                                _dense_spec, _split_axis_bit,
                                                build_group_operands,
                                                get_group_plan)

    reps = 10
    for n in PASS_NS:
        for cplx in (False, True):
            c = oracle.brickwork_circuit(n, 8, seed=n, complex_=cplx)
            p = prog.compile_circuit(c)
            plan = get_group_plan(p)
            planar = not plan.all_real
            ops = build_group_operands(p, plan, jnp.asarray(
                p.initial_params), jnp.complex64)
            axis_stacks, cross_ops = ops[0], ops[1]
            shape = tuple(plan.layout.axis_sizes)
            rank = len(shape)
            lead = (2,) if planar else ()
            dense = max((s for s in plan.steps
                         if isinstance(s, AxisMatmulStep)),
                        key=lambda s: shape[s.axis])
            cross = next(s for s in plan.steps if isinstance(s, CrossStep))

            real = plan.dense_real[dense.axis][dense.op_index]
            dop = axis_stacks[dense.axis][dense.op_index]
            dop = dop[0, 0] if real else dop
            dspec = _dense_spec(rank, dense.axis, real, planar)
            K_d = shape[dense.axis]

            creal = plan.cross_real[cross.index]
            cop = cross_ops[cross.index]
            cop = cop[0, 0] if creal else cop
            new_shape, bit_axis = _split_axis_bit(shape, cross.slice_axis,
                                                  cross.slice_pos)
            o = cross.op_axis + (2 if cross.op_axis > cross.slice_axis
                                 else 0)
            cspec = _cross_spec(len(new_shape), bit_axis, o, creal, planar)
            K_c = 2 * shape[cross.op_axis]

            def dense_fn(x, dop=dop, dspec=dspec):
                return jnp.einsum(dspec, dop, x, precision=_HI)

            def cross_fn(x, cop=cop, cspec=cspec, new_shape=new_shape,
                         lead=lead):
                xr = x.reshape(lead + new_shape)
                xr = jnp.einsum(cspec, cop, xr, precision=_HI)
                return xr.reshape(lead + shape)

            amps = 1 << n
            state_bytes = amps * 4 * (2 if planar else 1)
            for name, fn, K, op_real in (("dense", dense_fn, K_d, real),
                                         ("cross", cross_fn, K_c, creal)):
                f = jax.jit(fn, donate_argnums=(0,))
                x = jnp.zeros(lead + shape, jnp.float32).at[
                    (0,) * (len(lead) + rank)].set(1.0)
                x = f(x)
                x.block_until_ready()
                t0 = time.perf_counter()
                for _ in range(reps):
                    x = f(x)
                x.block_until_ready()
                dt = (time.perf_counter() - t0) / reps
                x.delete()
                # multiply-adds per amplitude: K per output plane, times
                # 2 output planes x 2 input planes for a complex operator
                # on a planar state, 2 for a real operator on it.
                planes = (4 if (planar and not op_real)
                          else 2 if planar else 1)
                flops = 2 * K * amps * planes
                log(f"pass n={n} {'planar' if planar else 'real'} {name} "
                    f"K={K} op={'real' if op_real else 'complex'} "
                    f"ms_per_pass={dt * 1e3:.3f} "
                    f"eff_GBps={2 * state_bytes / dt / 1e9:.1f} "
                    f"TFLOPps={flops / dt / 1e12:.2f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="forward,traj,layout,passes")
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"route_timings: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device kind={dev.device_kind} nvidia-smi: {smi}")
    for s in args.sections.split(","):
        t0 = time.perf_counter()
        globals()["section_" + s]()
        log(f"section {s} took {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
