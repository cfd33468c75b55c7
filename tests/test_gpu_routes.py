"""Backend routing, device memory budget, compile-cache placement, the
NumPy oracle, matmul precision and the on-card smoke script.

The GPU routes are exercised here on the CPU backend by making
``jax.default_backend()`` report ``"gpu"`` (the one predicate,
``config.on_gpu``, reads it at call time).
"""

import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import oracle
from quantum_simulator_tpu import (AmplitudeDampingNoise, DepolarizingNoise,
                                   NoiseModel, Simulator, config)
from quantum_simulator_tpu.ops import bigstate, bigtraj
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.simulator import _is_huge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _depol(p=0.05):
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(p))
    return nm


def _prog(n, depth=4, complex_=False):
    return prog.compile_circuit(
        oracle.brickwork_circuit(n, depth, seed=n, complex_=complex_))


# ---------------------------------------------------------------------------
# One predicate: every former backend-gated site picks its GPU route
# ---------------------------------------------------------------------------

def _site_forward():
    return prog.forward_route(_prog(8)) == "plan"


def _site_evolve():
    p = _prog(8)
    prog.evolve_fn(p)
    return ("evolve", p.compile_key, str(config.CONFIG.dtype),
            True) in prog._CACHE


def _site_trajectory():
    p = _prog(prog._PLAN_EXECUTOR_MIN_QUBITS)
    return prog.trajectory_route(p, _depol()) == "unitary-splice"


def _site_monitored():
    return prog._use_group_path(_prog(prog._PLAN_EXECUTOR_MIN_QUBITS))


def _site_huge():
    return _is_huge(oracle.brickwork_circuit(30, 2, seed=0))


def _site_quantum_volume(monkeypatch):
    from quantum_simulator_tpu.analysis import BenchmarkAnalysis
    from quantum_simulator_tpu.ops import plan

    calls = []
    real = plan.group_forward_body
    monkeypatch.setattr(plan, "group_forward_body",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    BenchmarkAnalysis.quantum_volume_at_scale(widths=(3,), num_trials=2,
                                              seed=0, chunk=2)
    return bool(calls)


class _HugeRoute(Exception):
    pass


def _site_superop(monkeypatch):
    from quantum_simulator_tpu import DensityMatrixSimulator, QuantumCircuit

    def hit(*a, **k):
        raise _HugeRoute

    monkeypatch.setattr(bigstate, "huge_forward_fn", hit)
    sim = DensityMatrixSimulator(noise_model=_depol())
    try:
        sim._run_superop(QuantumCircuit(15))
    except _HugeRoute:
        return True
    return False


def _site_huge_run(monkeypatch):
    monkeypatch.setattr(bigstate, "HUGE_STATE_BYTES", 8 << 10)
    c = oracle.qft_circuit(10, 613)
    sv = Simulator().run(c, shots=64, seed=0).final_state
    ks = [0, 1, 613, 1023]
    got = np.array([sv.amplitude(k) for k in ks])
    return (isinstance(sv, bigstate.PlanarStateVector)
            and np.abs(got - oracle.qft_amplitudes(10, 613, ks)).max()
            < 1e-5)


def _site_huge_noisy_run(monkeypatch):
    monkeypatch.setattr(bigstate, "HUGE_STATE_BYTES", 8 << 10)
    res = Simulator(noise_model=_depol()).run(
        oracle.brickwork_circuit(10, 4, seed=1), shots=64, seed=0)
    return (isinstance(res.final_state, bigstate.PlanarStateVector)
            and sum(res.measurement_counts.values()) == 64)


_SITES = {
    "forward": _site_forward,
    "evolve": _site_evolve,
    "trajectory": _site_trajectory,
    "monitored": _site_monitored,
    "huge": _site_huge,
    "quantum-volume": _site_quantum_volume,
    "superop": _site_superop,
    "huge-run": _site_huge_run,
    "huge-noisy-run": _site_huge_noisy_run,
}


@pytest.mark.parametrize("site", sorted(_SITES))
def test_predicate_picks_gpu_route(site, gpu, monkeypatch):
    fn = _SITES[site]
    args = (monkeypatch,) if fn.__code__.co_argcount else ()
    assert fn(*args), site


def test_cpu_keeps_per_gate_routes():
    assert not config.on_gpu()
    assert prog.forward_route(_prog(8)) == "per-gate"
    assert prog.trajectory_route(_prog(20), _depol()) == "per-gate"
    assert not _is_huge(oracle.brickwork_circuit(30, 2, seed=0))


@pytest.mark.parametrize("channel, want", [
    (DepolarizingNoise(0.05), "unitary-splice"),
    (AmplitudeDampingNoise(0.05), "monomial-splice"),
])
def test_trajectory_route_matches_selector(channel, want, gpu):
    nm = NoiseModel()
    nm.add_global_noise(channel)
    p = _prog(prog._PLAN_EXECUTOR_MIN_QUBITS)
    assert prog.trajectory_route(p, nm) == want
    assert prog.trajectory_route(p, nm, record_columns=True) \
        == "group-per-gate"
    assert prog.trajectory_route(_prog(8), nm) == "per-gate"


@pytest.mark.parametrize("planar", [True, False])
def test_huge_apply_donates_the_state(planar):
    """The donated apply aliases its output onto the input state: no
    second whole-state buffer is held across the dispatch."""
    from quantum_simulator_tpu.ops.plan import get_group_plan

    p = _prog(12, complex_=planar)
    plan = get_group_plan(p)
    shape = ((2,) if planar else ()) + tuple(plan.layout.axis_sizes)
    fn = bigstate._huge_apply_fn(p, jnp.complex64)
    mem = fn.lower(jax.ShapeDtypeStruct((len(p.initial_params),),
                                        jnp.float32),
                   jax.ShapeDtypeStruct(shape, jnp.float32)
                   ).compile().memory_analysis()
    assert mem.alias_size_in_bytes == 4 * math.prod(shape)


def test_dryrun_multichip_raises_on_gpu(monkeypatch):
    import types

    sys.path.insert(0, REPO)
    import __graft_entry__ as entry

    fake = [types.SimpleNamespace(platform="gpu")]
    monkeypatch.setattr(jax, "devices", lambda *a: fake)
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        entry.dryrun_multichip(4)


# ---------------------------------------------------------------------------
# One memory budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget_gib, n, planar, want", [
    (16, 29, True, jnp.float32), (16, 30, True, jnp.bfloat16),
    (16, 30, False, jnp.float32), (16, 31, False, jnp.bfloat16),
    (80, 30, True, jnp.float32), (80, 31, True, jnp.float32),
    (80, 31, False, jnp.float32), (80, 32, False, jnp.float32),
])
def test_sampling_probs_dtype_budget(budget_gib, n, planar, want):
    assert bigstate.sampling_probs_dtype(
        n, planar, budget=budget_gib << 30) == want


@pytest.mark.parametrize("budget_gib", [16, 80])
def test_is_huge_keys_on_state_size(budget_gib, gpu, monkeypatch):
    monkeypatch.setattr(config, "device_memory_budget",
                        lambda: budget_gib << 30)
    for n, want in ((16, False), (29, False), (30, True), (31, True)):
        assert _is_huge(oracle.brickwork_circuit(n, 2, seed=0)) is want, n
    # ...while auto_chunks alone decides whether the huge route chunks.
    assert bigstate.auto_chunks(30) == (8 if budget_gib == 16 else 1)


def test_device_memory_budget_on_cpu_is_host_memory():
    assert config.device_memory_budget() == config._host_memory_bytes()
    assert config.device_memory_budget() > 1 << 30


# ---------------------------------------------------------------------------
# Compile-cache placement
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_calls(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(config.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(config, "_REPO_CACHE_DIR", str(tmp_path / "repo"))
    return calls


def test_cache_env_dir_is_the_only_cache(cache_calls, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert config._bootstrap_compilation_cache() == str(tmp_path / "env")
    assert not any(k == "jax_compilation_cache_dir" for k, _ in cache_calls)
    assert not os.path.exists(tmp_path / "repo")


def test_cache_unset_uses_fixed_checkout_dir(cache_calls, monkeypatch,
                                             tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    loc = config._bootstrap_compilation_cache()
    assert loc == str(tmp_path / "repo") and os.path.isdir(loc)
    assert ("jax_compilation_cache_dir", loc) in cache_calls


def test_cache_off_on_cpu(cache_calls, monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert config._bootstrap_compilation_cache() is None
    assert cache_calls == []


def test_checkout_cache_dir_is_gitignored():
    rel = os.path.relpath(config._REPO_CACHE_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel + "/" in f.read().split()


# ---------------------------------------------------------------------------
# The NumPy oracle against Simulator.run
# ---------------------------------------------------------------------------

_CIRCUITS = {
    "brick-real-4": lambda: oracle.brickwork_circuit(4, 10, seed=1),
    "brick-real-10": lambda: oracle.brickwork_circuit(10, 12, seed=2),
    "brick-complex-6": lambda: oracle.brickwork_circuit(6, 8, 3, True),
    "brick-complex-12": lambda: oracle.brickwork_circuit(12, 8, 4, True),
    "qft-5": lambda: oracle.qft_circuit(5, 19),
    "qft-9": lambda: oracle.qft_circuit(9, 300),
    "ghz-4": lambda: oracle.ghz_circuit(4),
    "ghz-12": lambda: oracle.ghz_circuit(12),
}


@pytest.mark.parametrize("routes", ["cpu", "gpu"])
@pytest.mark.parametrize("name", sorted(_CIRCUITS))
def test_oracle_matches_simulator(name, routes, monkeypatch):
    if routes == "gpu":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    c = _CIRCUITS[name]()
    got = Simulator().run(c, shots=0).final_state.data
    ref = oracle.run_circuit(c)
    assert np.abs(got - ref).max() <= 1e-5
    assert oracle.fidelity(got, ref) >= 1 - 1e-5


# ---------------------------------------------------------------------------
# Oracle helpers (also used by chip_smoke.py)
# ---------------------------------------------------------------------------

def test_oracle_qft_is_the_dft():
    n, x = 7, 93
    psi = oracle.run_circuit(oracle.qft_circuit(n, x))
    np.testing.assert_allclose(
        psi, oracle.qft_amplitudes(n, x, range(1 << n)), atol=1e-12)
    dft = np.fft.ifft(np.eye(1 << n)[x]) * math.sqrt(1 << n)
    np.testing.assert_allclose(psi, dft, atol=1e-12)


def test_oracle_grover_amplitude():
    from quantum_simulator_tpu.algorithms import AlgorithmTemplate

    n, marked = 8, 77
    psi = oracle.run_circuit(AlgorithmTemplate.grover_search(
        n, marked_state=marked, num_iterations=3))
    assert abs(abs(psi[marked]) - oracle.grover_amplitude(n, 3)) < 1e-12


def test_oracle_gate_application_matches_kron():
    rng = np.random.default_rng(0)
    n = 5
    psi = rng.normal(size=32) + 1j * rng.normal(size=32)
    u1 = oracle.gate_matrix("Rx", (0.7,))
    for q in range(n):
        full = np.kron(np.kron(np.eye(1 << q), u1), np.eye(1 << (n - q - 1)))
        np.testing.assert_allclose(oracle.apply_gate(psi, u1, [q], n),
                                   full @ psi, atol=1e-12)
    cnot = oracle.gate_matrix("CNOT")
    full = np.kron(np.eye(2), np.kron(cnot, np.eye(4)))
    np.testing.assert_allclose(oracle.apply_gate(psi, cnot, [1, 2], n),
                               full @ psi, atol=1e-12)


@pytest.mark.parametrize("channel", ["depolarizing", "amplitude-damping"])
def test_oracle_kraus_qubit_z(channel):
    p, t = 0.05, 0.9
    if channel == "depolarizing":
        kraus = DepolarizingNoise(p).get_kraus_operators()
        want = math.cos(t) * (1 - 4 * p / 3)
    else:
        kraus = AmplitudeDampingNoise(p).get_kraus_operators()
        # P(1) = sin^2(t/2) decays by (1 - p); <Z> = 1 - 2 P(1)
        want = 1 - 2 * math.sin(t / 2) ** 2 * (1 - p)
    assert abs(oracle.kraus_qubit_z([t], kraus) - want) < 1e-12


def test_oracle_tvd_bound_and_coarse_distribution():
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(64))
    shots = 4096
    draws = rng.choice(64, size=shots, p=p)
    counts = {}
    for d in draws:
        s = format(int(d), "06b")
        counts[s] = counts.get(s, 0) + 1
    q = oracle.coarse_distribution(counts, 6, 6)
    assert oracle.tvd(p, q) <= oracle.tvd_bound(p, shots)
    np.testing.assert_allclose(oracle.coarse_distribution(p, 6, 2),
                               p.reshape(4, 16).sum(1))
    assert oracle.tvd_bound(p, 4 * shots) < oracle.tvd_bound(p, shots)


# ---------------------------------------------------------------------------
# Precision: no dot_general below HIGHEST (no TF32 on the GPU)
# ---------------------------------------------------------------------------

def _lowered(kind):
    nm = _depol()
    if kind == "forward-plan-real":
        from quantum_simulator_tpu.ops.plan import group_forward_body

        p = _prog(10)
        return jax.jit(lambda q: group_forward_body(p, q, jnp.complex64)), (
            jnp.asarray(p.initial_params),)
    if kind == "forward-plan-complex":
        from quantum_simulator_tpu.ops.plan import group_forward_body

        p = _prog(10, complex_=True)
        return jax.jit(lambda q: group_forward_body(p, q, jnp.complex64)), (
            jnp.asarray(p.initial_params),)
    if kind == "forward-per-gate":
        p = _prog(8, complex_=True)
        return jax.jit(lambda q: prog._forward_body(p, q, jnp.complex64)), (
            jnp.asarray(p.initial_params),)
    if kind in ("traj-unitary-splice", "traj-monomial-splice"):
        if kind == "traj-monomial-splice":
            nm = NoiseModel()
            nm.add_global_noise(AmplitudeDampingNoise(0.05))
        p = _prog(10)
        body = prog._group_traj_body(p, nm, jnp.complex64, False)
        return jax.jit(body), (jnp.asarray(p.initial_params),
                               jax.random.PRNGKey(0))
    if kind in ("huge-apply-whole", "huge-apply-chunked"):
        from quantum_simulator_tpu.ops.plan import get_group_plan

        p = _prog(12, complex_=True)
        plan = get_group_plan(p)
        chunks = 1 if kind.endswith("whole") else 8
        shape = (2,) + tuple(plan.layout.axis_sizes)

        def fn(q, x):
            ops = bigstate.build_group_operands(p, plan, q, jnp.complex64)
            return bigstate.execute_group_plan_chunked(
                plan, ops, p, q, jnp.complex64, x, chunks)

        return jax.jit(fn), (jnp.asarray(p.initial_params),
                             jnp.zeros(shape, jnp.float32))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", [
    "forward-plan-real", "forward-plan-complex", "forward-per-gate",
    "traj-unitary-splice", "traj-monomial-splice", "huge-apply-whole",
    "huge-apply-chunked"])
def test_every_dot_general_is_highest(kind):
    fn, args = _lowered(kind)
    text = fn.lower(*args).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "expected at least one contraction"
    low = [ln.strip()[:160] for ln in dots if "HIGHEST" not in ln]
    assert not low, low


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode == 2, r.stderr[-500:]
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert not r.stdout.strip() or not r.stdout.strip().splitlines()[
        -1].startswith("{")


def test_chip_smoke_sizes_are_full_width():
    sys.path.insert(0, REPO)
    import chip_smoke

    s = chip_smoke.SIZES
    assert s["huge_n"] == 30 and s["huge_real_n"] == 31
    assert (16, 40, False) in s["ideal"] and s["noisy_n"] == 20
    assert s["batch"] == 256 and s["qft_mesh_n"] == 32
    assert json.loads(json.dumps(s)) is not None
