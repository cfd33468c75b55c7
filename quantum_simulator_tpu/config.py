"""Global engine configuration for the quantum simulator.

The reference engine (``/root/reference/quantum_sim/engine``) is pure NumPy
complex128 and hard-caps circuits at 16 qubits (``state_vector.py:16``,
``circuit.py:130``). This rebuild keeps amplitudes in complex64 on the
accelerator (half the bytes of complex128, so twice the qubits fit per
byte of device memory and every bandwidth-bound pass moves half the
data), and sharding over a device mesh lifts the qubit cap far beyond 16.

Precision policy:
  * device compute defaults to complex64 (memory and bandwidth), with
    every contraction at ``Precision.HIGHEST`` (no TF32),
  * tiny host-side reductions (2x2 density matrices, eigenvalues, confusion
    matrices) run in NumPy float64/complex128 for reference-grade accuracy,
  * a complex128 device mode exists for verification on CPU backends.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class EngineConfig:
    """Mutable global knobs for the simulation engine."""

    # Device dtype for statevector amplitudes.
    dtype: object = jnp.complex64
    # Hard cap on single-device qubit count (2**32 complex64 amplitudes
    # = 32 GiB; whether a width fits is decided against the device's
    # memory budget, see ``device_memory_budget``). Sharded states may
    # exceed this per-mesh.
    max_qubits: int = 32
    # Structural cap on the circuit IR itself. Non-amplitude engines
    # (the Clifford tableau engine, the Pauli-frame QEC engine) hold
    # hundreds of qubits in O(n^2) bits, so the IR accepts far more than
    # the amplitude engines do; every amplitude path validates against
    # ``max_qubits`` at its own entry.
    max_circuit_qubits: int = 4096
    # Compile-cache size (circuit-structure keyed).
    compile_cache_size: int = 128
    # Interactive (edit-hot) forward routing: when True, a circuit
    # structure with no fused compiled program yet runs through the
    # skeleton-keyed executor (ops/plan.interactive_forward_fn) — a
    # 1-gate edit that preserves the plan's step skeleton reuses the
    # compiled executable instead of paying a fresh compile. The GUI
    # bootstrap flips this on; batch/bench paths keep the fused
    # (operands-in-trace) program.
    interactive: bool = False

    @property
    def real_dtype(self):
        return jnp.float64 if self.dtype == jnp.complex128 else jnp.float32


CONFIG = EngineConfig()


_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def _bootstrap_compilation_cache() -> str | None:
    """Place JAX's persistent compilation cache, so a process pays each
    device compile once per machine rather than once per process.

    * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is
      placed in code and that directory is the only cache.
    * otherwise, on an accelerator: one fixed directory inside the
      checkout (``.jax_cache/``, git-ignored). The path is part of the
      cache key, so it must not move between runs.
    * ``JAX_PLATFORMS=cpu`` (the tests, the virtual mesh): off. XLA:CPU
      AOT entries pin compile-machine features (``+prefer-no-gather``)
      that its loader then rejects on the same host, so every lookup
      logs a ``cpu_aot_loader`` error and recompiles anyway.

    Only compiles slower than 1 s persist (the device programs; tiny
    helper jits stay memory-only)."""
    loc = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if not loc:
        if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
            return None
        loc = _REPO_CACHE_DIR
        try:
            os.makedirs(loc, exist_ok=True)
        except OSError:  # pragma: no cover - read-only checkout
            return None
        jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return loc


COMPILE_CACHE_DIR = _bootstrap_compilation_cache()


def default_backend() -> str:
    return jax.default_backend()


def on_gpu() -> bool:
    """The one backend predicate for route selection: True when JAX's
    default backend is a GPU. It picks the group-plan forward, the
    splice trajectory bodies and the huge-state (n >= 30) route; on the
    CPU every path keeps the per-gate programs the tests were written
    against."""
    return jax.default_backend() == "gpu"


def _host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def device_memory_budget() -> int:
    """Bytes one device may allocate: ``memory_stats()["bytes_limit"]``
    of the first device (what the allocator was given, e.g. three
    quarters of an 80 GB H100 by default), or host memory on the CPU,
    whose devices report no limit. Memory schedules (chunking, the
    sampler's probability dtype, the GUI's capacity table) derive from
    this one number; tests pass an explicit budget instead."""
    try:
        stats = jax.devices()[0].memory_stats() or {}
    except Exception:  # pragma: no cover - backend without stats
        stats = {}
    limit = stats.get("bytes_limit")
    return int(limit) if limit else _host_memory_bytes()


def statevector_dtype():
    return CONFIG.dtype


def np_dtype():
    """NumPy dtype mirror for host-side reference computations."""
    return np.complex128


def enable_complex128() -> None:
    """Switch the engine to complex128 verification mode.

    Requires x64 support in jax (enabled here); intended for CPU-backend
    numerical verification — complex128 doubles every state's bytes and
    runs at the accelerator's far lower f64 rate. Call BEFORE building
    any compiled programs.
    """
    jax.config.update("jax_enable_x64", True)
    CONFIG.dtype = jnp.complex128


def enable_complex64() -> None:
    """Back to the complex64 default."""
    CONFIG.dtype = jnp.complex64
