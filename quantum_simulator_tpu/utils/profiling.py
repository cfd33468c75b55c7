"""Profiling and tracing utilities.

The reference's observability is wall-clock timers + a psutil panel
(SURVEY.md §5). Accelerator equivalents:

* ``trace(logdir)``: context manager around ``jax.profiler`` — produces a
  TensorBoard-compatible device trace of every XLA launch;
* ``time_compiled(fn, *args)``: compile-excluded, device-synchronized
  wall time with chained-dependency repeats (repeated identical dispatches
  can be elided by some runtimes — see bench.py);
* ``hbm_traffic_estimate``: bytes a circuit's forward pass must move at
  minimum, for roofline comparisons.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable
from dataclasses import dataclass

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/qsim-trace"):
    """Capture a device trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclass
class TimingResult:
    mean_s: float
    best_s: float
    repeats: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1000


def time_compiled(fn, *args, repeats: int = 10,
                  chain: "Callable | None" = None) -> TimingResult:
    """Time a jitted callable excluding compilation.

    Each repeat's output is fed back into the next call, so repeated
    identical dispatches cannot be deduplicated: by default the first
    positional arg is replaced with the output when shapes/dtypes match;
    pass ``chain(out, args) -> args`` for anything fancier.
    """
    out = fn(*args)
    jax.block_until_ready(out)

    def default_chain(prev, a):
        if (a and hasattr(prev, "shape") and hasattr(a[0], "shape")
                and prev.shape == a[0].shape and prev.dtype == a[0].dtype):
            return (prev,) + tuple(a[1:])
        return a

    chain = chain or default_chain
    times = []
    for _ in range(repeats):
        args = tuple(chain(out, args))
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return TimingResult(mean_s=sum(times) / len(times), best_s=min(times),
                        repeats=repeats)


def hbm_traffic_estimate(num_qubits: int, num_passes: int,
                         bytes_per_amp: int = 8) -> int:
    """Minimum HBM bytes for ``num_passes`` full-state read+write sweeps."""
    return num_passes * 2 * (2**num_qubits) * bytes_per_amp


def roofline_fraction(num_qubits: int, num_passes: int, measured_s: float,
                      *, hbm_bytes_per_s: float,
                      bytes_per_amp: int = 8) -> float:
    """Fraction of the memory-bandwidth roofline achieved at the device
    rate ``hbm_bytes_per_s`` (no default: the rate belongs to the device
    the time was measured on). 1.0 = at the floor; >1 means the state
    stayed in on-chip cache. ``bytes_per_amp`` is 8
    for planar complex64 evolution, 4 when the executor's all-real path
    carries a single f32 plane (``GroupPlan.all_real``)."""
    floor_s = hbm_traffic_estimate(num_qubits, num_passes,
                                   bytes_per_amp) / hbm_bytes_per_s
    return floor_s / measured_s if measured_s > 0 else float("inf")
