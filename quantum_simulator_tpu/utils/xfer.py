"""Complex-safe host<->device transfers.

All complex host<->device transfers go through split real/imag float
planes; float transfers pass straight through. This is correct on every
backend; whether the GPU still needs it is an open simplicity item
(ROADMAP.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnums=(2,))
def _combine_planes(re, im, dtype):
    # Inside jit the 1j constant is program-internal: the complex value
    # is formed on the device.
    return (re + 1j * im).astype(dtype)


def to_device_complex(array, dtype) -> jnp.ndarray:
    """NumPy (complex or real) -> device array of complex ``dtype``."""
    arr = np.asarray(array)
    real_dt = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    re = jnp.asarray(np.ascontiguousarray(arr.real), dtype=real_dt)
    if np.iscomplexobj(arr):
        im = jnp.asarray(np.ascontiguousarray(arr.imag), dtype=real_dt)
        return _combine_planes(re, im, dtype)
    return re.astype(dtype)


def to_host_complex(x) -> np.ndarray:
    """Device array -> NumPy complex128 (or float64 for real inputs)."""
    if isinstance(x, np.ndarray):
        return x.astype(np.complex128) if np.iscomplexobj(x) else x
    if jnp.iscomplexobj(x):
        re = np.asarray(jnp.real(x), dtype=np.float64)
        im = np.asarray(jnp.imag(x), dtype=np.float64)
        return re + 1j * im
    return np.asarray(x)


def to_host_float(x) -> np.ndarray:
    """Device real array -> NumPy float64."""
    return np.asarray(x, dtype=np.float64)
