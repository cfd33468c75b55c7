"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding logic is validated on XLA's host
platform with 8 virtual devices (SURVEY.md §4 fake-mesh plan). The GPU
path is driven on a card by ``python chip_smoke.py``. Must set the env
vars BEFORE jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Force the platform through the config API too, in case an installed
# plugin registered another backend first.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
