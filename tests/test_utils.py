"""Utility modules: transfers, profiling, app config, seeding edge cases."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantum_simulator_tpu.utils.profiling import (
    hbm_traffic_estimate,
    roofline_fraction,
    time_compiled,
    trace,
)
from quantum_simulator_tpu.utils.seeding import SeedManager
from quantum_simulator_tpu.utils.xfer import (
    to_device_complex,
    to_host_complex,
    to_host_float,
)


class TestXfer:
    def test_complex_roundtrip(self, rng):
        arr = (rng.normal(size=16) + 1j * rng.normal(size=16)).astype(
            np.complex128)
        dev = to_device_complex(arr, jnp.complex64)
        assert dev.dtype == jnp.complex64
        back = to_host_complex(dev)
        assert back.dtype == np.complex128
        np.testing.assert_allclose(back, arr, atol=1e-6)

    def test_real_input(self):
        dev = to_device_complex(np.ones(4), jnp.complex64)
        np.testing.assert_allclose(to_host_complex(dev), np.ones(4))

    def test_host_passthrough(self):
        arr = np.ones(4, dtype=np.complex128)
        assert to_host_complex(arr).dtype == np.complex128
        f = to_host_float(jnp.ones(4))
        assert f.dtype == np.float64

    def test_noncontiguous_input(self, rng):
        arr = (rng.normal(size=(4, 4))
               + 1j * rng.normal(size=(4, 4)))[::2, ::2]
        dev = to_device_complex(arr, jnp.complex64)
        np.testing.assert_allclose(to_host_complex(dev), arr, atol=1e-6)


class TestProfiling:
    def test_time_compiled(self):
        f = jax.jit(lambda x: x * 2 + 1)
        r = time_compiled(f, jnp.ones(64), repeats=3)
        assert r.repeats == 3
        assert r.best_s <= r.mean_s
        assert r.mean_ms == pytest.approx(r.mean_s * 1000)

    def test_roofline_math(self):
        assert hbm_traffic_estimate(10, 1) == 2 * 1024 * 8
        # exactly at the floor
        floor_s = hbm_traffic_estimate(20, 10) / 819e9
        assert roofline_fraction(20, 10, floor_s, hbm_bytes_per_s=819e9) \
            == pytest.approx(1.0)
        assert roofline_fraction(20, 10, floor_s * 10,
                                 hbm_bytes_per_s=819e9) == pytest.approx(0.1)

    def test_trace_context(self, tmp_path):
        with trace(str(tmp_path / "trace")) as logdir:
            jax.jit(lambda x: x + 1)(jnp.ones(8)).block_until_ready()
        assert (tmp_path / "trace").exists()


class TestSeedManagerEdge:
    def test_unseeded_is_nondeterministic_but_valid(self):
        mgr = SeedManager(None)
        assert mgr.seed is None
        rng = mgr.create_child_rng()
        assert 0 <= rng.random() < 1

    def test_child_key_deterministic(self):
        a = SeedManager(7).create_child_key()
        b = SeedManager(7).create_child_key()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_set_seed_resets_stream(self):
        mgr = SeedManager(1)
        s1 = mgr.create_child_seed()
        mgr.set_seed(1)
        assert mgr.create_child_seed() == s1


class TestAppConfig:
    def test_save_load_roundtrip(self, tmp_path):
        from quantum_simulator_tpu.utils.appconfig import AppConfig

        cfg = AppConfig(theme="light", default_qubits=6)
        cfg._config_dir = tmp_path
        cfg.add_recent_file("/a.qsim")
        cfg.add_recent_file("/b.qsim")
        cfg.add_recent_file("/a.qsim")  # dedup, moves to front
        assert cfg.recent_files == ["/a.qsim", "/b.qsim"]
        cfg.save()
        import json

        data = json.loads((tmp_path / "config.json").read_text())
        assert data["theme"] == "light"
        assert data["default_qubits"] == 6
        assert data["recent_files"] == ["/a.qsim", "/b.qsim"]

