"""Test configuration: CPU backend with 8 virtual devices (for sharding
tests) and float64 enabled (reference numerics are Float64; the GPU bench
path runs float32).

The platform goes through ``jax.config`` before any backend is used, so
the suite runs on the CPU whether or not ``JAX_PLATFORMS=cpu`` is set.
Tests that need a GPU carry the ``gpu`` marker and decide inside the test
whether one is present (see tests/test_chip_smoke.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from contactimplicitmpc_tpu.utils.runtime import \
    enable_compile_cache  # noqa: E402

# the suite's own CPU cache policy: cache every compile, however small
enable_compile_cache(min_compile_time_secs=0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips when none is present")
