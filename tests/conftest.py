"""Test environment: force an 8-virtual-device CPU backend so sharding/DP
logic is exercised without a multi-GPU host (SURVEY §4 'Distributed'),
and run the compositing kernels in the Pallas interpreter.

Tests that need a CUDA GPU carry the ``gpu`` marker and skip here; they
decide inside the test (the ``gpu_device`` fixture), never at import."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Persistent compile cache outside the checkout: the suite is
# XLA-CPU-compile dominated and repeat runs on a dev box are the common
# case.  Harmless when cold.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.expanduser("~/.cache/jax_gsplat_cpu_tests"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")

from gaussian_splatterer_tpu.ops import raster_tiled  # noqa: E402

raster_tiled.set_interpret(True)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA GPU (run on the card via chip_smoke.py)")
    return devs[0]
