"""Test environment: the CPU backend with 8 virtual devices.

The suite runs on the CPU: plain JAX through XLA's CPU backend, the Pallas
kernels in interpret mode (phys_autodiff_tpu/backend.py), and the sharding
tests on a jax.sharding.Mesh over 8 host-CPU devices (the standard JAX way
to test multi-device code without a cluster). Backends initialize lazily,
so switching platforms via jax.config before the first device use works;
this file does it first thing.

Tests marked `gpu` need an NVIDIA GPU. They take the `gpu` fixture, which
skips them unless JAX runs on one: set PHYS_AUTODIFF_TEST_GPU=1 to keep JAX
on the card (chip_smoke.py runs them that way, in its own process).
"""

import os

# Read when the CPU client is created (lazily), so still effective post-import.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

ON_GPU = os.environ.get("PHYS_AUTODIFF_TEST_GPU") == "1"
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time, never at
    import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these on the card")
