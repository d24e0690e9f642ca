"""Test harness: the CPU with 8 virtual devices, unless the caller picks
a platform.

SURVEY §4 tier 4: the analog of a fake distributed backend is XLA's
host-platform device-count flag — sharding/collective tests run against 8
virtual CPU devices, no accelerator required. ``JAX_PLATFORMS`` defaults
to ``cpu``; tests marked ``chip`` need an NVIDIA GPU and are run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip

(the ``gpu`` fixture skips them anywhere else).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture(scope="session")
def gpu():
    """The first NVIDIA GPU; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m chip)")
    return dev
