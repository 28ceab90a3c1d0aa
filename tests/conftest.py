"""Test configuration: run JAX on a virtual 8-device CPU mesh.

``JAX_PLATFORMS`` picks the platform when it is set (the card-marked
tests run with ``JAX_PLATFORMS=cuda`` from ``chip_smoke.py``); otherwise
the tests run on the CPU.  The CPU backend gets 8 virtual devices, so
the sharded paths (``parallel/``) run on a real multi-device mesh here.
Tests marked ``gpu`` need the card and skip elsewhere (``gpu_device``
fixture).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_DATA = pathlib.Path("/root/reference/mchap/tests/test_io/data")


@pytest.fixture(scope="session")
def fixture_data_dir():
    """Bundled MCHap fixture data (read-only reference inputs/goldens)."""
    return REFERENCE_DATA


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {device.platform}")
    return device
