"""Test configuration: the suite runs on the CPU, with an 8-device virtual
CPU mesh forced before JAX initializes, so multi-device sharding paths are
exercised without accelerator hardware.

``JSTSP19_TEST_DEVICE=1`` leaves the platform alone; that is how the
``gpu``-marked tests run on a card::

    JSTSP19_TEST_DEVICE=1 python -m pytest -m gpu tests/
"""
import os

if not os.environ.get("JSTSP19_TEST_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    return jax.devices()


@pytest.fixture(scope="session")
def gpu():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JSTSP19_TEST_DEVICE=1 on a machine with a card")
    return dev


@pytest.fixture()
def key():
    return jax.random.key(0)
