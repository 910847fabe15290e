"""Test configuration: run the tests on CPU with 8 virtual devices.

Mirrors the reference's decomposition-invariance strategy
(tests/compare_checksums.py in ecTrans): multi-device correctness is tested
on one host by giving XLA 8 virtual CPU devices, so sharded transforms can be
checked against single-device results without multi-device hardware.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU.  On a machine with one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# keep unit tests hermetic: never touch the user's on-disk legpol cache
os.environ.setdefault("ECTRANS_TPU_LEGPOL_DIR", "")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips where JAX finds none)")


@pytest.fixture
def gpu():
    """JAX's first GPU device; skips the test when there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return devices[0]
