"""Test configuration: run everything on an 8-virtual-device CPU mesh.

This is the substitute for the multi-device hardware the reference never
tests without (SURVEY.md §4): sharding/collective logic is
validated on fake devices; numerics are validated against golden fixtures
from the compiled C++ reference."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nbody_tpu.utils.platform import force_cpu

force_cpu(8)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running fidelity tests")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped elsewhere (chip_smoke.py "
        "covers it)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU.  Decided here, at run
    time, never at import or collection time."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py)")


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN_DIR
