"""Test bootstrap: run the suite on CPU with 8 simulated devices.

Carves the host platform into 8 virtual devices so mesh/data-parallel
paths (psum over a sharded batch) are exercised without accelerators (see
SURVEY.md §4). The env var must be set BEFORE jax initializes a backend.
The platform is ``JAX_PLATFORMS`` when set (``JAX_PLATFORMS=cuda`` runs
the ``gpu``-marked tests on a card) and the CPU otherwise.
"""

import os
import sys

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


@pytest.fixture
def gpu():
    """For ``gpu``-marked tests: skips unless JAX's first device is a GPU.
    Decided when the test runs, never at import or collection, so every
    pytest-xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (JAX_PLATFORMS=cuda on a card)")
    return jax.devices()[0]
