"""Test env: CPU with 8 virtual devices by default (multi-device sharding
tests run on a virtual mesh, per SURVEY.md §4).

Tests marked ``gpu`` need a card and skip elsewhere. They run in this same
process on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``; an explicit ``JAX_PLATFORMS`` is honoured, the default is ``cpu``.
"""

import os
import sys

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from tinyhipradixsort_tpu.utils import profiling  # noqa: E402

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR when set, else
# <checkout>/.jax_cache): cuts reruns from minutes of XLA compiles to
# seconds, and keeps a process below the XLA-CPU compiler segfault observed
# after a few hundred in-process compilations (positional, not
# program-specific). Populate per-file (`pytest tests/test_X.py`) if a cold
# full run ever hits it.
profiling.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the reference-density randomized tier (nightly; "
             "reference bar: unittest.cpp TEST_ITERATION=128)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "full: reference-density randomized tier (needs --full)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run with "
                   "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--full"):
        return
    skip = pytest.mark.skip(reason="full-density tier: pass --full")
    for item in items:
        if "full" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")


@pytest.fixture(autouse=True, scope="module")
def _drop_executables_between_modules():
    """Free loaded XLA executables after each test module.

    The XLA-CPU runtime segfaults (in fresh compiles *and* in
    cache-deserialization alike) once a single process holds a few hundred
    loaded executables; dropping them per module stays far below the
    threshold, and the persistent compilation cache makes re-loads cheap.
    """
    yield
    jax.clear_caches()
