"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding is
exercised without a GPU.  The card-only tests (marker ``gpu``) run on a
GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``: any
``JAX_PLATFORMS`` other than cpu is left alone.  Must happen before jax is
imported anywhere.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


_MODULE_SEEN = set()


@pytest.fixture(autouse=True)
def _bound_jit_cache(request):
    """Drop compiled executables at every module boundary.

    The suite compiles thousands of unique-shape programs in one process;
    letting them all stay live has produced nondeterministic XLA-CPU
    compiler segfaults late in the run (LLVM JIT resource exhaustion —
    the crash moves with test-collection order and never reproduces in
    isolation).  Clearing per module caps the live-executable count at
    the cost of recompiling the handful of shapes shared across
    modules."""
    mod = request.module.__name__
    if mod not in _MODULE_SEEN:
        _MODULE_SEEN.add(mod)
        import jax
        jax.clear_caches()
    yield


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu tests/")


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def random_dense(rng, m, n, density=0.5):
    return (rng.random((m, n)) < density).astype(np.uint8)
