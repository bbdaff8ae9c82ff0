"""Test env: force CPU with 8 virtual devices BEFORE jax initializes, so
collective/sharding tests run with full psum/all_gather/ppermute semantics
and no accelerator (SURVEY.md section 4.2 'distributed without a real
cluster').  Tests that need the GPU take the ``gpu_device`` fixture, which
skips them here (the ``gpu`` marker in pyproject.toml)."""

import os

# jax.config.update("jax_platforms", ...) below wins over JAX_PLATFORMS
# as long as no backend has been initialized yet; XLA_FLAGS is read lazily.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the CPU unless the caller names a platform: on the card,
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_route.py` runs the
# gpu tests
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# x64 available for the f64 oracle/verification paths; production arrays are
# created float32 explicitly (datagen default), matching the device setup.
jax.config.update("jax_enable_x64", True)

# persistent compilation cache — recompiling tiny CPU executables dominates
# test wall-clock otherwise
from convex_optimization_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device(request):
    """The first GPU, for tests marked ``gpu``; skips where JAX has none.
    Decided here at run time, never at import (every xdist worker must
    collect the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/test_route.py` on the card "
                    "(README.md, Testing)")
    return devs[0]
