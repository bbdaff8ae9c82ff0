"""The persistent JAX compilation cache, set in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
else is configured here.  Otherwise the cache goes in ``<repo>/.jax_cache/``
(listed in .gitignore): a fixed path inside the checkout, because the path
is part of the cache key and nothing is written outside the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(REPO_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
