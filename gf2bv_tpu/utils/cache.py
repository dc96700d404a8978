"""Persistent compilation cache: the one place its directory is chosen.

``$JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise ``.jax_cache`` at
the root of the checkout.  The path is part of a cache entry's identity,
so it is fixed rather than derived from the working directory.
"""

from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory :func:`enable_persistent_cache` points JAX at."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_DEFAULT)


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX at the persistent compilation cache (created on first
    write) and return its directory.  Through ``jax.config`` so it works
    after JAX has been imported."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return path
