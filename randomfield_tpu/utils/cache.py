"""JAX's persistent compilation cache, at one fixed place.

The cache key includes the directory, so the directory must not move
between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is set
(JAX reads the variable itself, and nothing else is set here), else
``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
