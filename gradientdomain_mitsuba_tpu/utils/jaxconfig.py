"""Central JAX configuration: persistent compilation cache.

The wavefront render programs are large (bounce loop over the full shading
system), so first-time XLA compilation takes minutes; the persistent cache
lets later processes skip it.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache/``.  Nothing here initialises a backend.
"""
from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def configure():
    import jax

    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def cache_dir():
    """The compile-cache directory in use (None when caching is off)."""
    import jax
    return jax.config.jax_compilation_cache_dir
