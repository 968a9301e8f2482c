"""Utility surface: logging, profiling, visualization, runtime config."""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_persistent_compile_cache() -> str:
    """Keep XLA executables on disk across runs; returns the directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing here overrides it.  Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so a
    directory that moved would never hit.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache_dir is None:
        cache_dir = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
