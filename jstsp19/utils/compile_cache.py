"""Persistent-compilation-cache setup (shared by every entry point).

Compiling the Monte-Carlo pipeline takes a large share of a cold run, so
compiled executables are kept on disk.  Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already uses that directory and nothing here overrides it;
otherwise the cache lives at the fixed ``<repo>/.jax_cache`` (a fixed path,
since the path is part of the cache key).  ``JSTSP19_NO_CACHE=1`` opts out
(used by the CPU dryrun subprocess: tiny-shape CPU compiles don't need a
cache, and reloading XLA:CPU executables built on another machine spams
machine-feature warnings).
"""
from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str | None:
    """Turn on JAX's persistent compilation cache and return its directory,
    or None when disabled via ``JSTSP19_NO_CACHE``.  Must run before the
    first compilation."""
    if os.environ.get("JSTSP19_NO_CACHE"):
        return None
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = REPO_CACHE
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
