"""Persistent XLA compilation cache.

The frame program takes minutes to compile cold; caching serialized
executables on disk makes every later process pay ~0. Where
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives at the fixed `<repo>/.jax_cache`
(a fixed path, since the path is part of what a cache hit needs). Call
before the first jit trace (importing jax is fine).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
