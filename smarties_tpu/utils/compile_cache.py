"""Persistent XLA compile cache at a fixed path.

Entry points call `enable_compile_cache()` before their first compile. When
JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory and no
other is set here. Otherwise the cache lives in `<checkout>/.jax_cache`: the
path is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
