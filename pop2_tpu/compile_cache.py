"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
itself). Otherwise the cache lives at the fixed path ``<repo>/.jax_cache``:
the path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
