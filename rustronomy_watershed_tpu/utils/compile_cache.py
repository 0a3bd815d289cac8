"""Where JAX keeps its persistent compilation cache for the repo's scripts."""

from __future__ import annotations

import os

import jax


def place_compile_cache(checkout: str) -> str:
    """Return the persistent compilation cache directory, placing it if needed.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX, which reads it
    itself.  Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed
    path, because the path is part of the cache key, and a directory that
    ``.gitignore`` lists.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(checkout), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
