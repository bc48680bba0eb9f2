"""JAX's persistent compilation cache, in one place.

Every entry point calls :func:`enable_compile_cache` before it compiles
anything.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache lives in
``<checkout>/.jax_cache`` (git-ignored), a fixed path, so a second run
of the same program finds the first one's executables.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The checkout root: the directory that holds the package.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<checkout>/.jax_cache``.  Child processes get it through the
    environment."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at :func:`cache_dir`; return it."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
