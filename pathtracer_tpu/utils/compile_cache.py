"""JAX persistent compilation cache location.

A cold compile of the render programs takes from seconds to minutes, so the
CLI, ``bench.py`` and ``chip_smoke.py`` keep compiled executables on disk.
The cache directory is part of each entry's key, so it must not move
between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise the fixed ``<checkout>/.jax_cache`` (gitignored).
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory ``enable_compile_cache`` uses."""
    return os.environ.get(CACHE_ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
