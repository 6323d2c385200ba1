"""Persistent XLA compile cache shared by the entry points.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives at the fixed in-checkout path ``<repo>/.jax_cache``
(listed in .gitignore).  The path is part of the cache key, so a fixed
location is what lets a second run find the first run's executables.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses: the environment's, else
    ``<repo>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir` and return
    the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
