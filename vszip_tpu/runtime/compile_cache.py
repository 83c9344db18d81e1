"""Persistent XLA compile cache for the repo's GPU scripts.

Used by ``chip_smoke.py`` and ``bench.py`` only: importing the library
sets no cache.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX reads
it itself; otherwise the cache lives at a fixed ``.jax_cache`` directory of
the checkout, so a second run of the same checkout finds its programs again
(the path is part of the cache key, so it must not move between runs).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root: str) -> str:
    """The cache directory a script under ``root`` uses."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root),
                                               ".jax_cache")


def enable_compile_cache(root: str) -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir(root)``
    and return that path.  With ``JAX_COMPILATION_CACHE_DIR`` set, nothing
    is changed: JAX already reads it."""
    path = compile_cache_dir(root)
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
