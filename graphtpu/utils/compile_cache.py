"""Persistent XLA compile cache for the program's entry points.

A cold run on the device compiles every executable; JAX's persistent
cache keeps them across processes.  The entry points (``graphtpu.cli``,
``chip_smoke.py``, ``bench.py``, ``tools/run_*``) call
:func:`enable_compile_cache` once, before their first compile.  Importing
``graphtpu`` alone sets nothing.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# one fixed path inside the checkout (listed in .gitignore): the cache
# directory is part of the cache key, so it must not move between runs
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Return the cache directory in use.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it, and this
    sets nothing; otherwise the cache goes to :data:`DEFAULT_DIR`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
