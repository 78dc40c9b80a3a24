"""Where compiled XLA programs are cached between processes.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set in code.  Otherwise the cache goes to a fixed ``.jax_cache/`` at
the root of the checkout (listed in .gitignore): a fixed path, because
the path is part of the cache key.
"""

from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / '.jax_cache'


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    jax.config.update('jax_compilation_cache_dir', str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
