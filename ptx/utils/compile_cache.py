"""Where XLA's persistent compile cache lives — decided in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing here overrides it.  Otherwise the cache goes to ``.jax_cache/``
at the root of the checkout (listed in ``.gitignore``), a fixed path so
that later runs of the same shapes load executables instead of
recompiling.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
