"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured as it is (JAX reads it
itself). Otherwise the cache lives at `<checkout>/build/jax_cache`,
resolved from this package's own path, so every process of one checkout
finds the programs an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
