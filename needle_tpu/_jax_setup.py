"""Shared JAX configuration: the persistent compilation cache.

First compiles of the fingerprint and search programs take seconds; the
persistent cache makes later processes (CLI runs, benchmarks) start hot.
JAX itself honours JAX_COMPILATION_CACHE_DIR; when that is unset, the
cache lives at a fixed `<repo>/.jax_cache`, so every process of one
checkout shares it. Import this module before any jitted call.
"""

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

_initialized = False


def cache_dir() -> str:
    """The compilation cache directory in use for this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def ensure() -> None:
    global _initialized
    if _initialized:
        return
    _initialized = True
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
