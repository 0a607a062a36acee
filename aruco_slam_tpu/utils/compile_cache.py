"""Persistent XLA compilation cache for the entry points (CLI, benchmarks,
``chip_smoke.py``). Called explicitly by each entry point, never at
package import."""

from __future__ import annotations

import os
from pathlib import Path

# Inside the checkout and listed in .gitignore: the path is part of the
# cache's key, so it must not move between runs.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep compiled programs where ``JAX_COMPILATION_CACHE_DIR`` says, or
    in the checkout's ``.jax_cache/`` when it is unset. Returns the
    directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
