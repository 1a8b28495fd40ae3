"""Where the persistent XLA compilation cache lives.

A cold process compiles every device program again, and the encode
wavefront takes long to compile at real widths, so the scripts that
drive the device (chip_smoke.py, bench.py, benchmarks/) share JAX's
persistent compilation cache.  The cache directory is part of what makes
an entry reusable, so it is one fixed path: never derived from a
tempdir, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache goes to
    ``<repo>/.jax_cache``, which .gitignore lists.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]
