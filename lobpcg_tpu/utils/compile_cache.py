"""Persistent XLA compilation cache for the scripts that drive full-size
solves (chip_smoke.py, bench.py, benchmarks/).

A full-size solve compiles for tens of seconds; JAX's persistent cache
keeps the compiled executables on disk so a later process with the same
program skips that.  The cache key includes the directory, so it must
not move between runs: it is the fixed ``<checkout>/.jax_cache``
(listed in .gitignore) unless ``JAX_COMPILATION_CACHE_DIR`` is set, in
which case JAX already reads that variable and nothing is set here.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
