"""Persistent XLA compilation cache placement — one rule for every entry
point (chip_smoke.py, bench.py, the CLI, the tools).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no other directory. Otherwise the cache lives at the fixed
``<repo>/.jit_cache`` (gitignored): the path is part of the cache key, so a
directory that moved between runs would never hit.

Call :func:`setup_jit_cache` early in a process; it returns the directory
and prints a one-line entry count (suppress with ``quiet=True``), so a run's
compile behavior is visible.
"""

from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jit_cache")


def cache_dir() -> str:
    """The cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def cache_entry_count(path: str) -> int:
    """Number of cache entries currently on disk (0 if dir absent)."""
    try:
        return sum(1 for n in os.listdir(path) if n.endswith("-cache"))
    except OSError:
        return 0


def setup_jit_cache(quiet: bool = False) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Safe to call before or after ``import jax``. Idempotent."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if not quiet:
        print(f"[tpuflow] jit-cache: {cache_entry_count(path)} entries at "
              f"{path}", file=sys.stderr, flush=True)
    return path
