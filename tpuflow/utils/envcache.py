"""Trace-env-keyed lru_cache for compiled-program builders.

Several TPUFLOW_* env flags are read at TRACE time (resample and smooth
forms, halo fusion): a builder cached
with a plain ``functools.lru_cache`` would keep returning the program
traced under the OLD flag values after a flip. Every compiled-program
builder in the package therefore caches through ``env_cached``, which
appends the current fingerprint of those flags to the cache key.
"""

from __future__ import annotations

import functools
import os

# Env flags the traced programs bake in.
TRACE_ENV_FLAGS = (
    "TPUFLOW_BANDED_RESAMPLE", "TPUFLOW_BANDED_COLS",
    "TPUFLOW_SMOOTH", "TPUFLOW_HALO_K",
)


def trace_env_fingerprint() -> tuple:
    return tuple(os.environ.get(k, "") for k in TRACE_ENV_FLAGS)


def halo_k_outer() -> int:
    """k-outer halo fusion factor for the spatially-sharded paths
    (default 1 = exchange every outer iteration). k > 1 exchanges a
    k*(inner+1)-row halo every k OUTER iterations and recomputes phi/ksi
    + sweeps redundantly in the margin — trading bandwidth and redundant
    compute for a k-fold cut in per-outer collective/latency cost (the
    n>=4 scaling lever, parallel/model.py). Valid-region numerics are
    identical for any k (each exchange re-seeds the halo with true
    neighbor rows; the margin shrinks by inner+1 per outer and never
    reaches owned rows). Trace-time; part of TRACE_ENV_FLAGS."""
    return max(1, int(os.environ.get("TPUFLOW_HALO_K", "1")))


def env_cached(maxsize: int):
    """``lru_cache`` that appends the TPUFLOW_* trace-env fingerprint to
    the key, so flipping a trace-time flag can never return a stale
    program."""

    def deco(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return cached(*args, _env=trace_env_fingerprint(), **kwargs)

        wrapper.cache_clear = cached.cache_clear
        return wrapper

    return deco
