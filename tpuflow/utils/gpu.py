"""What every measurement entry point (chip_smoke.py, bench.py) needs from
the device: refuse anything but a GPU, name the card and its power limit,
and time a solve in steady state."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List


class NoGPU(RuntimeError):
    """JAX found no GPU: a measurement never falls back to the CPU."""


def require_gpu(count: int = 1):
    """The first ``count`` JAX devices, which must be GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPU(f"JAX platform is {devs[0].platform!r}, not 'gpu'")
    if len(devs) < count:
        raise NoGPU(f"{count} GPUs needed, JAX sees {len(devs)}")
    return devs[:count]


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record(device) -> dict:
    """The device as JAX reports it: platform, kind, and the device count."""
    import jax

    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices())}


def time_calls(fn: Callable, *args, n: int = 5) -> List[float]:
    """Seconds of ``n`` calls of ``fn(*args)``, each ended by
    ``block_until_ready`` (the caller warms up first)."""
    import jax

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def summarize_ms(seconds: List[float], pixels: int) -> dict:
    """Median, min and max per-call ms and the median's Mpix/s."""
    s = sorted(seconds)
    med = s[len(s) // 2]
    return {
        "ms_median": med * 1e3,
        "ms_min": s[0] * 1e3,
        "ms_max": s[-1] * 1e3,
        "mpix_s": pixels / med / 1e6,
        "n": len(s),
    }
