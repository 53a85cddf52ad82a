"""Window median filter — median_2d.cu in JAX.

``radius`` is the window SIDE length (3/5/7), mirror ('reflect') boundary
(reference: src/kernels/median_2d.cu:87-299). Host-wrapper guards replicated
(reference: cuda_operation_median_2d.cpp:100-109,152-154): radius 1 -> copy,
even radius decremented, > 7 rejected.

Implementation: a Batcher odd-even-merge SORTING NETWORK applied to the
radius^2 shifted neighborhoods — every compare-exchange is a vectorized
min/max over the whole image, which XLA fuses into elementwise loops. The
reference's per-pixel insertion sort has the same selection semantics, so
results are identical.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=16)
def _batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Compare-exchange pairs of Batcher's odd-even merge sort for n items."""
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def _network_median(windows: List[jax.Array], length: int) -> jax.Array:
    vals = list(windows)
    for a, b in _batcher_pairs(length):
        lo = jnp.minimum(vals[a], vals[b])
        hi = jnp.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    return vals[length // 2]


def median(img: jax.Array, radius: int, *, use_network: bool = True) -> jax.Array:
    if radius > 7:
        raise ValueError("median radius > 7 not supported (reference parity)")
    if radius % 2 == 0:
        radius -= 1
    if radius <= 1:
        return img
    r2 = radius // 2
    h, w = img.shape
    padded = jnp.pad(img, r2, mode="reflect")
    windows = [
        padded[iy : iy + h, ix : ix + w]
        for iy in range(radius)
        for ix in range(radius)
    ]
    if use_network:
        return _network_median(windows, radius * radius)
    stack = jnp.stack(windows, axis=-1)
    ordered = jnp.sort(stack, axis=-1)
    return ordered[..., (radius * radius) // 2]
