"""Gaussian presmoothing: separable convolution with zero padding.

Tap semantics follow the reference host computation
(reference: src/cuda_operations/2d/cuda_operation_convolution_2d.cpp:83-112):
radius = floor(precision * sigma), normalized Gaussian, max radius unbounded
here (the reference caps the constant buffer at 51 taps; we keep the same
guard). The device kernels are zero-padded separable row/column convolutions
(reference: src/kernels/convolution_2d.cu:74-261, zero outside image).

Implementation: the two 1-D convolutions are banded Toeplitz matmuls by
default, or `lax.conv_general_dilated` on a (1, 1, H, W) view
(TPUFLOW_SMOOTH=conv); presmoothing runs once per frame pair.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

MAX_TAPS = 51  # same cap as the reference __constant__ c_Kernel[51]


@functools.lru_cache(maxsize=64)
def gaussian_kernel_taps(
    sigma: float, precision: int = 3, pixel_size: float = 1.0
) -> np.ndarray:
    """Normalized float32 Gaussian taps (host-side, cached)."""
    radius = int(precision * sigma / pixel_size)
    if 2 * radius + 1 > MAX_TAPS:
        raise ValueError(
            f"gaussian kernel length {2 * radius + 1} exceeds {MAX_TAPS} "
            "(reference parity limit)"
        )
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = (
        1.0
        / (sigma * np.sqrt(2.0 * 3.1415926))
        * np.exp(-(i * i * pixel_size * pixel_size) / (2.0 * sigma * sigma))
    ).astype(np.float32)
    total = np.float32(0.0)
    for t in taps:
        total = np.float32(total + t)
    return (taps / total).astype(np.float32)


def _conv1d(img: jax.Array, taps: jax.Array, axis: int) -> jax.Array:
    """Zero-padded 1-D convolution along ``axis`` of an (H, W) image."""
    radius = (taps.shape[0] - 1) // 2
    x = img[None, None, :, :]  # NCHW
    if axis == 1:
        k = taps[::-1][None, None, None, :]  # cross-correlation with flipped taps
        padding = ((0, 0), (radius, radius))
    else:
        k = taps[::-1][None, None, :, None]
        padding = ((radius, radius), (0, 0))
    out = lax.conv_general_dilated(
        x,
        k.astype(img.dtype),
        window_strides=(1, 1),
        padding=padding,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


@functools.lru_cache(maxsize=256)
def _conv_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) float32 banded Toeplitz matrix of the zero-padded 1-D conv.

    ``M @ x`` computes the same tap-weighted sums as the reference's
    zero-padded convolution kernels (convolution_2d.cu:74-261): row i
    holds the taps centered at i, truncated at the edges (truncation IS
    the zero padding).
    """
    taps = gaussian_kernel_taps(sigma)
    radius = (len(taps) - 1) // 2
    m = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo = max(0, i - radius)
        hi = min(n, i + radius + 1)
        m[i, lo:hi] = taps[lo - i + radius : hi - i + radius]
    return m


def gaussian_smooth(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian smoothing, rows then columns (zero padding).

    No-op when sigma <= 0, matching the driver guard
    (reference: src/optical_flow/optical_flow_2d.cpp:218).

    Default form: the two 1-D convolutions are applied as banded
    Toeplitz MATMULS (same zero-padded tap sums, f32 HIGHEST, so no TF32).
    TPUFLOW_SMOOTH=conv selects the conv lowering; which form is faster on
    a GPU is an open A/B (ROADMAP.md).
    """
    if sigma <= 0.0:
        return img
    import os

    if os.environ.get("TPUFLOW_SMOOTH", "matmul") == "conv":
        taps = jnp.asarray(gaussian_kernel_taps(float(sigma)))
        tmp = _conv1d(img, taps, axis=1)  # rows first
        return _conv1d(tmp, taps, axis=0)
    h, w = img.shape
    mx = jnp.asarray(_conv_matrix(w, float(sigma)))
    my = jnp.asarray(_conv_matrix(h, float(sigma)))
    tmp = jnp.matmul(img, mx.T, precision=lax.Precision.HIGHEST)  # rows first
    return jnp.matmul(my, tmp, precision=lax.Precision.HIGHEST)
