"""Area (box) resampling as matmuls — resample_2d.cu as linear maps.

The reference kernel integrates, for each output cell, the input cells
overlapped by ``[o*delta, (o+1)*delta]`` with fractional end weights, then
multiplies by ``out/in`` (reference: src/kernels/resample_2d.cu:44-74).
That is exactly a linear map with a sparse banded weight matrix per axis, so
we build the (out, in) float32 weight matrix host-side (cached per shape
pair) and apply both axes as matrix multiplies:

    out = W_y @ (img @ W_x^T)

This is value-preserving on upsample and area-averaging on downsample, like
the reference, and turns an awkward variable-length gather loop into two
dense matmuls (HIGHEST precision: no TF32).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

F = np.float32


@functools.lru_cache(maxsize=1024)
def resample_weights(in_n: int, out_n: int) -> np.ndarray:
    """(out_n, in_n) float32 box-overlap weight matrix, normalization folded in.

    Weights transliterate the fraction logic of resample_2d.cu:48-72 so the
    matmul reproduces the reference integral exactly (up to f32 summation
    order).
    """
    delta = F(F(in_n) / F(out_n))
    norm = F(F(out_n) / F(in_n))
    w = np.zeros((out_n, in_n), dtype=F)
    for o in range(out_n):
        left_f = F(F(o) * delta)
        right_f = F(F(o + 1) * delta)
        left_i = int(math.floor(left_f))
        right_i = min(in_n, int(math.ceil(right_f)))
        n = right_i - left_i
        for j in range(n):
            frac = F(1.0)
            if j == 0:
                frac = F(F(left_i + 1) - left_f)
            if j == n - 1:
                frac = F(right_f - F(left_i + j))
            if n == 1:
                frac = delta
            w[o, left_i + j] = F(frac * norm)
    return w


def box_weights_dyn(out_bucket: int, in_bucket: int, out_n, in_n) -> jax.Array:
    """Box-overlap weight matrix computed ON DEVICE with traced sizes.

    Produces the same float32 fractions as `resample_weights` (transliterated
    from resample_2d.cu:48-72: the j==0 / j==n-1 / single-cell rules applied
    in the reference's override order), but (out_n, in_n) are runtime
    scalars, so one compiled program serves every pyramid level — and no
    per-level host->device weight upload is needed.

    Rows >= out_n and cols >= in_n are zero (the bucketed ghost region).
    """
    out_f = out_n.astype(jnp.float32) if hasattr(out_n, "astype") else jnp.float32(out_n)
    in_f = in_n.astype(jnp.float32) if hasattr(in_n, "astype") else jnp.float32(in_n)
    delta = in_f / out_f
    norm = out_f / in_f

    of = jax.lax.broadcasted_iota(jnp.float32, (out_bucket, in_bucket), 0)
    iif = jax.lax.broadcasted_iota(jnp.float32, (out_bucket, in_bucket), 1)

    left_f = of * delta
    right_f = (of + 1.0) * delta
    left_i = jnp.floor(left_f)
    right_i = jnp.minimum(in_f, jnp.ceil(right_f))

    in_range = (iif >= left_i) & (iif <= right_i - 1.0)
    frac = jnp.ones_like(of)
    frac = jnp.where(iif == left_i, (left_i + 1.0) - left_f, frac)
    frac = jnp.where(iif == right_i - 1.0, right_f - iif, frac)
    frac = jnp.where(right_i - left_i == 1.0, delta, frac)

    return jnp.where(in_range, frac * norm, 0.0)


@functools.lru_cache(maxsize=4096)
def banded_weights(out_bucket: int, in_bucket: int, out_n: int, in_n: int):
    """Band extraction of the box-overlap matrix, padded to bucket dims.

    Returns ``(idx, w)`` with ``idx`` (out_bucket,) int32 and ``w``
    (B, out_bucket) float32 such that

        out[o] = sum_b w[b, o] * in[idx[o] + b]

    reproduces ``resample_weights(in_n, out_n) @ in`` exactly on the valid
    region (the band values ARE the dense matrix's nonzeros — same f32
    fractions) and writes zeros for o >= out_n (the bucket ghost region),
    matching the dense bucketed matmul. ``idx + B - 1 < in_n`` always, so
    no ghost/garbage input row is ever read.

    The point: each output cell overlaps only ``ceil(in_n/out_n)+1`` input
    cells, so the dense (out, in) matmul wastes a >95% zero band — this is
    the same linear map at O(B * out_n) instead of O(out_n * in_n).
    """
    W = resample_weights(in_n, out_n)  # (out_n, in_n) exact fractions
    nz = W != 0.0
    first = nz.argmax(axis=1).astype(np.int64)
    counts = nz.sum(axis=1)
    B = int(counts.max())
    start = np.minimum(first, in_n - B)
    idx = np.zeros((out_bucket,), np.int32)
    w = np.zeros((B, out_bucket), F)
    idx[:out_n] = start.astype(np.int32)
    for b in range(B):
        w[b, :out_n] = W[np.arange(out_n), start + b]
    return idx, w


def _take(x: jax.Array, idx: np.ndarray, axis: int) -> jax.Array:
    # Band indices are static and in-bounds by construction — skip the
    # clamp lowering.
    i = jnp.asarray(idx)
    if axis == 0:
        return x.at[i].get(mode="promise_in_bounds")
    return x.at[:, i].get(mode="promise_in_bounds")


def _apply_band_rows(x: jax.Array, idx: np.ndarray, w: np.ndarray) -> jax.Array:
    """Banded resample along axis 0: (in_bucket, W) -> (out_bucket, W)."""
    out = _take(x, idx, 0) * jnp.asarray(w[0])[:, None]
    for b in range(1, w.shape[0]):
        out = out + _take(x, idx + b, 0) * jnp.asarray(w[b])[:, None]
    return out


def _apply_band_cols(x: jax.Array, idx: np.ndarray, w: np.ndarray) -> jax.Array:
    """Banded resample along axis 1: (H, in_bucket) -> (H, out_bucket).

    TPUFLOW_BANDED_COLS=transpose routes through transpose + row gathers
    (A/B probe: lane-axis gathers vs two relayouts; trace-time env).
    """
    import os

    if os.environ.get("TPUFLOW_BANDED_COLS", "gather") == "transpose":
        return _apply_band_rows(x.T, idx, w).T
    out = _take(x, idx, 1) * jnp.asarray(w[0])[None, :]
    for b in range(1, w.shape[0]):
        out = out + _take(x, idx + b, 1) * jnp.asarray(w[b])[None, :]
    return out


def resample_banded(
    x: jax.Array,
    out_bucket_hw: tuple,
    out_hw: tuple,
    in_hw: tuple,
) -> jax.Array:
    """Bucketed box resample via banded gathers (static sizes only).

    ``x`` is (in_hb, in_wb) with valid region ``in_hw`` = (in_h, in_w);
    output is (out_hb, out_wb) = ``out_bucket_hw`` with the resampled field
    in the valid ``out_hw`` region and zeros beyond — the same contract as
    the dense ``wy @ (x @ wx.T)`` bucketed matmuls, in the same X-then-Y
    application order (reference: cuda_operation_resample_2d.cpp:99-106).
    """
    out_hb, out_wb = out_bucket_hw
    out_h, out_w = out_hw
    in_h, in_w = in_hw
    in_hb, in_wb = x.shape
    # X (columns) first, then Y, matching the dense path's sequencing.
    if (out_w, out_wb) == (in_w, in_wb):
        t = x
    else:
        t = _apply_band_cols(x, *banded_weights(out_wb, in_wb, out_w, in_w))
    if (out_h, out_hb) == (in_h, in_hb):
        out = t
    else:
        out = _apply_band_rows(t, *banded_weights(out_hb, in_hb, out_h, in_h))
    # Same-size axes skip the band, but then ghost rows/cols of the input
    # leak through where the dense path wrote zeros: clear them.
    if (out_w, out_wb) == (in_w, in_wb) and out_w < out_wb:
        out = out * (np.arange(out_wb) < out_w).astype(F)[None, :]
    if (out_h, out_hb) == (in_h, in_hb) and out_h < out_hb:
        out = out * (np.arange(out_hb) < out_h).astype(F)[:, None]
    return out


# Contraction dims below this stay dense: the blocked form trades one big
# matmul for ~out/blk small ones, which only pays once the dense band
# waste dominates the extra op launches (1080p-class resamples).
BLOCK_BANDED_MIN_K = 1024


@functools.lru_cache(maxsize=4096)
def _block_plan(out_bucket: int, in_bucket: int, out_n: int, in_n: int,
                blk: int, align: int):
    """Static block decomposition of the box-overlap matrix.

    The (out, in) box matrix is banded with ~ceil(in/out)+1 nonzeros per
    row, so each ``blk``-row output block only reads a narrow input
    window. Returns a tuple of (o_lo, o_hi, i_lo, i_hi, W_block) with
    ``W_block`` the dense weight slice (None for all-zero blocks, i.e.
    the bucket ghost rows) and the input window aligned to ``align``.
    The union of blocks applies the SAME linear map as the dense bucketed
    matrix: every excluded entry is an exact zero.
    """
    W = resample_weights(in_n, out_n)  # (out_n, in_n) exact fractions
    Wb = np.zeros((out_bucket, in_bucket), F)
    Wb[:out_n, :in_n] = W
    blocks = []
    for o_lo in range(0, out_bucket, blk):
        o_hi = min(out_bucket, o_lo + blk)
        sub = Wb[o_lo:o_hi]
        nz = np.nonzero(sub.any(axis=0))[0]
        if len(nz) == 0:
            blocks.append((o_lo, o_hi, 0, 0, None))
            continue
        i_lo = int(nz[0]) // align * align
        i_hi = min(in_bucket, -(-(int(nz[-1]) + 1) // align) * align)
        blocks.append((o_lo, o_hi, i_lo, i_hi,
                       np.ascontiguousarray(sub[:, i_lo:i_hi])))
    return tuple(blocks)


def resample_rows_blocked(x: jax.Array, out_bucket: int, out_n: int,
                          in_n: int) -> jax.Array:
    """``W_y @ x`` with the banded box matrix applied block-wise
    (..., in_bucket, W) -> (..., out_bucket, W). Static sizes only."""
    in_bucket = x.shape[-2]
    parts = []
    for o_lo, o_hi, i_lo, i_hi, w in _block_plan(
        out_bucket, in_bucket, out_n, in_n, 64, 8
    ):
        if w is None:
            parts.append(jnp.zeros(
                x.shape[:-2] + (o_hi - o_lo, x.shape[-1]), jnp.float32))
        else:
            parts.append(jnp.matmul(
                jnp.asarray(w), x[..., i_lo:i_hi, :],
                precision=lax.Precision.HIGHEST))
    return jnp.concatenate(parts, axis=-2)


def resample_cols_blocked(x: jax.Array, out_bucket: int, out_n: int,
                          in_n: int) -> jax.Array:
    """``x @ W_x^T`` with the banded box matrix applied block-wise
    (..., H, in_bucket) -> (..., H, out_bucket). Static sizes only."""
    in_bucket = x.shape[-1]
    parts = []
    for o_lo, o_hi, i_lo, i_hi, w in _block_plan(
        out_bucket, in_bucket, out_n, in_n, 128, 128
    ):
        if w is None:
            parts.append(jnp.zeros(
                x.shape[:-1] + (o_hi - o_lo,), jnp.float32))
        else:
            parts.append(jnp.matmul(
                x[..., i_lo:i_hi], jnp.asarray(w).T,
                precision=lax.Precision.HIGHEST))
    return jnp.concatenate(parts, axis=-1)


def resample(img: jax.Array, out_w: int, out_h: int) -> jax.Array:
    """Resample an (H, W) image to (out_h, out_w) via two matmuls."""
    in_h, in_w = img.shape
    if (in_h, in_w) == (out_h, out_w):
        return img
    wx = jnp.asarray(resample_weights(in_w, out_w))  # (out_w, in_w)
    wy = jnp.asarray(resample_weights(in_h, out_h))  # (out_h, in_h)
    # X first, then Y, matching the host wrapper sequencing
    # (reference: cuda_operation_resample_2d.cpp:99-106).
    tmp = jnp.matmul(img, wx.T, precision=lax.Precision.HIGHEST)
    return jnp.matmul(wy, tmp, precision=lax.Precision.HIGHEST)
