"""Solver robustness on pathological inputs.

The reference guards the data penalizer with e_data^2 and the diffusivity
with e_smooth^2 (no division can hit exactly zero), and the warp copies
frame_0 wherever targets go NaN/out-of-range. These tests pin that the
engines inherit the same robustness: finite outputs everywhere, zero
flow for constant scenes, no poisoning from extreme dynamic range.
"""

import numpy as np
import pytest

from tpuflow.config import FlowConfig
from tpuflow.solver.bucketed import compute_flow_bucketed_async
from tpuflow.solver.flow2d import compute_flow

CFG = FlowConfig(
    warp_levels_count=3,
    warp_scale_factor=0.6,
    outer_iterations_count=5,
    inner_iterations_count=3,
    median_radius=3,
    gaussian_sigma=0.8,
)


def run(f0, f1):
    u, v = compute_flow_bucketed_async(f0.astype(np.float32), f1.astype(np.float32), CFG)
    return np.asarray(u), np.asarray(v)


def test_flat_frames_zero_flow():
    f = np.full((32, 40), 128.0, np.float32)
    u, v = run(f, f)
    assert np.isfinite(u).all() and np.isfinite(v).all()
    np.testing.assert_allclose(u, 0.0, atol=1e-4)
    np.testing.assert_allclose(v, 0.0, atol=1e-4)


def test_zero_frames_finite():
    f = np.zeros((24, 32), np.float32)
    u, v = run(f, f)
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_extreme_dynamic_range_finite():
    rng = np.random.default_rng(0)
    f0 = (rng.random((32, 40)) * 65535.0).astype(np.float32)  # 16-bit range
    f1 = np.roll(f0, 1, axis=1)
    u, v = run(f0, f1)
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_single_hot_pixel_finite():
    f0 = np.zeros((32, 40), np.float32)
    f1 = np.zeros((32, 40), np.float32)
    f0[16, 20] = 1e6
    f1[16, 21] = 1e6
    u, v = run(f0, f1)
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_min_size_frames():
    # GetMaxWarpLevel guarantees levels >= 4 px; a 4x4 input must solve.
    rng = np.random.default_rng(1)
    f0 = (rng.random((4, 4)) * 255).astype(np.float32)
    f1 = np.roll(f0, 1, axis=0)
    res = compute_flow(f0, f1, CFG)
    assert res.u.shape == (4, 4)
    assert np.isfinite(res.u).all()


def test_non_square_extreme_aspect():
    rng = np.random.default_rng(2)
    f0 = (rng.random((8, 200)) * 255).astype(np.float32)
    f1 = np.roll(f0, 1, axis=1)
    u, v = run(f0, f1)
    assert u.shape == (8, 200)
    assert np.isfinite(u).all()
