"""Oracle emulation of the reference grad/log CUDA-block halo artifacts.

These tests pin the EMULATION's structure (where the artifact can and
cannot change values); the magnitude on a real workload is measured by
tools/measure_block_artifact.py.
"""

import numpy as np
import pytest

from tpuflow import oracle
from tpuflow.oracle import BLOCK_X, BLOCK_Y


def fields(h=40, w=64, seed=3):
    rng = np.random.default_rng(seed)
    f0 = rng.random((h, w), dtype=np.float32) * 255.0
    f1 = (f0 + rng.random((h, w), dtype=np.float32) * 8.0).astype(np.float32)
    u = (rng.random((h, w), dtype=np.float32) - 0.5).astype(np.float32)
    v = (rng.random((h, w), dtype=np.float32) - 0.5).astype(np.float32)
    du = np.zeros((h, w), np.float32)
    dv = np.zeros((h, w), np.float32)
    phi, ksi = oracle.compute_phi_ksi(f0, f1, u, v, du, dv, 1.0, 1.0, 1e-3, 1e-3)
    return f0, f1, u, v, du, dv, phi, ksi


def test_grad_block_artifact_localized_to_block_borders():
    """grad: only the derivative tiles are block-replicated
    (solve_2d.cu:813-841), so a single sweep can differ from clean math
    only AT block-border rows/columns (the tensor stencil reads +-1)."""
    f0, f1, u, v, du, dv, phi, ksi = fields()
    clean = oracle.solve_sweep_grad(f0, f1, u, v, du, dv, phi, ksi, 1.0, 1.0, 35.0)
    block = oracle.solve_sweep_grad(
        f0, f1, u, v, du, dv, phi, ksi, 1.0, 1.0, 35.0, block_emulation=True
    )
    d = np.abs(clean[0] - block[0]) + np.abs(clean[1] - block[1])
    h, w = d.shape
    xs = np.arange(w)[None, :] * np.ones((h, 1), int)
    ys = np.arange(h)[:, None] * np.ones((1, w), int)
    at_border = (
        (xs % BLOCK_X == 0) | (xs % BLOCK_X == BLOCK_X - 1)
        | (ys % BLOCK_Y == 0) | (ys % BLOCK_Y == BLOCK_Y - 1)
    )
    assert d[~at_border].max() == 0.0
    assert d[at_border].max() > 0.0  # the artifact is real


def test_log_bug_shifts_replicate_at_block_borders():
    rng = np.random.default_rng(0)
    a = rng.random((24, 48), dtype=np.float32)
    c, xp, xm, yp, ym = oracle._shifts_log_bug(a)
    # interior: true neighbors
    np.testing.assert_array_equal(xp[:, 5], a[:, 6])
    # block-right edge (x=15): halo holds the edge cell itself
    np.testing.assert_array_equal(xp[:, BLOCK_X - 1], a[:, BLOCK_X - 1])
    np.testing.assert_array_equal(xm[:, BLOCK_X], a[:, BLOCK_X])
    np.testing.assert_array_equal(yp[BLOCK_Y - 1, :], a[BLOCK_Y - 1, :])
    np.testing.assert_array_equal(ym[BLOCK_Y, :], a[BLOCK_Y, :])


def test_log_block_artifact_differs_and_grey_unaffected():
    f0, f1, u, v, du, dv, phi, ksi = fields()
    clean = oracle.solve_sweep_log(f0, f1, u, v, du, dv, phi, ksi, 1.0, 1.0, 35.0)
    block = oracle.solve_sweep_log(
        f0, f1, u, v, du, dv, phi, ksi, 1.0, 1.0, 35.0, block_emulation=True
    )
    assert np.abs(clean[0] - block[0]).max() > 0.0
    # grey pipeline has no block flag: compute_flow rejects nothing and is
    # unchanged by block_emulation.
    ug, vg = oracle.compute_flow(
        f0, f1, warp_levels_count=2, outer_iterations_count=2,
        inner_iterations_count=1, median_radius=3, gaussian_sigma=0.8,
    )
    ub, vb = oracle.compute_flow(
        f0, f1, warp_levels_count=2, outer_iterations_count=2,
        inner_iterations_count=1, median_radius=3, gaussian_sigma=0.8,
        block_emulation=True,
    )
    np.testing.assert_array_equal(ug, ub)
    np.testing.assert_array_equal(vg, vb)


def test_config_has_no_reserved_flags():
    import dataclasses

    from tpuflow.config import FlowConfig

    names = {f.name for f in dataclasses.fields(FlowConfig)}
    assert "grad_block_parity" not in names
    FlowConfig()  # no NotImplementedError paths left in validation