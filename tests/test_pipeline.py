"""End-to-end coarse-to-fine pipeline vs the NumPy oracle, plus physical
sanity on synthetic motion."""

import numpy as np
import pytest

import tpuflow.oracle as oracle
from tpuflow.config import DataConstancy, FlowConfig
from tpuflow.solver.flow2d import compute_flow, endpoint_error


def gaussian_blob(h, w, cy, cx, sigma=4.0, amp=200.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (
        amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))
    ).astype(np.float32)


SMALL_CFG = dict(
    warp_levels_count=3,
    warp_scale_factor=0.7,
    outer_iterations_count=6,
    inner_iterations_count=3,
    equation_alpha=35.0,
    equation_smoothness=0.001,
    equation_data=0.001,
    median_radius=3,
    gaussian_sigma=0.8,
)


@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
def test_pipeline_matches_oracle(constancy):
    h, w = 25, 31
    f0 = gaussian_blob(h, w, 12.0, 15.0) + gaussian_blob(h, w, 5.0, 6.0, 2.0, 80.0)
    f1 = gaussian_blob(h, w, 13.1, 14.2) + gaussian_blob(h, w, 6.1, 5.2, 2.0, 80.0)

    want_u, want_v = oracle.compute_flow(f0, f1, data_constancy=constancy, **SMALL_CFG)

    cfg = FlowConfig(data_constancy=DataConstancy(constancy), **SMALL_CFG)
    result = compute_flow(f0, f1, cfg)

    epe = endpoint_error(result.u, result.v, want_u, want_v)
    assert epe < 1e-3, f"EPE vs oracle = {epe}"


def test_pipeline_recovers_translation():
    # A blob translated by (+1.5, -1.0) px: flow in the blob's core must
    # point the right way with roughly the right magnitude.
    h, w = 40, 48
    f0 = gaussian_blob(h, w, 20.0, 24.0, 5.0)
    f1 = gaussian_blob(h, w, 19.0, 25.5, 5.0)  # dx=+1.5, dy=-1.0

    cfg = FlowConfig(
        warp_levels_count=5,
        warp_scale_factor=0.8,
        outer_iterations_count=20,
        inner_iterations_count=5,
        equation_alpha=10.0,
        median_radius=3,
        gaussian_sigma=0.8,
    )
    result = compute_flow(f0, f1, cfg)
    core = (slice(17, 24), slice(21, 28))
    u_core = float(np.asarray(result.u)[core].mean())
    v_core = float(np.asarray(result.v)[core].mean())
    assert 0.8 < u_core < 2.2, u_core
    assert -1.7 < v_core < -0.4, v_core


def test_pipeline_zero_motion_gives_zero_flow():
    f = gaussian_blob(20, 20, 10.0, 10.0)
    cfg = FlowConfig(**SMALL_CFG)
    result = compute_flow(f, f, cfg)
    assert float(np.abs(np.asarray(result.u)).max()) < 1e-3
    assert float(np.abs(np.asarray(result.v)).max()) < 1e-3


def test_single_level_horn_schunck_config():
    # Horn-Schunck: single level, grey constancy, no pyramid.
    f0 = gaussian_blob(16, 16, 8.0, 8.0)
    f1 = gaussian_blob(16, 16, 8.0, 9.0)
    cfg = FlowConfig(
        warp_levels_count=1,
        outer_iterations_count=10,
        inner_iterations_count=5,
        gaussian_sigma=0.0,
        median_radius=1,
    )
    want_u, want_v = oracle.compute_flow(
        f0,
        f1,
        warp_levels_count=1,
        outer_iterations_count=10,
        inner_iterations_count=5,
        gaussian_sigma=0.0,
        median_radius=1,
    )
    result = compute_flow(f0, f1, cfg)
    assert endpoint_error(result.u, result.v, want_u, want_v) < 1e-4
    # Blob moved +x: the dominant recovered component is positive u
    # (single-level relaxation with alpha=35 converges slowly, so only the
    # direction — not the magnitude — is asserted).
    u_core = float(np.asarray(result.u)[7:10, 7:10].mean())
    v_core = float(np.asarray(result.v)[7:10, 7:10].mean())
    assert u_core > 3.0 * abs(v_core) and u_core > 1e-3


def test_bucketed_group_traces():
    f0 = gaussian_blob(40, 48, 20.0, 24.0)
    f1 = gaussian_blob(40, 48, 20.7, 25.0)
    cfg = FlowConfig(**SMALL_CFG)
    res = compute_flow(f0, f1, cfg, collect_trace=True, engine="bucketed")
    assert len(res.levels) >= 1
    # negative level = "group of n levels" marker; sizes are bucket dims
    assert all(t.level < 0 and t.seconds >= 0 for t in res.levels)
    assert sum(-t.level for t in res.levels) == len(
        __import__("tpuflow.pyramid", fromlist=["level_schedule"]).level_schedule(
            48, 40, cfg.warp_levels_count, cfg.warp_scale_factor
        )
    )
