"""Sharded batched pipeline vs the single-device solver, on the 8-device
virtual CPU mesh (SURVEY.md §4 item 4)."""

import numpy as np
import pytest

import jax

from tpuflow.config import FlowConfig
from tpuflow.parallel import compute_flow_batched, make_mesh
from tpuflow.solver.flow2d import compute_flow, endpoint_error


def blob(h, w, cy, cx, sigma=4.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (200.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))).astype(
        np.float32
    )


CFG = FlowConfig(
    warp_levels_count=3,
    warp_scale_factor=0.7,
    outer_iterations_count=4,
    inner_iterations_count=2,
    median_radius=3,
    gaussian_sigma=0.8,
)


def make_batch(b, h, w):
    f0 = np.stack([blob(h, w, h / 2 + i, w / 2 - i) for i in range(b)])
    f1 = np.stack([blob(h, w, h / 2 + i + 0.8, w / 2 - i + 1.2) for i in range(b)])
    return f0, f1


def test_make_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == jax.device_count() == 8
    assert set(mesh.axis_names) == {"data", "y"}
    assert mesh.shape["data"] == 2 and mesh.shape["y"] == 4

    mesh1 = make_mesh((1, 8))
    assert mesh1.shape["y"] == 8
    with pytest.raises(ValueError):
        make_mesh((3, 2))


def test_batched_matches_single_device():
    # Rows are shardable (h=128 >= 4 shards * 16 rows) on the (2, 4) mesh.
    b, h, w = 4, 128, 96
    f0, f1 = make_batch(b, h, w)
    mesh = make_mesh((2, 4))
    U, V = compute_flow_batched(f0, f1, CFG, mesh)
    assert U.shape == (b, h, w)
    for i in range(b):
        res = compute_flow(f0[i], f1[i], CFG)
        epe = endpoint_error(U[i], V[i], res.u, res.v)
        assert epe < 1e-5, f"pair {i}: sharded vs single-device EPE {epe}"


def test_batched_small_images_replicate_spatially():
    # h=24 < 4*16: spatial axis must fall back to replication and still match.
    b, h, w = 2, 24, 32
    f0, f1 = make_batch(b, h, w)
    mesh = make_mesh((2, 4))
    U, V = compute_flow_batched(f0, f1, CFG, mesh)
    for i in range(b):
        res = compute_flow(f0[i], f1[i], CFG)
        assert endpoint_error(U[i], V[i], res.u, res.v) < 1e-5


def test_hybrid_dp_tail_sp_fine_matches_unsharded():
    """dp x sp hybrid (round-4, the coarse-tail Amdahl mitigation):
    coarse tails run one-pair-per-chip, fine levels row-shard over all
    chips, pairs sequential — per-pair flow must match the unsharded
    solve within the documented cross-program band. split_group=1
    forces both phases on the tiny test pyramid (the router would
    replicate everything at this size)."""
    from tpuflow.parallel.hybrid import compute_flow_bucketed_hybrid
    from tpuflow.solver.bucketed import compute_flow_bucketed_async

    h, w = 120, 140
    b = 8
    f0, f1 = make_batch(b, h, w)
    mesh = make_mesh((1, 8))
    U, V = compute_flow_bucketed_hybrid(f0, f1, CFG, mesh=mesh,
                                        split_group=1)
    U, V = np.asarray(U), np.asarray(V)
    assert U.shape == (b, h, w) and np.isfinite(U).all()
    for i in range(b):
        u1, v1 = compute_flow_bucketed_async(f0[i], f1[i], CFG)
        e = endpoint_error(U[i], V[i], np.asarray(u1), np.asarray(v1))
        assert e <= 1e-4, (i, e)


def test_hybrid_pads_ragged_batch():
    """B not divisible by the axis size: padded by repeating the last
    pair, trimmed after."""
    from tpuflow.parallel.hybrid import compute_flow_bucketed_hybrid

    h, w = 120, 140
    f0, f1 = make_batch(5, h, w)
    mesh = make_mesh((1, 8))
    U, V = compute_flow_bucketed_hybrid(f0, f1, CFG, mesh=mesh,
                                        split_group=1)
    assert np.asarray(U).shape == (5, h, w)
    assert np.isfinite(np.asarray(U)).all()


def test_front_door_routing_decisions():
    """plan_parallel: batches always dp (throughput); singles sp when
    the cost model says row-sharding beats one device, else single (pure
    decision logic, no execution; on the CPU one device runs the XLA
    engine)."""
    from tpuflow.solver.flow2d import plan_parallel

    cfg = FlowConfig()
    mesh = make_mesh((1, 8))
    # Tiny frames: every level replicates -> one chip.
    assert plan_parallel((64, 72), False, cfg, mesh) == "single"
    # With the measured 4-card constants, against one device running the
    # XLA engine: sharding leaves the engine's per-level floor in place,
    # so only frames whose fine levels carry enough per-pixel work shard.
    assert plan_parallel((1080, 1920), False, cfg, mesh) == "sp"
    assert plan_parallel((2160, 3840), False, cfg, mesh) == "sp"
    # Batches: dp regardless of size (pairs independent, eff ~1.0).
    assert plan_parallel((64, 72), True, cfg, mesh) == "dp"
    assert plan_parallel((1080, 1920), True, cfg, mesh) == "dp"
    # A mesh with no 'y' parallelism cannot shard rows.
    mesh_d = make_mesh((8, 1))
    assert plan_parallel((1080, 1920), False, cfg, mesh_d) == "single"


def test_front_door_batch_dp_executes():
    """compute_flow with a (B, H, W) stack + mesh routes to dp (small
    frames) and matches per-pair unsharded solves; the ('data','y') mesh
    is internally flattened so all 8 devices serve the batch axis."""
    b, h, w = 4, 64, 72
    f0, f1 = make_batch(b, h, w)
    mesh = make_mesh((2, 4))
    res = compute_flow(f0, f1, CFG, mesh=mesh)
    assert res.u.shape == (b, h, w)
    for i in range(b):
        r1 = compute_flow(f0[i], f1[i], CFG)
        e = np.mean(np.hypot(res.u[i] - r1.u, res.v[i] - r1.v))
        assert e <= 1e-4, (i, e)


def test_front_door_single_small_ignores_mesh():
    """A small single pair with a mesh routes to the one-chip engine
    (sharding would cost more than it saves) and matches the meshless
    call exactly."""
    h, w = 64, 72
    f0 = blob(h, w, 30, 36)
    f1 = blob(h, w, 31, 37)
    mesh = make_mesh((1, 8))
    r_mesh = compute_flow(f0, f1, CFG, mesh=mesh)
    r_none = compute_flow(f0, f1, CFG)
    assert np.array_equal(r_mesh.u, r_none.u)
    assert np.array_equal(r_mesh.v, r_none.v)


def test_front_door_batch_no_mesh_sequential():
    b, h, w = 2, 48, 56
    f0, f1 = make_batch(b, h, w)
    res = compute_flow(f0, f1, CFG)
    assert res.u.shape == (b, h, w)
    r0 = compute_flow(f0[0], f1[0], CFG)
    assert np.array_equal(res.u[0], r0.u)


def test_front_door_single_large_routes_sp(monkeypatch):
    """A single pair whose levels the router prices high enough to shard
    executes through the front door's sp path and matches the meshless
    solve. (At this test size the measured one-card level times would keep
    it on one device, so the per-pixel level cost is raised here.)"""
    import tpuflow.parallel.model as model

    monkeypatch.setattr(model, "LEVEL_PER_PIXEL_S", 1e-5)
    h, w = 194, 292
    f0 = blob(h, w, 90, 140, sigma=10.0) + blob(h, w, 40, 60, sigma=6.0)
    f1 = blob(h, w, 91, 141.5, sigma=10.0) + blob(h, w, 41, 61.5, sigma=6.0)
    mesh = make_mesh((1, 8))
    from tpuflow.solver.flow2d import plan_parallel

    assert plan_parallel((h, w), False, CFG, mesh) == "sp"
    r_mesh = compute_flow(f0, f1, CFG, mesh=mesh)
    r_none = compute_flow(f0, f1, CFG)
    e = np.mean(np.hypot(r_mesh.u - r_none.u, r_mesh.v - r_none.v))
    assert e <= 1e-4, e


@pytest.mark.parametrize("one_card_engine,route", [("xla", "sp"),
                                                   ("cuda", "single")])
def test_front_door_compares_sp_with_one_card_engine(monkeypatch,
                                                     one_card_engine, route):
    """A single 4K pair shards only if the sharded pipeline (XLA engine) is
    projected faster than one device running the engine it would pick:
    faster than the XLA scan, but not than the CUDA kernel (measured on 4
    H100s: 524 ms sharded against 412 ms on one card)."""
    import tpuflow.solver.bucketed as B
    from tpuflow.ops.relax_cuda import plan
    from tpuflow.solver.flow2d import plan_parallel

    if one_card_engine == "cuda":
        monkeypatch.setattr(
            B, "relax_kernel_plan",
            lambda bucket, cfg, relax="auto": plan(
                bucket[0], bucket[1], cfg.inner_iterations_count))
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    assert plan_parallel((2160, 3840), False, FlowConfig(), mesh) == route
    assert plan_parallel((2160, 3840), True, FlowConfig(), mesh) == "dp"
