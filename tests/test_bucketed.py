"""Bucketed engine vs the per-shape engine (CPU mesh).

The bucketed path must reproduce the per-shape solver inside the valid
region — same mirror boundaries (via ghost maintenance), same constants
(host-precomputed float32 scalars), same resample fractions (weights
computed on device from iota arithmetic).
"""

import numpy as np
import pytest

from tpuflow.config import DataConstancy, FlowConfig
from tpuflow.solver.bucketed import (
    bucket_dims,
    compute_flow_bucketed_async,
    maintain_mirror2,
)
from tpuflow.solver.flow2d import compute_flow, endpoint_error


def blob(h, w, cy, cx, sigma=5.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (200.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))).astype(
        np.float32
    )


def test_bucket_dims():
    assert bucket_dims(584, 388) == (448, 640)
    assert bucket_dims(4, 4) == (64, 128)
    assert bucket_dims(120, 56) == (64, 128)
    # slack guarantees ghost room
    assert bucket_dims(128, 64) == (128, 256)


def test_maintain_mirror2_matches_reflect():
    rng = np.random.default_rng(0)
    a = np.zeros((16, 128), np.float32)
    h, w = 11, 100
    a[:h, :w] = rng.random((h, w), dtype=np.float32)
    out = np.asarray(maintain_mirror2(a, np.int32(w), np.int32(h)))
    # ghost rows: row h == row h-2, row h+1 == row h-3 (reference 2h-r-2)
    np.testing.assert_array_equal(out[h, :w], a[h - 2, :w])
    np.testing.assert_array_equal(out[h + 1, :w], a[h - 3, :w])
    np.testing.assert_array_equal(out[:h, w], a[:h, w - 2])
    np.testing.assert_array_equal(out[:h, w + 1], a[:h, w - 3])
    # ghost corner is the 2D reflection
    assert out[h, w] == a[h - 2, w - 2]


@pytest.mark.parametrize(
    "h,w",
    [
        (40, 48),     # single bucket
        (97, 130),    # odd sizes, two buckets in the schedule
    ],
)
def test_bucketed_matches_per_shape(h, w):
    f0 = blob(h, w, h / 2, w / 2) + blob(h, w, h / 4, w / 4, 3.0)
    f1 = blob(h, w, h / 2 + 1.2, w / 2 - 0.7) + blob(h, w, h / 4 + 0.5, w / 4 + 0.9, 3.0)
    cfg = FlowConfig(
        warp_levels_count=4,
        warp_scale_factor=0.6,
        outer_iterations_count=5,
        inner_iterations_count=3,
        median_radius=5,
        gaussian_sigma=1.0,
    )
    ref = compute_flow(f0, f1, cfg)
    ub, vb = compute_flow_bucketed_async(f0, f1, cfg)
    epe = endpoint_error(np.asarray(ub), np.asarray(vb), ref.u, ref.v)
    assert epe < 5e-4, f"bucketed vs per-shape EPE {epe}"
    assert np.isfinite(np.asarray(ub)).all()


def test_bucketed_median_radius7_matches_per_shape():
    # The side-7 median window reads 3 cells beyond the valid edge: the
    # bucketed engine must maintain radius-3 mirror ghosts before the
    # median or border pixels take medians over stale ghost values
    # (round-1 advisor finding: max EPE 8.5e-5 with only radius-2 ghosts).
    h, w = 48, 56
    f0 = blob(h, w, 24, 28) + blob(h, w, 12, 14, 3.0)
    f1 = blob(h, w, 25.1, 27.2) + blob(h, w, 12.6, 14.8, 3.0)
    cfg = FlowConfig(
        warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=4,
        inner_iterations_count=2, median_radius=7, gaussian_sigma=0.8,
    )
    ref = compute_flow(f0, f1, cfg, engine="levels")
    ub, vb = compute_flow_bucketed_async(f0, f1, cfg)
    d = np.hypot(np.asarray(ub) - ref.u, np.asarray(vb) - ref.v)
    assert d.max() < 1e-6, f"median_radius=7 bucketed vs per-shape max diff {d.max()}"


def test_unrolled_pipeline_matches_scanned():
    # The production default unrolls the level scans so per-level weight
    # construction constant-folds; values must match the scanned program.
    from tpuflow.solver.bucketed import compiled_full_pipeline

    h, w = 48, 56
    f0 = blob(h, w, 24, 28)
    f1 = blob(h, w, 25.1, 27.2)
    cfg = FlowConfig(
        warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=3,
        inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
    )
    us, vs = compiled_full_pipeline((h, w), cfg, unroll=False)(f0, f1)
    uu, vu = compiled_full_pipeline((h, w), cfg, unroll=True)(f0, f1)
    epe = endpoint_error(np.asarray(uu), np.asarray(vu), np.asarray(us), np.asarray(vs))
    assert epe < 1e-5, epe


def test_bucketed_default_schedule_small():
    # Full default iteration counts on a small frame: exercises many levels
    # mapping to the same bucket program.
    f0 = blob(52, 60, 26, 30)
    f1 = blob(52, 60, 25.2, 31.1)
    cfg = FlowConfig(median_radius=3)
    ref = compute_flow(f0, f1, cfg)
    ub, vb = compute_flow_bucketed_async(f0, f1, cfg)
    epe = endpoint_error(np.asarray(ub), np.asarray(vb), ref.u, ref.v)
    assert epe < 2e-3, f"bucketed vs per-shape EPE {epe}"


def test_bucketed_batch_matches_single_and_shards():
    import jax
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.bucketed import compute_flow_bucketed_batch

    b, h, w = 8, 40, 48
    f0 = np.stack([blob(h, w, 20 + 0.2 * i, 24) for i in range(b)])
    f1 = np.stack([blob(h, w, 20.9 + 0.2 * i, 25.1) for i in range(b)])
    cfg = FlowConfig(
        warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=4,
        inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
    )
    mesh = make_mesh((8, 1))  # all 8 devices on the data axis
    U, V = compute_flow_bucketed_batch(f0, f1, cfg, mesh=mesh)
    assert U.shape == (b, h, w)
    for i in range(0, b, 3):
        u1, v1 = compute_flow_bucketed_async(f0[i], f1[i], cfg)
        d = np.hypot(np.asarray(U[i]) - np.asarray(u1), np.asarray(V[i]) - np.asarray(v1))
        assert d.max() < 1e-5, (i, d.max())


def test_bucketed_batch_dp_padding_and_gspmd_baseline():
    # dp="shard_map" (default): per-shard single-pair engine; batch not
    # divisible by the data axis is padded by repeating the last pair and
    # trimmed. dp="gspmd": the legacy vmapped baseline. Both must match
    # the unsharded single-pair solve per pair.
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.bucketed import compute_flow_bucketed_batch

    b, h, w = 5, 40, 48
    f0 = np.stack([blob(h, w, 20 + 0.3 * i, 24) for i in range(b)])
    f1 = np.stack([blob(h, w, 20.9 + 0.3 * i, 25.1) for i in range(b)])
    cfg = FlowConfig(
        warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=4,
        inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
    )
    mesh = make_mesh((4, 2))  # n=4 on 'data': b=5 pads to 8, trims back
    U, V = compute_flow_bucketed_batch(f0, f1, cfg, mesh=mesh)
    Ug, Vg = compute_flow_bucketed_batch(f0, f1, cfg, mesh=mesh, dp="gspmd")
    assert np.asarray(U).shape == (b, h, w)
    for i in range(b):
        u1, v1 = compute_flow_bucketed_async(f0[i], f1[i], cfg)
        e = endpoint_error(np.asarray(U[i]), np.asarray(V[i]),
                           np.asarray(u1), np.asarray(v1))
        assert e < 1e-5, f"shard_map dp pair {i}: EPE {e}"
        e = endpoint_error(np.asarray(Ug[i]), np.asarray(Vg[i]),
                           np.asarray(u1), np.asarray(v1))
        assert e < 1e-5, f"gspmd dp pair {i}: EPE {e}"


def test_bucketed_batch_dp_per_shard_no_collectives():
    # A DP mesh runs the full single-pair engine per device. Pin the
    # program contract at the jaxpr level — ZERO cross-shard collectives
    # (pairs are independent) — and per-pair equivalence.
    import jax
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.bucketed import compiled_full_pipeline_dp

    cfg = FlowConfig(
        warp_levels_count=2, warp_scale_factor=0.6, outer_iterations_count=2,
        inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
    )
    mesh = make_mesh((8, 1))
    h, w = 40, 48
    fn = compiled_full_pipeline_dp((h, w), 1, mesh, "data", cfg)
    zeros = np.zeros((8, h, w), np.float32)
    jaxpr = str(jax.make_jaxpr(fn)(zeros, zeros))
    for coll in ("ppermute", "psum", "all_gather", "all_to_all",
                 "collective_permute", "reduce_scatter"):
        assert coll not in jaxpr, f"unexpected collective {coll} in DP program"
    f0 = np.stack([blob(h, w, 20 + 0.3 * i, 24) for i in range(8)])
    f1 = np.stack([blob(h, w, 20.9 + 0.3 * i, 25.1) for i in range(8)])
    U, V = fn(f0, f1)
    u1, v1 = compute_flow_bucketed_async(f0[3], f1[3], cfg)
    e = endpoint_error(np.asarray(U[3]), np.asarray(V[3]),
                       np.asarray(u1), np.asarray(v1))
    assert e < 1e-4, f"dp pair EPE {e}"


def test_bucketed_spatial_sharding_matches_unsharded():
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.bucketed import compute_flow_bucketed_sharded

    h, w = 120, 140  # top bucket (128, 256): 128 rows shard over 4 devices
    f0 = blob(h, w, 60, 70, 8.0) + blob(h, w, 30, 35, 4.0)
    f1 = blob(h, w, 61.1, 69.2, 8.0) + blob(h, w, 30.7, 35.8, 4.0)
    cfg = FlowConfig(
        warp_levels_count=4, warp_scale_factor=0.6, outer_iterations_count=5,
        inner_iterations_count=3, median_radius=5, gaussian_sigma=1.0,
    )
    mesh = make_mesh((2, 4))
    us, vs = compute_flow_bucketed_sharded(f0, f1, cfg, mesh=mesh)
    u1, v1 = compute_flow_bucketed_async(f0, f1, cfg)
    epe = endpoint_error(np.asarray(us), np.asarray(vs), np.asarray(u1), np.asarray(v1))
    assert epe < 1e-5, f"sharded vs unsharded EPE {epe}"


@pytest.mark.parametrize("constancy", [DataConstancy.GRADIENT, DataConstancy.LOG_DERIVATIVES])
def test_bucketed_grad_log_matches_per_shape(constancy):
    h, w = 48, 56
    f0 = blob(h, w, 24, 28) + blob(h, w, 12, 14, 3.0)
    f1 = blob(h, w, 25.1, 27.2) + blob(h, w, 12.6, 14.8, 3.0)
    cfg = FlowConfig(
        warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=4,
        inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
        data_constancy=constancy,
    )
    ref = compute_flow(f0, f1, cfg, engine="levels")
    ub, vb = compute_flow_bucketed_async(f0, f1, cfg)
    epe = endpoint_error(np.asarray(ub), np.asarray(vb), ref.u, ref.v)
    assert epe < 1e-3, f"{constancy}: bucketed vs per-shape EPE {epe}"


@pytest.mark.parametrize("scale,path", [(3.0, "small"), (12.0, "wide"),
                                        (30.0, "violent")])
def test_warp_dyn_paths_match_oracle(scale, path):
    # Small and large displacements both go through the one exact gather;
    # every one must match the oracle on the valid region.
    import jax.numpy as jnp

    import tpuflow.oracle as oracle
    from tpuflow.solver.bucketed import warp_dyn

    rng = np.random.default_rng(2)
    HB, WB, cw, ch = 64, 128, 100, 50
    f0 = np.zeros((HB, WB), np.float32)
    f1 = np.zeros((HB, WB), np.float32)
    f0[:ch, :cw] = rng.random((ch, cw), dtype=np.float32) * 255
    f1[:ch, :cw] = rng.random((ch, cw), dtype=np.float32) * 255
    u = ((rng.random((HB, WB), dtype=np.float32) - 0.5) * scale).astype(np.float32)
    v = ((rng.random((HB, WB), dtype=np.float32) - 0.5) * scale).astype(np.float32)
    got = np.asarray(
        warp_dyn(
            jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(u), jnp.asarray(v),
            np.int32(cw), np.int32(ch), np.float32(1), np.float32(1),
            np.float32(cw - 1), np.float32(ch - 1),
        )
    )
    want = oracle.warp(f0[:ch, :cw], f1[:ch, :cw], u[:ch, :cw], v[:ch, :cw], 1.0, 1.0)
    np.testing.assert_allclose(got[:ch, :cw], want, atol=2e-4, err_msg=path)


@pytest.mark.parametrize("dx", [0.8, 6.5])
def test_pipeline_recovers_gentle_and_violent_motion(dx):
    """The production pipeline tracks a rigid shift of two blobs, from
    sub-pixel (0.8 px) to violent (6.5 px: beyond +-4 pixels at the fine
    levels), at both blob centres."""
    from tpuflow.config import FlowConfig
    from tpuflow.solver.bucketed import compute_flow_bucketed_async

    h, w = 72, 96
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def blobs(shift):
        return (200.0 * np.exp(-((ys - 36) ** 2 + (xs - 48 - shift) ** 2) / 60.0)
                + 150.0 * np.exp(-((ys - 20) ** 2 + (xs - 20 - shift) ** 2) / 40.0)
                ).astype(np.float32)

    # A schedule that tracks large motion: alpha=10, a deep pyramid.
    cfg = FlowConfig(warp_levels_count=8, warp_scale_factor=0.6,
                     outer_iterations_count=30, inner_iterations_count=5,
                     equation_alpha=10.0, median_radius=3,
                     gaussian_sigma=1.5)
    u, v = compute_flow_bucketed_async(blobs(0), blobs(dx), cfg)
    u, v = np.asarray(u), np.asarray(v)
    assert np.isfinite(u).all() and np.isfinite(v).all()
    for y, x in ((36, 48), (20, 20)):
        assert abs(u[y, x] - dx) < 0.1 * dx, (y, x, u[y, x])
        assert abs(v[y, x]) < 0.05, (y, x, v[y, x])


def test_level_step_blocked_resample_matches_dense(monkeypatch):
    # Force the block-banded route at a small size and pin it against the
    # dense-matmul route on the same level step (one sweep keeps ulp
    # amplification down; both routes apply the same linear map).
    import sys

    import jax.numpy as jnp

    import tpuflow.ops.resample  # noqa: F401 - ops/__init__ shadows the attr
    from tpuflow.solver.bucketed import (
        LevelScalars, bucket_dims, bucketed_level_step,
    )

    rs = sys.modules["tpuflow.ops.resample"]

    h0, w0 = 90, 130
    top_bucket = bucket_dims(w0, h0)
    h0b, w0b = top_bucket
    cw, ch = 84, 58
    bucket = bucket_dims(cw, ch)
    sc = LevelScalars.make(
        cw, ch, w0 / cw, h0 / ch, 35.0, w0, h0, 60, 40
    ).tree()
    cfg = FlowConfig(
        warp_levels_count=1, outer_iterations_count=1,
        inner_iterations_count=1, median_radius=3,
    )
    rng = np.random.default_rng(5)
    f0s = np.zeros((h0b, w0b), np.float32)
    f1s = np.zeros((h0b, w0b), np.float32)
    f0s[:h0, :w0] = rng.random((h0, w0), np.float32) * 200.0
    f1s[:h0, :w0] = rng.random((h0, w0), np.float32) * 200.0
    u_prev = np.zeros((h0b, w0b), np.float32)
    v_prev = np.zeros((h0b, w0b), np.float32)
    u_prev[:40, :60] = rng.standard_normal((40, 60)).astype(np.float32) * 0.3
    v_prev[:40, :60] = rng.standard_normal((40, 60)).astype(np.float32) * 0.3
    args = tuple(jnp.asarray(a) for a in (f0s, f1s, u_prev, v_prev))

    want_u, want_v = bucketed_level_step(
        *args, sc, bucket, top_bucket, cfg, relax="xla"
    )
    monkeypatch.setattr(rs, "BLOCK_BANDED_MIN_K", 64)
    got_u, got_v = bucketed_level_step(
        *args, sc, bucket, top_bucket, cfg, relax="xla"
    )
    d = np.maximum(
        np.abs(np.asarray(got_u)[:ch, :cw] - np.asarray(want_u)[:ch, :cw]),
        np.abs(np.asarray(got_v)[:ch, :cw] - np.asarray(want_v)[:ch, :cw]),
    )
    assert d.max() < 1e-5, d.max()


def test_pipeline_cache_keys_on_trace_env(monkeypatch):
    # Flipping a TPUFLOW_* trace-time flag must produce a different cached
    # program (the old behavior silently returned the stale one).
    from tpuflow.solver.bucketed import compiled_full_pipeline

    cfg = FlowConfig(warp_levels_count=2, warp_scale_factor=0.6,
                     outer_iterations_count=1, inner_iterations_count=1,
                     median_radius=3)
    a = compiled_full_pipeline((16, 24), cfg, unroll=False)
    monkeypatch.setenv("TPUFLOW_SMOOTH", "conv")
    b = compiled_full_pipeline((16, 24), cfg, unroll=False)
    monkeypatch.delenv("TPUFLOW_SMOOTH")
    c = compiled_full_pipeline((16, 24), cfg, unroll=False)
    assert a is not b
    assert a is c
