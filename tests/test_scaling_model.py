"""Cost model of spatial sharding (parallel/model) — structure checks: the
model walks the real applicability gate of the explicit halo path, prices
its documented message counts, and routes with no kernel path."""

import pytest

import tpuflow.parallel.model as model
from tpuflow.config import FlowConfig
from tpuflow.parallel.model import (
    LinkParams,
    estimate_level_t1,
    fit_level_time,
    fit_link,
    level_comm_cost,
    level_sharded_time,
    plan_level,
    project_schedule_auto,
    schedule_levels,
)


def test_rub_breakdown_matches_schedule():
    levels = schedule_levels(584, 388)
    assert len(levels) == 47  # the default schedule depth at 584x388
    assert all(t > 0 for _, _, t in levels)
    # Coarse-to-fine: the finest bucket is the largest and the slowest.
    assert levels[-1][2] == max(t for _, _, t in levels)


def test_gates_respected():
    cfg = FlowConfig()
    link = LinkParams()
    # 8 rows/shard: replicated, full single-card cost, no comm.
    t, path = level_sharded_time(1e-3, 64, 128, cfg, 8, link)
    assert path == "replicated" and t == 1e-3
    # 1080p bucket over 4 cards: 272 rows/shard clear the 6-row halo.
    _, path = level_sharded_time(1e-3, 1088, 2048, cfg, 4, link)
    assert path == "explicit"


def test_large_frames_scale_better():
    """Bigger frames carry more compute per exchanged halo row, so their
    projected sharding efficiency is higher."""
    cfg = FlowConfig()
    rub = project_schedule_auto(schedule_levels(584, 388), cfg, 4)
    big = project_schedule_auto(schedule_levels(3840, 2160), cfg, 4)
    assert big["efficiency"] >= rub["efficiency"]


def test_k_outer_cuts_comm():
    """k-outer fusion divides the per-level exchange count: comm cost falls
    monotonically in k (ceil(outer/k) exchanges of a k-widened halo)."""
    cfg = FlowConfig()
    link = LinkParams()
    costs = [level_comm_cost(448, 640, cfg, 4, link, k) for k in (1, 2, 5, 10)]
    assert costs == sorted(costs, reverse=True), costs


@pytest.mark.parametrize("bucket", [(64, 128), (448, 640), (1088, 2048),
                                    (2176, 3840)])
def test_plan_level_router(bucket):
    """The halo="auto" router only knows replicate and the explicit path;
    a level it shards is priced strictly below its replicated cost."""
    cfg = FlowConfig()
    hb, wb = bucket
    path, k, t = plan_level(hb, wb, cfg, 4)
    assert path in ("replicated", "explicit")
    t1 = estimate_level_t1(hb, wb, cfg)
    if path == "explicit":
        assert t < t1 and k >= 1
    else:
        assert t == t1


def test_plan_level_follows_compute_time():
    """Same bucket, same link: a level that costs next to nothing
    replicates, one that costs seconds shards."""
    cfg = FlowConfig()
    assert plan_level(1088, 2048, cfg, 4, t1=1e-7)[0] == "replicated"
    assert plan_level(1088, 2048, cfg, 4, t1=1.0)[0] == "explicit"


@pytest.mark.parametrize("n_y", [2, 4, 8])
def test_sharding_keeps_the_xla_floor(n_y):
    """Sharding rows splits only the per-pixel part of a level's XLA time:
    a level that costs no more than the engine's per-level floor gains
    nothing from it and replicates."""
    cfg = FlowConfig()
    floor = model.LEVEL_FLOOR_S
    t, path = level_sharded_time(floor, 1088, 2048, cfg, n_y)
    assert path == "explicit" and t > floor
    assert plan_level(1088, 2048, cfg, n_y, t1=floor)[0] == "replicated"


def test_efficiency_definition():
    cfg = FlowConfig()
    r = project_schedule_auto(schedule_levels(584, 388), cfg, 4)
    assert r["efficiency"] == pytest.approx(r["speedup"] / 4, abs=1e-3)
    assert sum(r["levels"].values()) == 47


def test_hybrid_split_matches_router():
    """The hybrid pipeline's tail/fine boundary agrees with the router:
    every group before the split replicates, the split group shards, and
    the dp tail holds strictly coarser buckets than the sharded section."""
    from tpuflow.parallel.hybrid import hybrid_split_group
    from tpuflow.solver.bucketed import _level_groups, level_schedule

    cfg = FlowConfig()
    specs = level_schedule(3840, 2160, cfg.warp_levels_count,
                           cfg.warp_scale_factor)
    groups = _level_groups(specs, 3840, 2160, cfg)
    g0 = hybrid_split_group(groups, cfg, 4)
    for bucket, _ in groups[:g0]:
        assert plan_level(bucket[0], bucket[1], cfg, 4)[0] == "replicated"
    if g0 < len(groups):
        b = groups[g0][0]
        assert plan_level(b[0], b[1], cfg, 4)[0] == "explicit"
    if 0 < g0 < len(groups):
        tail_max = max(b[0] * b[1] for b, _ in groups[:g0])
        fine_min = min(b[0] * b[1] for b, _ in groups[g0:])
        assert tail_max < fine_min


def test_fit_link_recovers_constants():
    link = LinkParams(latency_s=20e-6, bandwidth_bytes_s=80e9)
    sizes = [1 << 12, 1 << 16, 1 << 20, 1 << 24]
    times = [link.latency_s + s / link.bandwidth_bytes_s for s in sizes]
    got = fit_link(sizes, times)
    assert got.latency_s == pytest.approx(link.latency_s, rel=1e-6)
    assert got.bandwidth_bytes_s == pytest.approx(link.bandwidth_bytes_s,
                                                  rel=1e-6)


def test_fit_level_time_recovers_constants():
    buckets = [(64, 128), (448, 640), (1088, 2048)]
    times = [2e-3 + 5e-9 * hb * wb for hb, wb in buckets]
    floor, slope = fit_level_time(buckets, times)
    assert floor == pytest.approx(2e-3, rel=1e-6)
    assert slope == pytest.approx(5e-9, rel=1e-6)
