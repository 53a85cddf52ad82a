"""Cost model of spatial sharding: which levels to shard, and how often to
exchange halos.

The sharded pipeline (solver.bucketed.compiled_full_pipeline_sharded with
halo="auto") and the front door's route choice (solver.flow2d.plan_parallel)
price each pyramid level on ``n_y`` row shards as

    t_level(n) = t_compute + t_comm
    t_compute  = t_floor + (t1 - t_floor) * (s_rows + 2*halo) / hb
    t_comm     = msgs * (latency + bytes / bandwidth)

where t_floor is the XLA engine's per-level cost that does not shrink with
the rows a shard holds (the launches of its ~240 loop iterations: one
64x128 level costs 9.4 ms, one 1088x2048 level 23 ms), and the rest is
split with a redundant halo.

with the exact per-level message and byte counts of the explicit halo path
(parallel/halo.py): (n_const + 2) fields exchanged once per level, plus
(du, dv) once per EXCHANGE, each exchange sending a k*(inner+1)-row halo up
and down the ring (k = k-outer fusion factor: one exchange per k fused
outer iterations; valid-region numerics are k-invariant). Levels whose
sharded price is not below ``t1`` stay replicated.

The constants are measurements on four NVIDIA H100 80GB HBM3 (SXM) cards
joined by NVLink, at a 400 W power limit, all from one run of
``chip_smoke.py``'s four-card router phase (PERF.md names it):
``LinkParams`` is a least-squares fit of one ``ppermute`` ring step inside
a jitted loop of ring steps (the loop's launch cancels out), 4 KiB to
64 MiB per card; ``estimate_level_t1`` is fitted to one-card relaxation
times of one level of the XLA engine (the engine the sharded pipeline
runs) at the 64x128, 448x640 and 1088x2048 buckets, and
``estimate_level_t1_kernel`` to the same levels on the CUDA kernel (the
engine one card runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from tpuflow.config import DataConstancy, FlowConfig


@dataclass(frozen=True)
class LinkParams:
    """Cost of one ``ppermute`` of B bytes per device between the cards of
    a 4-card NVLink mesh: latency_s + B / bandwidth_bytes_s."""

    latency_s: float = 25.7e-6         # 4x H100 80GB HBM3, NVLink, 400 W
    bandwidth_bytes_s: float = 148e9   # 4x H100 80GB HBM3, NVLink, 400 W


# One-card per-level relaxation time at the default 40 x (1 + 5) schedule,
# t1 = FLOOR + PER_PIXEL * hb * wb, on one H100 80GB HBM3 (400 W):
# the XLA scan engine ...
LEVEL_FLOOR_S = 9.41e-3
LEVEL_PER_PIXEL_S = 6.06e-9
# ... and the CUDA kernel (tpuflow/ops/cuda/relax.cu).
KERNEL_LEVEL_FLOOR_S = 1.82e-3
KERNEL_LEVEL_PER_PIXEL_S = 4.02e-9


def _n_const_fields(cfg: FlowConfig) -> int:
    return 5 if cfg.data_constancy == DataConstancy.GREY else 10


def _halo_rows(cfg: FlowConfig, k: int) -> int:
    return k * (cfg.inner_iterations_count + 1)


def level_comm_cost(hb: int, wb: int, cfg: FlowConfig, n_y: int,
                    link: LinkParams = LinkParams(), k: int = 1) -> float:
    """Seconds of halo exchange for ONE level on one shard. Both ring
    directions run concurrently, so the cost is one direction's."""
    n_exchanges = -(-cfg.outer_iterations_count // k)
    row_bytes = _halo_rows(cfg, k) * wb * 4
    msgs = _n_const_fields(cfg) + 2 + 2 * n_exchanges
    return msgs * (link.latency_s + row_bytes / link.bandwidth_bytes_s)


def level_sharded_time(t1_s: float, hb: int, wb: int, cfg: FlowConfig,
                       n_y: int, link: LinkParams = LinkParams(), k: int = 1
                       ) -> Tuple[float, str]:
    """(projected seconds on n_y shards, "explicit" or "replicated") for
    one level, honoring the explicit path's applicability gate."""
    from tpuflow.parallel.halo import halo_applicable

    if not halo_applicable(hb, n_y, cfg, k_outer=k):
        return t1_s, "replicated"
    halo = _halo_rows(cfg, k)
    floor = min(t1_s, LEVEL_FLOOR_S * _passes(cfg) / 240.0)
    compute = floor + (t1_s - floor) * (hb // n_y + 2 * halo) / hb
    return compute + level_comm_cost(hb, wb, cfg, n_y, link, k), "explicit"


def _passes(cfg: FlowConfig) -> int:
    return cfg.outer_iterations_count * (1 + cfg.inner_iterations_count)


def estimate_level_t1(hb: int, wb: int, cfg: FlowConfig) -> float:
    """One-card seconds of one level's XLA relaxation at bucket (hb, wb),
    scaled linearly in the number of stencil passes from the default
    40 x (1 + 5)."""
    return ((LEVEL_FLOOR_S + LEVEL_PER_PIXEL_S * hb * wb)
            * (_passes(cfg) / 240.0))


def estimate_level_t1_kernel(hb: int, wb: int, cfg: FlowConfig) -> float:
    """estimate_level_t1 for the CUDA relaxation kernel."""
    return ((KERNEL_LEVEL_FLOOR_S + KERNEL_LEVEL_PER_PIXEL_S * hb * wb)
            * (_passes(cfg) / 240.0))


_PLAN_KS = (1, 2, 4, 5, 8, 10, 20, 40)


def plan_level(hb: int, wb: int, cfg: FlowConfig, n_y: int,
               link: LinkParams = LinkParams(), t1: float | None = None,
               ks: Sequence[int] = _PLAN_KS) -> Tuple[str, int, float]:
    """Cheapest (path, k, projected_seconds) for ONE level: replicate, or
    the explicit halo path at the best fusion factor k."""
    t1 = estimate_level_t1(hb, wb, cfg) if t1 is None else t1
    best = (t1, "replicated", 1)
    for k in ks:
        tt, resolved = level_sharded_time(t1, hb, wb, cfg, n_y, link, k)
        if resolved == "explicit" and tt < best[0]:
            best = (tt, "explicit", k)
    return best[1], best[2], best[0]


def schedule_levels(w: int, h: int, cfg: FlowConfig | None = None
                    ) -> List[Tuple[int, int, float]]:
    """[(hb, wb, t1_seconds), ...] for every level of a (w, h) frame's
    schedule, coarsest first, priced by estimate_level_t1."""
    from tpuflow.solver.bucketed import _level_groups, level_schedule

    cfg = cfg or FlowConfig()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    out = []
    for (hb, wb), stacked in _level_groups(specs, w, h, cfg):
        out += [(hb, wb, estimate_level_t1(hb, wb, cfg))] * stacked[0].shape[0]
    return out


def project_schedule_auto(levels: Sequence[Tuple[int, int, float]],
                          cfg: FlowConfig, n_y: int,
                          link: LinkParams = LinkParams()) -> dict:
    """Projected time of a [(hb, wb, t1), ...] schedule under the
    halo="auto" router: totals, speedup and efficiency (speedup / n_y),
    per-path level counts, and the replicated (Amdahl) share."""
    t1_total = sum(t for _, _, t in levels)
    tn_total = 0.0
    t_repl = 0.0
    counts: dict = {}
    for hb, wb, t1 in levels:
        path, _, tt = plan_level(hb, wb, cfg, n_y, link, t1)
        tn_total += tt
        counts[path] = counts.get(path, 0) + 1
        if path == "replicated":
            t_repl += tt
    speedup = t1_total / tn_total if tn_total else float("inf")
    return {
        "n_y": n_y,
        "t1_ms": round(t1_total * 1e3, 3),
        "tn_ms": round(tn_total * 1e3, 3),
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_y, 3),
        "levels": counts,
        "tn_replicated_ms": round(t_repl * 1e3, 3),
    }


def fit_link(sizes_bytes: Sequence[int], seconds: Sequence[float]
             ) -> LinkParams:
    """Least-squares fit of t = latency + bytes / bandwidth to measured
    ppermute times (chip_smoke.py --cards 4)."""
    n = len(sizes_bytes)
    mx = sum(sizes_bytes) / n
    my = sum(seconds) / n
    sxx = sum((x - mx) ** 2 for x in sizes_bytes)
    sxy = sum((x - mx) * (y - my) for x, y in zip(sizes_bytes, seconds))
    slope = sxy / sxx
    return LinkParams(latency_s=max(my - slope * mx, 0.0),
                      bandwidth_bytes_s=1.0 / slope)


def fit_level_time(buckets: Sequence[Tuple[int, int]],
                   seconds: Sequence[float]) -> Tuple[float, float]:
    """Least-squares (floor_s, per_pixel_s) of t1 = floor + per_pixel * area
    over measured one-card level times."""
    areas = [hb * wb for hb, wb in buckets]
    n = len(areas)
    mx = sum(areas) / n
    my = sum(seconds) / n
    sxx = sum((x - mx) ** 2 for x in areas)
    slope = sum((x - mx) * (y - my) for x, y in zip(areas, seconds)) / sxx
    return max(my - slope * mx, 0.0), slope
