"""Batched, sharded coarse-to-fine solve over a device mesh.

Frames arrive as (B, H, W) stacks. The batch axis is sharded over the mesh's
``data`` axis and image rows over the ``y`` axis; every per-level program is
``vmap``-ed over the batch and jitted with explicit in/out shardings. XLA's
GSPMD partitioner turns the stencil shifts into 1-row halo exchanges
between devices and partitions the resample matmuls — the classic scaling-book recipe
(mesh -> annotate -> let XLA insert collectives).

Coarse pyramid levels whose height is too small to split usefully run
replicated on the spatial axis (sharded only over ``data``) — the
replicate-below-threshold strategy from SURVEY.md §5.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuflow.config import FlowConfig
from tpuflow.ops.gaussian import gaussian_smooth
from tpuflow.pyramid import LevelSpec, level_schedule
from tpuflow.solver.level import level_step

# Shard rows only when each device keeps at least this many rows (below
# this the halo traffic dominates).
MIN_ROWS_PER_SHARD = 16


def _spatial_spec(height: int, mesh: Mesh, data_axis: str, y_axis: str) -> P:
    n_y = mesh.shape[y_axis]
    if n_y > 1 and height % n_y == 0 and height >= n_y * MIN_ROWS_PER_SHARD:
        return P(data_axis, y_axis, None)
    return P(data_axis, None, None)


@functools.lru_cache(maxsize=256)
def _compiled_batched_level(
    spec: LevelSpec,
    cfg: FlowConfig,
    mesh: Mesh,
    data_axis: str,
    y_axis: str,
    full_h: int,
) -> callable:
    """Jitted vmapped level program with explicit shardings."""
    frame_spec = _spatial_spec(full_h, mesh, data_axis, y_axis)
    out_spec = _spatial_spec(spec.height, mesh, data_axis, y_axis)

    def vstep(a, b, u, v):
        un, vn = jax.vmap(
            lambda a_, b_, u_, v_: level_step(a_, b_, u_, v_, spec, cfg)
        )(a, b, u, v)
        # Pin the level output layout; everything upstream is GSPMD-propagated
        # (intermediate level sizes are rarely divisible by the mesh, so the
        # partitioner is free to choose halo-padded layouts internally).
        un = jax.lax.with_sharding_constraint(un, NamedSharding(mesh, out_spec))
        vn = jax.lax.with_sharding_constraint(vn, NamedSharding(mesh, out_spec))
        return un, vn

    return jax.jit(
        vstep,
        in_shardings=(
            NamedSharding(mesh, frame_spec),
            NamedSharding(mesh, frame_spec),
            NamedSharding(mesh, P(data_axis, None, None)),
            NamedSharding(mesh, P(data_axis, None, None)),
        ),
    )


def compute_flow_batched(
    frames_0,
    frames_1,
    cfg: Optional[FlowConfig] = None,
    mesh: Optional[Mesh] = None,
    *,
    data_axis: str = "data",
    y_axis: str = "y",
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense flow for a batch of frame pairs, sharded over ``mesh``.

    frames_*: (B, H, W). Returns (U, V) as (B, H, W) numpy arrays.
    """
    from tpuflow.parallel.mesh import make_mesh

    cfg = cfg or FlowConfig()
    mesh = mesh or make_mesh()

    f0 = jnp.asarray(frames_0, dtype=jnp.float32)
    f1 = jnp.asarray(frames_1, dtype=jnp.float32)
    if f0.ndim != 3 or f0.shape != f1.shape:
        raise ValueError(f"expected (B, H, W) frame stacks, got {f0.shape} {f1.shape}")
    b, orig_h, orig_w = f0.shape

    frame_sharding = NamedSharding(mesh, _spatial_spec(orig_h, mesh, data_axis, y_axis))
    f0 = jax.device_put(f0, frame_sharding)
    f1 = jax.device_put(f1, frame_sharding)

    smooth = jax.jit(
        jax.vmap(lambda a: gaussian_smooth(a, cfg.gaussian_sigma)),
        in_shardings=(frame_sharding,),
        out_shardings=frame_sharding,
    )
    f0s, f1s = smooth(f0), smooth(f1)

    specs = level_schedule(orig_w, orig_h, cfg.warp_levels_count, cfg.warp_scale_factor)
    first = specs[0]
    flow_sharding = NamedSharding(mesh, P(data_axis, None, None))
    u = jax.device_put(
        jnp.zeros((b, first.height, first.width), jnp.float32), flow_sharding
    )
    v = jax.device_put(jnp.zeros_like(u), flow_sharding)

    for spec in specs:
        step = _compiled_batched_level(spec, cfg, mesh, data_axis, y_axis, orig_h)
        u_new, v_new = step(f0s, f1s, u, v)
        # Re-home the flow for the next level's input contract (replicated
        # on the spatial axis: coarse flows are tiny).
        u = jax.device_put(u_new, flow_sharding)
        v = jax.device_put(v_new, flow_sharding)

    return np.asarray(u), np.asarray(v)
