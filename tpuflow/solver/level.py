"""Single pyramid-level program: resample -> warp -> relax -> add -> median.

One warp level of the reference driver loop
(reference: src/optical_flow/optical_flow_2d.cpp:267-502) expressed as ONE
jitted XLA program per level shape:

  * frames are resampled from the FULL-RES smoothed frames (never cascaded,
    reference :283-304) — two matmuls;
  * the flow is prolongated from the previous level's size (:315-340);
  * backward registration (:343-363);
  * relaxation with du,dv zero-init (:229-232): `lax.scan` over outer
    iterations, each outer = one phi/ksi update + `lax.scan` over inner
    Jacobi sweeps. The reference's ping-pong buffer swap becomes scan
    carries, and its per-sweep host sync
    (cuda_operation_solve_2d.cpp:291) disappears — the whole level runs
    on-device with zero host round-trips;
  * flow increment add (:409-421) and median filtering (:428-449).

The per-level programs are compiled once per (shape, config) and cached.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from tpuflow.config import FlowConfig
from tpuflow.ops.median import median
from tpuflow.ops.resample import resample
from tpuflow.ops.solver_ops import (
    compute_phi_ksi_padded,
    pad_mirror,
    solve_sweep_padded,
)
from tpuflow.ops.warp import warp
from tpuflow.pyramid import LevelSpec
from tpuflow.utils.envcache import env_cached


def relax(
    f0_l: jax.Array,
    f1_w: jax.Array,
    u: jax.Array,
    v: jax.Array,
    hx: float,
    hy: float,
    cfg: FlowConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Outer x inner lagged-nonlinearity relaxation; returns (du, dv).

    Always the XLA scan path: the per-shape engine exists for per-level
    tracing and CPU test parity; production runs the bucketed engine
    (tpuflow.solver.bucketed).
    """
    h, w = u.shape
    # XLA scan path on mirror-padded fields: every stencil shift is a pure
    # slice of one padded buffer, so each sweep materializes only the
    # re-padded du/dv instead of 4 shifted copies per field (several-fold
    # less HBM traffic; values are identical).
    f0p = pad_mirror(f0_l)
    f1p = pad_mirror(f1_w)
    up = pad_mirror(u)
    vp = pad_mirror(v)
    dup0 = jnp.zeros((h + 2, w + 2), dtype=u.dtype)
    dvp0 = jnp.zeros_like(dup0)

    def inner_step(carry, _):
        dup, dvp, phip, ksi = carry
        du_n, dv_n = solve_sweep_padded(
            f0p, f1p, up, vp, dup, dvp, phip, ksi,
            hx, hy, cfg.equation_alpha, cfg.data_constancy,
        )
        return (pad_mirror(du_n), pad_mirror(dv_n), phip, ksi), None

    def outer_step(carry, _):
        dup, dvp = carry
        phi, ksi = compute_phi_ksi_padded(
            f0p, f1p, up, vp, dup, dvp,
            hx, hy, cfg.equation_smoothness, cfg.equation_data,
        )
        (dup, dvp, _, _), _ = jax.lax.scan(
            inner_step, (dup, dvp, pad_mirror(phi), ksi), None,
            length=cfg.inner_iterations_count,
        )
        return (dup, dvp), None

    (dup, dvp), _ = jax.lax.scan(
        outer_step, (dup0, dvp0), None, length=cfg.outer_iterations_count
    )
    return dup[1:-1, 1:-1], dvp[1:-1, 1:-1]


def level_step(
    frame_0_full: jax.Array,
    frame_1_full: jax.Array,
    u_prev: jax.Array,
    v_prev: jax.Array,
    spec: LevelSpec,
    cfg: FlowConfig,
) -> Tuple[jax.Array, jax.Array]:
    """One coarse-to-fine level; returns the refined (u, v) at level size."""
    cw, ch, hx, hy = spec.width, spec.height, spec.hx, spec.hy

    f0_l = resample(frame_0_full, cw, ch)
    f1_l = resample(frame_1_full, cw, ch)

    u = resample(u_prev, cw, ch)
    v = resample(v_prev, cw, ch)

    f1_w = warp(f0_l, f1_l, u, v, hx, hy)

    du, dv = relax(f0_l, f1_w, u, v, hx, hy, cfg)

    u = u + du
    v = v + dv
    u = median(u, cfg.median_radius)
    v = median(v, cfg.median_radius)
    return u, v


@env_cached(maxsize=256)
def compiled_level_step(
    spec: LevelSpec, cfg: FlowConfig, prev_shape: Tuple[int, int],
    *, _env=None,
) -> Callable:
    """Jitted level program, cached per (level spec, config, input shape,
    trace-env fingerprint — level_step's ops read TPUFLOW_* flags at trace
    time)."""
    del prev_shape  # part of the cache key; shapes are read off the args

    @jax.jit
    def run(frame_0_full, frame_1_full, u_prev, v_prev):
        return level_step(frame_0_full, frame_1_full, u_prev, v_prev, spec, cfg)

    return run
