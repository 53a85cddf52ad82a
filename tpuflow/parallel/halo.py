"""Explicit ring-halo-exchange sharded relaxation (shard_map + ppermute).

The GSPMD spatial path (tpuflow.solver.bucketed.compiled_full_pipeline_sharded
with halo="gspmd") lets XLA partition every stencil shift, which inserts a
1-row collective-permute pair around EACH shifted field of EACH sweep —
~6 exchanges x 5 sweeps + 4 for phi per outer iteration, all
latency-bound 2.5 KB messages. This module implements the SURVEY §2.7/§5
design instead: shard image rows over the mesh's 'y' axis and exchange ONE
widened halo of k = inner_iterations + 1 rows per OUTER iteration, then run
the whole phi/ksi + k-sweep block locally with redundant computation in the
halo (overlap decomposition). Identical numerics: each halo row holds the
true neighbor value at exchange time, and every sweep shrinks the valid
halo margin by exactly the stencil radius 1
(reference stencil contract: src/kernels/solve_2d.cu:343-359).

Boundary semantics inside the local block:
  * interior shard edges — true neighbor rows via `jax.lax.ppermute`;
  * global top edge — the phi gradient's mirror row (y=-1 -> y=1,
    solve_2d.cu:75-76) is written into the adjacent halo slot of shard 0;
    all deeper top-halo rows only feed redundantly-computed halo results
    that the free-boundary weights (solve_2d.cu:333-340, zero at the
    image edge) keep out of valid pixels;
  * the traced valid edge (row chv / col cwv of the bucket) — mirror
    ghost maintenance exactly like the unsharded engine, applied on
    whichever shard owns the ghost row (a where-select on global row
    index, so no special-casing of shards).

Everything outside the relaxation (box-resample matmuls, warp, median)
stays on the GSPMD path — the relaxation is ~95% of the per-level work
(outer x (1 + inner) stencil passes vs a handful for the rest).

The per-shard compute is the XLA engine. The exchange is a plain
``ppermute`` under ``shard_map``, which XLA hands to NCCL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpuflow.config import FlowConfig
from tpuflow.ops.solver_ops import _shifts
from tpuflow.ops.sweep_core import sweep_update_T
from tpuflow.solver.bucketed import level_constants


def halo_applicable(hb: int, n_y: int, cfg: FlowConfig,
                    k_outer: int | None = None) -> bool:
    """Row sharding with an m-row halo needs each shard to own at least m
    rows (the exchange sends the shard's outermost m rows); below 16
    rows/shard the pipeline replicates the bucket anyway (the coarse-level
    threshold), so require that too. The traced valid edge needs no
    placement constraint: its mirror maintenance is a where-select on
    global row index, applied identically on every shard (including halo
    copies of the ghost row)."""
    from tpuflow.utils.envcache import halo_k_outer

    k = k_outer if k_outer is not None else halo_k_outer()
    halo = k * (cfg.inner_iterations_count + 1)
    if hb % n_y != 0:
        return False
    s = hb // n_y
    return s >= max(halo, 16)


def _exchange(x_local, halo: int, y_axis: str, n_y: int, top_fill=None):
    """(S, W) local rows -> (S + 2*halo, W) padded with neighbor rows.

    Shard 0's top halo and shard n-1's bottom halo arrive as zeros (the
    ring is cut at the image edge); ``top_fill`` optionally overwrites the
    top shard's ADJACENT halo row (the mirror row the phi gradient needs).
    """
    up = [(i, i + 1) for i in range(n_y - 1)]     # my bottom rows -> next shard's top halo
    down = [(i + 1, i) for i in range(n_y - 1)]   # my top rows -> prev shard's bottom halo
    top_halo = jax.lax.ppermute(x_local[-halo:, :], y_axis, up)
    bot_halo = jax.lax.ppermute(x_local[:halo, :], y_axis, down)
    if top_fill is not None:
        is_top = jax.lax.axis_index(y_axis) == 0
        fill = jnp.where(is_top, top_fill, top_halo[-1:, :])
        top_halo = jnp.concatenate([top_halo[:-1, :], fill], axis=0)
    return jnp.concatenate([top_halo, x_local, bot_halo], axis=0)


def relax_sharded(
    f0_l, f1_w, u, v, sc, cfg: FlowConfig, mesh, y_axis: str = "y",
    k_outer: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """outer x inner relaxation on bucket arrays, rows sharded over
    ``y_axis``, one halo exchange per k_outer OUTER iterations.

    k_outer (default: envcache.halo_k_outer(), i.e. TPUFLOW_HALO_K or 1)
    fuses k outer iterations per exchange by widening the halo to
    k*(inner+1) rows and recomputing phi/ksi + sweeps redundantly in the
    margin. Each exchange re-seeds the halo with true neighbor rows; one
    outer iteration consumes exactly inner+1 rows of margin (1 for the
    phi gradient, 1 for the phi neighbor average, 1 per additional
    sweep), so after k fused outers the garbage front has just reached —
    never crossed — the owned-row boundary. The only in-block upkeep is
    per-outer mirror maintenance: the valid-edge ghost row/col (as in the
    unsharded engine) plus the global row -1 mirror (du[-1] := du[1],
    the phi gradient's boundary read, solve_2d.cu:75-76), both
    where-selects on global indices that fire on whichever shard holds
    the row.

    Inputs/outputs are full bucket-shaped arrays (shard_map handles the
    split); numerics on the valid region are bit-identical to
    tpuflow.solver.bucketed._relax_dyn for ANY k (same expression order
    per pixel — the halo rows merely provide the same neighbor values
    the unsharded stencil reads directly).
    """
    from jax import shard_map

    from tpuflow.utils.envcache import halo_k_outer

    k = k_outer if k_outer is not None else halo_k_outer()
    (cw, ch, _, _, div2hx, div2hy, _, _, a_hx2, a_hy2) = sc[:10]
    hb, wb = u.shape
    n_y = mesh.shape[y_axis]
    halo = k * (cfg.inner_iterations_count + 1)
    s_rows = hb // n_y
    pad_rows = s_rows + 2 * halo
    F = np.float32
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)

    fx, fy, ft, (J11, J22, J12, J13, J23) = level_constants(f0_l, f1_w, sc, cfg)

    def local_fn(u_l, v_l, fx_l, fy_l, ft_l, j11_l, j22_l, j12_l, j13_l, j23_l):
        yi = jax.lax.axis_index(y_axis)
        start = yi * s_rows  # global row of local row 0

        def pad(x_l, top_mirror):
            tf = x_l[1:2, :] if top_mirror else None
            return _exchange(x_l, halo, y_axis, n_y, top_fill=tf)

        # Level constants: exchanged once (consumed at centers of the
        # redundantly-computed halo rows).
        fx_p = pad(fx_l, False)
        fy_p = pad(fy_l, False)
        ft_p = pad(ft_l, False)
        j11_p = pad(j11_l, False)
        j22_p = pad(j22_l, False)
        j12_p = pad(j12_l, False)
        j13_p = pad(j13_l, False)
        j23_p = pad(j23_l, False)

        # Free-boundary weights at GLOBAL coordinates (solve_2d.cu:333-340).
        gys = (
            jax.lax.broadcasted_iota(jnp.int32, (pad_rows, wb), 0)
            + start
            - halo
        )
        gxs = jax.lax.broadcasted_iota(jnp.int32, (pad_rows, wb), 1)
        xp_w = jnp.where(gxs < cw - 1, a_hx2, 0.0)
        xm_w = jnp.where(gxs > 0, a_hx2, 0.0)
        yp_w = jnp.where((gys < ch - 1) & (gys >= 0), a_hy2, 0.0)
        ym_w = jnp.where(gys > 0, a_hy2, 0.0)

        def maintain_pad(a):
            """Mirror ghost row chv / col cwv of the padded block (the
            where never fires on shards that don't own the ghost row)."""
            lgr = ch - start + halo
            rows = jax.lax.broadcasted_iota(jnp.int32, (pad_rows, wb), 0)
            a = jnp.where(rows == lgr, jnp.roll(a, 2, axis=0), a)
            return jnp.where(gxs == cw, jnp.roll(a, 2, axis=1), a)

        def maintain_top(a):
            """Global row -1 := mirror of row 1 (phi gradient boundary,
            solve_2d.cu:75-76) — the in-block replacement for the
            exchange-time top_fill; fires only on the top shard's
            adjacent halo row."""
            return jnp.where(gys == -1, jnp.roll(a, -2, axis=0), a)

        def local_shifts(a):
            """Concat shifts on the padded block; block-edge values are
            halo garbage that never reaches valid pixels."""
            return _shifts(a)

        u_p = pad(u_l, True)
        v_p = pad(v_l, True)

        def outer_step(carry, _):
            du_p, dv_p = carry
            # phi/ksi (solve_2d.cu:43-198), hoisted formulation.
            _, u_xp, u_xm, u_yp, u_ym = local_shifts(u_p)
            _, v_xp, v_xm, v_yp, v_ym = local_shifts(v_p)
            du_c, du_xp, du_xm, du_yp, du_ym = local_shifts(du_p)
            dv_c, dv_xp, dv_xm, dv_yp, dv_ym = local_shifts(dv_p)
            dux = (u_xp - u_xm + du_xp - du_xm) / div2hx
            duy = (u_yp - u_ym + du_yp - du_ym) / div2hy
            dvx = (v_xp - v_xm + dv_xp - dv_xm) / div2hx
            dvy = (v_yp - v_ym + dv_yp - dv_ym) / div2hy
            phi = 1.0 / (
                2.0 * jnp.sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2)
            )
            phi = maintain_pad(phi)
            sq = (
                (fx_p * fx_p * du_c + fx_p * fy_p * dv_c + fx_p * ft_p) * du_c
                + (fx_p * fy_p * du_c + fy_p * fy_p * dv_c + fy_p * ft_p) * dv_c
                + (fx_p * ft_p * du_c + fy_p * ft_p * dv_c + ft_p * ft_p)
            )
            ksi = 1.0 / (2.0 * jnp.sqrt(jnp.maximum(sq, 0.0) + e_d2))

            phi_c, phi_xp_n, phi_xm_n, phi_yp_n, phi_ym_n = local_shifts(phi)
            pw_xp = (phi_xp_n + phi_c) * 0.5 * xp_w
            pw_xm = (phi_xm_n + phi_c) * 0.5 * xm_w
            pw_yp = (phi_yp_n + phi_c) * 0.5 * yp_w
            pw_ym = (phi_ym_n + phi_c) * 0.5 * ym_w
            sumH = pw_xp + pw_xm + pw_yp + pw_ym
            a12 = ksi * j12_p
            a13 = ksi * j13_p
            a23 = ksi * j23_p
            denom_u = ksi * j11_p + sumH
            denom_v = ksi * j22_p + sumH

            def inner_step(carry2, _):
                du_i, dv_i = carry2
                tu = u_p + du_i
                tv = v_p + dv_i
                _, tu_xp, tu_xm, tu_yp, tu_ym = local_shifts(tu)
                _, tv_xp, tv_xm, tv_yp, tv_ym = local_shifts(tv)
                new_du, new_dv = sweep_update_T(
                    (tu_xp, tu_xm, tu_yp, tu_ym),
                    (tv_xp, tv_xm, tv_yp, tv_ym),
                    u_p, v_p, dv_i, (pw_xp, pw_xm, pw_yp, pw_ym),
                    a12, a13, a23, denom_u, denom_v,
                )
                return (new_du, new_dv), None

            (du_p2, dv_p2), _ = jax.lax.scan(
                inner_step, (du_p, dv_p), None, length=cfg.inner_iterations_count
            )
            # In-block upkeep only: valid-edge + global-top mirror
            # maintenance on the padded block. The halo itself is
            # re-seeded once per k-outer block (fused_block below).
            du_n = maintain_top(maintain_pad(du_p2))
            dv_n = maintain_top(maintain_pad(dv_p2))
            return (du_n, dv_n), None

        def fused_block(du_own, dv_own, n_out: int):
            """Exchange once, then run n_out outer iterations locally
            with redundant compute in the (shrinking) halo margin."""
            du_p = pad(du_own, True)
            dv_p = pad(dv_own, True)
            (du_p, dv_p), _ = jax.lax.scan(
                outer_step, (du_p, dv_p), None, length=n_out
            )
            return (
                du_p[halo : halo + s_rows, :],
                dv_p[halo : halo + s_rows, :],
            )

        du_o = jnp.zeros((s_rows, wb), jnp.float32)
        dv_o = jnp.zeros_like(du_o)
        n_blocks, rem = divmod(cfg.outer_iterations_count, k)
        if n_blocks:
            (du_o, dv_o), _ = jax.lax.scan(
                lambda c, _: (fused_block(c[0], c[1], k), None),
                (du_o, dv_o), None, length=n_blocks,
            )
        if rem:
            du_o, dv_o = fused_block(du_o, dv_o, rem)
        return du_o, dv_o

    spec = P(y_axis, None)
    sharded = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec,) * 10,
        out_specs=(spec, spec),
        check_vma=False,
    )
    return sharded(u, v, fx, fy, ft, J11, J22, J12, J13, J23)
