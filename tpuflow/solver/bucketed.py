"""Bucketed coarse-to-fine engine: one compiled program per bucket shape.

The per-shape engine (tpuflow.solver.level) compiles ~46 XLA programs for
the default schedule — one per pyramid level shape. This engine quantizes
level shapes to BUCKETS and passes the valid extent plus every h-derived
constant as runtime scalars, so the default 584x388 schedule needs only ~10
level bodies, and any workload reuses them across levels and across nearby
image sizes.

Design:
  * bucket dims: Wb = ceil((cw+8)/128)*128, Hb = ceil((ch+8)/64)*64 — the
    +8 slack guarantees room for ghost mirror rows/cols;
  * mirror boundary at the VALID edge is provided by ghost maintenance:
    after every field update, rows [ch, ch+2) := mirror rows and cols
    [cw, cw+2) := mirror cols (radius 2 covers the median window), so the
    static concat shifts of tpuflow.ops.solver_ops produce reference-exact
    values inside the valid region;
  * box-resample weight matrices are computed ON DEVICE from iota
    arithmetic (tpuflow.ops.resample.box_weights_dyn — bit-exact vs the
    host transliteration of the reference fractions), so the resample
    stays two matmuls with no per-level recompilation or uploads;
  * the flow field is carried between levels at the TOP bucket shape, so a
    program's signature depends only on its own bucket;
  * consecutive same-bucket levels run as ONE dispatch (`lax.scan` over
    their stacked scalars), and a vmapped variant batches independent
    frame pairs for streaming throughput;
  * the relaxation of a level runs either on the XLA engine
    (`_relax_dyn`'s scan) or, on a GPU, in one call of the CUDA kernel
    (tpuflow.ops.relax_cuda), chosen per bucket (`relax_kernel_plan`).

Numerics inside the valid region are identical to the per-shape engine
(same expression order, host-precomputed float32 constants passed as
scalars); tests pin bucketed vs per-shape on full pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from tpuflow.config import DataConstancy, FlowConfig
from tpuflow.ops.gaussian import gaussian_smooth
from tpuflow.ops.median import median
from tpuflow.ops.resample import box_weights_dyn, resample_banded
from tpuflow.ops.solver_ops import (
    compute_phi_ksi_dyn,
    edge_weights_dyn,
)
from tpuflow.ops.sweep_core import sweep_update_T
from tpuflow.pyramid import level_schedule

ROW_Q, COL_Q, SLACK = 64, 128, 8


def bucket_dims(cw: int, ch: int) -> Tuple[int, int]:
    """(Hb, Wb) bucket for a (cw, ch) level."""
    hb = -(-(ch + SLACK) // ROW_Q) * ROW_Q
    wb = -(-(cw + SLACK) // COL_Q) * COL_Q
    return hb, wb


def maintain_mirror(a: jax.Array, cw, ch, r: int) -> jax.Array:
    """Write mirror ghost rows [ch, ch+r) and cols [cw, cw+r).

    Row ch+k := row ch-2-k (the reference mirror index 2h-y-2); then the
    same for columns, so the ghost corner is the 2D reflection. Requires
    ch+r <= Hb and cw+r <= Wb (bucket SLACK=8) and ch, cw >= r+1
    (guaranteed: levels have min dim 4 and r <= 3). Radius ceil((side-1)/2)
    covers a median window of the given side; stencil ops only need
    `maintain_mirror1`.
    """
    hb, wb = a.shape
    rows = jax.lax.dynamic_slice(a, (ch - r - 1, 0), (r, wb))[::-1, :]
    a = jax.lax.dynamic_update_slice(a, rows, (ch, 0))
    cols = jax.lax.dynamic_slice(a, (0, cw - r - 1), (hb, r))[:, ::-1]
    a = jax.lax.dynamic_update_slice(a, cols, (0, cw))
    return a


def maintain_mirror2(a: jax.Array, cw, ch) -> jax.Array:
    """Radius-2 ghost maintenance (covers the default radius-5 median)."""
    return maintain_mirror(a, cw, ch, 2)


def maintain_mirror1(a: jax.Array, cw, ch) -> jax.Array:
    """Radius-1 ghost maintenance (row ch := row ch-2, col cw := col cw-2)
    — all the radius-1 stencils need, at half the update cost."""
    hb, wb = a.shape
    row = jax.lax.dynamic_slice(a, (ch - 2, 0), (1, wb))
    a = jax.lax.dynamic_update_slice(a, row, (ch, 0))
    col = jax.lax.dynamic_slice(a, (0, cw - 2), (hb, 1))
    a = jax.lax.dynamic_update_slice(a, col, (0, cw))
    return a


def maintain_replicate1(a: jax.Array, cw, ch) -> jax.Array:
    """Radius-1 REPLICATE ghost maintenance (row ch := row ch-1, col cw :=
    col cw-1) — the boundary rule of the gradient/log derivative fields
    (reference: solve_2d.cu:813-841 replicates at tile borders)."""
    hb, wb = a.shape
    row = jax.lax.dynamic_slice(a, (ch - 1, 0), (1, wb))
    a = jax.lax.dynamic_update_slice(a, row, (ch, 0))
    col = jax.lax.dynamic_slice(a, (0, cw - 1), (hb, 1))
    a = jax.lax.dynamic_update_slice(a, col, (0, cw))
    return a


@dataclasses.dataclass(frozen=True)
class LevelScalars:
    """Host-precomputed per-level scalars, float32-rounded exactly like the
    per-shape engine's baked constants (parity)."""

    cw: np.int32
    ch: np.int32
    inv_hx: np.float32
    inv_hy: np.float32
    div2hx: np.float32
    div2hy: np.float32
    div4hx: np.float32
    div4hy: np.float32
    alpha_hx2: np.float32
    alpha_hy2: np.float32
    wlim: np.float32  # cw - 1 as float (warp bounds)
    hlim: np.float32
    cwf: np.float32  # resample target sizes (float)
    chf: np.float32
    w0f: np.float32  # full-res frame sizes (resample source)
    h0f: np.float32
    prev_cwf: np.float32  # previous level's valid flow extent
    prev_chf: np.float32
    # float32(1/(2h)) rounded from float64, NOT the f32 reciprocal of the
    # f32-rounded 2h — keeps the bucketed grad/log tensor bit-matched to
    # the per-shape engine's baked constants (solver_ops._second_order_tensor).
    hx_1: np.float32
    hy_1: np.float32

    @staticmethod
    def make(
        cw: int, ch: int, hx: float, hy: float, alpha: float,
        w0: int, h0: int, prev_cw: int, prev_ch: int,
    ) -> "LevelScalars":
        F = np.float32
        return LevelScalars(
            cw=np.int32(cw),
            ch=np.int32(ch),
            inv_hx=F(1.0) / F(hx),
            inv_hy=F(1.0) / F(hy),
            div2hx=F(2.0 * hx),
            div2hy=F(2.0 * hy),
            div4hx=F(4.0 * hx),
            div4hy=F(4.0 * hy),
            alpha_hx2=F(float(alpha) / (float(hx) * float(hx))),
            alpha_hy2=F(float(alpha) / (float(hy) * float(hy))),
            wlim=F(cw - 1),
            hlim=F(ch - 1),
            cwf=F(cw),
            chf=F(ch),
            w0f=F(w0),
            h0f=F(h0),
            prev_cwf=F(prev_cw),
            prev_chf=F(prev_ch),
            hx_1=F(1.0 / (2.0 * hx)),
            hy_1=F(1.0 / (2.0 * hy)),
        )

    def tree(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _warp_coords(u, v, inv_hx, inv_hy, wlim, hlim):
    """Shared warp coordinate fields (reference: registration_2d.cu:48-55).

    Returns (invalid, x0, y0, w00, w01, w10, w11): the out-of-bounds/NaN
    mask, integer base coords and bilinear weights.
    """
    hb, wb = u.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (hb, wb), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (hb, wb), 0)
    x_f = xs + u * inv_hx
    y_f = ys + v * inv_hy

    invalid = (
        (x_f < 0.0)
        | (x_f > wlim)
        | (y_f < 0.0)
        | (y_f > hlim)
        | jnp.isnan(x_f)
        | jnp.isnan(y_f)
        | (xs > wlim)  # ghost region: copy f0 (discarded anyway)
        | (ys > hlim)
    )

    safe_x = jnp.where(invalid, xs, x_f)
    safe_y = jnp.where(invalid, ys, y_f)
    x0 = jnp.floor(safe_x).astype(jnp.int32)
    y0 = jnp.floor(safe_y).astype(jnp.int32)
    dx = safe_x - x0.astype(jnp.float32)
    dy = safe_y - y0.astype(jnp.float32)

    one = jnp.float32(1.0)
    w00 = (one - dx) * (one - dy)
    w01 = dx * (one - dy)
    w10 = (one - dx) * dy
    w11 = dx * dy
    return invalid, x0, y0, w00, w01, w10, w11


def _gather_taps(f1, x0, y0, w00, w01, w10, w11, cw, ch):
    """4-tap bilinear gather with the reference's +1-neighbor clamps
    (registration_2d.cu:56-71)."""
    hb, wb = f1.shape
    x1 = jnp.minimum(cw - 1, x0 + 1)
    y1 = jnp.minimum(ch - 1, y0 + 1)
    flat = f1.reshape(-1)

    def at(yy, xx):
        return jnp.take(flat, yy * wb + xx, axis=0)

    return (
        w00 * at(y0, x0)
        + w01 * at(y0, x1)
        + w10 * at(y1, x0)
        + w11 * at(y1, x1)
    )


def warp_dyn(f0, f1, u, v, cw, ch, inv_hx, inv_hy, wlim, hlim):
    """Bilinear backward warp with traced valid extent
    (reference: registration_2d.cu:48-72): a 4-tap gather per pixel,
    out-of-range and NaN samples copy frame_0.

    On an H100 the gather beat the masked shift-sum form this engine used
    to carry (a sum over (2D+2)^2 static shifts of f1 behind a runtime
    cond), both per pair and, by minutes, in compile time (PERF.md)."""
    invalid, x0, y0, w00, w01, w10, w11 = _warp_coords(
        u, v, inv_hx, inv_hy, wlim, hlim
    )
    value = _gather_taps(f1, x0, y0, w00, w01, w10, w11, cw, ch)
    return jnp.where(invalid, f0, value)


def relax_kernel_plan(bucket: Tuple[int, int], cfg: FlowConfig,
                      relax: str = "auto"):
    """The CUDA kernel's launch plan for this bucket, or None for the XLA
    engine.

    relax: "xla" (always the XLA engine), "cuda" (the kernel wherever it
    has a launch shape) or "auto" (the kernel on a GPU backend — measured
    faster end to end than the XLA scan with both launch shapes, PERF.md —
    and the XLA engine elsewhere)."""
    if relax == "xla":
        return None
    if relax not in ("auto", "cuda"):
        raise ValueError(f"relax must be 'auto', 'xla' or 'cuda', got {relax!r}")
    from tpuflow.ops.relax_cuda import plan

    p = plan(bucket[0], bucket[1], cfg.inner_iterations_count)
    if relax == "cuda" or p is None:
        return p
    return p if jax.default_backend() == "gpu" else None


def level_constants(f0_l, f1_w, sc, cfg: FlowConfig):
    """Per-level motion-tensor constants at bucket shape.

    Returns (fx, fy, ft, (J11, J22, J12, J13, J23)):
      * fx, fy, ft — the GREY first derivatives, frame-averaged /4h
        (reference: solve_2d.cu:311-321). Always computed: ksi comes from
        the grey motion tensor even for the gradient/log solvers
        (reference quirk: cuda_operation_solve_2d.cpp:84).
      * J* — the motion tensor the solve update uses: grey products, or
        the second-order tensor from (log-)derivative fields with
        REPLICATE boundary (reference: solve_2d.cu:798-884; log uses
        log(1+I), :508-524).
    """
    from tpuflow.ops.solver_ops import _shifts

    (cw, ch, _, _, _, _, div4hx, div4hy, _, _) = sc[:10]

    def first_derivs(a, b):
        a_c, a_xp, a_xm, a_yp, a_ym = _shifts(a)
        b_c, b_xp, b_xm, b_yp, b_ym = _shifts(b)
        fx = (a_xp - a_xm + b_xp - b_xm) / div4hx
        fy = (a_yp - a_ym + b_yp - b_ym) / div4hy
        ft = b_c - a_c
        return fx, fy, ft

    fx, fy, ft = first_derivs(f0_l, f1_w)

    if cfg.data_constancy == DataConstancy.GREY:
        J = (fx * fx, fy * fy, fx * fy, fx * ft, fy * ft)
        return fx, fy, ft, J

    from tpuflow.ops.solver_ops import _shifts_edge

    if cfg.data_constancy == DataConstancy.LOG_DERIVATIVES:
        gx, gy, gt = first_derivs(jnp.log1p(f0_l), jnp.log1p(f1_w))
    else:
        gx, gy, gt = fx, fy, ft
    # Replicate ghosts so the concat edge shifts see the reference's
    # boundary rule at the valid edge.
    gx = maintain_replicate1(gx, cw, ch)
    gy = maintain_replicate1(gy, cw, ch)
    gt = maintain_replicate1(gt, cw, ch)
    hx_1, hy_1 = sc[18], sc[19]  # host-rounded float32(1/(2h))
    gx_xp, gx_xm, gx_yp, gx_ym = _shifts_edge(gx)
    gy_xp, gy_xm, gy_yp, gy_ym = _shifts_edge(gy)
    gt_xp, gt_xm, gt_yp, gt_ym = _shifts_edge(gt)
    fxx = (gx_xp - gx_xm) * hx_1
    fxy = (gx_yp - gx_ym) * hy_1
    fyy = (gy_yp - gy_ym) * hy_1
    fxt = (gt_xp - gt_xm) * hx_1
    fyt = (gt_yp - gt_ym) * hy_1
    J11 = fxx * fxx + fxy * fxy
    J22 = fxy * fxy + fyy * fyy
    J12 = fxx * fxy + fxy * fyy
    J13 = fxx * fxt + fxy * fyt
    J23 = fxy * fxt + fyy * fyt
    return fx, fy, ft, (J11, J22, J12, J13, J23)


def _relax_dyn(f0_l, f1_w, u, v, sc, cfg: FlowConfig, relax: str = "auto"):
    """outer x inner relaxation on bucket arrays with ghost maintenance.

    Loop-invariant work is hoisted explicitly (XLA's while-loop LICM cannot
    be relied on):
      * the motion tensor and free-boundary weights are per-LEVEL constants
        — computed once (the reference recomputes them in every kernel
        launch, solve_2d.cu:311-329);
      * the half-point-diffusivity x edge-weight products, sumH, and the
        ksi-scaled tensor terms are per-OUTER constants — computed once
        after each phi/ksi update;
      * each sweep then only shifts the combined iterate T = flow + d
        ((u_xp + du_xp) == T_xp exactly) and applies the point updates.

    All hoists are value-exact except folding ksi into the tensor terms
    (ksi*(-J13 - J12*dv) -> -a13 - a12*dv), a 1-ulp-level reassociation.

    relax: which engine runs the loop (relax_kernel_plan). The CUDA kernel
    computes the same relaxation of the valid region; its output is 0
    outside it, where this scan leaves don't-care values.
    """
    from tpuflow.ops.solver_ops import _shifts

    (cw, ch, _, _, div2hx, div2hy, div4hx, div4hy, a_hx2, a_hy2) = sc[:10]

    fx, fy, ft, (J11, J22, J12, J13, J23) = level_constants(f0_l, f1_w, sc, cfg)

    kplan = relax_kernel_plan(u.shape, cfg, relax)
    if kplan is not None:
        from tpuflow.ops.relax_cuda import relax_cuda

        return relax_cuda(fx, fy, ft, (J11, J22, J12, J13, J23), u, v, sc,
                          cfg, kplan)

    F = np.float32
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    xp_w, xm_w, yp_w, ym_w = edge_weights_dyn(u.shape, cw, ch, a_hx2, a_hy2)

    du0 = jnp.zeros_like(u)
    dv0 = jnp.zeros_like(v)

    def outer_step(carry, _):
        du, dv = carry
        phi, ksi = compute_phi_ksi_dyn(
            f0_l, f1_w, u, v, du, dv, div2hx, div2hy, div4hx, div4hy, e_s2, e_d2
        )
        phi = maintain_mirror1(phi, cw, ch)

        # ---- per-outer constants ----
        phi_c, phi_xp_n, phi_xm_n, phi_yp_n, phi_ym_n = _shifts(phi)
        pw_xp = (phi_xp_n + phi_c) * 0.5 * xp_w
        pw_xm = (phi_xm_n + phi_c) * 0.5 * xm_w
        pw_yp = (phi_yp_n + phi_c) * 0.5 * yp_w
        pw_ym = (phi_ym_n + phi_c) * 0.5 * ym_w
        sumH = pw_xp + pw_xm + pw_yp + pw_ym
        a12 = ksi * J12
        a13 = ksi * J13
        a23 = ksi * J23
        denom_u = ksi * J11 + sumH
        denom_v = ksi * J22 + sumH
        u_c = u
        v_c = v

        def inner_step(carry2, _):
            du_i, dv_i = carry2
            tu = u + du_i
            tv = v + dv_i
            _, tu_xp, tu_xm, tu_yp, tu_ym = _shifts(tu)
            _, tv_xp, tv_xm, tv_yp, tv_ym = _shifts(tv)
            new_du, new_dv = sweep_update_T(
                (tu_xp, tu_xm, tu_yp, tu_ym), (tv_xp, tv_xm, tv_yp, tv_ym),
                u_c, v_c, dv_i, (pw_xp, pw_xm, pw_yp, pw_ym),
                a12, a13, a23, denom_u, denom_v,
            )
            new_du = maintain_mirror1(new_du, cw, ch)
            new_dv = maintain_mirror1(new_dv, cw, ch)
            return (new_du, new_dv), None

        (du, dv), _ = jax.lax.scan(
            inner_step, (du, dv), None, length=cfg.inner_iterations_count
        )
        return (du, dv), None

    (du, dv), _ = jax.lax.scan(
        outer_step, (du0, dv0), None, length=cfg.outer_iterations_count
    )
    return du, dv


def _resample_top(x, out_bucket_hw, out_hw_f, in_hw_f, _prec):
    """(..., H0b, W0b) -> (..., hb, wb) box resample, choosing the
    block-banded form per axis when that axis's contraction dim is large
    (the box matrix carries ~ceil(in/out)+1 nonzeros per row, so dense
    1080p-class matmuls spend >99% of their work on zeros). Static
    valid sizes required for the blocked form; X then Y (reference
    sequencing, cuda_operation_resample_2d.cpp:99-106). Values match the
    dense bucketed matmuls (excluded entries are exact zeros)."""
    from tpuflow.ops.resample import (
        BLOCK_BANDED_MIN_K, resample_cols_blocked, resample_rows_blocked,
    )

    hb, wb = out_bucket_hw
    h0b, w0b = x.shape[-2:]
    chf, cwf = out_hw_f
    ihf, iwf = in_hw_f
    if w0b >= BLOCK_BANDED_MIN_K:
        t = resample_cols_blocked(x, wb, int(cwf), int(iwf))
    else:
        t = jnp.matmul(x, box_weights_dyn(wb, w0b, cwf, iwf).T,
                       precision=_prec)
    if h0b >= BLOCK_BANDED_MIN_K:
        return resample_rows_blocked(t, hb, int(chf), int(ihf))
    return jnp.matmul(box_weights_dyn(hb, h0b, chf, ihf), t,
                      precision=_prec)


def bucketed_level_step(
    f0s, f1s,            # (H0b, W0b) bucket-padded full-res smoothed frames
    u_prev, v_prev,      # (H0b, W0b) flow carried at the top bucket
    scalars,             # LevelScalars.tree()
    bucket: Tuple[int, int],
    top_bucket: Tuple[int, int],
    cfg: FlowConfig,
    relax: str = "auto",
    relax_fn=None,   # override: (f0_l, f1_w, u, v, scalars, cfg) -> (du, dv)
):
    """One pyramid level at a bucket shape; returns flow at the top bucket.

    relax selects the relaxation engine (relax_kernel_plan); relax_fn
    overrides it (the sharded paths)."""
    import os

    (cw, ch, inv_hx, inv_hy, _d2x, _d2y, _d4x, _d4y, _ax, _ay, wlim, hlim,
     cwf, chf, w0f, h0f, prev_cwf, prev_chf) = scalars[:18]
    hb, wb = bucket
    h0b, w0b = top_bucket
    # Resample matmuls always run at HIGHEST precision: the exact
    # reference fractions need a float32 accumulate, and anything lower is
    # TF32 on a GPU.
    _prec = jax.lax.Precision.HIGHEST

    # TPUFLOW_BANDED_RESAMPLE=1: resample via banded gathers instead of the
    # dense matmuls (box matrices are >95% zeros). Off by default; an A/B
    # of the two forms on the GPU is still open (ROADMAP.md).
    _scal = (int, float, np.integer, np.floating)
    banded = (
        os.environ.get("TPUFLOW_BANDED_RESAMPLE", "0") == "1"
        and all(isinstance(s, _scal)
                for s in (chf, cwf, h0f, w0f, prev_chf, prev_cwf))
    )
    from tpuflow.ops.resample import BLOCK_BANDED_MIN_K

    blocked = (
        not banded
        and all(isinstance(s, _scal)
                for s in (chf, cwf, h0f, w0f, prev_chf, prev_cwf))
        and max(h0b, w0b) >= BLOCK_BANDED_MIN_K
    )
    fin_identity = (
        all(isinstance(s, _scal) for s in (chf, cwf, h0f, w0f))
        and (int(chf), int(cwf)) == (int(h0f), int(w0f))
        and bucket == top_bucket
    )
    if not banded and not blocked and not fin_identity:
        # Box-resample weights computed on device (exact reference
        # fractions, tpuflow.ops.resample.box_weights_dyn) — no per-level
        # uploads.
        wy_f = box_weights_dyn(hb, h0b, chf, h0f)
        wx_f = box_weights_dyn(wb, w0b, cwf, w0f)
        wy_u = box_weights_dyn(hb, h0b, chf, prev_chf)
        wx_u = box_weights_dyn(wb, w0b, cwf, prev_cwf)

    # Frames, ALWAYS from full-res smoothed (reference: optical_flow_2d.cpp:283-304).
    if banded:
        out_hw = (int(chf), int(cwf))
        f0_l = resample_banded(f0s, bucket, out_hw, (int(h0f), int(w0f)))
        f1_l = resample_banded(f1s, bucket, out_hw, (int(h0f), int(w0f)))
        u = resample_banded(u_prev, bucket, out_hw,
                            (int(prev_chf), int(prev_cwf)))
        v = resample_banded(v_prev, bucket, out_hw,
                            (int(prev_chf), int(prev_cwf)))
    elif fin_identity:
        # Finest level: the frame "resample" is the identity map — the
        # dense path would still burn 4 full-size HIGHEST matmuls whose
        # only effect is zeroing the ghost region. Mask instead (exact).
        keep = (
            (np.arange(hb) < int(chf)).astype(np.float32)[:, None]
            * (np.arange(wb) < int(cwf)).astype(np.float32)[None, :]
        )
        f0_l = f0s * keep
        f1_l = f1s * keep
        if (
            all(isinstance(s, _scal) for s in (prev_chf, prev_cwf))
            and max(h0b, w0b) >= BLOCK_BANDED_MIN_K
        ):
            uv = _resample_top(jnp.stack([u_prev, v_prev]), bucket,
                               (chf, cwf), (prev_chf, prev_cwf), _prec)
            u, v = uv[0], uv[1]
        else:
            wy_u = box_weights_dyn(hb, h0b, chf, prev_chf)
            wx_u = box_weights_dyn(wb, w0b, cwf, prev_cwf)
            u = jnp.matmul(wy_u, jnp.matmul(u_prev, wx_u.T, precision=_prec),
                           precision=_prec)
            v = jnp.matmul(wy_u, jnp.matmul(v_prev, wx_u.T, precision=_prec),
                           precision=_prec)
    elif blocked:
        # 1080p-class levels: block-banded resamples (static sizes).
        fl = _resample_top(jnp.stack([f0s, f1s]), bucket,
                           (chf, cwf), (h0f, w0f), _prec)
        f0_l, f1_l = fl[0], fl[1]
        uv = _resample_top(jnp.stack([u_prev, v_prev]), bucket,
                           (chf, cwf), (prev_chf, prev_cwf), _prec)
        u, v = uv[0], uv[1]
    else:
        f0_l = jnp.matmul(wy_f, jnp.matmul(f0s, wx_f.T, precision=_prec),
                          precision=_prec)
        f1_l = jnp.matmul(wy_f, jnp.matmul(f1s, wx_f.T, precision=_prec),
                          precision=_prec)
        u = jnp.matmul(wy_u, jnp.matmul(u_prev, wx_u.T, precision=_prec),
                       precision=_prec)
        v = jnp.matmul(wy_u, jnp.matmul(v_prev, wx_u.T, precision=_prec),
                       precision=_prec)
    f0_l = maintain_mirror1(f0_l, cw, ch)
    f1_l = maintain_mirror1(f1_l, cw, ch)
    u = maintain_mirror2(u, cw, ch)
    v = maintain_mirror2(v, cw, ch)

    # Backward registration (:343-363).
    f1_w = warp_dyn(f0_l, f1_l, u, v, cw, ch, inv_hx, inv_hy, wlim, hlim)
    f1_w = maintain_mirror1(f1_w, cw, ch)

    if relax_fn is not None:
        du, dv = relax_fn(f0_l, f1_w, u, v, scalars, cfg)
    else:
        du, dv = _relax_dyn(f0_l, f1_w, u, v, scalars, cfg, relax=relax)

    u = u + du
    v = v + dv
    # The median reads a (side-1)//2-radius window: refresh that many ghost
    # rows/cols of the summed flow (du carries at most radius-1 ghosts).
    # radius 3 for the side-7 window; SLACK=8 leaves room.
    ghost_r = max(2, (cfg.median_radius - 1) // 2)
    u = maintain_mirror(u, cw, ch, ghost_r)
    v = maintain_mirror(v, cw, ch, ghost_r)
    u = median(u, cfg.median_radius)
    v = median(v, cfg.median_radius)

    # Re-embed into the top bucket for the next level.
    u_out = jnp.zeros((h0b, w0b), jnp.float32).at[:hb, :wb].set(u)
    v_out = jnp.zeros((h0b, w0b), jnp.float32).at[:hb, :wb].set(v)
    return u_out, v_out


# Env-fingerprinted builder cache (shared with the per-shape engine):
# flipping a trace-time TPUFLOW_* flag can never return a stale program.
from tpuflow.utils.envcache import (  # noqa: E402
    env_cached as _env_cached,
    trace_env_fingerprint as _trace_env_fingerprint,
)


@_env_cached(maxsize=256)
def compiled_bucketed_level(bucket: Tuple[int, int], top_bucket: Tuple[int, int],
                            cfg: FlowConfig, relax: str = "auto", *,
                            _env=None):
    @jax.jit
    def run(f0s, f1s, u_prev, v_prev, scalars):
        return bucketed_level_step(
            f0s, f1s, u_prev, v_prev, scalars, bucket, top_bucket, cfg,
            relax=relax,
        )

    return run


@_env_cached(maxsize=256)
def compiled_bucketed_group(bucket: Tuple[int, int], top_bucket: Tuple[int, int],
                            n_levels: int, cfg: FlowConfig,
                            relax: str = "auto", *, _env=None):
    """All consecutive levels sharing one bucket as ONE dispatch: a
    `lax.scan` over their stacked per-level scalars."""

    @jax.jit
    def run(f0s, f1s, u_prev, v_prev, stacked_scalars):
        def body(carry, sc):
            u, v = carry
            u, v = bucketed_level_step(
                f0s, f1s, u, v, sc, bucket, top_bucket, cfg, relax=relax
            )
            return (u, v), None

        (u, v), _ = jax.lax.scan(body, (u_prev, v_prev), stacked_scalars,
                                 length=n_levels)
        return u, v

    return run


@_env_cached(maxsize=64)
def _compiled_smooth_pad(sigma: float, orig_shape: Tuple[int, int],
                         top_bucket: Tuple[int, int], *, _env=None):
    h0, w0 = orig_shape
    h0b, w0b = top_bucket

    @jax.jit
    def run(a):
        s = gaussian_smooth(a, sigma)
        return jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(s)

    return run


def compiled_full_pipeline(orig_shape: Tuple[int, int], cfg: FlowConfig,
                           unroll: bool = None, relax: str = "auto"):
    """The ENTIRE solve — presmooth + every bucket group — as ONE XLA
    program (one compile, one dispatch per pair). Per-level scalars are
    baked in as constants (the cache key is the workload shape + config +
    the TPUFLOW_* trace-time env flags).

    unroll: unroll the per-group level scans into straight-line code —
    the per-level scalars become XLA literals, so the on-device resample
    weight-matrix construction, boundary masks, and ghost-maintenance
    indices all constant-fold away, at a longer compile. Default: the
    TPUFLOW_UNROLL env flag, else UNROLL_DEFAULT.

    relax: the relaxation engine per level (relax_kernel_plan).
    """
    if unroll is None:
        unroll = unroll_default()
    return _compiled_full_pipeline(orig_shape, cfg, unroll, relax)


# Whether the single-pair pipeline unrolls its level scans by default. It
# does not: on an H100 the unrolled default-schedule program at 584x388 had
# not finished compiling after 6 minutes, while the scanned one compiles in
# minutes (PERF.md).
UNROLL_DEFAULT = False


def unroll_default() -> bool:
    """TPUFLOW_UNROLL (0/1) when set, else UNROLL_DEFAULT."""
    import os

    env = os.environ.get("TPUFLOW_UNROLL")
    return UNROLL_DEFAULT if env is None else env != "0"


def make_pipeline_fn(orig_shape: Tuple[int, int], cfg: FlowConfig,
                     unroll: bool, relax: str = "auto"):
    """The single-pair whole-pipeline body as a pure (f0, f1) -> (u, v)
    function (unjitted). `_compiled_full_pipeline` jits it directly;
    `compiled_full_pipeline_dp` shard_maps it over a 'data' mesh axis so
    every device runs THIS engine on its own pairs — frame pairs are
    independent (reference contract: one pair per run,
    src/main.cpp:175-178), so data parallelism needs no partitioning of
    the per-pair program at all."""
    h0, w0 = orig_shape
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
    h0b, w0b = top_bucket
    groups = _level_groups(specs, w0, h0, cfg)

    def run(f0, f1):
        f0s = gaussian_smooth(f0, cfg.gaussian_sigma)
        f0s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f0s)
        f1s = gaussian_smooth(f1, cfg.gaussian_sigma)
        f1s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f1s)

        if unroll:
            # Straight-line levels with static scalars.
            u = jnp.zeros((h0b, w0b), jnp.float32)
            v = jnp.zeros_like(u)
            for bucket, stacked in groups:
                for i in range(stacked[0].shape[0]):
                    sc = tuple(col[i] for col in stacked)
                    u, v = bucketed_level_step(
                        f0s, f1s, u, v, sc, bucket, top_bucket, cfg,
                        relax=relax,
                    )
            return u[:h0, :w0], v[:h0, :w0]

        u = jnp.zeros((h0b, w0b), jnp.float32)
        v = jnp.zeros_like(u)
        for bucket, stacked in groups:

            def body(carry, sc, bucket=bucket):
                return bucketed_level_step(
                    f0s, f1s, carry[0], carry[1], sc, bucket, top_bucket,
                    cfg, relax=relax,
                ), None

            (u, v), _ = jax.lax.scan(
                body, (u, v), stacked, length=stacked[0].shape[0]
            )
        return u[:h0, :w0], v[:h0, :w0]

    return run


@_env_cached(maxsize=64)
def _compiled_full_pipeline(orig_shape: Tuple[int, int], cfg: FlowConfig,
                            unroll: bool, relax: str = "auto", *, _env=None):
    return jax.jit(make_pipeline_fn(orig_shape, cfg, unroll, relax=relax))


def compute_flow_bucketed_async(frame_0, frame_1, cfg: FlowConfig = None,
                                *, single_dispatch: bool = True,
                                group_traces=None, relax: str = "auto"):
    """Full coarse-to-fine solve via bucketed programs; returns DEVICE
    arrays at the original (H, W).

    single_dispatch=True (default) runs the whole pyramid as one program;
    False dispatches one program per bucket group (useful when iterating on
    a single bucket's code, or to share group programs across workload
    shapes).

    group_traces: optional list; when given, forces grouped dispatch and
    appends one (bucket, n_levels, seconds) record per group (host-fenced —
    a profiling mode, not the fast path).

    relax: the relaxation engine per level (relax_kernel_plan).
    """
    import time

    cfg = cfg or FlowConfig()
    f0 = jnp.asarray(frame_0, dtype=jnp.float32)
    f1 = jnp.asarray(frame_1, dtype=jnp.float32)
    h0, w0 = f0.shape

    if group_traces is not None:
        single_dispatch = False

    if single_dispatch:
        return compiled_full_pipeline((h0, w0), cfg, relax=relax)(f0, f1)

    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
    h0b, w0b = top_bucket

    smooth = _compiled_smooth_pad(cfg.gaussian_sigma, (h0, w0), top_bucket)
    f0s = smooth(f0)
    f1s = smooth(f1)

    u = jnp.zeros((h0b, w0b), jnp.float32)
    v = jnp.zeros_like(u)

    for bucket, stacked in _level_groups(specs, w0, h0, cfg):
        t0 = time.perf_counter() if group_traces is not None else 0.0
        step = compiled_bucketed_group(bucket, top_bucket,
                                       stacked[0].shape[0], cfg, relax)
        u, v = step(f0s, f1s, u, v, stacked)
        if group_traces is not None:
            jax.block_until_ready(u)
            group_traces.append((bucket, int(stacked[0].shape[0]),
                                 time.perf_counter() - t0))

    return u[:h0, :w0], v[:h0, :w0]


def _level_groups(specs, w0: int, h0: int, cfg: FlowConfig):
    """Consecutive same-bucket levels with their stacked scalar trees."""
    groups = []
    prev_cw, prev_ch = specs[0].width, specs[0].height  # first level: identity
    for spec in specs:
        cw, ch = spec.width, spec.height
        bucket = bucket_dims(cw, ch)
        sc = LevelScalars.make(
            cw, ch, spec.hx, spec.hy, cfg.equation_alpha, w0, h0, prev_cw, prev_ch
        )
        if groups and groups[-1][0] == bucket:
            groups[-1][1].append(sc)
        else:
            groups.append((bucket, [sc]))
        prev_cw, prev_ch = cw, ch
    return [
        (bucket, tuple(np.stack(col) for col in zip(*(sc.tree() for sc in scs))))
        for bucket, scs in groups
    ]


@_env_cached(maxsize=64)
def compiled_full_pipeline_batched(orig_shape: Tuple[int, int], batch: int,
                                   cfg: FlowConfig, relax: str = "auto",
                                   *, _env=None):
    """vmapped single-dispatch whole-pipeline program for (B, H, W) stacks.

    relax: the relaxation engine per level (relax_kernel_plan); vmap runs
    the CUDA kernel once per pair. The GSPMD-sharded batch path passes
    "xla" (GSPMD cannot partition the custom call).
    """
    h0, w0 = orig_shape
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
    h0b, w0b = top_bucket
    groups = _level_groups(specs, w0, h0, cfg)

    def single(f0, f1):
        f0s = gaussian_smooth(f0, cfg.gaussian_sigma)
        f0s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f0s)
        f1s = gaussian_smooth(f1, cfg.gaussian_sigma)
        f1s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f1s)
        u = jnp.zeros((h0b, w0b), jnp.float32)
        v = jnp.zeros_like(u)
        for bucket, stacked in groups:
            def body(carry, sc, bucket=bucket):
                uu, vv = bucketed_level_step(
                    f0s, f1s, carry[0], carry[1], sc, bucket, top_bucket, cfg,
                    relax=relax,
                )
                return (uu, vv), None

            (u, v), _ = jax.lax.scan(body, (u, v), stacked,
                                     length=stacked[0].shape[0])
        return u[:h0, :w0], v[:h0, :w0]

    return jax.jit(jax.vmap(single))


@_env_cached(maxsize=32)
def compiled_full_pipeline_dp(orig_shape: Tuple[int, int], b_local: int,
                              mesh, data_axis: str, cfg: FlowConfig,
                              *, _env=None):
    """Data-parallel whole-pipeline program: `shard_map` over ``data_axis``
    whose per-shard body is the FULL single-pair engine — the CUDA kernel
    included — run over the shard's ``b_local`` pairs sequentially.

    Frame pairs are independent (reference: one pair per run,
    src/main.cpp:175-178), so the per-shard program needs ZERO cross-shard
    collectives and GSPMD never has to partition the kernel's custom call.
    A jaxpr-level test pins the absence of collectives.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    unroll = unroll_default()
    single = make_pipeline_fn(orig_shape, cfg, unroll)

    def local_fn(f0_l, f1_l):
        # (b_local, H, W) local pairs; unrolled Python loop — XLA overlaps
        # the chain like the async single-pair dispatch stream does.
        outs = [single(f0_l[i], f1_l[i]) for i in range(b_local)]
        return (
            jnp.stack([o[0] for o in outs]),
            jnp.stack([o[1] for o in outs]),
        )

    spec = P(data_axis, None, None)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


@_env_cached(maxsize=64)
def compiled_full_pipeline_sharded(orig_shape: Tuple[int, int], mesh,
                                   y_axis: str, cfg: FlowConfig,
                                   halo: str = "explicit", *, _env=None):
    """Single-dispatch pipeline with rows sharded over the mesh's spatial
    axis — the SURVEY §2.7 spatial domain decomposition.

    Every bucket dimension is a multiple of 64 rows, so row sharding
    divides evenly for any power-of-two axis size.

    halo="explicit" (default): the relaxation — ~95% of per-level work —
    runs as a shard_map with ONE ppermute exchange of an
    (inner_iterations+1)-row halo per outer iteration and redundant
    in-halo computation (tpuflow.parallel.halo); buckets too small for a
    halo block replicate on the XLA path. Resample/warp/median stay GSPMD.

    halo="gspmd": everything left to GSPMD, which partitions each stencil
    shift separately (~30 1-row collective-permutes per outer iteration —
    the latency-bound baseline the explicit path exists to beat).

    halo="auto": cost-based per-level routing (parallel.model.plan_level)
    — each bucket runs the cheaper of {replicate, explicit@k} under the
    measured collective model, where k is the k-outer halo-fusion factor
    (one exchange per k fused outer iterations; valid-region numerics are
    k-invariant). Replicated-planned buckets carry a fully-replicated
    sharding constraint so GSPMD compiles them without per-shift
    collectives.

    "explicit" honors TPUFLOW_HALO_K as a fixed fusion factor (default 1);
    "auto" chooses k per level.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    h0, w0 = orig_shape
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
    h0b, w0b = top_bucket
    groups = _level_groups(specs, w0, h0, cfg)
    n_y = mesh.shape[y_axis]
    row_sharding = NamedSharding(mesh, P(y_axis, None))
    repl_sharding = NamedSharding(mesh, P(None, None))

    plans = {}
    if halo == "auto":
        from tpuflow.parallel.model import plan_level

        for bucket, _ in groups:
            plans[bucket] = plan_level(bucket[0], bucket[1], cfg, n_y)

    def constrain(a, hb, bucket=None):
        if bucket is not None and plans.get(bucket, ("",))[0] == "replicated":
            # auto-planned replication: pin the carry replicated so
            # GSPMD compiles the level without per-shift collectives.
            return jax.lax.with_sharding_constraint(a, repl_sharding)
        if hb % n_y == 0 and hb // n_y >= 16:
            return jax.lax.with_sharding_constraint(a, row_sharding)
        return a  # tiny buckets: replicate (GSPMD's choice)

    def relax_for(bucket):
        if halo not in ("explicit", "auto"):
            return None
        from tpuflow.parallel.halo import halo_applicable, relax_sharded

        if halo == "auto":
            path, kk, _ = plans[bucket]
            if path == "replicated":
                return None

            def aefn(f0_l, f1_w, uu, vv, sc, cfg_, kk=kk):
                return relax_sharded(
                    f0_l, f1_w, uu, vv, sc, cfg_, mesh, y_axis, k_outer=kk)

            return aefn

        if not halo_applicable(bucket[0], n_y, cfg):
            return None

        def fn(f0_l, f1_w, uu, vv, sc, cfg_):
            return relax_sharded(f0_l, f1_w, uu, vv, sc, cfg_, mesh, y_axis)

        return fn

    @jax.jit
    def run(f0, f1):
        f0s = gaussian_smooth(f0, cfg.gaussian_sigma)
        f0s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f0s)
        f1s = gaussian_smooth(f1, cfg.gaussian_sigma)
        f1s = jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(f1s)
        f0s = constrain(f0s, h0b)
        f1s = constrain(f1s, h0b)
        u = jnp.zeros((h0b, w0b), jnp.float32)
        v = jnp.zeros_like(u)
        for bucket, stacked in groups:
            relax_fn = relax_for(bucket)

            def body(carry, sc, bucket=bucket, relax_fn=relax_fn):
                # relax="xla" on the replicated levels: GSPMD cannot
                # partition the kernel's custom call.
                uu, vv = bucketed_level_step(
                    f0s, f1s, carry[0], carry[1], sc, bucket, top_bucket, cfg,
                    relax="xla", relax_fn=relax_fn,
                )
                return (constrain(uu, h0b, bucket),
                        constrain(vv, h0b, bucket)), None

            (u, v), _ = jax.lax.scan(
                body, (u, v), stacked, length=stacked[0].shape[0]
            )
        return u[:h0, :w0], v[:h0, :w0]

    return run


def compute_flow_bucketed_sharded(frame_0, frame_1, cfg: FlowConfig = None,
                                  mesh=None, y_axis: str = "y",
                                  halo: str = "explicit"):
    """Single frame pair with image rows sharded over the mesh (the
    lowest-latency route for one large frame). Returns DEVICE arrays.

    halo: "explicit" (shard_map + one widened ppermute exchange per outer,
    the default), "auto" (cost-based per-level routing over
    {replicate, explicit@k} via parallel.model.plan_level) or "gspmd"
    (compiler-partitioned stencils)."""
    from tpuflow.parallel.mesh import make_mesh

    cfg = cfg or FlowConfig()
    mesh = mesh or make_mesh()
    f0 = jnp.asarray(frame_0, dtype=jnp.float32)
    f1 = jnp.asarray(frame_1, dtype=jnp.float32)
    run = compiled_full_pipeline_sharded(f0.shape, mesh, y_axis, cfg, halo)
    return run(f0, f1)


def compute_flow_bucketed_batch(frames_0, frames_1, cfg: FlowConfig = None,
                                mesh=None, data_axis: str = "data",
                                dp: str = "shard_map"):
    """Solve a (B, H, W) stack of independent frame pairs.

    The streaming-throughput entry point. Returns DEVICE arrays (B, H, W).

    With ``mesh``, pairs are data-parallel over the mesh's ``data_axis``.
    Frame pairs are independent (reference contract: one pair per run,
    src/main.cpp:175-178), so the default ``dp="shard_map"`` runs the
    FULL single-pair engine — the CUDA kernel included — per shard via
    `compiled_full_pipeline_dp` (N x the headline single-chip engine; the
    batch is padded to an axis-size multiple by repeating the last pair
    and trimmed after; output sharding is P(data_axis) on the caller's
    mesh, so global/multi-host arrays keep their shard layout). For pure
    DP put every device on ``data_axis`` — other mesh axes replicate the
    work. ``dp="gspmd"`` keeps the legacy vmapped program whose batch
    axis GSPMD shards over ``data_axis`` — that path must force the XLA
    relaxation (GSPMD cannot partition the kernel's custom call); it
    remains as the A/B baseline.
    """
    cfg = cfg or FlowConfig()
    f0 = jnp.asarray(frames_0, dtype=jnp.float32)
    f1 = jnp.asarray(frames_1, dtype=jnp.float32)
    if f0.ndim != 3 or f0.shape != f1.shape:
        raise ValueError(f"expected (B, H, W) stacks, got {f0.shape} {f1.shape}")
    b, h0, w0 = f0.shape

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        # Pad the batch to an axis-size multiple by repeating the last
        # pair (trimmed after): both DP modes shard the batch axis.
        n = mesh.shape[data_axis]
        b_pad = -(-b // n) * n
        if b_pad != b:
            f0 = jnp.concatenate(
                [f0, jnp.broadcast_to(f0[-1:], (b_pad - b, h0, w0))], axis=0)
            f1 = jnp.concatenate(
                [f1, jnp.broadcast_to(f1[-1:], (b_pad - b, h0, w0))], axis=0)
        sharding = NamedSharding(mesh, P(data_axis, None, None))
        f0 = jax.device_put(f0, sharding)
        f1 = jax.device_put(f1, sharding)
        if dp == "shard_map":
            run = compiled_full_pipeline_dp((h0, w0), b_pad // n, mesh,
                                            data_axis, cfg)
        else:
            # Legacy vmapped program: GSPMD shards the batch axis but
            # cannot partition the kernel's custom call -> XLA relaxation.
            run = compiled_full_pipeline_batched((h0, w0), b_pad, cfg,
                                                 relax="xla")
        u, v = run(f0, f1)
        return (u, v) if b_pad == b else (u[:b], v[:b])

    # One program, one dispatch (the whole pyramid vmapped over the batch).
    run = compiled_full_pipeline_batched((h0, w0), b, cfg)
    return run(f0, f1)


_WARMED: set = set()


def warmup_bucketed(orig_shape: Tuple[int, int], cfg: FlowConfig,
                    max_workers: int = 16, *, grouped: bool = False,
                    relax: str = "auto") -> float:
    """Compile the solver for a workload shape before timing/serving.

    Warms by CALLING with zero arguments: `.lower().compile()` does not
    populate the jit dispatch cache, so an AOT-only warmup still pays the
    full compile on the first real call.

    Default warms the single-dispatch whole-pipeline program.
    ``grouped=True`` also warms the per-bucket group programs. Idempotent
    per (shape, cfg, grouped).
    """
    import time
    from concurrent.futures import ThreadPoolExecutor

    key = (orig_shape, cfg, grouped, relax, _trace_env_fingerprint())
    if key in _WARMED:
        return 0.0
    t0 = time.perf_counter()
    h0, w0 = orig_shape
    zeros_frame = jnp.zeros((h0, w0), jnp.float32)
    jax.block_until_ready(compiled_full_pipeline(orig_shape, cfg, relax=relax)(
        zeros_frame, zeros_frame))

    if grouped:
        specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
        top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
        h0b, w0b = top_bucket
        groups = _level_groups(specs, w0, h0, cfg)
        zeros = jnp.zeros((h0b, w0b), jnp.float32)

        def compile_group(group):
            bucket, stacked = group
            fn = compiled_bucketed_group(bucket, top_bucket,
                                         stacked[0].shape[0], cfg, relax)
            np.asarray(fn(zeros, zeros, zeros, zeros, stacked)[0])

        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            list(ex.map(compile_group, groups))
        smooth = _compiled_smooth_pad(cfg.gaussian_sigma, (h0, w0), top_bucket)
        np.asarray(smooth(zeros_frame))
    # Record success only AFTER everything compiled and ran: a failure
    # must not mark the key warmed.
    _WARMED.add(key)
    return time.perf_counter() - t0
