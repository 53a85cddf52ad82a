"""The variational solver core: phi/ksi and Jacobi relaxation sweeps (JAX).

Transliterates the math of reference: src/kernels/solve_2d.cu —
  * ``compute_phi_ksi``: flow-driven (TV-like) diffusivity
    phi = 1/(2*sqrt(|grad(u+du)|^2 + |grad(v+dv)|^2 + e_s^2)) and robust
    data penalizer ksi = 1/(2*sqrt(s + e_d^2)) from the GREY motion tensor
    (solve_2d.cu:43-198; ksi is grey even for gradient/log solvers,
    cuda_operation_solve_2d.cpp:84);
  * ``solve_sweep``: one point-wise lagged-nonlinearity Jacobi sweep with
    arithmetic-mean half-point diffusivities, free-boundary masks, and the
    sequential du* -> dv* intra-pixel coupling (solve_2d.cu:200-377 grey,
    :683-953 gradient, :391-669 log).

All stencils use mirror ('reflect') boundaries like the shared-memory halo
loads in the reference.  Everything is shift-and-multiply; XLA fuses the
whole sweep into a handful of loops.  The CUDA relaxation kernel
(tpuflow/ops/cuda/relax.cu) transliterates this module's math.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from tpuflow.config import DataConstancy


def _shifts(a: jax.Array):
    """(center, x+1, x-1, y+1, y-1) with the mirror boundary of the
    reference halo loads (x<0 -> -x, x>=w -> 2w-x-2, i.e. 'reflect').

    Implemented as slice+concat (not jnp.pad).
    """
    xp = jnp.concatenate([a[:, 1:], a[:, -2:-1]], axis=1)
    xm = jnp.concatenate([a[:, 1:2], a[:, :-1]], axis=1)
    yp = jnp.concatenate([a[1:, :], a[-2:-1, :]], axis=0)
    ym = jnp.concatenate([a[1:2, :], a[:-1, :]], axis=0)
    return a, xp, xm, yp, ym


def _shifts_edge(a: jax.Array):
    """(x+1, x-1, y+1, y-1) with replicate boundary (derivative fields)."""
    xp = jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    xm = jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)
    yp = jnp.concatenate([a[1:, :], a[-1:, :]], axis=0)
    ym = jnp.concatenate([a[:1, :], a[:-1, :]], axis=0)
    return xp, xm, yp, ym


def _grey_derivatives(f0: jax.Array, f1: jax.Array, hx: float, hy: float):
    """fx, fy averaged over both frames (/4h); ft = f1 - f0
    (reference: solve_2d.cu:164-174,311-321)."""
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _shifts(f1)
    fx = (f0_xp - f0_xm + f1_xp - f1_xm) / jnp.float32(4.0 * hx)
    fy = (f0_yp - f0_ym + f1_yp - f1_ym) / jnp.float32(4.0 * hy)
    ft = f1_c - f0_c
    return fx, fy, ft


def compute_phi_ksi(
    f0: jax.Array,
    f1: jax.Array,
    u: jax.Array,
    v: jax.Array,
    du: jax.Array,
    dv: jax.Array,
    hx: float,
    hy: float,
    e_smooth: float,
    e_data: float,
) -> Tuple[jax.Array, jax.Array]:
    """Lagged-nonlinearity update (reference: solve_2d.cu:43-198)."""
    _, u_xp, u_xm, u_yp, u_ym = _shifts(u)
    _, v_xp, v_xm, v_yp, v_ym = _shifts(v)
    du_c, du_xp, du_xm, du_yp, du_ym = _shifts(du)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _shifts(dv)

    dux = (u_xp - u_xm + du_xp - du_xm) / jnp.float32(2.0 * hx)
    duy = (u_yp - u_ym + du_yp - du_ym) / jnp.float32(2.0 * hy)
    dvx = (v_xp - v_xm + dv_xp - dv_xm) / jnp.float32(2.0 * hx)
    dvy = (v_yp - v_ym + dv_yp - dv_ym) / jnp.float32(2.0 * hy)

    e_s2 = jnp.float32(e_smooth) * jnp.float32(e_smooth)
    phi = 1.0 / (2.0 * jnp.sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2))

    fx, fy, ft = _grey_derivatives(f0, f1, hx, hy)
    J11, J22, J33 = fx * fx, fy * fy, ft * ft
    J12, J13, J23 = fx * fy, fx * ft, fy * ft

    s = (
        (J11 * du_c + J12 * dv_c + J13) * du_c
        + (J12 * du_c + J22 * dv_c + J23) * dv_c
        + (J13 * du_c + J23 * dv_c + J33)
    )
    s = jnp.maximum(s, 0.0)

    e_d2 = jnp.float32(e_data) * jnp.float32(e_data)
    ksi = 1.0 / (2.0 * jnp.sqrt(s + e_d2))
    return phi, ksi


def _edge_weights(h: int, w: int, hx: float, hy: float, alpha: float):
    """alpha/h^2 neighbor weights, zeroed at image borders (free boundary)
    (reference: solve_2d.cu:333-340)."""
    hx_2 = jnp.float32(float(alpha) / (float(hx) * float(hx)))
    hy_2 = jnp.float32(float(alpha) / (float(hy) * float(hy)))
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xp = jnp.where(xs < w - 1, hx_2, 0.0)
    xm = jnp.where(xs > 0, hx_2, 0.0)
    yp = jnp.where(ys < h - 1, hy_2, 0.0)
    ym = jnp.where(ys > 0, hy_2, 0.0)
    return xp, xm, yp, ym


def _second_order_tensor(fx, fy, ft, hx: float, hy: float):
    """Gradient-constancy motion tensor from first-derivative fields
    (reference: solve_2d.cu:867-884), replicate boundary for the derivative
    stencil (clean global form of the reference's tile-halo replication at
    solve_2d.cu:813-841)."""
    hx_1 = jnp.float32(1.0 / (2.0 * hx))
    hy_1 = jnp.float32(1.0 / (2.0 * hy))
    fx_xp, fx_xm, fx_yp, fx_ym = _shifts_edge(fx)
    fy_xp, fy_xm, fy_yp, fy_ym = _shifts_edge(fy)
    ft_xp, ft_xm, ft_yp, ft_ym = _shifts_edge(ft)

    fxx = (fx_xp - fx_xm) * hx_1
    fxy = (fx_yp - fx_ym) * hy_1
    fyy = (fy_yp - fy_ym) * hy_1
    fxt = (ft_xp - ft_xm) * hx_1
    fyt = (ft_yp - ft_ym) * hy_1

    J11 = fxx * fxx + fxy * fxy
    J22 = fxy * fxy + fyy * fyy
    J12 = fxx * fxy + fxy * fyy
    J13 = fxx * fxt + fxy * fyt
    J23 = fxy * fxt + fyy * fyt
    return J11, J22, J12, J13, J23


def _motion_tensor(
    f0: jax.Array, f1: jax.Array, hx: float, hy: float, constancy: DataConstancy
):
    """(J11, J22, J12, J13, J23) for the selected data term."""
    if constancy == DataConstancy.GREY:
        fx, fy, ft = _grey_derivatives(f0, f1, hx, hy)
        return fx * fx, fy * fy, fx * fy, fx * ft, fy * ft
    if constancy == DataConstancy.GRADIENT:
        fx, fy, ft = _grey_derivatives(f0, f1, hx, hy)
        return _second_order_tensor(fx, fy, ft, hx, hy)
    if constancy == DataConstancy.LOG_DERIVATIVES:
        # Derivatives of log(1 + I) (reference: solve_2d.cu:508-524).
        log0 = jnp.log1p(f0)
        log1 = jnp.log1p(f1)
        fx, fy, ft = _grey_derivatives(log0, log1, hx, hy)
        return _second_order_tensor(fx, fy, ft, hx, hy)
    raise ValueError(f"unknown data constancy {constancy}")


# ---------------------------------------------------------------------------
# Dynamic-size (bucketed) formulation.
#
# Arrays live at a padded BUCKET shape; the valid region (ch, cw) and all
# h-derived constants arrive as traced scalars, so ONE compiled program
# serves every pyramid level that maps to the same bucket. Mirror
# semantics at the valid edge are provided by ghost-row/col maintenance
# (tpuflow.solver.bucketed.maintain_mirror2), so plain concat shifts give
# reference-exact values inside the valid region.
# ---------------------------------------------------------------------------


def edge_weights_dyn(shape, cw, ch, alpha_hx2, alpha_hy2):
    """Free-boundary neighbor weights with a traced valid region.

    Same masks as _edge_weights (reference: solve_2d.cu:333-340) but the
    image extent (cw, ch) and the alpha/h^2 constants are runtime scalars.
    """
    hb, wb = shape
    xs = jax.lax.broadcasted_iota(jnp.int32, (hb, wb), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (hb, wb), 0)
    xp = jnp.where(xs < cw - 1, alpha_hx2, 0.0)
    xm = jnp.where(xs > 0, alpha_hx2, 0.0)
    yp = jnp.where(ys < ch - 1, alpha_hy2, 0.0)
    ym = jnp.where(ys > 0, alpha_hy2, 0.0)
    return xp, xm, yp, ym


def compute_phi_ksi_dyn(f0, f1, u, v, du, dv, div2hx, div2hy, div4hx, div4hy,
                        e_s2, e_d2):
    """compute_phi_ksi with traced h-spacing constants (bucketed path)."""
    _, u_xp, u_xm, u_yp, u_ym = _shifts(u)
    _, v_xp, v_xm, v_yp, v_ym = _shifts(v)
    du_c, du_xp, du_xm, du_yp, du_ym = _shifts(du)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _shifts(dv)

    dux = (u_xp - u_xm + du_xp - du_xm) / div2hx
    duy = (u_yp - u_ym + du_yp - du_ym) / div2hy
    dvx = (v_xp - v_xm + dv_xp - dv_xm) / div2hx
    dvy = (v_yp - v_ym + dv_yp - dv_ym) / div2hy

    phi = 1.0 / (2.0 * jnp.sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2))

    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _shifts(f1)
    fx = (f0_xp - f0_xm + f1_xp - f1_xm) / div4hx
    fy = (f0_yp - f0_ym + f1_yp - f1_ym) / div4hy
    ft = f1_c - f0_c

    J11, J22, J33 = fx * fx, fy * fy, ft * ft
    J12, J13, J23 = fx * fy, fx * ft, fy * ft
    s = (
        (J11 * du_c + J12 * dv_c + J13) * du_c
        + (J12 * du_c + J22 * dv_c + J23) * dv_c
        + (J13 * du_c + J23 * dv_c + J33)
    )
    s = jnp.maximum(s, 0.0)
    ksi = 1.0 / (2.0 * jnp.sqrt(s + e_d2))
    return phi, ksi


# ---------------------------------------------------------------------------
# Padded formulation — the fast XLA path used by the relaxation scan.
#
# The unpadded API above materializes 4 shifted copies per field per sweep
# (the concats become separate XLA fusions). Maintaining each field as an
# (h+2, w+2) mirror-padded array turns every shift into a pure slice of ONE
# buffer, cutting per-sweep HBM traffic several-fold. Values are identical:
# slices of a reflect-padded array ARE the mirror-boundary shifts.
# ---------------------------------------------------------------------------


def pad_mirror(a: jax.Array) -> jax.Array:
    """(h, w) -> (h+2, w+2) with the reference mirror boundary."""
    return jnp.pad(a, 1, mode="reflect")


def _pshifts(p: jax.Array):
    """center, x+1, x-1, y+1, y-1 as slices of a padded array."""
    return (
        p[1:-1, 1:-1],
        p[1:-1, 2:],
        p[1:-1, :-2],
        p[2:, 1:-1],
        p[:-2, 1:-1],
    )


def _grey_derivatives_p(f0p, f1p, hx: float, hy: float):
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _pshifts(f0p)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _pshifts(f1p)
    fx = (f0_xp - f0_xm + f1_xp - f1_xm) / jnp.float32(4.0 * hx)
    fy = (f0_yp - f0_ym + f1_yp - f1_ym) / jnp.float32(4.0 * hy)
    ft = f1_c - f0_c
    return fx, fy, ft


def compute_phi_ksi_padded(
    f0p, f1p, up, vp, dup, dvp, hx, hy, e_smooth, e_data
) -> Tuple[jax.Array, jax.Array]:
    """compute_phi_ksi on mirror-padded inputs; returns UNPADDED phi, ksi."""
    _, u_xp, u_xm, u_yp, u_ym = _pshifts(up)
    _, v_xp, v_xm, v_yp, v_ym = _pshifts(vp)
    du_c, du_xp, du_xm, du_yp, du_ym = _pshifts(dup)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _pshifts(dvp)

    dux = (u_xp - u_xm + du_xp - du_xm) / jnp.float32(2.0 * hx)
    duy = (u_yp - u_ym + du_yp - du_ym) / jnp.float32(2.0 * hy)
    dvx = (v_xp - v_xm + dv_xp - dv_xm) / jnp.float32(2.0 * hx)
    dvy = (v_yp - v_ym + dv_yp - dv_ym) / jnp.float32(2.0 * hy)

    e_s2 = jnp.float32(e_smooth) * jnp.float32(e_smooth)
    phi = 1.0 / (2.0 * jnp.sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2))

    fx, fy, ft = _grey_derivatives_p(f0p, f1p, hx, hy)
    J11, J22, J33 = fx * fx, fy * fy, ft * ft
    J12, J13, J23 = fx * fy, fx * ft, fy * ft

    s = (
        (J11 * du_c + J12 * dv_c + J13) * du_c
        + (J12 * du_c + J22 * dv_c + J23) * dv_c
        + (J13 * du_c + J23 * dv_c + J33)
    )
    s = jnp.maximum(s, 0.0)
    e_d2 = jnp.float32(e_data) * jnp.float32(e_data)
    ksi = 1.0 / (2.0 * jnp.sqrt(s + e_d2))
    return phi, ksi


def _motion_tensor_p(f0p, f1p, hx: float, hy: float, constancy: DataConstancy):
    if constancy == DataConstancy.GREY:
        fx, fy, ft = _grey_derivatives_p(f0p, f1p, hx, hy)
        return fx * fx, fy * fy, fx * fy, fx * ft, fy * ft
    if constancy == DataConstancy.GRADIENT:
        fx, fy, ft = _grey_derivatives_p(f0p, f1p, hx, hy)
        return _second_order_tensor(fx, fy, ft, hx, hy)
    if constancy == DataConstancy.LOG_DERIVATIVES:
        fx, fy, ft = _grey_derivatives_p(jnp.log1p(f0p), jnp.log1p(f1p), hx, hy)
        return _second_order_tensor(fx, fy, ft, hx, hy)
    raise ValueError(f"unknown data constancy {constancy}")


def solve_sweep_padded(
    f0p, f1p, up, vp, dup, dvp, phip, ksi, hx, hy, alpha,
    constancy: DataConstancy = DataConstancy.GREY,
) -> Tuple[jax.Array, jax.Array]:
    """One Jacobi sweep on mirror-padded fields; returns UNPADDED du', dv'."""
    J11, J22, J12, J13, J23 = _motion_tensor_p(f0p, f1p, hx, hy, constancy)
    h, w = ksi.shape
    xp, xm, yp, ym = _edge_weights(h, w, hx, hy, alpha)

    phi_c, phi_xp_n, phi_xm_n, phi_yp_n, phi_ym_n = _pshifts(phip)
    u_c, u_xp, u_xm, u_yp, u_ym = _pshifts(up)
    v_c, v_xp, v_xm, v_yp, v_ym = _pshifts(vp)
    du_c, du_xp, du_xm, du_yp, du_ym = _pshifts(dup)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _pshifts(dvp)

    phi_xp = (phi_xp_n + phi_c) * 0.5
    phi_xm = (phi_xm_n + phi_c) * 0.5
    phi_yp = (phi_yp_n + phi_c) * 0.5
    phi_ym = (phi_ym_n + phi_c) * 0.5

    sumH = xp * phi_xp + xm * phi_xm + yp * phi_yp + ym * phi_ym
    sumU = (
        phi_xp * xp * (u_xp + du_xp - u_c)
        + phi_xm * xm * (u_xm + du_xm - u_c)
        + phi_yp * yp * (u_yp + du_yp - u_c)
        + phi_ym * ym * (u_ym + du_ym - u_c)
    )
    sumV = (
        phi_xp * xp * (v_xp + dv_xp - v_c)
        + phi_xm * xm * (v_xm + dv_xm - v_c)
        + phi_yp * yp * (v_yp + dv_yp - v_c)
        + phi_ym * ym * (v_ym + dv_ym - v_c)
    )

    result_du = (ksi * (-J13 - J12 * dv_c) + sumU) / (ksi * J11 + sumH)
    result_dv = (ksi * (-J23 - J12 * result_du) + sumV) / (ksi * J22 + sumH)
    return result_du, result_dv


def solve_sweep(
    f0: jax.Array,
    f1: jax.Array,
    u: jax.Array,
    v: jax.Array,
    du: jax.Array,
    dv: jax.Array,
    phi: jax.Array,
    ksi: jax.Array,
    hx: float,
    hy: float,
    alpha: float,
    constancy: DataConstancy = DataConstancy.GREY,
) -> Tuple[jax.Array, jax.Array]:
    """One Jacobi sweep: returns (du', dv').

    The motion tensor is recomputed in-sweep like the reference kernels do;
    for a fixed level (f0, f1, hx, hy are loop constants) XLA hoists it out
    of the `lax.scan` over sweeps automatically — same math, none of the
    redundant recomputation the CUDA kernel pays per launch.
    """
    J11, J22, J12, J13, J23 = _motion_tensor(f0, f1, hx, hy, constancy)
    h, w = u.shape
    xp, xm, yp, ym = _edge_weights(h, w, hx, hy, alpha)

    phi_c, phi_xp_n, phi_xm_n, phi_yp_n, phi_ym_n = _shifts(phi)
    u_c, u_xp, u_xm, u_yp, u_ym = _shifts(u)
    v_c, v_xp, v_xm, v_yp, v_ym = _shifts(v)
    du_c, du_xp, du_xm, du_yp, du_ym = _shifts(du)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _shifts(dv)

    phi_xp = (phi_xp_n + phi_c) * 0.5
    phi_xm = (phi_xm_n + phi_c) * 0.5
    phi_yp = (phi_yp_n + phi_c) * 0.5
    phi_ym = (phi_ym_n + phi_c) * 0.5

    sumH = xp * phi_xp + xm * phi_xm + yp * phi_yp + ym * phi_ym
    sumU = (
        phi_xp * xp * (u_xp + du_xp - u_c)
        + phi_xm * xm * (u_xm + du_xm - u_c)
        + phi_yp * yp * (u_yp + du_yp - u_c)
        + phi_ym * ym * (u_ym + du_ym - u_c)
    )
    sumV = (
        phi_xp * xp * (v_xp + dv_xp - v_c)
        + phi_xm * xm * (v_xm + dv_xm - v_c)
        + phi_yp * yp * (v_yp + dv_yp - v_c)
        + phi_ym * ym * (v_ym + dv_ym - v_c)
    )

    # Sequential 2x2 intra-pixel coupling: dv* uses the fresh du*
    # (reference: solve_2d.cu:361-367).
    result_du = (ksi * (-J13 - J12 * dv_c) + sumU) / (ksi * J11 + sumH)
    result_dv = (ksi * (-J23 - J12 * result_du) + sumV) / (ksi * J22 + sumH)
    return result_du, result_dv
