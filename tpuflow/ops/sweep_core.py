"""THE per-pixel Jacobi sweep update — single source of truth.

Every engine (the XLA scan path of solver.bucketed, the sharded ppermute
block of parallel.halo) runs the same coupled point update, and the CUDA
kernel (tpuflow/ops/cuda/relax.cu) transliterates it in the same order
(reference math: src/kernels/solve_2d.cu:361-367):

    sumU   = sum_i pw_i (T_i - u_c)           (smoothness, 4 neighbors)
    new_du = (-a13 - a12 * dv_c + sumU) / dnu
    new_dv = (-a23 - a12 * new_du + sumV) / dnv   (fresh du - Gauss-Seidel
                                                   coupling inside the pair)

The iterate is T = flow + d; neighbors enter recentered (T_i - u_c), and
the data terms a13/a23 are the ksi-scaled tensor entries.

These helpers are pure jnp expression builders — they trace identically
inside XLA jit and shard_map bodies. Association order is load-bearing:
the engines are pinned against each other at the 1-ulp level, so any
change here must re-run the parity tests (tests/test_halo.py,
tests/test_relax_engines.py).

The per-shape engine's unhoisted form (ops/solver_ops.py,
`ksi*(-J13 - J12*dv) + sumU) / (ksi*J11 + sumH)`) is intentionally NOT
unified: it reproduces the reference's own operation order for
oracle-anchored testing and differs from the hoisted form at 1 ulp.
"""

from __future__ import annotations


def smoothness_sum(pw, nb, center):
    """sum_i pw_i * (nb_i - center).

    pw = (pw_xp, pw_xm, pw_yp, pw_ym) half-point diffusivity weights,
    nb = neighbor values in the SAME order. Left-associated."""
    pw_xp, pw_xm, pw_yp, pw_ym = pw
    n_xp, n_xm, n_yp, n_ym = nb
    return (
        pw_xp * (n_xp - center)
        + pw_xm * (n_xm - center)
        + pw_yp * (n_yp - center)
        + pw_ym * (n_ym - center)
    )


def sweep_update_T(nb_tu, nb_tv, u_c, v_c, dv_c, pw, a12, a13, a23,
                   dnu, dnv):
    """T-form update. nb_tu/nb_tv: (xp, xm, yp, ym) neighbor values of
    the combined iterates Tu/Tv; u_c/v_c: center flow; dv_c: the CENTER
    v-displacement. Returns (new_du, new_dv) DISPLACEMENTS."""
    sumU = smoothness_sum(pw, nb_tu, u_c)
    sumV = smoothness_sum(pw, nb_tv, v_c)
    new_du = (-a13 - a12 * dv_c + sumU) / dnu
    new_dv = (-a23 - a12 * new_du + sumV) / dnv
    return new_du, new_dv
