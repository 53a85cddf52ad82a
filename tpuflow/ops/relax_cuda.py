"""Hopper relaxation kernel (tpuflow/ops/cuda/relax.cu) as a JAX operation.

``relax_cuda`` computes what ``tpuflow.solver.bucketed._relax_dyn`` computes
— ``outer x (phi/ksi + inner sweeps)`` on one bucket — in one FFI call. This
module holds everything around the kernel that the CPU can test: the choice
of launch shape per bucket (``plan``), the packing of the level scalars
(``pack_params``), the build of the shared library, and
``relax_tiled_reference``, a NumPy transliteration of the kernel's tiled
halo schedule.

The library is built from the committed source into ``<repo>/build`` at
first use, or ahead of time with ``python -m tpuflow.ops.relax_cuda --build``
(needs ``nvcc``; CUDA only — there is no interpret mode).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from tpuflow.config import DataConstancy, FlowConfig

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "tpuflow", "ops", "cuda", "relax.cu")
LIBRARY = os.path.join(_REPO, "build", "librelax_kernel.so")
TARGET = "tpuflow_relax"

# Mirrors of the kernel's compile-time limits (relax.cu).
WHOLE_THREADS, WHOLE_MAX_P = 512, 14
TILED_THREADS, TILED_MAX_P = 256, 14
N_FIELDS = 5
SMEM_LIMIT = 227 * 1024
TILE_CANDIDATES = ((32, 64), (16, 64), (16, 32), (8, 32))
SLACK = 8  # bucket slack (solver.bucketed.SLACK): valid <= bucket - 8


class Plan(NamedTuple):
    """Launch shape for one bucket: ``whole`` (one block, every iteration in
    one launch) or ``tiled`` (one launch per outer iteration)."""

    variant: str
    tile_h: int
    tile_w: int
    halo: int
    grid: Tuple[int, int]      # (blocks along y, blocks along x)
    threads: int
    smem_bytes: int


def plan(hb: int, wb: int, inner: int) -> Optional[Plan]:
    """The kernel's launch shape for an (hb, wb) bucket, or None when no
    shape fits the kernel's per-thread pixel budget or shared memory (the
    caller then runs the XLA engine)."""
    region = (hb - SLACK) * (wb - SLACK)
    if region <= WHOLE_THREADS * WHOLE_MAX_P and (
            N_FIELDS * 4 * region <= SMEM_LIMIT):
        return Plan("whole", hb, wb, 0, (1, 1), WHOLE_THREADS,
                    N_FIELDS * 4 * region)
    halo = inner + 1
    for th, tw in TILE_CANDIDATES:
        ext = (th + 2 * halo) * (tw + 2 * halo)
        smem = N_FIELDS * 4 * ext
        if ext <= TILED_THREADS * TILED_MAX_P and smem <= SMEM_LIMIT:
            return Plan("tiled", th, tw, halo,
                        (-(-hb // th), -(-wb // tw)), TILED_THREADS, smem)
    return None


def pack_params(sc) -> jax.Array:
    """float32[8] device vector of the level scalars the kernel reads:
    (cw, ch, 2hx, 2hy, alpha/hx^2, alpha/hy^2, 0, 0). Traced scalars (the
    scanned pipeline) and constants (the unrolled one) both work."""
    cw, ch, _, _, div2hx, div2hy, _, _, a_hx2, a_hy2 = sc[:10]
    vals = [cw, ch, div2hx, div2hy, a_hx2, a_hy2]
    return jnp.stack([jnp.asarray(x).astype(jnp.float32) for x in vals]
                     + [jnp.float32(0), jnp.float32(0)])


def build_command(out: str = LIBRARY) -> list:
    return [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out, SOURCE,
    ]


def build_library(force: bool = False) -> str:
    """Compile relax.cu into LIBRARY unless an up-to-date build exists."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


_LOCK = threading.Lock()
_REGISTERED = False


def _ensure_registered() -> None:
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TpuflowRelax), platform="CUDA")
        _REGISTERED = True


def relax_cuda(fx, fy, ft, tensor, u, v, sc, cfg: FlowConfig, p: Plan):
    """(du, dv) of one level on the CUDA kernel. ``tensor`` is the
    (J11, J22, J12, J13, J23) motion tensor for gradient/log, ignored for
    grey (the kernel forms grey J from fx, fy, ft)."""
    _ensure_registered()
    hb, wb = u.shape
    if cfg.outer_iterations_count == 0:
        z = jnp.zeros_like(u)
        return z, z
    F = np.float32
    grey = cfg.data_constancy == DataConstancy.GREY
    J = (fx,) * 5 if grey else tuple(tensor)
    out = jax.ShapeDtypeStruct((hb, wb), jnp.float32)
    call = jax.ffi.ffi_call(TARGET, (out,) * 4, vmap_method="sequential")
    du, dv, _, _ = call(
        pack_params(sc), fx, fy, ft, *J, u, v,
        outer=np.int64(cfg.outer_iterations_count),
        inner=np.int64(cfg.inner_iterations_count),
        grey=np.int64(grey), whole=np.int64(p.variant == "whole"),
        tile_h=np.int64(p.tile_h), tile_w=np.int64(p.tile_w),
        e_s2=F(cfg.equation_smoothness) * F(cfg.equation_smoothness),
        e_d2=F(cfg.equation_data) * F(cfg.equation_data),
    )
    return du, dv


# ---------------------------------------------------------------------------
# NumPy transliteration of the kernel (CPU reference of its tiled schedule)
# ---------------------------------------------------------------------------


def _nb(g: np.ndarray, d: int, n: int, r0: int, rn: int) -> np.ndarray:
    y = g + d
    y = np.where(y < 0, -y, np.where(y >= n, 2 * n - y - 2, y))
    return np.clip(y - r0, 0, rn - 1)


def _outer_block(c, u, v, du, dv, ry0, rx0, cw, ch, s, n_outer, inner,
                 e_s2, e_d2, grey):
    """n_outer iterations of the kernel on one block's region (float32)."""
    F = np.float32
    rh, rw = u.shape
    gy = np.arange(ry0, ry0 + rh)[:, None]
    gx = np.arange(rx0, rx0 + rw)[None, :]
    xp, xm = _nb(gx, 1, cw, rx0, rw), _nb(gx, -1, cw, rx0, rw)
    yp, ym = _nb(gy, 1, ch, ry0, rh), _nb(gy, -1, ch, ry0, rh)
    R = np.arange(rh)[:, None]
    C = np.arange(rw)[None, :]

    def XP(a):
        return a[R, xp]

    def XM(a):
        return a[R, xm]

    def YP(a):
        return a[yp, C]

    def YM(a):
        return a[ym, C]

    div2hx, div2hy, ahx2, ahy2 = s
    fx, fy, ft = c[0], c[1], c[2]
    w_xp = np.where(gx < cw - 1, ahx2, F(0)).astype(F) + np.zeros((rh, 1), F)
    w_xm = np.where(gx > 0, ahx2, F(0)).astype(F) + np.zeros((rh, 1), F)
    w_yp = np.where(gy < ch - 1, ahy2, F(0)).astype(F) + np.zeros((1, rw), F)
    w_ym = np.where(gy > 0, ahy2, F(0)).astype(F) + np.zeros((1, rw), F)
    if grey:
        J11, J22, J12, J13, J23 = (fx * fx, fy * fy, fx * fy, fx * ft,
                                   fy * ft)
    else:
        J11, J22, J12, J13, J23 = c[3:8]
    for _ in range(n_outer):
        dux = (XP(u) - XM(u) + XP(du) - XM(du)) / div2hx
        duy = (YP(u) - YM(u) + YP(du) - YM(du)) / div2hy
        dvx = (XP(v) - XM(v) + XP(dv) - XM(dv)) / div2hx
        dvy = (YP(v) - YM(v) + YP(dv) - YM(dv)) / div2hy
        phi = F(1) / (F(2) * np.sqrt(dux * dux + duy * duy + dvx * dvx
                                     + dvy * dvy + e_s2))
        g11, g22, g33 = fx * fx, fy * fy, ft * ft
        g12, g13, g23 = fx * fy, fx * ft, fy * ft
        sv = ((g11 * du + g12 * dv + g13) * du + (g12 * du + g22 * dv + g23)
              * dv + (g13 * du + g23 * dv + g33))
        ksi = F(1) / (F(2) * np.sqrt(np.maximum(sv, F(0)) + e_d2))
        pw_xp = (XP(phi) + phi) * F(0.5) * w_xp
        pw_xm = (XM(phi) + phi) * F(0.5) * w_xm
        pw_yp = (YP(phi) + phi) * F(0.5) * w_yp
        pw_ym = (YM(phi) + phi) * F(0.5) * w_ym
        sumH = pw_xp + pw_xm + pw_yp + pw_ym
        a12, a13, a23 = ksi * J12, ksi * J13, ksi * J23
        dnu, dnv = ksi * J11 + sumH, ksi * J22 + sumH
        for _ in range(inner):
            tu, tv = u + du, v + dv
            sumU = (pw_xp * (XP(tu) - u) + pw_xm * (XM(tu) - u)
                    + pw_yp * (YP(tu) - u) + pw_ym * (YM(tu) - u))
            sumV = (pw_xp * (XP(tv) - v) + pw_xm * (XM(tv) - v)
                    + pw_yp * (YP(tv) - v) + pw_ym * (YM(tv) - v))
            ndu = (-a13 - a12 * dv + sumU) / dnu
            dv = ((-a23 - a12 * ndu + sumV) / dnv).astype(F)
            du = ndu.astype(F)
    return du, dv


def relax_tiled_reference(fx, fy, ft, tensor, u, v, sc, cfg: FlowConfig,
                          p: Plan):
    """The kernel's schedule in NumPy: per launch, per block, load the
    block's region (owned tile + halo, clamped to the valid extent), run the
    launch's outer iterations there, keep the owned pixels. Returns (du, dv)
    at bucket shape, 0 outside the valid region."""
    F = np.float32
    arr = [np.asarray(a, F) for a in (fx, fy, ft)]
    grey = cfg.data_constancy == DataConstancy.GREY
    if not grey:
        arr += [np.asarray(a, F) for a in tensor]
    u = np.asarray(u, F)
    v = np.asarray(v, F)
    hb, wb = u.shape
    cw, ch = int(sc[0]), int(sc[1])
    s = tuple(F(x) for x in (sc[4], sc[5], sc[8], sc[9]))
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    inner = cfg.inner_iterations_count
    du = np.zeros((hb, wb), F)
    dv = np.zeros((hb, wb), F)
    launches = ([(cfg.outer_iterations_count)] if p.variant == "whole"
                else [1] * cfg.outer_iterations_count)
    for n_outer in launches:
        ndu = np.zeros_like(du)
        ndv = np.zeros_like(dv)
        for by in range(p.grid[0]):
            for bx in range(p.grid[1]):
                oy0, ox0 = by * p.tile_h, bx * p.tile_w
                ry0, ry1 = max(0, oy0 - p.halo), min(ch, oy0 + p.tile_h + p.halo)
                rx0, rx1 = max(0, ox0 - p.halo), min(cw, ox0 + p.tile_w + p.halo)
                if ry1 <= ry0 or rx1 <= rx0:
                    continue
                sl = (slice(ry0, ry1), slice(rx0, rx1))
                bdu, bdv = _outer_block(
                    [a[sl] for a in arr], u[sl], v[sl], du[sl], dv[sl],
                    ry0, rx0, cw, ch, s, n_outer, inner, e_s2, e_d2, grey)
                oy1 = min(oy0 + p.tile_h, ch)
                ox1 = min(ox0 + p.tile_w, cw)
                if oy1 > oy0 and ox1 > ox0:
                    ndu[oy0:oy1, ox0:ox1] = bdu[oy0 - ry0:oy1 - ry0,
                                                ox0 - rx0:ox1 - rx0]
                    ndv[oy0:oy1, ox0:ox1] = bdv[oy0 - ry0:oy1 - ry0,
                                                ox0 - rx0:ox1 - rx0]
        du, dv = ndu, ndv
    return du, dv


if __name__ == "__main__":
    if "--build" in sys.argv[1:]:
        print(build_library(force=True))
    else:
        print(__doc__)
