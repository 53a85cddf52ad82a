"""The relaxation engines on the CPU.

* the XLA engine (solver.bucketed._relax_dyn) against the NumPy oracle,
  across data constancy x bucket shape x inner sweeps;
* the CUDA kernel's schedule, transliterated in NumPy
  (ops.relax_cuda.relax_tiled_reference), against the XLA engine — the
  halo arithmetic, reflect boundary and zero fill outside the valid region;
* the wrapper around the kernel: launch shape per bucket, scalar packing,
  engine selection, build command.

Cross-program float noise (1 ulp from a different expression association)
is amplified by the lagged nonlinearity at phi-sensitive pixels, so parity
is bounded by the mean EPE over the valid region (the repo's band).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuflow import oracle
from tpuflow.config import DataConstancy, FlowConfig
from tpuflow.ops import relax_cuda as RC
from tpuflow.solver import bucketed as B

CONSTANCIES = [DataConstancy.GREY, DataConstancy.GRADIENT,
               DataConstancy.LOG_DERIVATIVES]
# (hb, wb, ch, cw): the coarse bucket, a mid bucket, a wide one.
BUCKETS = [(64, 128, 50, 113), (128, 128, 97, 117), (64, 256, 41, 230)]
INNERS = [0, 1, 5]
HX, HY = 1.3, 1.2


def _smooth_field(rng, shape, scale):
    a = rng.standard_normal(shape).astype(np.float32)
    for _ in range(4):
        a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 0)) / 4
    return (a * scale).astype(np.float32)


def level_inputs(hb, wb, ch, cw, seed=0):
    """Bucket arrays with the ghost maintenance the level step gives them
    (frames radius 1, flow radius 2), their valid-region views, and the
    level scalars."""
    rng = np.random.default_rng(seed)
    f0 = np.abs(_smooth_field(rng, (hb, wb), 150.0)) + 20.0
    f1 = f0 + _smooth_field(rng, (hb, wb), 8.0)
    u = _smooth_field(rng, (hb, wb), 1.5)
    v = _smooth_field(rng, (hb, wb), 1.5)
    sc = B.LevelScalars.make(cw, ch, HX, HY, 35.0, 584, 388, cw, ch).tree()
    f0 = B.maintain_mirror1(jnp.asarray(f0), cw, ch)
    f1 = B.maintain_mirror1(jnp.asarray(f1), cw, ch)
    u = B.maintain_mirror2(jnp.asarray(u), cw, ch)
    v = B.maintain_mirror2(jnp.asarray(v), cw, ch)
    return f0, f1, u, v, sc


def oracle_relax(f0, f1, u, v, cfg: FlowConfig):
    """The reference relaxation (oracle.compute_flow's inner loop)."""
    name = {DataConstancy.GREY: "grey", DataConstancy.GRADIENT: "gradient",
            DataConstancy.LOG_DERIVATIVES: "log"}[cfg.data_constancy]
    sweep = oracle._SWEEPS[name]
    du = np.zeros_like(u)
    dv = np.zeros_like(v)
    for _ in range(cfg.outer_iterations_count):
        phi, ksi = oracle.compute_phi_ksi(
            f0, f1, u, v, du, dv, HX, HY, cfg.equation_smoothness,
            cfg.equation_data)
        for _ in range(cfg.inner_iterations_count):
            du, dv = sweep(f0, f1, u, v, du, dv, phi, ksi, HX, HY,
                           cfg.equation_alpha)
    return du, dv


def _mean_epe(a, b, ch, cw):
    return float(np.mean(np.hypot(
        np.asarray(a[0])[:ch, :cw] - np.asarray(b[0])[:ch, :cw],
        np.asarray(a[1])[:ch, :cw] - np.asarray(b[1])[:ch, :cw])))


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("bucket", BUCKETS, ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("constancy", CONSTANCIES, ids=lambda c: c.value)
def test_xla_relax_matches_oracle(constancy, bucket, inner):
    hb, wb, ch, cw = bucket
    cfg = FlowConfig(outer_iterations_count=3, inner_iterations_count=inner,
                     data_constancy=constancy)
    f0, f1, u, v, sc = level_inputs(hb, wb, ch, cw)
    got = jax.jit(lambda *a: B._relax_dyn(*a, sc, cfg, relax="xla"))(
        f0, f1, u, v)
    want = oracle_relax(*(np.asarray(a)[:ch, :cw] for a in (f0, f1, u, v)),
                        cfg)
    assert np.isfinite(np.asarray(got[0])).all()
    scale = float(np.abs(want[0]).mean()) if inner else 0.0
    epe = _mean_epe(got, want, ch, cw)
    assert epe <= 1e-4, (epe, scale)
    if inner:
        assert scale > 1e-3  # the comparison is not vacuous


def _tiled_plan(hb, wb, inner, th=16, tw=32):
    return RC.Plan("tiled", th, tw, inner + 1, (-(-hb // th), -(-wb // tw)),
                   RC.TILED_THREADS, 0)


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("variant", ["whole", "tiled"])
@pytest.mark.parametrize("constancy", CONSTANCIES, ids=lambda c: c.value)
def test_kernel_schedule_matches_xla_relax(constancy, variant, inner):
    hb, wb, ch, cw = BUCKETS[0]
    cfg = FlowConfig(outer_iterations_count=3, inner_iterations_count=inner,
                     data_constancy=constancy)
    f0, f1, u, v, sc = level_inputs(hb, wb, ch, cw, seed=1)
    want = B._relax_dyn(f0, f1, u, v, sc, cfg, relax="xla")
    fx, fy, ft, J = B.level_constants(f0, f1, sc, cfg)
    p = (RC.plan(hb, wb, inner) if variant == "whole"
         else _tiled_plan(hb, wb, inner))
    assert p.variant == variant
    got = RC.relax_tiled_reference(fx, fy, ft, J, u, v, sc, cfg, p)
    assert _mean_epe(got, want, ch, cw) <= 1e-4
    # Outside the valid region the kernel writes zeros.
    assert not np.asarray(got[0])[ch:, :].any()
    assert not np.asarray(got[1])[:, cw:].any()


@pytest.mark.parametrize("tile", [(8, 32), (16, 32), (16, 64)])
@pytest.mark.parametrize("constancy", CONSTANCIES, ids=lambda c: c.value)
def test_tiled_schedule_equals_whole_level(constancy, tile):
    """The halo arithmetic: an (inner+1)-pixel margin recomputed per
    outer iteration reproduces the whole-level relaxation exactly."""
    hb, wb, ch, cw = BUCKETS[0]
    inner = 5
    cfg = FlowConfig(outer_iterations_count=3, inner_iterations_count=inner,
                     data_constancy=constancy)
    f0, f1, u, v, sc = level_inputs(hb, wb, ch, cw, seed=2)
    fx, fy, ft, J = B.level_constants(f0, f1, sc, cfg)
    whole = RC.relax_tiled_reference(fx, fy, ft, J, u, v, sc, cfg,
                                     RC.plan(hb, wb, inner))
    tiled = RC.relax_tiled_reference(fx, fy, ft, J, u, v, sc, cfg,
                                     _tiled_plan(hb, wb, inner, *tile))
    np.testing.assert_array_equal(whole[0], tiled[0])
    np.testing.assert_array_equal(whole[1], tiled[1])


def test_short_halo_breaks_tiled_schedule():
    """The margin is load-bearing: with one pixel less than inner+1 the
    tiled schedule no longer reproduces the whole level."""
    hb, wb, ch, cw = BUCKETS[0]
    cfg = FlowConfig(outer_iterations_count=2, inner_iterations_count=3)
    f0, f1, u, v, sc = level_inputs(hb, wb, ch, cw, seed=3)
    fx, fy, ft, J = B.level_constants(f0, f1, sc, cfg)
    whole = RC.relax_tiled_reference(fx, fy, ft, J, u, v, sc, cfg,
                                     RC.plan(hb, wb, 3))
    short = RC.relax_tiled_reference(
        fx, fy, ft, J, u, v, sc, cfg,
        RC.Plan("tiled", 16, 32, 3, (4, 4), RC.TILED_THREADS, 0))
    assert np.abs(whole[0] - short[0]).max() > 0


@pytest.mark.parametrize("bucket", [(64, 128), (64, 256), (128, 128),
                                    (128, 256), (192, 384), (448, 640),
                                    (1088, 2048), (2176, 3968)])
def test_kernel_plan_fits_the_card(bucket):
    hb, wb = bucket
    p = RC.plan(hb, wb, 5)
    assert p is not None
    assert p.variant == ("whole" if bucket == (64, 128) else "tiled")
    assert p.smem_bytes <= RC.SMEM_LIMIT
    if p.variant == "whole":
        assert p.grid == (1, 1)
        assert (hb - 8) * (wb - 8) <= p.threads * RC.WHOLE_MAX_P
    else:
        assert p.halo == 6
        ext = (p.tile_h + 2 * p.halo) * (p.tile_w + 2 * p.halo)
        assert ext <= p.threads * RC.TILED_MAX_P
        assert p.grid[0] * p.tile_h >= hb and p.grid[1] * p.tile_w >= wb
        assert (p.grid[0] - 1) * p.tile_h < hb
        assert p.smem_bytes == RC.N_FIELDS * 4 * ext


def test_kernel_plan_large_inner_falls_back():
    # A halo too wide for any tile: no plan, the XLA engine runs.
    assert RC.plan(448, 640, 60) is None
    # Smaller tiles take over as the halo grows.
    assert RC.plan(448, 640, 12).tile_h < RC.plan(448, 640, 5).tile_h


@pytest.mark.parametrize("relax,expect", [("xla", None), ("auto", None),
                                          ("cuda", "whole")])
def test_relax_kernel_plan_selection(relax, expect):
    # On the CPU backend "auto" keeps the XLA engine; "cuda" forces a plan.
    p = B.relax_kernel_plan((64, 128), FlowConfig(), relax)
    assert (p.variant if p is not None else None) == expect


def test_relax_kernel_plan_rejects_unknown_engine():
    with pytest.raises(ValueError):
        B.relax_kernel_plan((64, 128), FlowConfig(), "pallas")


def test_pack_params_static_and_traced():
    sc = B.LevelScalars.make(113, 50, HX, HY, 35.0, 584, 388, 113, 50).tree()
    p = np.asarray(RC.pack_params(sc))
    assert p.dtype == np.float32 and p.shape == (8,)
    np.testing.assert_array_equal(
        p[:6], np.array([113, 50, sc[4], sc[5], sc[8], sc[9]], np.float32))
    traced = jax.jit(lambda *s: RC.pack_params(s))(*sc)
    np.testing.assert_array_equal(np.asarray(traced), p)


def test_kernel_source_limits_match_wrapper():
    src = open(RC.SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSmallThreads") == RC.WHOLE_THREADS
    assert const("kSmallMaxP") == RC.WHOLE_MAX_P
    assert const("kTiledThreads") == RC.TILED_THREADS
    assert const("kTiledMaxP") == RC.TILED_MAX_P
    assert const("kFields") == RC.N_FIELDS
    assert "XLA_FFI_DEFINE_HANDLER_SYMBOL" in src and "TpuflowRelax" in src


def test_build_command_targets_hopper():
    cmd = RC.build_command("/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == RC.SOURCE and cmd[cmd.index("-o") + 1] == "/x/lib.so"
    assert jax.ffi.include_dir() in cmd
    assert RC.LIBRARY.endswith("build/librelax_kernel.so")
