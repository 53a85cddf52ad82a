#!/usr/bin/env python
"""Bring-up check of tpuflow on NVIDIA GPUs — the quickest proof that the
system still starts and computes the right flow on the card.

    python chip_smoke.py             # one card (every phase below)
    python chip_smoke.py --cards 4   # four cards: dp and sp against one card

Phases on one card, each printing one JSON line:
  device     — the platform must be 'gpu' (never a CPU fallback); the
               card's name and power limit; the compile-cache directory;
               builds the native libraries from the committed sources
               (make -C tpuflow/_native, the CUDA relaxation kernel).
  gpu-tests  — the ``gpu``-marked tests (tests/test_relax_cuda_gpu.py).
  inputs     — seeded uint8 frame pairs with known flow at 584x388 and
               1920x1080 (tpuflow.synthetic).
  grey-584   — full default schedule through compute_flow vs the committed
               oracle golden: mean EPE <= 1e-3 px.
  constancy  — grey/gradient/log at the small schedule vs committed
               goldens: mean EPE <= min(0.05, 0.1 * RMS + 1e-4) px.
  1080p      — small schedule vs the NumPy oracle computed here (<= 1e-3
               px); full default schedule finite everywhere.
  kernel     — the CUDA relaxation kernel vs the XLA engine on real level
               inputs at the 64x128, 448x640 and 1088x2048 buckets, all
               three constancies, after 40 and 3 outer iterations: mean
               EPE <= max(1e-4 px, 2x the XLA engine's own drift under
               +-1-ulp input jitter over 8 seeds); where that is wider
               than 1e-4 px, a planted fault (one inner sweep fewer) must
               fail it.
  timing     — steady-state per-pair time of the default pipeline at both
               sizes, XLA engine and kernel in turns (xla, cuda, cuda,
               xla); informs, gates nothing.

With --cards 4 only the four-card path runs: the NVLink ppermute cost
inside a program and the one-card level times the sharding router is
calibrated with, then a
(4, 1080, 1920) stack through compute_flow(..., mesh=make_mesh()) (data
parallel) and one 3840x2160 pair with the explicit halo (spatial
sharding), each against the one-card result (mean EPE <= 1e-4 px). On
four H100s this takes ~9 minutes, ~4 of them compiling the sharded 4K
program; give it a time limit of at least 900 s.

The last line of standard output is one JSON object, printed only when
every phase passed:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failure exits non-zero without it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()

# (hb, wb, ch, cw): the kernel-parity buckets with their valid extents.
KERNEL_BUCKETS = ((64, 128, 50, 113), (448, 640, 388, 584),
                  (1088, 2048, 1080, 1920))
DP_SHAPE = (4, 1080, 1920)   # (pairs, h, w) of the data-parallel stack
SP_SHAPE = (2160, 3840)      # (h, w) of the spatially sharded pair
PPERMUTE_ROWS = (1, 16, 256, 4096, 16384)  # x 4 KiB per device
ROUTER_BUCKETS = KERNEL_BUCKETS  # one-card level times for the router
ULP_SEEDS = 8                     # float-noise ensemble of the kernel gate
PPERMUTE_HOPS = (10, 110)         # ring steps per program (link fit)


def emit(phase, **kv):
    rec = {"phase": phase, "t_s": round(time.perf_counter() - T0, 1)}
    rec.update(kv)
    print(json.dumps(rec), flush=True)


class PhaseFailed(Exception):
    pass


def check(ok, phase, msg):
    if not ok:
        raise PhaseFailed(f"{phase}: {msg}")


def mean_epe(u_a, v_a, u_b, v_b):
    import numpy as np

    return float(np.mean(np.hypot(np.asarray(u_a) - np.asarray(u_b),
                                  np.asarray(v_a) - np.asarray(v_b))))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(cards):
    import jax

    from tpuflow.utils.gpu import card_line, require_gpu
    from tpuflow.utils.jitcache import setup_jit_cache

    cache = setup_jit_cache(quiet=True)
    devices = require_gpu(cards)
    print(card_line(), flush=True)
    emit("device", devices=[str(d) for d in jax.devices()],
         kind=devices[0].device_kind, jax=jax.__version__, cache_dir=cache)
    t = time.perf_counter()
    res = subprocess.run(["make", "-C", os.path.join(REPO, "tpuflow",
                                                      "_native")],
                         capture_output=True, text=True)
    check(res.returncode == 0, "device", f"make failed: {res.stderr[-2000:]}")
    from tpuflow.ops.relax_cuda import build_library

    lib = build_library()
    emit("build", native="tpuflow/_native", kernel=os.path.relpath(lib, REPO),
         seconds=round(time.perf_counter() - t, 1))
    return devices


def phase_gpu_tests():
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.outcome] = (
                    self.outcomes.get(report.outcome, 0) + 1)

    os.environ["TPUFLOW_TEST_PLATFORM"] = "gpu"
    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "-p", "no:xdist",
                      os.path.join(REPO, "tests", "test_relax_cuda_gpu.py")],
                     plugins=[counter])
    emit("gpu-tests", rc=int(rc), outcomes=counter.outcomes)
    check(rc == 0 and counter.outcomes.get("passed", 0) > 0
          and not counter.outcomes.get("skipped"), "gpu-tests",
          f"rc={rc} outcomes={counter.outcomes}")


def phase_grey_584(pair):
    from tpuflow import FlowConfig, compute_flow
    from tpuflow.synthetic import load_golden

    f0, f1, ut, vt = pair
    t = time.perf_counter()
    res = compute_flow(f0, f1, FlowConfig())
    gu, gv = load_golden("default", f0, f1)
    epe = mean_epe(res.u, res.v, gu, gv)
    emit("grey-584", schedule="default", epe_oracle_px=epe, gate_px=1e-3,
         epe_true_px=mean_epe(res.u, res.v, ut, vt),
         wall_s=round(time.perf_counter() - t, 1))
    check(epe <= 1e-3, "grey-584", f"EPE vs golden {epe}")


def phase_constancy(pair):
    import numpy as np

    from tpuflow import FlowConfig, compute_flow
    from tpuflow.config import DataConstancy
    from tpuflow.synthetic import SMALL_SCHEDULE, load_golden

    f0, f1, _, _ = pair
    for name in ("grey", "gradient", "log"):
        cfg = FlowConfig(data_constancy=DataConstancy(name), **SMALL_SCHEDULE)
        res = compute_flow(f0, f1, cfg)
        gu, gv = load_golden(f"{name}_small", f0, f1, SMALL_SCHEDULE)
        epe = mean_epe(res.u, res.v, gu, gv)
        rms = float(np.sqrt(np.mean(gu * gu + gv * gv)))
        gate = min(0.05, 0.1 * rms + 1e-4)
        emit("constancy", constancy=name, schedule="small", epe_oracle_px=epe,
             gate_px=gate, golden_rms_px=rms)
        check(epe <= gate, "constancy", f"{name}: EPE {epe} > {gate}")


def phase_1080p(pair):
    import numpy as np

    from tpuflow import FlowConfig, compute_flow, oracle
    from tpuflow.synthetic import SMALL_SCHEDULE

    f0, f1, ut, vt = pair
    t = time.perf_counter()
    ou, ov = oracle.compute_flow(f0, f1, **SMALL_SCHEDULE)
    t_oracle = time.perf_counter() - t
    res = compute_flow(f0, f1, FlowConfig(**SMALL_SCHEDULE))
    epe = mean_epe(res.u, res.v, ou, ov)
    emit("1080p", schedule="small", epe_oracle_px=epe, gate_px=1e-3,
         oracle_s=round(t_oracle, 1))
    check(epe <= 1e-3, "1080p", f"small-schedule EPE vs oracle {epe}")
    res = compute_flow(f0, f1, FlowConfig())
    finite = bool(np.isfinite(res.u).all() and np.isfinite(res.v).all())
    emit("1080p", schedule="default", finite=finite,
         epe_true_px=mean_epe(res.u, res.v, ut, vt))
    check(finite, "1080p", "non-finite flow at the default schedule")


def level_inputs(hb, wb, ch, cw, constancy, seed):
    """One real pyramid level at bucket (hb, wb): presmoothed seeded frames
    at the level's valid size, the true flow as the prolongated prior, the
    backward warp, and ghost upkeep exactly as bucketed_level_step does."""
    import jax.numpy as jnp
    import numpy as np

    from tpuflow.config import FlowConfig
    from tpuflow.ops.gaussian import gaussian_smooth
    from tpuflow.solver import bucketed as B
    from tpuflow.synthetic import seeded_pair

    f0, f1, ut, vt = seeded_pair(cw, ch, seed)
    cfg = FlowConfig(data_constancy=constancy)

    def bucket(a):
        out = np.zeros((hb, wb), np.float32)
        out[:ch, :cw] = np.asarray(a, np.float32)
        return jnp.asarray(out)

    sc = B.LevelScalars.make(cw, ch, 1.0, 1.0, cfg.equation_alpha, cw, ch,
                             cw, ch).tree()
    f0b = B.maintain_mirror1(bucket(gaussian_smooth(
        jnp.asarray(f0, jnp.float32), cfg.gaussian_sigma)), cw, ch)
    f1b = B.maintain_mirror1(bucket(gaussian_smooth(
        jnp.asarray(f1, jnp.float32), cfg.gaussian_sigma)), cw, ch)
    u = B.maintain_mirror2(bucket(0.8 * ut), cw, ch)
    v = B.maintain_mirror2(bucket(0.8 * vt), cw, ch)
    f1w = B.maintain_mirror1(
        B.warp_dyn(f0b, f1b, u, v, cw, ch, sc[2], sc[3], sc[10], sc[11]),
        cw, ch)
    return f0b, f1w, u, v, sc, cfg


def ulp_jitter(a, seed):
    """``a`` with every pixel moved by -1, 0 or +1 ulp, drawn from ``seed``."""
    import jax.numpy as jnp
    import numpy as np

    a = np.asarray(a, np.float32)
    step = np.random.default_rng(seed).integers(-1, 2, a.shape)
    out = np.where(step > 0, np.nextafter(a, np.float32(np.inf)),
                   np.where(step < 0, np.nextafter(a, np.float32(-np.inf)), a))
    return jnp.asarray(out)


def phase_kernel():
    """Kernel vs XLA engine on real level inputs, after 40 (the default)
    and 3 outer iterations.

    Each case also runs the XLA engine on its input flow jittered by
    +-1 ulp under ULP_SEEDS seeds: the largest mean EPE of those runs
    against the unjittered one is the engine's own float-noise drift d.
    The gate is max(1e-4, 2 d) px. It is 1e-4 everywhere except the
    gradient constancy at 40 outer iterations, which is chaotic under float
    noise (d ~ 1e-4..5e-3 px). Wherever the gate is wider than 1e-4 a
    planted fault — the kernel run with one inner sweep fewer — must fail
    it, so the gate still separates a wrong kernel from float noise."""
    import jax
    import numpy as np

    from tpuflow.config import DataConstancy, FlowConfig
    from tpuflow.solver import bucketed as B

    def run(cfg, sc, relax, *args):
        fn = jax.jit(lambda *a: B._relax_dyn(*a, sc, cfg, relax=relax))
        du, dv = jax.block_until_ready(fn(*args))
        return fn, np.asarray(du), np.asarray(dv)

    for hb, wb, ch, cw in KERNEL_BUCKETS:
        for constancy in DataConstancy:
            f0, f1, u, v, sc, _ = level_inputs(hb, wb, ch, cw, constancy, 3)
            for outer in (40, 3):
                cfg = FlowConfig(data_constancy=constancy,
                                 outer_iterations_count=outer)

                def epe_to(du, dv):
                    e = np.hypot(du[:ch, :cw] - xla[0][:ch, :cw],
                                 dv[:ch, :cw] - xla[1][:ch, :cw])
                    return float(e.mean()), float(e.max())

                fn, *xla = run(cfg, sc, "xla", f0, f1, u, v)
                _, *cuda = run(cfg, sc, "cuda", f0, f1, u, v)
                drifts = [epe_to(*map(np.asarray, fn(
                    f0, f1, ulp_jitter(u, 2 * k), ulp_jitter(v, 2 * k + 1))))
                    for k in range(ULP_SEEDS)]
                drift = max(m for m, _ in drifts)
                gate = max(1e-4, 2 * drift)
                epe, epe_max = epe_to(*cuda)
                finite = bool(np.isfinite(cuda[0]).all()
                              and np.isfinite(cuda[1]).all())
                rec = dict(bucket=[hb, wb], valid=[ch, cw],
                           constancy=constancy.value, outer=outer,
                           variant=B.relax_kernel_plan((hb, wb), cfg,
                                                       "cuda").variant,
                           epe_vs_xla_px=epe, max_epe_vs_xla_px=epe_max,
                           xla_ulp_drift_px=[m for m, _ in drifts],
                           xla_ulp_drift_max_px=max(x for _, x in drifts),
                           gate_px=gate,
                           du_scale_px=float(np.abs(xla[0][:ch, :cw]).mean()))
                fault = None
                if gate > 1e-4:
                    bad = FlowConfig(data_constancy=constancy,
                                     outer_iterations_count=outer,
                                     inner_iterations_count=(
                                         cfg.inner_iterations_count - 1))
                    _, *wrong = run(bad, sc, "cuda", f0, f1, u, v)
                    fault = epe_to(*wrong)[0]
                    rec["planted_fault_epe_px"] = fault
                emit("kernel", **rec)
                where = f"{hb}x{wb} {constancy.value} outer={outer}"
                check(finite and epe <= gate, "kernel",
                      f"{where}: EPE {epe} > {gate} (finite={finite})")
                check(fault is None or fault > gate, "kernel",
                      f"{where}: planted fault EPE {fault} passes gate {gate}")


def phase_timing(pairs, n=5):
    import jax
    import jax.numpy as jnp

    from tpuflow import FlowConfig
    from tpuflow.solver.bucketed import compiled_full_pipeline
    from tpuflow.utils.gpu import summarize_ms, time_calls

    cfg = FlowConfig()
    result = {}
    for f0, f1, _, _ in pairs:
        h, w = f0.shape
        g0 = jnp.asarray(f0, jnp.float32)
        g1 = jnp.asarray(f1, jnp.float32)
        compile_s = {}
        times = {"xla": [], "cuda": []}
        for turn, relax in enumerate(("xla", "cuda", "cuda", "xla")):
            fn = compiled_full_pipeline((h, w), cfg, relax=relax)
            if relax not in compile_s:
                t = time.perf_counter()
                jax.block_until_ready(fn(g0, g1))
                compile_s[relax] = time.perf_counter() - t
            secs = time_calls(fn, g0, g1, n=n)
            times[relax] += secs
            emit("timing", size=f"{w}x{h}", turn=turn, relax=relax,
                 **summarize_ms(secs, w * h))
        for relax in ("xla", "cuda"):
            s = summarize_ms(times[relax], w * h)
            emit("timing", size=f"{w}x{h}", relax=relax, summary=True,
                 compile_plus_first_s=round(compile_s[relax], 1), **s)
            result[(w, h, relax)] = s["ms_median"]
        emit("timing", size=f"{w}x{h}", speedup_cuda_over_xla=(
            result[(w, h, "xla")] / result[(w, h, "cuda")]))
    return result


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_dp():
    import numpy as np

    from tpuflow import FlowConfig, compute_flow
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.flow2d import plan_parallel
    from tpuflow.synthetic import seeded_batch

    F0, F1, _, _ = seeded_batch(DP_SHAPE[0], DP_SHAPE[2], DP_SHAPE[1],
                                seed=11)
    cfg = FlowConfig()
    mesh = make_mesh()
    route = plan_parallel(F0.shape[1:], True, cfg, mesh)
    t = time.perf_counter()
    res = compute_flow(F0, F1, cfg, mesh=mesh)
    first_s = time.perf_counter() - t
    res2 = compute_flow(F0, F1, cfg, mesh=mesh)
    worst = 0.0
    for i in range(F0.shape[0]):
        one = compute_flow(F0[i], F1[i], cfg)
        epe = mean_epe(res2.u[i], res2.v[i], one.u, one.v)
        worst = max(worst, epe)
        emit("dp", pair=i, epe_vs_one_card_px=epe, gate_px=1e-4)
    emit("dp", route=route, batch=list(F0.shape), compile_plus_first_s=round(
        first_s, 1), steady_s=round(res2.seconds, 4),
        mpix_s=F0.size / res2.seconds / 1e6)
    check(route == "dp" and worst <= 1e-4 and np.isfinite(res2.u).all(),
          "dp", f"route={route} worst EPE {worst}")


def phase_sp():
    import jax
    import numpy as np

    from tpuflow import FlowConfig, compute_flow
    from tpuflow.parallel import make_mesh
    from tpuflow.solver.bucketed import compute_flow_bucketed_sharded
    from tpuflow.solver.flow2d import plan_parallel
    from tpuflow.synthetic import seeded_pair
    from tpuflow.utils.gpu import summarize_ms, time_calls

    f0, f1, ut, vt = seeded_pair(SP_SHAPE[1], SP_SHAPE[0], 21)
    cfg = FlowConfig()
    mesh = make_mesh((1, 4))
    t = time.perf_counter()
    u, v = jax.block_until_ready(
        compute_flow_bucketed_sharded(f0, f1, cfg, mesh=mesh, halo="explicit"))
    first_s = time.perf_counter() - t
    secs = time_calls(lambda: compute_flow_bucketed_sharded(
        f0, f1, cfg, mesh=mesh, halo="explicit"), n=3)
    one = compute_flow(f0, f1, cfg)
    one_secs = time_calls(lambda: compute_flow(f0, f1, cfg).u, n=3)
    epe = mean_epe(u, v, one.u, one.v)
    emit("sp", size=f"{SP_SHAPE[1]}x{SP_SHAPE[0]}", halo="explicit",
         epe_vs_one_card_px=epe,
         gate_px=1e-4, epe_true_px=mean_epe(u, v, ut, vt),
         route_front_door=plan_parallel(f0.shape, False, cfg, mesh),
         compile_plus_first_s=round(first_s, 1),
         sp4=summarize_ms(secs, f0.size), one_card=summarize_ms(one_secs,
                                                                  f0.size))
    check(epe <= 1e-4 and bool(np.isfinite(np.asarray(u)).all()), "sp",
          f"EPE vs one card {epe}")


def ring_hop_seconds(mesh, rows, hops=PPERMUTE_HOPS, n=5):
    """Seconds of one ppermute ring step of ``rows`` x 4 KiB per card
    inside a program: the median time of a jitted loop of hops[1] steps
    minus that of hops[0], over the steps between them, so the launch and
    sync of the program itself cancel out."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuflow.utils.gpu import time_calls

    n_dev = mesh.shape["y"]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    x = jax.device_put(jnp.ones((n_dev * rows, 1024), jnp.float32),
                       NamedSharding(mesh, P("y", None)))
    med = []
    for n_hops in hops:
        def ring(a, n_hops=n_hops):
            return jax.lax.fori_loop(
                0, n_hops, lambda _, b: jax.lax.ppermute(b, "y", perm), a)

        fn = jax.jit(shard_map(ring, mesh=mesh, in_specs=P("y", None),
                               out_specs=P("y", None)))
        jax.block_until_ready(fn(x))
        med.append(float(np.median(time_calls(fn, x, n=n))))
    return (med[1] - med[0]) / (hops[1] - hops[0])


def phase_router_constants():
    """The inputs of parallel/model.py: the cost of one ppermute ring step
    over the 4 cards inside a program, and the one-card level relaxation
    times of both engines."""
    import jax
    import numpy as np

    from tpuflow.config import DataConstancy
    from tpuflow.parallel import make_mesh
    from tpuflow.parallel.model import fit_level_time, fit_link
    from tpuflow.solver import bucketed as B
    from tpuflow.utils.gpu import time_calls

    mesh = make_mesh((1, 4))
    sizes, secs = [], []
    for rows in PPERMUTE_ROWS:
        s = ring_hop_seconds(mesh, rows)
        sizes.append(rows * 4096)
        secs.append(s)
        emit("router", ppermute_bytes_per_device=rows * 4096,
             hops=list(PPERMUTE_HOPS), seconds_per_hop=s)
    link = fit_link(sizes, secs)
    buckets, t1 = [], {"xla": [], "cuda": []}
    for hb, wb, ch, cw in ROUTER_BUCKETS:
        f0, f1, u, v, sc, cfg = level_inputs(hb, wb, ch, cw,
                                             DataConstancy.GREY, 3)
        buckets.append((hb, wb))
        for relax in ("xla", "cuda"):
            fn = jax.jit(lambda *a, sc=sc, cfg=cfg, relax=relax:
                         B._relax_dyn(*a, sc, cfg, relax=relax))
            jax.block_until_ready(fn(f0, f1, u, v))
            s = float(np.median(time_calls(fn, f0, f1, u, v, n=5)))
            t1[relax].append(s)
            emit("router", bucket=[hb, wb], relax=relax, level_relax_s=s)
    floor, per_px = fit_level_time(buckets, t1["xla"])
    k_floor, k_per_px = fit_level_time(buckets, t1["cuda"])
    emit("router", latency_s=link.latency_s,
         bandwidth_bytes_s=link.bandwidth_bytes_s, level_floor_s=floor,
         level_per_pixel_s=per_px, kernel_level_floor_s=k_floor,
         kernel_level_per_pixel_s=k_per_px)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the 1080p pair (the 584x388 pair is the "
                         "goldens' seed)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import tpuflow  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpuflow package is not next to this script "
              f"({e})", file=sys.stderr)
        return 2

    from tpuflow.utils.gpu import NoGPU, device_record

    try:
        devices = phase_device(args.cards)
        if args.cards == 4:
            phase_router_constants()
            phase_dp()
            phase_sp()
        else:
            from tpuflow.synthetic import GOLDEN_SEED, seeded_pair

            phase_gpu_tests()
            pair_584 = seeded_pair(584, 388, GOLDEN_SEED)
            pair_1080 = seeded_pair(1920, 1080, args.seed)
            emit("inputs", sizes=["584x388", "1920x1080"], dtype="uint8",
                 seeds=[GOLDEN_SEED, args.seed])
            phase_grey_584(pair_584)
            phase_constancy(pair_584)
            phase_1080p(pair_1080)
            phase_kernel()
            phase_timing([pair_584, pair_1080])
    except NoGPU as e:
        print(f"chip_smoke: {e}; refusing to run without a GPU",
              file=sys.stderr)
        return 3
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_record(devices[0])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
