#!/usr/bin/env python
"""Benchmark: steady-state time of one frame pair on the GPU, with an EPE
gate in the same run.

    python bench.py [--size WxH] [--relax auto|xla|cuda] [--runs N]

Prints the card's name and power limit (nvidia-smi), then ONE JSON line:
    {"metric": "pair_ms_<W>x<H>_default", "value": <median ms>, ...,
     "mpix_s": ..., "ms_min": ..., "ms_max": ..., "compile_s": ...,
     "epe_px": ..., "epe_ok": ..., "device": {...}}

Workload: the seeded textured pair of tpuflow.synthetic (uint8, known
flow) at the given size (default: the reference's 584x388), solved with the
full default schedule. At 584x388 the flow is gated against the committed
NumPy-oracle golden (data/oracle_seeded_default.npz, <= 1e-3 px mean EPE);
other sizes report the EPE against the true flow only. A failed gate still
prints the line but exits 1.

Timing: one warm-up call (compilation, reported as compile_s), then
``--runs`` calls each ended by block_until_ready; value is the median.
Without a GPU the script exits 3 and prints no result: a measurement never
falls back to the CPU.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

EPE_GATE_PX = 1e-3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="584x388")
    ap.add_argument("--relax", default="auto", choices=("auto", "xla", "cuda"))
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.lower().split("x"))

    from tpuflow.utils.gpu import (
        NoGPU, card_line, device_record, require_gpu, summarize_ms,
        time_calls,
    )
    from tpuflow.utils.jitcache import setup_jit_cache

    setup_jit_cache(quiet=True)
    try:
        dev = require_gpu()[0]
    except NoGPU as e:
        print(f"bench: {e}; refusing to measure without a GPU",
              file=sys.stderr)
        return 3

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpuflow import FlowConfig
    from tpuflow.solver.bucketed import compiled_full_pipeline
    from tpuflow.solver.flow2d import endpoint_error
    from tpuflow.synthetic import GOLDEN_SEED, load_golden, seeded_pair

    card = card_line()
    print(card, flush=True)
    f0, f1, ut, vt = seeded_pair(w, h, GOLDEN_SEED)
    g0, g1 = jnp.asarray(f0, jnp.float32), jnp.asarray(f1, jnp.float32)
    fn = compiled_full_pipeline((h, w), FlowConfig(), relax=args.relax)
    t0 = time.perf_counter()
    u, v = jax.block_until_ready(fn(g0, g1))
    compile_s = time.perf_counter() - t0
    stats = summarize_ms(time_calls(fn, g0, g1, n=args.runs), w * h)

    u, v = np.asarray(u), np.asarray(v)
    rec = {
        "metric": f"pair_ms_{w}x{h}_default",
        "value": stats["ms_median"],
        "unit": "ms",
        "mpix_s": stats["mpix_s"],
        "ms_min": stats["ms_min"],
        "ms_max": stats["ms_max"],
        "runs": stats["n"],
        "compile_s": compile_s,
        "relax": args.relax,
        "epe_true_px": endpoint_error(u, v, ut, vt),
        "card": card,
        "device": device_record(dev),
    }
    ok = True
    if (h, w) == (388, 584):
        gu, gv = load_golden("default", f0, f1)
        rec["epe_px"] = endpoint_error(u, v, gu, gv)
        rec["epe_ok"] = ok = bool(rec["epe_px"] <= EPE_GATE_PX)
    print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
