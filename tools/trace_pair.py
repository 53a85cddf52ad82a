#!/usr/bin/env python
"""Device-time breakdown of one frame pair from a JAX profiler trace.

    python tools/trace_pair.py [--size WxH] [--relax auto|xla|cuda]
                               [--pairs N] [--out DIR]

Warms the default pipeline up (compilation outside the window), traces
``--pairs`` steady-state pairs, and reduces the trace (``reduce_trace``):
per GPU plane, the union of kernel intervals (busy), the window, the idle
share (1 - busy / window), and device time per kernel name, top first.
Prints one JSON line and writes the full table to ``--out``
(default chiprun_out/) as trace_<W>x<H>_<relax>.json. Needs a GPU.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, top: int = 25) -> dict:
    """Busy/idle and per-kernel device time of the GPU planes of one
    .xplane.pb trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out = {"planes": []}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans, by_name = [], {}
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
        if not spans:
            continue
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _union_ns(spans)
        kernels = sorted(by_name.items(), key=lambda kv: -kv[1])
        out["planes"].append({
            "plane": plane.name,
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "n_events": len(spans),
            "top": [{"name": n[:120], "ms": t / 1e6} for n, t in kernels[:top]],
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="584x388")
    ap.add_argument("--relax", default="auto", choices=("auto", "xla", "cuda"))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.lower().split("x"))

    from tpuflow.utils.gpu import NoGPU, card_line, require_gpu
    from tpuflow.utils.jitcache import setup_jit_cache

    setup_jit_cache(quiet=True)
    try:
        require_gpu()
    except NoGPU as e:
        print(f"trace_pair: {e}", file=sys.stderr)
        return 3
    import jax
    import jax.numpy as jnp

    from tpuflow import FlowConfig
    from tpuflow.solver.bucketed import compiled_full_pipeline
    from tpuflow.synthetic import seeded_pair

    f0, f1, _, _ = seeded_pair(w, h, 0)
    g0, g1 = jnp.asarray(f0, jnp.float32), jnp.asarray(f1, jnp.float32)
    fn = compiled_full_pipeline((h, w), FlowConfig(), relax=args.relax)
    jax.block_until_ready(fn(g0, g1))
    tmp = tempfile.mkdtemp()
    jax.profiler.start_trace(tmp)
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        jax.block_until_ready(fn(g0, g1))
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"), recursive=True)[0]
    red = reduce_trace(path)
    red.update(size=f"{w}x{h}", relax=args.relax, pairs=args.pairs,
               wall_ms_per_pair=wall / args.pairs * 1e3, card=card_line())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"trace_{w}x{h}_{args.relax}.json"),
              "w") as f:
        json.dump(red, f, indent=1)
    brief = {k: v for k, v in red.items() if k != "planes"}
    brief["planes"] = [{k: p[k] for k in ("plane", "window_ms", "busy_ms",
                                          "idle_share", "n_events")}
                       | {"top5": p["top"][:5]} for p in red["planes"]]
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
