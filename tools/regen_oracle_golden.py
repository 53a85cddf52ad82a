#!/usr/bin/env python
"""Regenerate the NumPy-oracle goldens of the seeded frame pair.

Writes data/oracle_seeded_default.npz (grey, the FULL default schedule,
~8 min of pure NumPy) and data/oracle_seeded_{grey,gradient,log}_small.npz
(tpuflow.synthetic.SMALL_SCHEDULE, seconds each). The pair is
tpuflow.synthetic.seeded_pair at the reference's default 584x388 shape and
seed 0; every golden records the frames' digest and its schedule, which
tpuflow.synthetic.load_golden checks.

The oracle (tpuflow/oracle.py) is the float32 transliteration of the
reference kernel math. Gradient and log use its clean math
(block_emulation=False), as the production path does.

Usage: python tools/regen_oracle_golden.py [default] [small]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpuflow import oracle  # noqa: E402
from tpuflow.config import FlowConfig  # noqa: E402
from tpuflow.synthetic import (  # noqa: E402
    GOLDEN_SEED, GOLDEN_SHAPE, SMALL_SCHEDULE, frames_digest, golden_path,
    seeded_pair,
)


def _write(name, u, v, schedule, digest):
    out = golden_path(name)
    np.savez_compressed(
        out, u=u.astype(np.float32), v=v.astype(np.float32),
        schedule=np.array(sorted((k, repr(x)) for k, x in schedule.items())),
        frames_sha256=np.array(digest))
    print(f"wrote {out}  |u|max={np.abs(u).max():.3f} "
          f"|v|max={np.abs(v).max():.3f}", flush=True)


def main():
    which = set(sys.argv[1:]) or {"default", "small"}
    h, w = GOLDEN_SHAPE
    f0, f1, _, _ = seeded_pair(w, h, GOLDEN_SEED)
    digest = frames_digest(f0, f1)

    if "small" in which:
        for constancy in ("grey", "gradient", "log"):
            t0 = time.time()
            u, v = oracle.compute_flow(f0, f1, data_constancy=constancy,
                                       **SMALL_SCHEDULE)
            _write(f"{constancy}_small", u, v, SMALL_SCHEDULE, digest)
            print(f"  {constancy}: {time.time() - t0:.1f}s")

    if "default" in which:
        t0 = time.time()
        u, v = oracle.compute_flow(f0, f1)  # defaults == reference defaults
        cfg = FlowConfig()
        sched = {k: getattr(cfg, k) for k in SMALL_SCHEDULE}
        _write("default", u, v, sched, digest)
        print(f"  default: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
