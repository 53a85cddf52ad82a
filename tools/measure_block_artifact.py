#!/usr/bin/env python
"""Quantify the reference grad/log kernels' CUDA-block halo artifacts.

Runs the NumPy oracle on the seeded 584x388 pair (tpuflow.synthetic, full
default schedule) for GRADIENT and LOG constancy, with clean global
stencils vs the reference's 16x8-block halo behavior (tpuflow.oracle
block_emulation=True), and prints the flow deviation between the two. It
bounds how far ANY clean-math implementation (including this framework)
can sit from the reference binary's output for grad/log.

Usage: python tools/measure_block_artifact.py [seed]  (~1-2 min of NumPy)
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpuflow import oracle  # noqa: E402
from tpuflow.synthetic import seeded_pair  # noqa: E402


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    f0, f1, _, _ = seeded_pair(584, 388, seed)

    for constancy in ("gradient", "log"):
        t0 = time.time()
        u_c, v_c = oracle.compute_flow(f0, f1, data_constancy=constancy)
        u_b, v_b = oracle.compute_flow(
            f0, f1, data_constancy=constancy, block_emulation=True
        )
        epe = np.hypot(u_c - u_b, v_c - v_b)
        mag = float(np.hypot(u_c, v_c).mean())
        print(
            f"{constancy}: clean-vs-block EPE mean={epe.mean():.3e} px "
            f"max={epe.max():.3e} px  (mean |flow|={mag:.3f} px)  "
            f"[{time.time() - t0:.0f}s]"
        )


if __name__ == "__main__":
    main()
