#!/usr/bin/env python
"""Example: dense optical flow on a frame pair, with reference-format
outputs.

Usage:
    python examples/rub_pair.py [out_dir] [frame_0.raw frame_1.raw W H]

Without frame files it solves the seeded 584x388 pair of
tpuflow.synthetic (the reference's default frame shape, uint8, known
flow) and reports the EPE against the true flow. With raw u8 files it
solves those. Writes flow-u/flow-v RAW, the colour-coded flow image, the
magnitude RAW and a VTK file for ParaView.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpuflow import FlowConfig, compute_flow  # noqa: E402
from tpuflow.io import (  # noqa: E402
    read_raw_u8,
    write_flow_image_rgb,
    write_magnitude_f32,
    write_raw_f32,
)
from tpuflow.io.vtk import write_flow_vtk  # noqa: E402
from tpuflow.solver.flow2d import endpoint_error  # noqa: E402
from tpuflow.synthetic import seeded_pair  # noqa: E402


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "./out"
    os.makedirs(out_dir, exist_ok=True)
    truth = None
    if len(sys.argv) > 5:
        w, h = int(sys.argv[4]), int(sys.argv[5])
        f0 = read_raw_u8(sys.argv[2], w, h)
        f1 = read_raw_u8(sys.argv[3], w, h)
    else:
        f0, f1, ut, vt = seeded_pair(584, 388, 0)
        h, w = f0.shape
        truth = (ut, vt)

    result = compute_flow(f0, f1, FlowConfig())
    print(f"solved in {result.seconds:.3f}s "
          f"({result.megapixels_per_second:.2f} Mpix/s steady-state)")
    print(f"flow range u [{result.u.min():.2f}, {result.u.max():.2f}] "
          f"v [{result.v.min():.2f}, {result.v.max():.2f}] "
          f"mean |f| {np.hypot(result.u, result.v).mean():.3f}")
    if truth is not None:
        print(f"EPE vs the true flow: "
              f"{endpoint_error(result.u, result.v, *truth):.4f} px")

    write_raw_f32(os.path.join(out_dir, f"flow-u-{w}-{h}.raw"), result.u)
    write_raw_f32(os.path.join(out_dir, f"flow-v-{w}-{h}.raw"), result.v)
    write_flow_image_rgb(result.u, result.v, 10,
                         os.path.join(out_dir, "res.ppm"))
    write_magnitude_f32(result.u, result.v,
                        os.path.join(out_dir, f"amp-{w}-{h}.raw"))
    write_flow_vtk(result.u, result.v, os.path.join(out_dir, "flow.vtk"))
    print(f"outputs in {out_dir}")


if __name__ == "__main__":
    main()
