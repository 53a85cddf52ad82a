#!/usr/bin/env python
"""Example: the multi-device modes of tpuflow on one mesh.

Usage:
    python examples/multichip.py [n_devices]

Runs on whatever devices exist — four H100s, or on a CPU-only machine
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu
for a virtual mesh (how the test suite validates the distributed paths).

Shows, on a ('data', 'y') mesh:

  dp — THROUGHPUT scaling: a batch of B independent frame pairs, one per
       'data' shard, each solved by the FULL single-pair engine inside
       shard_map (zero cross-shard collectives).
  sp — LATENCY scaling for one large pair: image rows sharded over 'y'
       with explicit ring-halo exchange (one widened ppermute per outer
       iteration).

and the sharding router's projection (tpuflow.parallel.model) for the
mesh's 'y' size.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from tpuflow import FlowConfig, compute_flow  # noqa: E402
from tpuflow.parallel import make_mesh  # noqa: E402
from tpuflow.parallel.model import (  # noqa: E402
    project_schedule_auto, schedule_levels,
)
from tpuflow.solver.bucketed import (  # noqa: E402
    compute_flow_bucketed_async,
    compute_flow_bucketed_batch,
    compute_flow_bucketed_sharded,
)
from tpuflow.solver.flow2d import endpoint_error  # noqa: E402
from tpuflow.synthetic import seeded_batch, seeded_pair  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    devices = jax.devices()[:n]
    print(f"{n} x {devices[0].platform} devices")
    mesh = make_mesh((1, n), devices=devices)
    print(f"mesh: {dict(mesh.shape)}")

    if devices[0].platform == "gpu":
        w, h, cfg = 1920, 1080, FlowConfig()
    else:
        # Virtual CPU mesh: small frames and schedule, same code paths.
        w, h = 144, 96
        cfg = FlowConfig(warp_levels_count=3, outer_iterations_count=4,
                         inner_iterations_count=2)
    f0, f1, _, _ = seeded_pair(w, h, 0)

    u1, v1 = map(np.asarray, compute_flow_bucketed_async(f0, f1, cfg))
    print(f"single-device solve: mean |f| {np.hypot(u1, v1).mean():.3f}")

    # dp: one pair per device.
    F0, F1, _, _ = seeded_batch(n, w, h, seed=0)
    dmesh = make_mesh((n, 1), devices=devices)
    U, V = map(np.asarray, compute_flow_bucketed_batch(F0, F1, cfg,
                                                       mesh=dmesh))
    print(f"dp batch of {n}: pair-0 EPE vs single-device "
          f"{endpoint_error(U[0], V[0], u1, v1):.2e} px")

    # sp: rows of ONE pair over 'y', explicit ppermute halo.
    us, vs = map(np.asarray, compute_flow_bucketed_sharded(
        f0, f1, cfg, mesh=mesh, halo="explicit"))
    print(f"sp halo='explicit': EPE vs single-device "
          f"{endpoint_error(us, vs, u1, v1):.2e} px")

    # The FRONT DOOR: a (B, H, W) stack goes dp, a large single pair goes
    # cost-routed sp, a small one runs on one device
    # (tpuflow.solver.flow2d.plan_parallel).
    res = compute_flow(F0, F1, cfg, mesh=mesh)
    print(f"front door (batch -> dp): pair-0 EPE vs single-device "
          f"{endpoint_error(res.u[0], res.v[0], u1, v1):.2e} px")

    proj = project_schedule_auto(schedule_levels(w, h), FlowConfig(),
                                 mesh.shape["y"])
    print(f"router projection at {w}x{h}, n_y={mesh.shape['y']}: "
          f"efficiency {proj['efficiency']:.0%}, levels {proj['levels']}")


if __name__ == "__main__":
    main()
