"""tpuflow — dense variational 2D optical flow in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
CUDA reference engine (axruff/cuda-flow2d): coarse-to-fine warping with a
robust (sub-quadratic) variational model — brightness / gradient /
log-derivative constancy data terms, flow-driven isotropic smoothness,
point-wise lagged-nonlinearity (Jacobi) relaxation with intra-pixel
(du → dv) sequential coupling, and intermediate median filtering.

Architecture (a re-design, not a port):
  * every operation is a pure function on jax arrays; the whole per-level
    relaxation (outer x inner sweeps) runs as ONE traced program with
    `lax.scan` ping-pong carries — no host sync inside the hot loop
    (the reference syncs the stream after every sweep,
    reference: src/cuda_operations/2d/cuda_operation_solve_2d.cpp:291);
  * box resampling is expressed as two matmuls with analytic overlap-weight
    matrices, not a per-pixel gather loop;
  * on a GPU the relaxation of a level runs as one call of a CUDA kernel
    (tpuflow/ops/cuda/relax.cu) with the XLA engine as its reference;
  * scaling is spatial domain decomposition over a `jax.sharding.Mesh`
    (halo exchange via collectives) plus a batch axis over frame pairs.
"""

__version__ = "0.1.0"

from tpuflow.config import FlowConfig, DataConstancy  # noqa: F401
from tpuflow.solver.flow2d import compute_flow  # noqa: F401
