"""Distributed execution: device meshes, sharded pipelines, halo exchange.

The reference is strictly single-GPU (one context on device 0,
reference: src/main.cpp:51-54, src/utils/cuda_utils.cpp:43); everything in
this package is new design per SURVEY.md §2.7:

  * data parallelism — a batch axis over independent frame pairs;
  * spatial parallelism — each pyramid level's rows sharded over the mesh,
    with the 1-px stencil halos exchanged via XLA collectives (GSPMD
    partitions the shift-and-pad stencils automatically; the explicit
    shard_map + ppermute halo path runs the relaxation);
  * replicate-below-threshold — coarse levels smaller than the mesh run
    replicated instead of sharded;
  * cost-based routing — halo="auto" picks the cheapest of
    {replicate, explicit@k} per level (parallel.model);
  * the dp x sp hybrid — coarse tails one-pair-per-device, fine levels
    row-sharded (parallel.hybrid), amortizing the Amdahl tail over a
    batch.
"""

from tpuflow.parallel.mesh import make_mesh  # noqa: F401
from tpuflow.parallel.batch import compute_flow_batched  # noqa: F401
from tpuflow.parallel.hybrid import compute_flow_bucketed_hybrid  # noqa: F401
