"""Multi-host execution: process initialization and streaming sequences.

The reference is single-process/single-GPU; this is new design (SURVEY.md
§2.7): multi-host scaling uses `jax.distributed.initialize` + a global
('data', 'y') mesh spanning all hosts. Frame pairs are independent work
units, so the streaming driver shards the BATCH over hosts (each host reads
its own slice of the sequence — per-host input sharding over DCN-free local
I/O) while spatial row-sharding stays within each host's devices.

Failure model (SURVEY.md §5): frame pairs are independent, so recovery is
re-processing — the output manifest records completed pairs and `resume`
skips them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax

from tpuflow.config import FlowConfig


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-process JAX (no-op for single-process runs).

    Multi-process runs pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` explicitly, or set
    TPUFLOW_NUM_PROCESSES and let ``jax.distributed.initialize`` read the
    rest from its own environment variables.
    """
    if num_processes is None and coordinator_address is None:
        env_procs = os.environ.get("TPUFLOW_NUM_PROCESSES")
        if env_procs is None or int(env_procs) <= 1:
            return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclasses.dataclass
class SequenceManifest:
    """Completed-pair ledger for resumable streaming runs."""

    path: str

    def done(self) -> set:
        if not os.path.exists(self.path):
            return set()
        with open(self.path) as f:
            return {json.loads(line)["pair"] for line in f if line.strip()}

    def record(self, pair_id: str, seconds: float) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"pair": pair_id, "seconds": seconds}) + "\n")


def process_sequence(
    pairs: Sequence[Tuple[str, str]],
    width: int,
    height: int,
    output_dir: str,
    cfg: Optional[FlowConfig] = None,
    *,
    resume: bool = True,
    flow_max_scale: float = 10.0,
    chain: int = 1,
    mesh=None,
    data_axis: str = "data",
) -> List[str]:
    """Stream a sequence of frame-pair files through the solver.

    Each process handles pairs where ``index % process_count == process_index``
    (per-host input sharding); outputs use the reference naming scheme with
    the pair index as counter. Returns the pair ids this process completed.

    Host I/O overlaps device compute: the next pair's frames are read and
    submitted while previous results are still materializing (async
    dispatch), so a long sequence keeps the chip busy.

    chain > 1 switches to the CHUNK-FETCH streaming mode: ``chain`` pairs
    are submitted as independent async calls of the same single-pair
    program (submission already overlaps device compute), their flows are
    stacked ON DEVICE, and the stack leaves in ONE host fetch, which
    amortizes the per-fetch synchronization by ``chain``. Per-pair values
    are bit-identical to the unchained path (tested).

    mesh: DATA-PARALLEL streaming (multi-chip dp soak, round-4 verdict
    item #8): groups of B = mesh.shape[data_axis] pairs are solved as
    ONE compute_flow_bucketed_batch dispatch (shard_map — each chip runs
    the full single-pair engine on its own pair), fetched in one round
    trip, written and manifest-recorded per pair. A run killed
    mid-stream resumes exactly: the manifest holds only fully-written
    pairs, the resume filter drops them BEFORE re-grouping, so the
    remaining pairs complete exactly once (groups re-form over the
    remainder). Mutually exclusive with chain>1 (chain amortizes fetch
    round trips on ONE chip; mesh amortizes across chips).
    """
    import time

    from tpuflow.io import write_flow_image_rgb, write_magnitude_f32, write_raw_f32
    from tpuflow.io.loader import FrameLoader
    from tpuflow.solver.flow2d import compute_flow_async

    cfg = cfg or FlowConfig()
    os.makedirs(output_dir, exist_ok=True)
    manifest = SequenceManifest(os.path.join(output_dir, "manifest.jsonl"))
    done = manifest.done() if resume else set()

    pid = jax.process_index()
    pcount = jax.process_count()

    completed = []

    def drain(entry):
        pair_id, uv_dev, t_submit = entry
        # One device_get for both components.
        u, v = np.asarray(uv_dev)
        suffix = f"-{width}-{height}.raw"
        write_raw_f32(os.path.join(output_dir, f"{pair_id}flow-u{suffix}"), u)
        write_raw_f32(os.path.join(output_dir, f"{pair_id}flow-v{suffix}"), v)
        write_flow_image_rgb(u, v, flow_max_scale,
                             os.path.join(output_dir, f"{pair_id}res.pgm"))
        write_magnitude_f32(u, v, os.path.join(output_dir, f"{pair_id}amp{suffix}"))
        manifest.record(pair_id, time.perf_counter() - t_submit)
        completed.append(pair_id)

    # This process's work (index-sharded), minus already-completed pairs.
    my_pairs = [
        (f"{idx:05d}_", path0, path1)
        for idx, (path0, path1) in enumerate(pairs)
        if idx % pcount == pid and f"{idx:05d}_" not in done
    ]
    # Native prefetching loader (tpuflow/_native/loader.cpp): worker
    # threads read + widen the next frames off the GIL while the device
    # computes and the host writes outputs; numpy fallback when unbuilt.
    files = [p for _, p0, p1 in my_pairs for p in (p0, p1)]
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor

    def drain_chunk(entry):
        ids, uv_dev, t_submit = entry
        uvs = np.asarray(uv_dev)  # ONE fetch for the whole chunk
        # Chunk-amortized per-pair time: the chunk shares one submit
        # timestamp and one download, so the honest per-pair figure is
        # the chunk's elapsed time divided by its size (comparable to
        # the unchained path's per-pair records).
        per_pair = (time.perf_counter() - t_submit) / len(ids)
        for i, pair_id in enumerate(ids):
            u, v = uvs[0, i], uvs[1, i]
            suffix = f"-{width}-{height}.raw"
            write_raw_f32(os.path.join(output_dir, f"{pair_id}flow-u{suffix}"), u)
            write_raw_f32(os.path.join(output_dir, f"{pair_id}flow-v{suffix}"), v)
            write_flow_image_rgb(u, v, flow_max_scale,
                                 os.path.join(output_dir, f"{pair_id}res.pgm"))
            write_magnitude_f32(u, v,
                                os.path.join(output_dir, f"{pair_id}amp{suffix}"))
            manifest.record(pair_id, per_pair)
            completed.append(pair_id)

    if mesh is not None and chain > 1:
        raise ValueError(
            "process_sequence: mesh= and chain> 1 are mutually exclusive "
            "(mesh amortizes across chips, chain across fetch round trips)")
    if mesh is not None and pcount > 1:
        # Each process's my_pairs is a DIFFERENT index-sharded stack;
        # device_put-ing it as the global batch over a multi-host mesh
        # would compute the wrong pairs and produce non-addressable
        # results. Multi-process runs shard by INDEX (the default path);
        # the mesh mode is the single-process multi-chip soak.
        raise ValueError(
            "process_sequence: mesh= requires a single-process runtime "
            "(multi-host runs already shard pairs by process index)")
    if mesh is not None and my_pairs:
        from tpuflow.solver.bucketed import compute_flow_bucketed_batch

        B = mesh.shape[data_axis]
        with FrameLoader(files, width, height) as loader, \
                ThreadPoolExecutor(max_workers=1) as writer:
            futures = []
            for c0 in range(0, len(my_pairs), B):
                group = my_pairs[c0:c0 + B]
                t_submit = time.perf_counter()
                # The loader yields f0_0, f1_0, f0_1, f1_1, ... in order.
                frames = [loader.next() for _ in range(2 * len(group))]
                f0s = np.stack(frames[0::2])
                f1s = np.stack(frames[1::2])
                U, V = compute_flow_bucketed_batch(
                    f0s, f1s, cfg, mesh=mesh, data_axis=data_axis)
                ids = [pid_ for pid_, _, _ in group]
                futures.append(writer.submit(
                    drain_chunk, (ids, jnp.stack([U, V]), t_submit)))
                if len(futures) >= 2:
                    futures.pop(0).result()
            for f in futures:
                f.result()
        return completed

    if chain > 1 and my_pairs:
        with FrameLoader(files, width, height) as loader, \
                ThreadPoolExecutor(max_workers=1) as writer:
            futures = []
            for c0 in range(0, len(my_pairs), chain):
                chunk = my_pairs[c0:c0 + chain]
                t_submit = time.perf_counter()
                uvs = []
                for _pid, _p0, _p1 in chunk:
                    f0 = loader.next()
                    f1 = loader.next()
                    u_dev, v_dev = compute_flow_async(f0, f1, cfg)
                    uvs.append((u_dev, v_dev))
                stacked = jnp.stack([
                    jnp.stack([u for u, _ in uvs]),
                    jnp.stack([v for _, v in uvs]),
                ])
                ids = [pid for pid, _, _ in chunk]
                futures.append(
                    writer.submit(drain_chunk, (ids, stacked, t_submit))
                )
                if len(futures) >= 3:
                    futures.pop(0).result()
            for f in futures:
                f.result()
        return completed

    # Downloads + disk writes run on ONE background worker (ordering
    # preserved) so the blocking host materialization of pair k overlaps
    # the submission of pairs k+1..; the bounded queue keeps at most a few
    # flows resident on device.
    with FrameLoader(files, width, height) as loader, \
            ThreadPoolExecutor(max_workers=1) as writer:
        futures = []
        for pair_id, _p0, _p1 in my_pairs:
            f0 = loader.next()
            f1 = loader.next()
            t_submit = time.perf_counter()
            u_dev, v_dev = compute_flow_async(f0, f1, cfg)
            futures.append(
                writer.submit(drain, (pair_id, jnp.stack([u_dev, v_dev]), t_submit))
            )
            if len(futures) >= 6:
                futures.pop(0).result()
        for f in futures:
            f.result()
    return completed
