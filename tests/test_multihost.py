"""Real multi-process jax.distributed coverage (SURVEY §4 item 4).

Spawns 2 OS processes, each exposing 4 virtual CPU devices, joined via
``jax.distributed.initialize`` into one 8-device runtime, and checks:

  * a global ('data', 'y') mesh batch solve over process-spanning arrays
    matches the single-process unsharded solve on every addressable shard;
  * ``process_sequence`` partitions a frame sequence across processes by
    index and both processes' outputs land in one shared manifest.

This is the standard JAX multi-host test harness (multi-process CPU with
a localhost coordinator) — the same code paths a multi-host GPU run
takes, with the processes on one machine.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from tpuflow.config import FlowConfig
from tpuflow.parallel.mesh import make_mesh
from tpuflow.solver.bucketed import (
    compute_flow_bucketed_async,
    compute_flow_bucketed_batch,
)
from tpuflow.parallel.multihost import process_sequence
from tpuflow.io import write_raw_f32

cfg = FlowConfig(
    warp_levels_count=2, warp_scale_factor=0.5, outer_iterations_count=2,
    inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8,
)
b, h, w = 4, 48, 64
rng = np.random.default_rng(0)  # same data in both processes
f0 = rng.random((b, h, w), dtype=np.float32) * 255.0
f1 = rng.random((b, h, w), dtype=np.float32) * 255.0

mesh = make_mesh((2, 4))  # 'data' spans the two processes
sharding = NamedSharding(mesh, P("data", None, None))
f0_g = jax.make_array_from_callback((b, h, w), sharding, lambda idx: f0[idx])
f1_g = jax.make_array_from_callback((b, h, w), sharding, lambda idx: f1[idx])

U, V = compute_flow_bucketed_batch(f0_g, f1_g, cfg, mesh=mesh)

# Every process checks its addressable output shards against a local
# single-device reference solve of the same pairs.
for shard in U.addressable_shards:
    sl = shard.index[0]
    for i in range(b)[sl]:
        u1, v1 = compute_flow_bucketed_async(f0[i], f1[i], cfg)
        d = np.abs(shard.data[i - sl.start] - np.asarray(u1)).max()
        assert d < 1e-5, (pid, i, d)

# process_sequence under a 2-process runtime: index-sharded work.
outdir = sys.argv[3]
indir = os.path.join(outdir, "frames")
if pid == 0:
    os.makedirs(indir, exist_ok=True)
    for i in range(5):
        write_raw_f32(os.path.join(indir, f"f{i}.raw"), f0[i % b])
import jax.experimental.multihost_utils as mhu
mhu.sync_global_devices("frames-written")
pairs = [
    (os.path.join(indir, f"f{i}.raw"), os.path.join(indir, f"f{i+1}.raw"))
    for i in range(4)
]
done = process_sequence(pairs, w, h, outdir, cfg)
expect = [f"{i:05d}_" for i in range(4) if i % 2 == pid]
assert done == expect, (pid, done, expect)
print(f"MH OK pid={pid} pairs={done}")
"""


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid), str(tmp_path / "out")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-4000:]}"
        assert f"MH OK pid={pid}" in out, out[-2000:]

    # Both processes' pairs in one shared manifest (resumable ledger).
    manifest = tmp_path / "out" / "manifest.jsonl"
    assert manifest.exists()
    lines = manifest.read_text().strip().splitlines()
    assert len(lines) == 4
