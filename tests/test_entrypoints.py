"""The measurement entry points on a machine without a GPU, and the pieces
of them that run anywhere: chip_smoke.py and bench.py refuse the CPU, the
trace reduction, the timing summary."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_the_cpu(script):
    res = _run([os.path.join(REPO, script)])
    assert res.returncode == 3, res.stderr
    assert "refusing" in res.stderr
    assert '"ok": true' not in res.stdout and "{" not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert res.returncode != 0
    assert res.stdout == ""


def test_require_gpu_raises_on_cpu():
    from tpuflow.utils.gpu import NoGPU, require_gpu

    with pytest.raises(NoGPU):
        require_gpu()


def test_chip_smoke_cards_option():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit):
        chip_smoke.main(["--cards", "2"])
    assert chip_smoke.main([]) == 3          # no GPU: refused, no result
    assert chip_smoke.main(["--cards", "4"]) == 3


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_chip_smoke_ulp_jitter(seed):
    """The kernel gate's float-noise ensemble: every pixel moves by -1, 0
    or +1 ulp, the same way for the same seed."""
    sys.path.insert(0, REPO)
    import chip_smoke

    a = np.random.default_rng(3).standard_normal((16, 32)).astype(np.float32)
    j = np.asarray(chip_smoke.ulp_jitter(a, seed))
    ulps = j.view(np.int32).astype(np.int64) - a.view(np.int32)
    assert set(np.unique(ulps)) == {-1, 0, 1}
    np.testing.assert_array_equal(j, np.asarray(chip_smoke.ulp_jitter(a, seed)))
    assert not np.array_equal(j, np.asarray(chip_smoke.ulp_jitter(a, seed + 1)))


def test_chip_smoke_ring_hop_runs_on_a_mesh():
    """The router phase's link probe runs a loop of ppermute ring steps
    inside one program over the 'y' axis and returns seconds per step."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from tpuflow.parallel import make_mesh

    s = chip_smoke.ring_hop_seconds(make_mesh((1, 8)), 2, hops=(1, 3), n=1)
    assert np.isfinite(s)


def test_device_record_and_summary():
    import jax

    from tpuflow.utils.gpu import device_record, summarize_ms

    rec = device_record(jax.devices()[0])
    assert set(rec) == {"platform", "kind", "count"}
    assert rec["count"] == len(jax.devices())
    s = summarize_ms([0.03, 0.01, 0.02], pixels=2_000_000)
    assert s["ms_median"] == pytest.approx(20.0)
    assert s["ms_min"] == pytest.approx(10.0)
    assert s["ms_max"] == pytest.approx(30.0)
    assert s["mpix_s"] == pytest.approx(100.0)


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10), (20, 30)], 20),            # disjoint
    ([(0, 10), (5, 15)], 15),             # overlapping
    ([(0, 30), (5, 10), (12, 20)], 30),   # nested
    ([(5, 6)], 1),
])
def test_trace_busy_is_the_union_of_kernel_intervals(spans, busy):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from trace_pair import _union_ns

    assert _union_ns(spans) == busy


def test_trace_reduction_ignores_host_planes(tmp_path):
    import glob

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from trace_pair import reduce_trace

    jax.profiler.start_trace(str(tmp_path))
    x = jnp.ones((64, 64))
    jax.block_until_ready(x @ x)
    jax.profiler.stop_trace()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    assert reduce_trace(path) == {"planes": []}   # CPU: no GPU planes
