"""The CUDA relaxation kernel on the card (skips without a GPU).

Run on a GPU machine with ``python chip_smoke.py`` (its "gpu tests" phase)
or ``TPUFLOW_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

import jax

from tpuflow.config import DataConstancy, FlowConfig
from tpuflow.solver import bucketed as B

from test_relax_engines import CONSTANCIES, level_inputs


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [(64, 128, 50, 113), (128, 256, 100, 230)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("constancy", CONSTANCIES, ids=lambda c: c.value)
def test_cuda_relax_matches_xla(gpu_backend, constancy, bucket):
    hb, wb, ch, cw = bucket
    cfg = FlowConfig(outer_iterations_count=4, inner_iterations_count=5,
                     data_constancy=constancy)
    f0, f1, u, v, sc = level_inputs(hb, wb, ch, cw)
    want = jax.jit(lambda *a: B._relax_dyn(*a, sc, cfg, relax="xla"))(
        f0, f1, u, v)
    got = jax.jit(lambda *a: B._relax_dyn(*a, sc, cfg, relax="cuda"))(
        f0, f1, u, v)
    got = [np.asarray(g) for g in got]
    assert all(np.isfinite(g).all() for g in got)
    epe = np.hypot(got[0][:ch, :cw] - np.asarray(want[0])[:ch, :cw],
                   got[1][:ch, :cw] - np.asarray(want[1])[:ch, :cw])
    assert epe.mean() <= 1e-4, epe.mean()
    assert not got[0][ch:, :].any() and not got[1][:, cw:].any()


@pytest.mark.gpu
def test_cuda_relax_under_vmap(gpu_backend):
    hb, wb, ch, cw = 64, 128, 50, 113
    cfg = FlowConfig(outer_iterations_count=2, inner_iterations_count=2,
                     data_constancy=DataConstancy.GREY)
    ins = [level_inputs(hb, wb, ch, cw, seed=s) for s in (0, 1)]
    sc = ins[0][4]
    stack = [np.stack([np.asarray(i[k]) for i in ins]) for k in range(4)]
    got = jax.jit(jax.vmap(
        lambda *a: B._relax_dyn(*a, sc, cfg, relax="cuda")))(*stack)
    one = B._relax_dyn(*ins[1][:4], sc, cfg, relax="cuda")
    np.testing.assert_array_equal(np.asarray(got[0][1]), np.asarray(one[0]))
