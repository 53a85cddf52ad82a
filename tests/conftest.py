"""Test harness config.

By default everything runs on the CPU with 8 virtual devices: XLA's host
platform is forced to expose 8 devices, so mesh/halo logic runs exactly as
it would across cards (collectives included).

Tests marked ``gpu`` need a CUDA device and skip elsewhere; the decision is
made inside the ``gpu_backend`` fixture, never at import time. To run them
on a GPU machine, set TPUFLOW_TEST_PLATFORM=gpu (``chip_smoke.py`` does):
the harness then leaves JAX on its default backend and runs only the
``gpu`` tests it is given.
"""

import os

import pytest

_ON_GPU = os.environ.get("TPUFLOW_TEST_PLATFORM") == "gpu"

if not _ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-compile tests"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips elsewhere)"
    )


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run on the card via chip_smoke.py)")
    return jax.devices()[0]


@pytest.fixture(autouse=True)
def _tpuflow_env_hygiene():
    """No test (or library code a test drives) may leak TPUFLOW_* state:
    fails the OFFENDING test on any TPUFLOW_* env delta."""
    before = {k: v for k, v in os.environ.items() if k.startswith("TPUFLOW_")}
    yield
    after = {k: v for k, v in os.environ.items() if k.startswith("TPUFLOW_")}
    assert after == before, (
        "TPUFLOW_* env leaked across this test: "
        f"{ {k: (before.get(k), after.get(k)) for k in set(before) | set(after) if before.get(k) != after.get(k)} }"
    )


def pytest_sessionstart(session):
    if _ON_GPU:
        return
    assert all(d.platform == "cpu" for d in jax.devices()), (
        "tests must run on the virtual CPU mesh, got "
        f"{[d.platform for d in jax.devices()]}"
    )
    assert jax.device_count() == 8, (
        f"expected 8 virtual CPU devices, got {jax.device_count()}"
    )
