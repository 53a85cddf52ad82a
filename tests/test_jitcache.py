"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else the
fixed <repo>/.jit_cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from tpuflow.utils.jitcache import setup_jit_cache;"
          "p = setup_jit_cache(quiet=True);"
          "print(p); print(jax.config.jax_compilation_cache_dir)")


def _run(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",) + tuple(drop)}
    env.update(env_extra)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_cache_follows_the_environment(tmp_path):
    d = str(tmp_path / "cache")
    path, cfg = _run({"JAX_COMPILATION_CACHE_DIR": d})
    assert path == d and cfg == d
    assert os.path.isdir(d)


def test_cache_defaults_to_repo_dir():
    path, cfg = _run({})
    want = os.path.join(REPO, ".jit_cache")
    assert path == want and cfg == want


def test_cache_dir_function(monkeypatch, tmp_path):
    from tpuflow.utils import jitcache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jitcache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jitcache.cache_dir() == jitcache.DEFAULT_CACHE_DIR
    assert jitcache.cache_entry_count(str(tmp_path / "absent")) == 0
