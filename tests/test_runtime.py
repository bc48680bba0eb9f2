"""Run-time plumbing: the compile-cache location, the device helpers, and
``chip_smoke.py`` refusing to run where there is no GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from sm_hpss_mtl_tpu.utils import compile_cache
from sm_hpss_mtl_tpu.utils.device import device_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after a test that moves it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_honours_environment(monkeypatch, tmp_path,
                                           cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code.
    assert jax.config.jax_compilation_cache_dir is None


def test_device_report_names_the_device():
    rep = device_report()
    assert rep == {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU: non-zero exit and no result line, both from the checkout
    and from a directory that holds ``chip_smoke.py`` alone."""
    if where == "checkout":
        proc = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    _assert_refused(proc)
    assert "no GPU" in proc.stderr
