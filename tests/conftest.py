"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the environment before jax is imported anywhere, so this executes
at conftest import time.  This is the standard JAX fake-backend technique
for testing multi-device sharding logic without accelerators (SURVEY.md §4).

Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless
JAX's first device is a GPU; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: the suite is compile-bound on CPU, and
# cached executables make reruns ~10x faster.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU; the test is skipped where JAX finds none.  Decided
    here, at run time, never while a test module is imported."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def audio_1s(rng):
    """1 s of deterministic 16 kHz test audio: tones + noise bursts, so it
    has both harmonic and percussive structure."""
    fs = 16000
    t = np.arange(fs) / fs
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.3 * np.sin(2 * np.pi * 1213 * t)
         + 0.1 * rng.standard_normal(fs))
    # Percussive clicks every 100 ms.
    for k in range(0, fs, 1600):
        x[k:k + 40] += np.hanning(40) * 2.0
    return x.astype(np.float32)
