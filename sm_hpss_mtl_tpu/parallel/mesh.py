"""Device mesh helpers.

The reference is single-GPU (SURVEY.md §2.5); multi-device support here is
a new first-class component: a ``Mesh`` with a ``data`` axis for batch
(data-parallel) sharding and a ``time`` axis for sharding long
spectrogram time axes (the sequence-parallel analog used by
``parallel.halo``).  XLA inserts the collectives from sharding
annotations (GSPMD), which NCCL carries between GPUs — no hand-written
transport.  The mesh is a plain reshape of the device list: every GPU of
an NVLink host reaches every other at the same rate, so the layout
follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_time: int = 1,
              n_model: int = 1, devices=None) -> Mesh:
    """Mesh over ('data', 'time', 'model').  Defaults to all devices on
    'data'.

    The 'model' axis is a size-1 placeholder (SURVEY.md §2.5 TP row): the
    reference's models are a few M params so tensor parallelism is never
    needed, but keeping the axis in the mesh from day one means sharding
    specs and checkpoints won't break if a larger model family ever sets
    ``n_model > 1``.
    """
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // (n_time * n_model)
    dev = np.asarray(devices[:n_data * n_time * n_model]).reshape(
        n_data, n_time, n_model)
    return Mesh(dev, ("data", "time", "model"))


def model_sharding(mesh: Mesh, axis: int, ndim: int) -> NamedSharding:
    """Shard dimension ``axis`` of an ``ndim``-rank param over 'model'.

    With the default size-1 'model' axis this is a no-op placement, but it
    gives tensor-parallel-ready param specs a stable spelling.
    """
    spec = [None] * ndim
    spec[axis] = "model"
    return NamedSharding(mesh, P(*spec))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def time_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Shard the trailing (time) axis of a (..., F, T) array over 'time'."""
    spec = [None] * (ndim - 1) + ["time"]
    return NamedSharding(mesh, P(*spec))
