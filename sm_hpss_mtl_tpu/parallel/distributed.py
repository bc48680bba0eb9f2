"""Multi-host (multi-process) wiring.

The reference is strictly single-process/single-GPU
(``/root/reference/Proposed_Work_Results.py:31-41`` pins one GPU and one
CPU thread); SURVEY.md §2.5/§5 makes multi-host support a first-class
component of the rebuild: ``jax.distributed.initialize()`` for the
coordination service, XLA collectives (NCCL between GPUs), and
per-process input sharding so each host feeds a disjoint slice of the
global batch.

Design: initialization is **env-gated** — the standard
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
triple configures it explicitly (nothing on a plain GPU host tells JAX
of a cluster), or ``SMHPSS_DISTRIBUTED=1`` defers to a cluster
environment JAX can auto-detect.  Single-process runs (the common dev
case) are a no-op, so every entry point can call
``initialize_from_env()`` unconditionally.
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize_from_env() -> bool:
    """Call ``jax.distributed.initialize()`` when the environment asks
    for it; return True iff running multi-process afterwards.

    Triggers (checked in order):
      * ``SMHPSS_DISTRIBUTED=1`` — pod/auto-detect mode: bare
        ``initialize()`` (a cluster environment JAX auto-detects
        supplies the coordinator and process id).
      * ``JAX_COORDINATOR_ADDRESS`` set — explicit mode: also reads
        ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.
      * neither — single-process; returns False without touching jax.

    Idempotent: a second call is a no-op (jax forbids re-initialization).
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if os.environ.get("SMHPSS_DISTRIBUTED") == "1" and not coord:
        jax.distributed.initialize()
        _initialized = True
    elif coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]))
        _initialized = True
    else:
        return False
    return jax.process_count() > 1


def per_process_seed(seed: int) -> int:
    """Decorrelate host-side RNG streams across processes.

    Each process's balanced batcher must draw different files/patches —
    otherwise every host feeds identical data and the global batch
    collapses to ``process_count`` copies.  Large stride so per-worker
    offsets (+100+w in ``cli.experiment``) never collide across processes.
    """
    return seed + 100_003 * jax.process_index()


def process_file_shard(files: dict[str, list], *,
                       process_index: int | None = None,
                       process_count: int | None = None) -> dict[str, list]:
    """Per-class round-robin shard of a ``{class: [files...]}`` dict for
    this process.

    Multi-host data loading: each host reads only its own slice of the
    corpus (strided, so class balance and genre spread survive the split).
    Classes with fewer files than processes fall back to the full list —
    a short class must still appear in every host's balanced stream.
    """
    idx = jax.process_index() if process_index is None else process_index
    cnt = jax.process_count() if process_count is None else process_count
    if cnt <= 1:
        return files
    out = {}
    for cls, lst in files.items():
        lst = list(lst)
        shard = lst[idx::cnt]
        out[cls] = shard if shard else lst
    return out
