"""Device timing by chained, differenced iterations.

1. Chain ``iters`` dependent applications of the op inside ONE jitted
   ``lax.fori_loop`` (data-dependent carry, so iterations cannot be
   elided or overlapped away), ending in a scalar reduction.
2. Force completion by fetching that scalar to the host.
3. Run two iteration counts and difference them, cancelling the fixed
   per-call dispatch and transfer overhead:
   ``t_iter = (t(n2) - t(n1)) / (n2 - n1)``.

Take the min over repeats to strip scheduler noise (``stat='min'``, the
default), or measure the two chain lengths as temporally-adjacent PAIRS
and take the median of per-pair differences (``stat='median'``): a pair
that straddles a clock or power-state change produces one outlier
difference, which the median rejects, whereas min-of-independent-runs
can select exactly that artifact.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable

import jax
import jax.numpy as jnp


def _timed_call(loop_fn, carry, iters: int, repeats: int) -> float:
    float(loop_fn(carry, iters))  # warm the compile cache
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(loop_fn(carry, iters))
        best = min(best, time.perf_counter() - t0)
    return best


def _timed_once(loop_fn, carry, iters: int) -> float:
    t0 = time.perf_counter()
    float(loop_fn(carry, iters))
    return time.perf_counter() - t0


def time_op(step: Callable, carry, *, iters: tuple[int, int] = (4, 20),
            repeats: int = 5, stat: str = "min") -> float:
    """Seconds per application of ``step``.

    ``step(carry) -> carry`` must keep a fixed carry structure and be
    data-dependent on its input (e.g. for HPSS use ``H + P``, which is
    ~idempotent but dependent).  Returns the differenced per-iteration
    time in seconds.  ``stat='min'`` differences the min-over-repeats of
    each chain length (best-observed); ``stat='median'`` differences
    adjacent (n1, n2) pairs and returns the median per-pair difference
    (drift-robust — see module docstring).
    """

    @functools.partial(jax.jit, static_argnames="n")
    def loop_fn(c, n):
        out = jax.lax.fori_loop(0, n, lambda i, s: step(s), c)
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)

    n1, n2 = iters
    if stat == "median":
        float(loop_fn(carry, n1))  # warm both compiles
        float(loop_fn(carry, n2))
        diffs = []
        for _ in range(repeats):
            t1 = _timed_once(loop_fn, carry, n1)
            t2 = _timed_once(loop_fn, carry, n2)
            diffs.append((t2 - t1) / (n2 - n1))
        return max(statistics.median(diffs), 1e-9)
    t1 = _timed_call(loop_fn, carry, n1, repeats)
    t2 = _timed_call(loop_fn, carry, n2, repeats)
    return max((t2 - t1) / (n2 - n1), 1e-9)
