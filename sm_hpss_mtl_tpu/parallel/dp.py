"""Data-parallel training via GSPMD sharding annotations.

The train step from ``train.state`` is compiled with the batch sharded
over the mesh 'data' axis and all state replicated; XLA inserts the
gradient all-reduces (psum) from the sharding annotations —
the pjit recipe, not a port of any host-side loop.  BatchNorm statistics
are computed over the *global* batch automatically (GSPMD reduces across
shards), sidestepping the per-replica-BN divergence SURVEY.md §7 flags.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..train.state import make_train_step


def shard_batch(tree, mesh: Mesh):
    """Place a host batch pytree with its leading axis over 'data'."""
    sh = NamedSharding(mesh, P("data"))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def make_dp_train_step(model, optimizer, mesh: Mesh, *, mtl: bool,
                       loss_weights: dict | None = None) -> Callable:
    """Jitted DP train step: state replicated, batch/labels data-sharded."""
    base = make_train_step(model, optimizer, mtl=mtl,
                           loss_weights=loss_weights)
    rep = NamedSharding(mesh, P())
    dat = NamedSharding(mesh, P("data"))

    def _spec_like(tree, sharding):
        return jax.tree_util.tree_map(lambda _: sharding, tree)

    # in_shardings need the call's pytree structure; resolve lazily.
    compiled = {}

    def dp_step(state, batch, labels, rng):
        key = jax.tree_util.tree_structure((batch, labels))
        if key not in compiled:
            in_sh = (_spec_like(state, rep), _spec_like(batch, dat),
                     _spec_like(labels, dat), rep)
            compiled[key] = jax.jit(base, in_shardings=in_sh)
        return compiled[key](state, batch, labels, rng)

    return dp_step
