"""Time-axis sharded HPSS with halo exchange.

The sequence-parallel component SURVEY.md §2.5 calls for: the harmonic
median filter needs ``l_harm//2`` frames of context on each side, so a
spectrogram sharded along time across chips exchanges that halo with its
ring neighbors (``lax.ppermute``) and computes its interior
locally; the global edges use the same symmetric reflection as the
unsharded op.  Output is bit-identical to ``ops.hpss.hpss`` on the
gathered array.

This is how multi-hour broadcast audio (the DAFx12 streaming use case,
``/root/reference/DAFx12_...py:634-676``) scales past one device's memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.hpss import hpss_from_time_extended


def hpss_time_sharded(S: jax.Array, mesh: Mesh, *, l_harm: int = 21,
                      l_perc: int = 11, power: float = 2.0,
                      axis: str = "time") -> tuple[jax.Array, jax.Array]:
    """HPSS over ``(B, F, T)`` with T sharded on ``mesh`` axis ``axis``.

    Each shard ppermutes its edge frames to its ring neighbors; the first
    and last shards substitute the symmetric reflection of their own edge
    (matching scipy's 'reflect' boundary).  T must divide evenly by the
    axis size and each local block must hold at least ``l_harm//2``
    frames.
    """
    ht = l_harm // 2
    n = mesh.shape[axis]
    if S.shape[-1] % n:
        raise ValueError(f"T={S.shape[-1]} not divisible by {axis}={n}")
    if S.shape[-1] // n < ht:
        raise ValueError("local time block smaller than the halo")

    spec = P(*([None] * (S.ndim - 1) + [axis]))

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec))
    def _fn(S_local):
        idx = jax.lax.axis_index(axis)
        # Send my last ht frames right; receive my left halo.
        right_perm = [(i, (i + 1) % n) for i in range(n)]
        left_halo = jax.lax.ppermute(S_local[..., -ht:], axis, right_perm)
        # Send my first ht frames left; receive my right halo.
        left_perm = [(i, (i - 1) % n) for i in range(n)]
        right_halo = jax.lax.ppermute(S_local[..., :ht], axis, left_perm)
        # Global edges: symmetric reflection of own boundary frames.
        reflect_l = jnp.flip(S_local[..., :ht], axis=-1)
        reflect_r = jnp.flip(S_local[..., -ht:], axis=-1)
        left_halo = jnp.where(idx == 0, reflect_l, left_halo)
        right_halo = jnp.where(idx == n - 1, reflect_r, right_halo)
        ext = jnp.concatenate([left_halo, S_local, right_halo], axis=-1)
        return hpss_from_time_extended(ext, l_harm=l_harm, l_perc=l_perc,
                                       power=power)

    return _fn(S)
