"""Harmonic–percussive source separation (HPSS) in pure jnp.

The XLA-compiled path for
``librosa.decompose.hpss(S, kernel_size=(l_harm, l_perc))`` as invoked at
``/root/reference/lib/preprocessing.py:408,418,430,440``: a width-``l_harm``
running median across time yields the harmonic envelope, a width-``l_perc``
running median across frequency yields the percussive envelope, and the two
are converted to Wiener soft masks (power=2).  ``ops.reference`` (numpy /
scipy) is the plain reference it is tested against.

Design notes:

- The sliding median is a *selection network* over the ``width``
  shifted slices of the symmetric-padded plane: a Batcher odd-even
  mergesort network pruned back from the single median wire.  Every
  comparator is an elementwise ``minimum``/``maximum``, so XLA fuses the
  whole median, and the masks that follow, into one elementwise loop
  over the plane, with no data-dependent control flow and no stacked
  window copy in memory.  Boundary handling is 'symmetric' padding
  (scipy.ndimage's ``mode='reflect'``).
- Everything is elementwise work on (F, T) planes → vmappable over a
  batch of spectrograms and shardable along T (see
  ``sm_hpss_mtl_tpu.parallel.halo`` and ``parallel.frontend_shard``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_F32_TINY = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=None)
def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even mergesort comparator network for ``n`` wires."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


@functools.lru_cache(maxsize=None)
def median_network(n: int) -> tuple[tuple[int, int], ...]:
    """Comparators needed to place the median on wire ``n//2``:
    the full sort network pruned backward from that single output."""
    target = n // 2
    needed = {target}
    kept = []
    for i, j in reversed(batcher_pairs(n)):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.add(i)
            needed.add(j)
    return tuple(reversed(kept))


def _apply_median_network(values: list, n: int):
    """Run the pruned network over a list of arrays; returns the median
    wire.  Each comparator is one elementwise min and one max."""
    v = list(values)
    for i, j in median_network(n):
        lo = jnp.minimum(v[i], v[j])
        hi = jnp.maximum(v[i], v[j])
        v[i], v[j] = lo, hi
    return v[n // 2]


def _median_of_extended(S_ext: jax.Array, width: int, axis: int) -> jax.Array:
    """Running median of ``S_ext``, which is already extended by
    ``width//2`` on each side of ``axis``; the output is that much
    shorter on ``axis``."""
    n = S_ext.shape[axis] - 2 * (width // 2)
    return _apply_median_network(
        [jax.lax.slice_in_dim(S_ext, k, k + n, axis=axis)
         for k in range(width)], width)


def _sliding_median(S: jax.Array, width: int, axis: int) -> jax.Array:
    """Running median of odd ``width`` along ``axis`` with symmetric
    (edge-inclusive reflect) boundary, matching scipy.ndimage
    ``median_filter(..., mode='reflect')``."""
    half = width // 2
    pad = [(0, 0)] * S.ndim
    pad[axis] = (half, half)
    return _median_of_extended(jnp.pad(S, pad, mode="symmetric"), width, axis)


def softmask(X: jax.Array, X_ref: jax.Array, power: float = 2.0) -> jax.Array:
    """Wiener soft mask matching ``librosa.util.softmask`` with
    ``split_zeros=False`` (both-zero positions get mask 0)."""
    X = X.astype(jnp.float32)
    X_ref = X_ref.astype(jnp.float32)
    Z = jnp.maximum(X, X_ref)
    bad = Z < _F32_TINY
    Zs = jnp.where(bad, 1.0, Z)
    m = (X / Zs) ** power
    r = (X_ref / Zs) ** power
    denom = jnp.where(bad, 1.0, m + r)
    return jnp.where(bad, 0.0, m / denom)


@functools.partial(jax.jit, static_argnames=("l_harm", "l_perc", "power"))
def hpss_masks(S: jax.Array, *, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[jax.Array, jax.Array]:
    """Harmonic and percussive soft masks for spectrogram(s) ``(..., F, T)``."""
    harm = _sliding_median(S, l_harm, axis=S.ndim - 1)
    perc = _sliding_median(S, l_perc, axis=S.ndim - 2)
    return softmask(harm, perc, power), softmask(perc, harm, power)


def hpss_from_time_extended(S_ext: jax.Array, *, l_harm: int, l_perc: int,
                            power: float = 2.0
                            ) -> tuple[jax.Array, jax.Array]:
    """HPSS of ``(..., F, T + 2*(l_harm//2))`` magnitudes whose time axis
    already carries ``l_harm//2`` context frames on each side (real
    neighbour frames or the symmetric mirror); returns ``(H, P)`` over
    the ``T`` centre frames.  Frequency is symmetric-padded as usual."""
    ht = l_harm // 2
    t_axis = S_ext.ndim - 1
    harm = _median_of_extended(S_ext, l_harm, t_axis)
    S = jax.lax.slice_in_dim(S_ext, ht, S_ext.shape[-1] - ht, axis=t_axis)
    perc = _sliding_median(S, l_perc, axis=S.ndim - 2)
    S = S.astype(jnp.float32)
    return S * softmask(harm, perc, power), S * softmask(perc, harm, power)


@functools.partial(jax.jit, static_argnames=("l_harm", "l_perc", "power"))
def hpss(S: jax.Array, *, l_harm: int = 21, l_perc: int = 11,
         power: float = 2.0) -> tuple[jax.Array, jax.Array]:
    """Split ``(..., F, T)`` magnitude spectrogram(s) into harmonic and
    percussive components ``(H, P) = (S*mask_h, S*mask_p)``."""
    mh, mp = hpss_masks(S, l_harm=l_harm, l_perc=l_perc, power=power)
    S = S.astype(jnp.float32)
    return S * mh, S * mp
