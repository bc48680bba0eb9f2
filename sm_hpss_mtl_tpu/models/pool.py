"""Max pooling without ``reduce_window``.

A ``lax.reduce_window`` max pool has a ``SelectAndScatter`` gradient.
These formulations keep the same math but lower the backward to
elementwise select + pad ops, so the gradient is plain elementwise work
XLA fuses:

- window == stride (the (2,2)/2 and (1,12)/(1,12) cases): reshape the
  axis into (out, w) groups and ``max`` over the group axis — the
  gradient is a compare/select per group.
- overlapping window (Papakostas' (3,3)/2): elementwise ``maximum`` of
  the w*w strided window slices — the gradient of each slice is a
  dilated pad, all regular XLA ops.

Semantics match a ``lax.reduce_window`` max pool (XLA SAME padding
arithmetic, -inf identity) and are pinned against it in
tests/test_models.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG_INF = float("-inf")


def _pad_amount(size: int, window: int, stride: int, padding: str):
    if padding == "VALID":
        out = (size - window) // stride + 1
        return out, 0, 0
    out = -(-size // stride)                     # SAME: ceil(size/stride)
    total = max(0, (out - 1) * stride + window - size)
    lo = total // 2
    return out, lo, total - lo


def max_pool(x: jax.Array, window: tuple[int, int],
             strides: tuple[int, int], padding: str = "VALID") -> jax.Array:
    """Max pool over the H, W axes of an NHWC tensor."""
    B, H, W, C = x.shape
    wh, ww = window
    sh, sw = strides
    oh, ph_lo, ph_hi = _pad_amount(H, wh, sh, padding)
    ow, pw_lo, pw_hi = _pad_amount(W, ww, sw, padding)

    if (wh, ww) == (sh, sw):
        # Non-overlapping: group-reshape max.
        if padding == "VALID":
            xs = x[:, :oh * sh, :ow * sw]
        else:
            xs = jnp.pad(x, ((0, 0), (ph_lo, ph_hi), (pw_lo, pw_hi),
                             (0, 0)), constant_values=_NEG_INF)
        xs = xs.reshape(B, oh, wh, ow, ww, C)
        return jnp.max(xs, axis=(2, 4))

    # Overlapping: max of the wh*ww strided window slices.
    xp = jnp.pad(x, ((0, 0), (ph_lo, ph_hi), (pw_lo, pw_hi), (0, 0)),
                 constant_values=_NEG_INF)
    out = None
    for di in range(wh):
        for dj in range(ww):
            sl = jax.lax.slice(
                xp, (0, di, dj, 0),
                (B, di + sh * (oh - 1) + 1, dj + sw * (ow - 1) + 1, C),
                (1, sh, sw, 1))
            out = sl if out is None else jnp.maximum(out, sl)
    return out
