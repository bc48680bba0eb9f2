"""Sliding-window patch extraction over featuregram time axes.

Semantics match the reference's Cython ``extract_patches``
(``/root/reference/lib/cython_impl/tools.pyx:21-38``) plus the wrap-around
rule for short clips in ``lib/preprocessing.py:get_feature_patches``
(:139-142): a clip shorter than one window is tiled (whole-copy appends of
the original) until strictly longer than ``patch_size``; windows are then
centered at ``i in range(half, T-half, shift)`` with ``half = patch_size//2``.

On device this is a single static gather — ``(D, T) -> (N, D, W)`` — which
XLA turns into strided HBM reads; there is no per-patch copy loop.  The
per-file standardization the reference applies before patching
(sklearn ``StandardScaler`` over the time axis,
``lib/preprocessing.py:146-148``) is :func:`standardize_rows`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def tiled_length(T: int, patch_size: int) -> int:
    """Length after the reference's short-clip tiling rule: repeat the
    original until strictly longer than ``patch_size``."""
    out = T
    while out <= patch_size:
        out += T
    return out


def num_patches(T: int, patch_size: int, patch_shift: int) -> int:
    """Patch count for a (possibly tiled) time axis of ``T`` frames."""
    T = tiled_length(T, patch_size)
    half = patch_size // 2
    return len(range(half, T - half, patch_shift))


def _start_indices(T: int, patch_size: int, patch_shift: int) -> np.ndarray:
    half = patch_size // 2
    centers = np.arange(half, T - half, patch_shift)
    return centers - half


@functools.partial(jax.jit, static_argnames=("patch_size", "patch_shift"))
def extract_patches(FV: jax.Array, *, patch_size: int, patch_shift: int) -> jax.Array:
    """``(..., D, T) -> (N, ..., D, patch_size)`` sliding windows.

    Applies the short-clip tiling rule, then extracts all windows with
    XLA's native strided-patch op instead of a fancy-index gather.
    Patch axis is leading so downstream code can treat it as batch.
    """
    T = FV.shape[-1]
    full_T = tiled_length(T, patch_size)
    if full_T != T:
        reps = [1] * (FV.ndim - 1) + [full_T // T + (1 if full_T % T else 0)]
        FV = jnp.tile(FV, reps)[..., :full_T]
    starts = _start_indices(full_T, patch_size, patch_shift)
    # Windows start at 0, shift, 2*shift, ... and stop before
    # full_T - patch_size//2 - patch_size/2; trim the tail to the exact
    # reference count.
    n_keep = len(starts)
    lead = FV.shape[:-1]
    x = FV.reshape((-1, 1, full_T))
    pat = jax.lax.conv_general_dilated_patches(
        x, filter_shape=(patch_size,), window_strides=(patch_shift,),
        padding="VALID")                      # (BD, patch_size, N_all)
    pat = pat[..., :n_keep]
    pat = jnp.moveaxis(pat, -1, 0)            # (N, BD, patch_size)
    return pat.reshape((n_keep,) + lead + (patch_size,))


def extract_patches_np(FV: np.ndarray, patch_size: int, patch_shift: int) -> np.ndarray:
    """Host-side numpy twin of :func:`extract_patches` (same semantics),
    for the data-loading pipeline: ``(D, T) -> (N, D, patch_size)``."""
    D, T = FV.shape
    full_T = tiled_length(T, patch_size)
    if full_T != T:
        reps = -(-full_T // T)
        FV = np.tile(FV, (1, reps))[:, :full_T]
    starts = _start_indices(full_T, patch_size, patch_shift)
    idx = starts[:, None] + np.arange(patch_size)[None, :]
    return np.ascontiguousarray(np.moveaxis(FV[:, idx], 1, 0))


def standardize_rows(FV, eps_like_sklearn: bool = True):
    """Per-row (per frequency bin) standardization over the time axis,
    matching ``StandardScaler(copy=False).fit_transform(FV.T).T``
    (``/root/reference/lib/preprocessing.py:146-148``): ddof=0 std, and
    constant rows are left centered (scale forced to 1)."""
    xp = jnp if isinstance(FV, jax.Array) else np
    mean = xp.mean(FV, axis=-1, keepdims=True)
    var = xp.var(FV, axis=-1, keepdims=True)
    scale = xp.sqrt(var)
    if eps_like_sklearn:
        scale = xp.where(scale == 0.0, 1.0, scale)
    return (FV - mean) / scale
