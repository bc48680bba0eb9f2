"""Mel featurization as matmuls + fused elementwise log scaling.

The mel projection is a ``(n_mels, F) @ (F, T)`` matmul, and
``power_to_db`` is elementwise work XLA fuses after it.  Filterbanks are
host-computed constants (closed over by jit), so they live in device
memory once.

Semantics match the reference's librosa calls, including the deliberate
quirk that the HPSS branches build the mel bank with librosa's default
sr=22050 (see ``sm_hpss_mtl_tpu.ops.reference.melspectrogram_from_S``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import reference as ref


@functools.lru_cache(maxsize=32)
def _mel_basis(sr: int, n_fft: int, n_mels: int):
    # Cached as a HOST numpy array: caching a device value here would leak
    # tracers when first touched inside a jit trace.
    import numpy as np
    return np.asarray(ref.mel_filterbank(sr, n_fft, n_mels), dtype=np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> jax.Array:
    """Slaney-norm mel filterbank as a device constant, ``(n_mels, 1+n_fft//2)``."""
    return jnp.asarray(_mel_basis(sr, n_fft, n_mels))


@functools.partial(jax.jit, static_argnames=("sr", "n_mels"))
def apply_mel(S: jax.Array, *, sr: int, n_mels: int) -> jax.Array:
    """Project a spectrogram ``(..., F, T)`` onto ``n_mels`` mel bands.

    The FFT size is inferred from the frequency axis like
    ``librosa.feature.melspectrogram(S=...)`` does.
    """
    n_fft = 2 * (S.shape[-2] - 1)
    M = _mel_basis(sr, n_fft, n_mels)
    # HIGHEST: full-f32 products — the projection is tiny and feeds log
    # scaling, so a TF32/bf16 default would visibly move the features.
    return jnp.einsum("mf,...ft->...mt", M, S,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("ref_value", "amin", "top_db"))
def power_to_db(S: jax.Array, *, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0,
                valid_len=None) -> jax.Array:
    """``librosa.core.power_to_db`` semantics on device.

    The ``top_db`` clamp references the max over the *last two* axes (one
    spectrogram), matching librosa's per-array max when vmapped/batched
    over leading axes.  ``valid_len`` (traced scalar) restricts that max
    to the first ``valid_len`` frames — used by the length-bucketed
    featurizer so padding frames cannot shift the clamp threshold.
    """
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, S))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, ref_value))
    if top_db is not None:
        if valid_len is not None:
            t = jnp.arange(S.shape[-1]) < valid_len
            masked = jnp.where(t, log_spec, -jnp.inf)
            peak = jnp.max(masked, axis=(-2, -1), keepdims=True)
        else:
            peak = jnp.max(log_spec, axis=(-2, -1), keepdims=True)
        log_spec = jnp.maximum(log_spec, peak - top_db)
    return log_spec
