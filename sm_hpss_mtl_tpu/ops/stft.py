"""Batched STFT / iSTFT / RMS framing as XLA ops.

JAX replacement for the reference's librosa STFT calls
(``/root/reference/lib/preprocessing.py:381,387,407,417``).

Design note: framing avoids a gather (``y[..., idx]``).  Instead:

- **STFT = windowed DFT as a matmul.**  The rFFT of a 400-sample
  Hann-windowed frame is a fixed linear map, so the whole STFT is one
  ``(n_fft, 2F)`` matmul against the windowed cos/−sin basis over
  frames assembled from strided slices, exact to f32 with HIGHEST
  precision.  Whether a framed ``jnp.fft.rfft`` (cuFFT) is as fast on
  the GPU is an open measurement (ROADMAP Design 5).
- **Frame extraction** (for RMS etc.) uses
  ``lax.conv_general_dilated_patches``, XLA's native strided-patch op.

Default geometry matches the reference: 16 kHz audio, Tw=25 ms window
(win_length=400), Ts=10 ms hop (hop_length=160), n_fft=400 (512 for the
Jang model) — ``/root/reference/Proposed_Work_Results.py:758-765,800-801``.
All functions operate on the last axis as time and vmap/shard naturally
over leading axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import reference as ref


def hann_window(win_length: int, n_fft: int, dtype=jnp.float32) -> jax.Array:
    """Periodic Hann window zero-padded to ``n_fft`` (host-computed constant)."""
    return jnp.asarray(ref.pad_center(ref.hann_window(win_length), n_fft), dtype=dtype)


def n_frames(n_samples: int, frame_length: int, hop_length: int) -> int:
    """Frame count for center=False framing (static helper)."""
    return 1 + (n_samples - frame_length) // hop_length


def frame(y: jax.Array, frame_length: int, hop_length: int) -> jax.Array:
    """Frame the last axis: ``(..., n) -> (..., n_frames, frame_length)``.

    center=False semantics via XLA's native patch-extraction op instead
    of a gather.
    """
    lead = y.shape[:-1]
    x = y.reshape((-1, 1, y.shape[-1]))
    patches = jax.lax.conv_general_dilated_patches(
        x, filter_shape=(frame_length,), window_strides=(hop_length,),
        padding="VALID")                      # (B, frame_length, T)
    patches = jnp.swapaxes(patches, -1, -2)    # (B, T, frame_length)
    return patches.reshape(lead + patches.shape[1:])


@functools.lru_cache(maxsize=16)
def _dft_kernel(n_fft: int, win_length: int):
    """Windowed rDFT basis as a conv kernel (host numpy), shape
    ``(2F, 1, n_fft)``: rows 0..F-1 real (cos), rows F..2F-1 imag (−sin)."""
    F = 1 + n_fft // 2
    window = ref.pad_center(ref.hann_window(win_length), n_fft)
    n = np.arange(n_fft)
    f = np.arange(F)[:, None]
    ang = 2.0 * np.pi * f * n[None, :] / n_fft
    real = np.cos(ang) * window[None, :]
    imag = -np.sin(ang) * window[None, :]
    return np.concatenate([real, imag], axis=0)[:, None, :].astype(np.float32)


def _stft_reim(y: jax.Array, n_fft: int, win_length: int, hop_length: int):
    """(real, imag) halves, each ``(..., F, T)``.

    Block-matmul formulation: with ``g = gcd(n_fft, hop)`` the signal is
    reshaped into g-sample blocks; frame ``t`` is blocks
    ``[t*hop/g : t*hop/g + n_fft/g]``, gathered as ``n_fft/g`` strided
    slices (regular XLA slices, not gathers), stacked and hit with ONE
    ``(n_fft, 2F)`` windowed-DFT matmul.
    """
    import math

    lead = y.shape[:-1]
    F = 1 + n_fft // 2
    T = n_frames(y.shape[-1], n_fft, hop_length)
    g = math.gcd(n_fft, hop_length)
    k = n_fft // g          # blocks per frame
    s = hop_length // g     # block stride between frames
    nb_needed = s * (T - 1) + k
    x = y.reshape((-1, y.shape[-1])).astype(jnp.float32)
    x = x[:, :nb_needed * g].reshape(-1, nb_needed, g)

    views = [jax.lax.slice(x, (0, j, 0), (x.shape[0], j + s * (T - 1) + 1, g),
                           (1, s, 1)) for j in range(k)]      # k x (B, T, g)
    frames = jnp.concatenate(views, axis=-1)                  # (B, T, n_fft)
    # Keep XLA from fusing the strided-slice assembly INTO the matmul,
    # so the frames are assembled once and the product reads them
    # contiguously (kept from the first design; ROADMAP Design 5
    # re-measures it on the GPU).
    frames = jax.lax.optimization_barrier(frames)

    kernel = jnp.asarray(_dft_kernel(n_fft, win_length)[:, 0, :])  # (2F, n_fft)
    out = jnp.einsum("btn,fn->bft", frames, kernel,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)     # (B, 2F, T)
    out = out.reshape(lead + out.shape[1:])
    return out[..., :F, :], out[..., F:, :]


@functools.partial(jax.jit, static_argnames=("n_fft", "win_length", "hop_length"))
def stft(y: jax.Array, *, n_fft: int, win_length: int, hop_length: int) -> jax.Array:
    """Complex STFT of the last axis, center=False: ``(..., n) ->
    (..., 1+n_fft//2, n_frames)`` (freq, time layout, matching the
    reference's ``nFeatures x nFrames`` featuregrams)."""
    re, im = _stft_reim(y, n_fft, win_length, hop_length)
    return jax.lax.complex(re, im)


@functools.partial(jax.jit, static_argnames=("n_fft", "win_length", "hop_length"))
def stft_mag(y: jax.Array, *, n_fft: int, win_length: int, hop_length: int) -> jax.Array:
    """Magnitude STFT ``(..., F, T)`` (float32) — stays in real arithmetic."""
    re, im = _stft_reim(y, n_fft, win_length, hop_length)
    return jnp.sqrt(re * re + im * im)


@functools.partial(jax.jit, static_argnames=("n_fft", "win_length", "hop_length", "length"))
def istft(S: jax.Array, *, n_fft: int, win_length: int, hop_length: int,
          length: int | None = None) -> jax.Array:
    """Inverse of :func:`stft` via windowed overlap-add with NOLA
    normalization.  ``S``: ``(..., F, T)`` complex -> ``(..., n_samples)``.

    The overlap-add is a strided transposed convolution
    (``conv_transpose`` of the frames with an identity-placement kernel),
    XLA's native scatter-free formulation.
    """
    S = jnp.swapaxes(S, -1, -2)                      # (..., T, F)
    window = hann_window(win_length, n_fft, dtype=jnp.float32)
    frames = jnp.fft.irfft(S, n=n_fft, axis=-1) * window   # (..., T, n_fft)
    lead = frames.shape[:-2]
    T = frames.shape[-2]
    out_len = n_fft + hop_length * (T - 1)

    # Transposed conv: treat the n_fft frame samples as input channels.
    # conv_transpose applies the kernel spatially flipped, so
    # kernel[w, c, 0] = [w == n_fft-1-c] places channel c at time offset
    # c; a stride-hop conv_transpose then performs the whole overlap-add.
    x = frames.reshape((-1, T, n_fft))               # (B, T, C=n_fft) NHC
    kernel = jnp.asarray(
        np.eye(n_fft, dtype=np.float32)[::-1].copy())[..., None]
    y = jax.lax.conv_transpose(
        x, kernel, strides=(hop_length,), padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"))     # (B, out_len, 1)
    y = y[..., 0].reshape(lead + (y.shape[1],))
    assert y.shape[-1] == out_len, (y.shape, out_len)

    wsq = jnp.broadcast_to((window ** 2)[None, None, :], (1, T, n_fft))
    wsum = jax.lax.conv_transpose(
        wsq, kernel, strides=(hop_length,), padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"))[0, :, 0]
    y = y / jnp.where(wsum > 1e-10, wsum, 1.0)
    if length is not None:
        if length <= out_len:
            y = y[..., :length]
        else:
            pad = [(0, 0)] * (y.ndim - 1) + [(0, length - out_len)]
            y = jnp.pad(y, pad)
    return y


@functools.partial(jax.jit, static_argnames=("frame_length", "hop_length"))
def rms_energy(y: jax.Array, *, frame_length: int, hop_length: int) -> jax.Array:
    """Per-frame RMS with center=True reflect padding, matching
    ``librosa.feature.rms`` as used for silence gating
    (``/root/reference/lib/preprocessing.py:337``). ``(..., n) -> (..., T)``.

    The mean-square is a depthwise conv with a constant kernel — no
    framing materialized.
    """
    pad = [(0, 0)] * (y.ndim - 1) + [(frame_length // 2, frame_length // 2)]
    yp = jnp.pad(y, pad, mode="reflect").astype(jnp.float32)
    lead = yp.shape[:-1]
    x = (yp ** 2).reshape((-1, 1, yp.shape[-1]))
    kernel = jnp.full((1, 1, frame_length), 1.0 / frame_length, jnp.float32)
    ms = jax.lax.conv_general_dilated(
        x, kernel, window_strides=(hop_length,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return jnp.sqrt(ms[:, 0, :]).reshape(lead + (ms.shape[-1],))
