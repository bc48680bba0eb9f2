"""Time-sharded audio->feature frontend.

The raw audio is sharded along time across the mesh's ``time`` axis;
each device exchanges a small audio halo with its ring neighbours
(``lax.ppermute``) and runs the plain XLA chain on its local chunk:
``stft_mag`` on the extended audio, the symmetric spectral edge mirror
on the first and last shards only, the HPSS medians and masks, and the
mel projection.  Compared with the spectral halo exchange
(``parallel.halo``), the wire traffic is raw audio — ``l_harm//2 * hop``
samples per boundary, ~25x smaller than the same halo in spectrogram
frames — and no device ever holds more than its own block of the
spectrogram.

Shard-boundary correctness: interior boundaries receive real neighbour
audio, so their median windows are exact; the global-edge symmetric
mirror is selected per shard (``axis_index == 0`` / ``== n-1``), so it
applies only on the true first/last shards.  Output equals the
unsharded ``ops.featuregram.stft_hpss`` up to f32 rounding.

This is how the DAFx12-style multi-hour broadcast featurization
(``/root/reference/DAFx12_...py:594-706``) scales past one device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import featuregram as fg
from ..ops import stft as stft_mod
from ..ops.hpss import hpss_from_time_extended


def stft_hpss_mel_time_sharded(
        y: jax.Array, mel_basis, mesh: Mesh, *, n_fft: int = 400,
        win_length: int = 400, hop_length: int = 160, l_harm: int = 21,
        l_perc: int = 11, power: float = 2.0,
        axis: str = "time") -> tuple[jax.Array, jax.Array]:
    """Audio ``(B, n_samples)`` -> ``(mel(H), mel(P))``, time-sharded.

    ``mel_basis=None`` emits full-resolution masked magnitudes
    ``(H, P)`` of shape ``(B, F, T)`` instead (the HarmSpec/PercSpec
    featName family — Papakostas/Jang presets).

    Requirements: the frame count ``T = 1 + (n - n_fft) // hop`` must
    divide evenly by the ``axis`` size, and each local block must hold
    at least ``2 * (l_harm // 2)`` frames.
    """
    B, N = y.shape
    ht = l_harm // 2
    n = mesh.shape[axis]
    T = 1 + (N - n_fft) // hop_length
    if T % n:
        raise ValueError(f"T={T} not divisible by {axis}={n}")
    T_local = T // n
    if T_local < 2 * ht:
        raise ValueError("local time block smaller than 2*(l_harm//2)")

    halo = ht * hop_length
    tail_len = n_fft - hop_length   # samples past the last frame start
    body = y[:, :T * hop_length].astype(jnp.float32)
    tail = y[:, T * hop_length:(T - 1) * hop_length + n_fft]
    tail = tail.astype(jnp.float32)
    emit_mel = mel_basis is not None
    # A dummy 1-mel basis rides the replicated slot when unused.
    M = (jnp.asarray(mel_basis, jnp.float32) if emit_mel
         else jnp.zeros((1, 1 + n_fft // 2), jnp.float32))

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, None), P(None, None)),
        out_specs=(P(None, None, axis), P(None, None, axis)))
    def _fn(y_local, tail_rep, M_rep):
        idx = jax.lax.axis_index(axis)
        # Left halo: my left neighbour's last `halo` samples.
        right_perm = [(i, (i + 1) % n) for i in range(n)]
        left_halo = jax.lax.ppermute(y_local[:, -halo:], axis, right_perm)
        # Right extension: neighbour's first `halo + tail_len` samples;
        # the last shard substitutes the replicated global tail + zeros.
        left_perm = [(i, (i - 1) % n) for i in range(n)]
        right_ext = jax.lax.ppermute(y_local[:, :halo + tail_len], axis,
                                     left_perm)
        own_tail = jnp.concatenate(
            [tail_rep, jnp.zeros((y_local.shape[0], halo), jnp.float32)],
            axis=-1)
        right_ext = jnp.where(idx == n - 1, own_tail, right_ext)
        y_ext = jnp.concatenate([left_halo, y_local, right_ext], axis=-1)

        # (B, F, T_local + 2*ht): frames [-ht, T_local + ht) of the block.
        S = stft_mod.stft_mag(y_ext, n_fft=n_fft, win_length=win_length,
                              hop_length=hop_length)
        # Global edges: frame -1-i mirrors frame i, and frame T+m mirrors
        # frame T-1-m (scipy's 'reflect'), on the edge shards only.
        left = jnp.where(idx == 0, jnp.flip(S[..., ht:2 * ht], -1),
                         S[..., :ht])
        right = jnp.where(idx == n - 1,
                          jnp.flip(S[..., T_local:T_local + ht], -1),
                          S[..., T_local + ht:])
        S = jnp.concatenate([left, S[..., ht:T_local + ht], right], axis=-1)
        H, Pc = hpss_from_time_extended(S, l_harm=l_harm, l_perc=l_perc,
                                        power=power)
        if emit_mel:
            return fg.mel_project(H, M_rep), fg.mel_project(Pc, M_rep)
        return H, Pc

    return _fn(body, tail, M)


def featuregram_time_sharded(y: jax.Array, mesh: Mesh, *,
                             feat_name: str = "LogMelHarmPercSpec",
                             sr: int = 16000, n_fft: int = 400,
                             win_length: int = 400, hop_length: int = 160,
                             n_mels: int = 120, l_harm: int = 21,
                             l_perc: int = 11,
                             axis: str = "time") -> jax.Array:
    """Multi-device featuregram for long recordings: the HPSS featName
    families (Mel/LogMel and full-resolution (Log)Harm/Perc/HarmPerc)
    computed via the time-sharded frontend.

    This is the multi-hour-broadcast featurization path of the DAFx12
    driver (``/root/reference/DAFx12_...py:594-706``) scaled across
    devices.  Frame counts that don't divide the ``axis`` size are
    zero-padded to the next multiple and trimmed; the final
    ``l_harm//2`` frames (whose median windows would see pad audio
    instead of the symmetric spectral boundary) are recomputed exactly
    on a ~3*(l_harm//2)-frame unsharded slab and spliced in.
    """
    from ..ops import mel as mel_mod
    from ..ops.featuregram import _MEL_SR_QUIRK, _parse

    log, is_mel, harm, perc = _parse(feat_name)
    if not (harm or perc):
        raise ValueError(
            f"featuregram_time_sharded supports the HPSS featName "
            f"families, got {feat_name!r}")

    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    B, N = y.shape
    n = mesh.shape[axis]
    ht = l_harm // 2
    T = 1 + (N - n_fft) // hop_length
    Tpad = -(-T // n) * n
    extra = Tpad - T
    M = (mel_mod.mel_filterbank(_MEL_SR_QUIRK, n_fft, n_mels)
         if is_mel else None)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              l_harm=l_harm, l_perc=l_perc)

    n_need = (Tpad - 1) * hop_length + n_fft
    yp = jnp.pad(y.astype(jnp.float32), ((0, 0), (0, max(0, n_need - N))))
    H, P = stft_hpss_mel_time_sharded(yp[:, :n_need], M, mesh, axis=axis,
                                      **kw)
    H, P = H[..., :T], P[..., :T]
    if extra:
        # Tail splice: recompute the last ht frames against the TRUE
        # right boundary (the padded run mirrored at Tpad, not T).
        k = 3 * ht
        t0 = (T - k) * hop_length
        t1 = (T - 1) * hop_length + n_fft
        th, tp = fg.stft_hpss(y[:, t0:t1], M, **kw)
        H = jnp.concatenate([H[..., :T - ht], th[..., -ht:]], axis=-1)
        P = jnp.concatenate([P[..., :T - ht], tp[..., -ht:]], axis=-1)

    def _post(fv):
        if log:
            fv = mel_mod.power_to_db(fv ** 2)
        return fv.astype(jnp.float32)

    parts = ([_post(H)] if harm else []) + ([_post(P)] if perc else [])
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-2)
    return out[0] if squeeze else out
