"""Numpy golden-reference DSP, algorithm-compatible with the librosa calls
made by the reference repo.

The reference repo (``/root/reference``) computes its features with librosa
(``lib/preprocessing.py:355-457``).  librosa is not available in this
environment, so this module re-implements the *documented algorithms* of the
exact librosa entry points the reference uses, in plain numpy/scipy.  Every
JAX op in ``sm_hpss_mtl_tpu.ops`` is unit-tested against this module;
this module itself is validated structurally (window identities, filterbank
row sums, mask ranges) in ``tests/test_reference_dsp.py``.

Mapping to the reference's librosa calls:

- :func:`hann_window`, :func:`frame_signal`, :func:`stft_mag` —
  ``librosa.core.stft(y, n_fft, win_length, hop_length, center=False)``
  as called at ``lib/preprocessing.py:381,387,407,417,429,439``.
- :func:`mel_filterbank` — ``librosa.filters.mel(sr, n_fft, n_mels,
  norm='slaney', htk=False)`` (default mel basis of
  ``librosa.feature.melspectrogram``; also used directly at
  ``lib/proposed_architectures.py:681``).
- :func:`melspectrogram_from_audio` / :func:`melspectrogram_from_S` —
  ``librosa.feature.melspectrogram`` at ``lib/preprocessing.py:394,400,
  409-410,419-421``.  NOTE the reference quirk: when called with ``S=``
  (the HPSS branches) the sampling rate is left at librosa's default
  22050 Hz even though the audio is 16 kHz, so the mel bank spans
  0..11025 Hz over a spectrogram that only covers 0..8000 Hz.  We
  replicate that deliberately (``sr=22050`` default in
  :func:`melspectrogram_from_S`).
- :func:`power_to_db` — ``librosa.core.power_to_db`` with ref=1.0,
  amin=1e-10, top_db=80 (``lib/preprocessing.py:388,401,420-422``).
- :func:`softmask`, :func:`hpss` — ``librosa.decompose.hpss(S,
  kernel_size=(l_harm, l_perc))`` with margin=1, power=2.0, mask=False
  (``lib/preprocessing.py:408,418,430,440``): median filter across time
  for harmonic, across frequency for percussive (scipy
  ``median_filter`` with 'reflect' boundary), then Wiener soft masks.
- :func:`rms_energy` — ``librosa.feature.rms(y, frame_length,
  hop_length)`` with the default center=True / reflect padding
  (``lib/preprocessing.py:337``).
- :func:`istft` — inverse STFT (the reference repo ships pre-rendered
  HPSS demo audio in ``hpss_audio/`` but no resynthesis script; this is
  the missing entry point, ``cli.hpss_resynth``).
- :func:`featuregram` — the featName dispatch of
  ``lib/preprocessing.py:get_featuregram`` (:355-457) over the above, in
  float64: the plain reference for ``ops.featuregram.featuregram``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import median_filter as _nd_median_filter


# ---------------------------------------------------------------------------
# Windows and framing
# ---------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, scipy ``get_window('hann', N)``."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` samples."""
    n = len(window)
    if size < n:
        raise ValueError(f"size {size} < window length {n}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Non-centered framing: frame ``t`` is ``y[t*hop : t*hop+frame_length]``.

    Returns shape ``(frame_length, n_frames)`` (librosa column layout).
    """
    n_frames = 1 + (len(y) - frame_length) // hop_length
    if n_frames < 1:
        raise ValueError(
            f"signal of {len(y)} samples too short for frame_length={frame_length}")
    idx = (np.arange(frame_length)[:, None]
           + hop_length * np.arange(n_frames)[None, :])
    return y[idx]


# ---------------------------------------------------------------------------
# STFT / iSTFT
# ---------------------------------------------------------------------------

def stft(y: np.ndarray, n_fft: int, win_length: int, hop_length: int) -> np.ndarray:
    """Complex STFT with ``center=False`` semantics.

    The window of ``win_length`` samples is zero-padded to ``n_fft`` and each
    frame spans ``n_fft`` samples.  Returns ``(1 + n_fft//2, n_frames)``.
    """
    window = pad_center(hann_window(win_length), n_fft)
    frames = frame_signal(np.asarray(y, dtype=np.float64), n_fft, hop_length)
    return np.fft.rfft(frames * window[:, None], n=n_fft, axis=0)


def stft_mag(y: np.ndarray, n_fft: int, win_length: int, hop_length: int) -> np.ndarray:
    """``np.abs(librosa.core.stft(..., center=False))`` equivalent."""
    return np.abs(stft(y, n_fft, win_length, hop_length))


def istft(S: np.ndarray, n_fft: int, win_length: int, hop_length: int,
          length: int | None = None) -> np.ndarray:
    """Inverse STFT matching :func:`stft` (center=False), via NOLA
    overlap-add with squared-window normalization."""
    window = pad_center(hann_window(win_length), n_fft)
    frames = np.fft.irfft(S, n=n_fft, axis=0) * window[:, None]
    n_frames = frames.shape[1]
    out_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(out_len, dtype=np.float64)
    wsum = np.zeros(out_len, dtype=np.float64)
    for t in range(n_frames):
        s = t * hop_length
        y[s:s + n_fft] += frames[:, t]
        wsum[s:s + n_fft] += window ** 2
    good = wsum > 1e-10
    y[good] /= wsum[good]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


# ---------------------------------------------------------------------------
# Mel
# ---------------------------------------------------------------------------

def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(log_t,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
                    mels)
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t,
                     min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                     freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney") -> np.ndarray:
    """Slaney-style triangular mel filterbank, shape ``(n_mels, 1+n_fft//2)``."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


def melspectrogram_from_audio(y: np.ndarray, sr: int, n_fft: int,
                              win_length: int, hop_length: int,
                              n_mels: int, power: float = 2.0) -> np.ndarray:
    """``librosa.feature.melspectrogram(y=..., center=False)``:
    ``mel_basis @ |stft|**power`` with the basis built for ``sr``."""
    S = stft_mag(y, n_fft, win_length, hop_length) ** power
    M = mel_filterbank(sr, n_fft, n_mels)
    return M @ S


def melspectrogram_from_S(S: np.ndarray, n_mels: int, sr: int = 22050) -> np.ndarray:
    """``librosa.feature.melspectrogram(S=...)``: apply the mel basis to a
    pre-computed spectrogram.

    ``sr`` defaults to 22050 — librosa's default — because the reference
    omits ``sr`` in its HPSS branches (``lib/preprocessing.py:409-410,
    419-421``), building an 0..11025 Hz mel bank over 16 kHz audio.  The
    FFT size is inferred from the spectrogram height, like librosa does.
    """
    n_fft = 2 * (S.shape[0] - 1)
    M = mel_filterbank(sr, n_fft, n_mels)
    return M @ S


def power_to_db(S: np.ndarray, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> np.ndarray:
    """``librosa.core.power_to_db`` semantics, including the data-dependent
    per-array ``top_db`` clamp."""
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


# ---------------------------------------------------------------------------
# HPSS
# ---------------------------------------------------------------------------

def softmask(X: np.ndarray, X_ref: np.ndarray, power: float = 1.0,
             split_zeros: bool = False) -> np.ndarray:
    """Wiener-style soft mask: ``(X/Z)**p / ((X/Z)**p + (X_ref/Z)**p)``
    with ``Z = max(X, X_ref)``; positions where both are ~0 get 0 (or 0.5
    when ``split_zeros``).  Matches ``librosa.util.softmask``."""
    dtype = np.float32
    Z = np.maximum(X, X_ref).astype(dtype)
    bad = Z < np.finfo(dtype).tiny
    Zs = np.where(bad, 1.0, Z)
    mask = (X / Zs) ** power
    ref_mask = (X_ref / Zs) ** power
    mask = np.where(bad, 0.5 if split_zeros else 0.0,
                    mask / np.where(bad, 1.0, mask + ref_mask))
    return mask.astype(dtype)


def hpss_medians(S: np.ndarray, l_harm: int, l_perc: int) -> tuple[np.ndarray, np.ndarray]:
    """The two running medians of HPSS: harmonic = median across time
    (width ``l_harm``), percussive = median across frequency (width
    ``l_perc``), both with 'reflect' boundary handling."""
    harm = _nd_median_filter(S, size=(1, l_harm), mode="reflect")
    perc = _nd_median_filter(S, size=(l_perc, 1), mode="reflect")
    return harm, perc


def hpss(S: np.ndarray, l_harm: int = 21, l_perc: int = 11,
         power: float = 2.0, margin: float = 1.0):
    """``librosa.decompose.hpss(S, kernel_size=(l_harm, l_perc))`` with the
    reference's defaults (margin=1, power=2, mask=False): returns
    ``(H, P) = (S * mask_h, S * mask_p)``."""
    harm, perc = hpss_medians(S, l_harm, l_perc)
    mask_h = softmask(harm, perc * margin, power=power)
    mask_p = softmask(perc, harm * margin, power=power)
    return (S * mask_h).astype(np.float32), (S * mask_p).astype(np.float32)


def hpss_masks(S: np.ndarray, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Just the two soft masks (for mask-fidelity testing)."""
    harm, perc = hpss_medians(S, l_harm, l_perc)
    return softmask(harm, perc, power=power), softmask(perc, harm, power=power)


def featuregram(y: np.ndarray, feat_name: str, *, sr: int = 16000,
                n_fft: int = 400, win_length: int = 400,
                hop_length: int = 160, n_mels: int = 120,
                l_harm: int = 21, l_perc: int = 11) -> np.ndarray:
    """``(n_samples,)`` audio -> the ``(D, T)`` featuregram of one
    featName (``[Log][Mel]{Spec,HarmSpec,PercSpec,HarmPercSpec}``).

    Plain-spectrogram features use the true ``sr``; the HPSS branches
    build their mel bank at librosa's default 22050 Hz, and ``[H; P]``
    features run one ``power_to_db`` per component, as the reference
    does (``lib/preprocessing.py:408-422``)."""
    name = feat_name
    log = name.startswith("Log")
    name = name[3:] if log else name
    mel = name.startswith("Mel")
    name = name[3:] if mel else name
    comps = {"Spec": "", "HarmSpec": "H", "PercSpec": "P",
             "HarmPercSpec": "HP"}[name]
    y = np.asarray(y, np.float64)
    S = stft_mag(y, n_fft, win_length, hop_length)
    if not comps:
        X = (melspectrogram_from_audio(y, sr, n_fft, win_length, hop_length,
                                       n_mels) if mel else S)
        return power_to_db(X ** 2) if log else X
    H, P = hpss(S, l_harm, l_perc)
    parts = []
    for c in comps:
        X = np.asarray(H if c == "H" else P, np.float64)
        if mel:
            X = melspectrogram_from_S(X, n_mels)
        parts.append(power_to_db(X ** 2) if log else X)
    return np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# RMS energy
# ---------------------------------------------------------------------------

def rms_energy(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """``librosa.feature.rms(y, frame_length, hop_length)`` with the default
    ``center=True`` reflect padding; returns 1-D ``(n_frames,)``."""
    y = np.asarray(y, dtype=np.float64)
    y = np.pad(y, frame_length // 2, mode="reflect")
    frames = frame_signal(y, frame_length, hop_length)
    return np.sqrt(np.mean(frames ** 2, axis=0))
