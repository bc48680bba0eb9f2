"""HPSS resynthesis: audio -> harmonic / percussive wav files.

The reference ships pre-rendered demo audio (``hpss_audio/*.mp3``) but no
script that generates it (SURVEY.md §2.3); this is that missing entry
point: STFT -> median-filter soft masks ->
masked complex spectrogram -> iSTFT, all on device.

    python -m sm_hpss_mtl_tpu.cli.hpss_resynth in.wav --out-dir out/
    python -m sm_hpss_mtl_tpu.cli.hpss_resynth sp.wav --mix mu.wav --smr 5 --out-dir out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import jax.numpy as jnp

from ..data.audio import read_audio, write_wav
from ..ops import stft as st
from ..ops.hpss import hpss_masks
from ..ops.mixing import mix_signals_np, normalize_signal_np
from ..utils.compile_cache import enable_compile_cache


def resynthesize(x: np.ndarray, *, n_fft: int = 400, win_length: int = 400,
                 hop_length: int = 160, l_harm: int = 21, l_perc: int = 11):
    """Returns (harmonic, percussive) time-domain signals, same length."""
    S = st.stft(jnp.asarray(x), n_fft=n_fft, win_length=win_length,
                hop_length=hop_length)
    mh, mp = hpss_masks(jnp.abs(S).astype(jnp.float32),
                        l_harm=l_harm, l_perc=l_perc)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              length=len(x))
    yh = np.asarray(st.istft(S * mh, **kw))
    yp = np.asarray(st.istft(S * mp, **kw))
    return yh, yp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="input wav (speech if --mix is given)")
    p.add_argument("--mix", default=None, help="music wav to mix in")
    p.add_argument("--smr", type=float, default=0.0,
                   help="speech-to-music ratio in dB for --mix")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--l-harm", type=int, default=21)
    p.add_argument("--l-perc", type=int, default=11)
    args = p.parse_args(argv)
    enable_compile_cache()

    x, sr = read_audio(args.input)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    if args.mix:
        m, _ = read_audio(args.mix)
        x = mix_signals_np(normalize_signal_np(x), normalize_signal_np(m),
                           args.smr).astype(np.float32)
        stem = f"{stem}+{os.path.splitext(os.path.basename(args.mix))[0]}_{args.smr:g}dB"
    yh, yp = resynthesize(x, l_harm=args.l_harm, l_perc=args.l_perc)

    os.makedirs(args.out_dir, exist_ok=True)
    for name, y in (("", x), ("_Harmonic", yh), ("_Percussive", yp)):
        path = os.path.join(args.out_dir, f"{stem}{name}.wav")
        write_wav(path, np.asarray(y) / max(np.max(np.abs(y)), 1e-9), sr)
        print(path)


if __name__ == "__main__":
    main()
