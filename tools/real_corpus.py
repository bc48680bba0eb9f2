"""Build a MUSAN-layout corpus from the reference's own demo audio.

``/root/reference/hpss_audio/sp.mp3`` (659 s of real speech) and
``mu.mp3`` (155 s of real music) are the only real recordings in this
environment.  This tool slices them into fixed-length clips and writes a
``music/ speech/ annotations/`` corpus, so the full experiment stack
(fold builder, SMR-cycled speech+music synthesis, training, SMR sweep)
runs on REAL audio instead of the synthetic toy corpus — the closest
available proxy for the TASLP MUSAN protocol (the corpus itself is not
distributable here).

    python tools/real_corpus.py --out bench_out/real_musan [--clip-s 4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm_hpss_mtl_tpu.data import codecs
from sm_hpss_mtl_tpu.data.audio import write_wav
from sm_hpss_mtl_tpu.ops.mixing import normalize_signal_np

HPSS_DIR = "/root/reference/hpss_audio"
SR = 16000


def slice_clips(x: np.ndarray, clip_s: float, min_rms: float = 0.01):
    """Consecutive clips, skipping near-silent ones (mp3 lead-in etc.)."""
    n = int(clip_s * SR)
    out = []
    for i in range(0, len(x) - n + 1, n):
        c = x[i:i + n]
        if float(np.sqrt((c ** 2).mean())) >= min_rms:
            out.append(np.asarray(normalize_signal_np(c), np.float32))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="bench_out/real_musan")
    ap.add_argument("--clip-s", type=float, default=4.0)
    ap.add_argument("--max-per-class", type=int, default=0,
                    help="0 = keep all clips")
    args = ap.parse_args(argv)

    made = {}
    for cls, stem in (("speech", "sp"), ("music", "mu")):
        x, sr = codecs.read_mp3(os.path.join(HPSS_DIR, f"{stem}.mp3"))
        assert sr == SR
        clips = slice_clips(x.astype(np.float64), args.clip_s)
        if args.max_per_class:
            clips = clips[:args.max_per_class]
        d = os.path.join(args.out, cls)
        os.makedirs(d, exist_ok=True)
        for i, c in enumerate(clips):
            write_wav(os.path.join(d, f"{cls}-real-{i:04d}.wav"), c, SR)
        made[cls] = len(clips)
    # annotations: single stratum (no genre/gender metadata survives the
    # demo mp3s) -> the fold builder's round-robin still applies.
    ad = os.path.join(args.out, "annotations")
    os.makedirs(ad, exist_ok=True)
    for cls in ("music", "speech"):
        with open(os.path.join(ad, f"{cls}.csv"), "w") as f:
            for i in range(made[cls]):
                f.write(f"{cls}-real-{i:04d},real\n")
    print({"out": args.out, **made,
           "clip_s": args.clip_s})


if __name__ == "__main__":
    main()
