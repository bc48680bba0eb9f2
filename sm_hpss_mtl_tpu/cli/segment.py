"""Streaming segmentation driver: long-audio speech/music detection.

JAX equivalent of
``/root/reference/DAFx12_Speech_Music_Detection_B3_MTL_v2.py``: load a
trained MUSAN MTL checkpoint, stream dense per-frame predictions over
whole recordings (shift-1 windows in 10,000-frame slabs), smooth the
probability track (median, win 501), optionally score against
time-interval annotation CSVs, and write per-frame labels.

    python -m sm_hpss_mtl_tpu.cli.segment broadcast.wav \\
        --ckpt results/.../fold0_ckpt [--head S] \\
        [--annot labels/speech/broadcast.csv] [--out labels.npz]
"""

from __future__ import annotations

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from ..data.audio import read_audio
from ..eval.metrics import get_performance
from ..eval.segment import (StreamingSegmenter,
                            interval_annotations_to_markers,
                            read_interval_csv)
from ..models import get_model
from ..train import TrainState, for_model, make_predict, restore_checkpoint
from ..train.config import MODEL_PRESETS
from ..utils.compile_cache import enable_compile_cache

#: Broadcasts longer than this many frames featurize via the slabbed
#: fixed-shape path (ops.featuregram.featuregram_slabbed) instead of a
#: per-length whole-signal program.
SLAB_THRESHOLD_FRAMES = 16384


def _featurize_broadcast(x, preset):
    """Featurize a whole broadcast.  With >1 device and a Mel-HPSS
    featName, shard the time axis across devices via the audio halo
    exchange (``parallel.featuregram_time_sharded``) — the
    multi-device leg of the DAFx streaming path; otherwise the plain
    jitted featuregram."""
    from ..data.featurize import _reflect_pad_to, bucket_length
    from ..ops.featuregram import _parse, featuregram
    from ..ops.stft import n_frames as stft_frames
    from ..parallel import featuregram_time_sharded

    n_dev = len(jax.devices())
    log, is_mel, harm, perc = _parse(preset["feat_name"])
    n_frames = 1 + (len(x) - preset["n_fft"]) // 160
    if (n_dev > 1 and is_mel and (harm or perc)
            and n_frames // n_dev >= 20):
        from jax.sharding import Mesh
        mesh = Mesh(np.array(jax.devices()).reshape(n_dev), ("time",))
        return np.asarray(featuregram_time_sharded(
            jnp.asarray(x), mesh, feat_name=preset["feat_name"],
            n_fft=preset["n_fft"], n_mels=preset["n_mels"]))
    true_t = stft_frames(len(x), preset["n_fft"], 160)
    if true_t > SLAB_THRESHOLD_FRAMES:
        # Long broadcast: fixed-shape slab programs (at most two XLA
        # compiles per config, reused across every broadcast length —
        # the whole-signal program would recompile per duration).
        from ..ops.featuregram import featuregram_slabbed
        return featuregram_slabbed(
            np.asarray(x, np.float32), feat_name=preset["feat_name"],
            n_fft=preset["n_fft"],
            n_mels=preset["n_mels"] if preset["n_mels"] > 0 else 120)
    # Short files: bucket the audio length like Featurizer._compute —
    # every distinct length otherwise traces/compiles a fresh XLA
    # program, so batch segmenting many ragged files pays repeated
    # multi-second compiles.
    x = _reflect_pad_to(np.asarray(x), bucket_length(len(x)))
    fv = np.asarray(featuregram(
        jnp.asarray(x), feat_name=preset["feat_name"],
        n_fft=preset["n_fft"],
        n_mels=preset["n_mels"] if preset["n_mels"] > 0 else 120,
        valid_frames=jnp.asarray(true_t, jnp.int32)))
    return fv[:, :true_t]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("audio", help="input wav (any length), or a "
                                 "precomputed featuregram .npy with --spec")
    p.add_argument("--spec", action="store_true",
                   help="treat the input as a precomputed (D, T) "
                        "featuregram .npy (the reference's DAFx spectrogram "
                        "cache path, DAFx12_...py:608-612)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--head", default="S", choices=["S", "M"])
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--chunk-frames", type=int, default=10000)
    p.add_argument("--smooth-win", type=int, default=501)
    p.add_argument("--annot", default=None,
                   help="interval CSV (tmin,dur,label) to score against")
    p.add_argument("--out", default=None, help="save labels npz here")
    args = p.parse_args(argv)
    enable_compile_cache()

    preset = MODEL_PRESETS[args.model]
    if args.spec:
        fv = np.load(args.audio, allow_pickle=False)
    else:
        x, sr = read_audio(args.audio)
        fv = _featurize_broadcast(x, preset)

    mels_kw = ({"n_mels": preset["n_mels"]} if preset["n_mels"] > 0 else {})
    spec = get_model(args.model, **mels_kw)
    opt, _ = for_model(args.model, tr_steps=1)
    input_kind = ("time_mel" if args.model.startswith("Lemaire") else "image")
    if input_kind == "time_mel":
        sample = jnp.zeros((2, args.patch_size, fv.shape[0]))
    else:
        sample = jnp.zeros((2, fv.shape[0], args.patch_size, 1))
    template = TrainState.create(spec.module, opt, sample,
                                 jax.random.PRNGKey(0))
    state, _ = restore_checkpoint(args.ckpt, template)
    predict = make_predict(spec.module)

    seg = StreamingSegmenter(
        predict_fn=lambda b: predict(state, b),
        patch_size=args.patch_size, chunk_frames=args.chunk_frames,
        input_kind=input_kind, feat_name=preset["feat_name"])
    prob, labels, tracks = seg.segment(fv, head=args.head,
                                       smooth_win=args.smooth_win)
    frac = labels.mean() if len(labels) else 0.0
    print(f"{args.audio}: {len(labels)} frames, "
          f"{args.head}-positive fraction {frac:.3f}")

    if args.annot:
        rows = read_interval_csv(args.annot)
        marker = interval_annotations_to_markers(rows, len(labels))
        conf, prec, rec, f1 = get_performance(labels, marker.astype(int),
                                              [0, 1])
        print(f"frame P/R/F1 vs annotations: {prec} {rec} {f1}")

    if args.out:
        np.savez(args.out, prob=prob, labels=labels,
                 **{f"track_{k}": v for k, v in tracks.items()})
        print("saved:", args.out)
    return prob, labels


if __name__ == "__main__":
    main()
