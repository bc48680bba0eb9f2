"""Cross-domain transfer demo on real audio: the DAFx12 scenario.

The reference's DAFx12 driver evaluates a MUSAN-trained model on OFAI
radio broadcasts and fine-tunes it on the target domain
(``transfer_learn_model``, ``DAFx12_...py:442-473``).  No radio corpus
exists in this environment, so this tool simulates the domain shift on
the real-audio broadcast (``tools/real_corpus.py`` clips): a radio-like
channel (bandpass + soft compression + noise floor) is applied, the
MUSAN-analog checkpoint is scored zero-shot, then fine-tuned on the
first half of the degraded broadcast (S-head-only loss) and re-scored
on the held-out second half.

    python tools/radio_transfer.py --ckpt <fold_ckpt> [--out JSON]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from scipy.signal import butter, sosfilt

SR = 16000


def radio_channel(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Bandpass 250-4500 Hz + tanh soft compression + -40 dBFS noise."""
    sos = butter(4, [250, 4500], btype="bandpass", fs=SR, output="sos")
    y = sosfilt(sos, x.astype(np.float64))
    y = np.tanh(2.5 * y) / 2.5
    rng = np.random.default_rng(seed)
    y = y + 0.01 * rng.standard_normal(len(y))
    return (y / max(np.max(np.abs(y)), 1e-9)).astype(np.float32)


def window_labels(marker: np.ndarray, W: int, shift: int) -> np.ndarray:
    n = (len(marker) - W) // shift + 1
    idx = np.arange(W)[None, :] + shift * np.arange(n)[:, None]
    return (marker[idx].mean(axis=1) > 0.5).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--broadcast", default="bench_out/real_broadcast.wav")
    ap.add_argument("--annot", default="bench_out/real_broadcast_speech.csv")
    ap.add_argument("--patch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from sm_hpss_mtl_tpu.cli.segment import _featurize_broadcast
    from sm_hpss_mtl_tpu.data.audio import read_wav
    from sm_hpss_mtl_tpu.eval.metrics import get_performance
    from sm_hpss_mtl_tpu.eval.segment import (StreamingSegmenter,
                                              interval_annotations_to_markers,
                                              read_interval_csv)
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.ops.patches import standardize_rows
    from sm_hpss_mtl_tpu.train import (TrainState, for_model, make_predict,
                                       restore_checkpoint)
    from sm_hpss_mtl_tpu.train.config import MODEL_PRESETS
    from sm_hpss_mtl_tpu.train.transfer import transfer_learn

    preset = MODEL_PRESETS["Lemaire_et_al_MTL"]
    x, sr = read_wav(args.broadcast)
    assert sr == SR
    radio = radio_channel(np.asarray(x))
    fv = _featurize_broadcast(radio, dict(preset))     # (D, T)
    T = fv.shape[1]
    rows = read_interval_csv(args.annot)
    marker = interval_annotations_to_markers(rows, T).astype(int)

    spec = get_model("Lemaire_et_al_MTL", n_mels=120)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=1000)
    W = args.patch_size
    template = TrainState.create(
        spec.module, opt, jnp.zeros((2, W, fv.shape[0])),
        jax.random.PRNGKey(0))
    state, _ = restore_checkpoint(args.ckpt, template)
    predict = make_predict(spec.module)

    def score(st, lo, hi):
        seg = StreamingSegmenter(
            predict_fn=lambda b: predict(st, b), patch_size=W,
            chunk_frames=2000, input_kind="time_mel",
            feat_name=preset["feat_name"])
        _, labels, _ = seg.segment(fv[:, lo:hi], head="S", smooth_win=501)
        ref = marker[lo:hi][:len(labels)]
        conf, prec, rec, f1 = get_performance(labels, ref, [0, 1])
        return {"precision": round(float(prec[1]), 4),
                "recall": round(float(rec[1]), 4),
                "f1": round(float(f1[1]), 4)}

    half = T // 2
    zero_shot = score(state, half, T)

    # fine-tuning stream from the FIRST half: slab-standardized windows,
    # class-balanced, S-head-only loss (the other heads get zero weight —
    # the reference cuts the model to one head, DAFx12_...py:518-523).
    half_fv = np.asarray(standardize_rows(fv[:, :half]))
    wins = np.stack([half_fv[:, s:s + W]
                     for s in range(0, half - W, W // 2)])   # (N, D, W)
    wl = window_labels(marker[:half], W, W // 2)[:len(wins)]
    pos, neg = np.nonzero(wl == 1)[0], np.nonzero(wl == 0)[0]
    rng = np.random.default_rng(0)

    def batches():
        while True:
            p = rng.choice(pos, 8)
            n = rng.choice(neg, 8)
            idx = np.concatenate([p, n])
            xb = jnp.asarray(np.transpose(wins[idx], (0, 2, 1)))
            yb = jnp.asarray(wl[idx])
            dummy = {"S": yb, "M": jnp.zeros_like(yb),
                     "R": jnp.zeros((16, 2), jnp.float32),
                     "3C": jnp.zeros((16, 3), jnp.float32)}
            yield xb, dummy

    result = transfer_learn(
        spec.module, opt, state, batches(), batches(), mtl=True,
        epochs=args.epochs, steps_per_epoch=args.steps, val_steps=4,
        loss_weights={"S": 1.0, "M": 0.0, "R": 0.0, "3C": 0.0})
    tuned = score(result.state, half, T)

    report = {"channel": "butter bandpass 250-4500 Hz + tanh compression "
                         "+ -40 dBFS noise",
              "held_out": "second half of the 200-s broadcast",
              "zero_shot": zero_shot, "fine_tuned": tuned,
              "epochs": args.epochs, "steps_per_epoch": args.steps}
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
