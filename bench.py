"""Headline benchmark: HPSS featurization throughput on one GPU.

Measures the flagship feature pipeline — STFT -> HPSS -> mel -> log
(LogMelHarmPercSpec, the proposed-work configuration) — in audio-hours
processed per second on the GPU, against a single-thread CPU baseline
running the numpy/scipy golden implementation of the same librosa
algorithms (the reference's compute path).

Prints ONE json line:
  {"metric": ..., "value": N, "unit": "audio_hours_per_sec",
   "vs_baseline": N, "device": {...}}
where vs_baseline is the speedup over the CPU baseline.  The card's
name and power limit go to stderr.  Exits non-zero without a GPU.

Timing uses chained-iteration differencing (utils/benchmarking.py).
"""

import json
import statistics
import sys
import time

import numpy as np

import jax.numpy as jnp


def featurize_step():
    from sm_hpss_mtl_tpu.ops import featuregram as fg

    def step(audio):
        fv = fg.featuregram(audio, feat_name="LogMelHarmPercSpec",
                            n_mels=120)
        # Data-dependent carry with the input's shape: fold features back
        # into an audio-shaped perturbation so iterations chain.
        delta = jnp.mean(fv, axis=(-2, -1), keepdims=False)[..., None]
        return audio + 1e-6 * delta

    return step


def cpu_baseline_seconds(audio_np: np.ndarray) -> float:
    """Single-thread numpy/scipy featurization of one batch item
    (min of 3 runs to shed scheduler noise)."""
    from sm_hpss_mtl_tpu.ops import reference as ref

    x = audio_np[0]
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        S = ref.stft_mag(x, 400, 400, 160)
        H, P = ref.hpss(S, 21, 11)
        fH = ref.power_to_db(ref.melspectrogram_from_S(H, 120) ** 2)
        fP = ref.power_to_db(ref.melspectrogram_from_S(P, 120) ** 2)
        np.concatenate([fH, fP], axis=0)
        best = min(best, time.perf_counter() - t0)
    return best * audio_np.shape[0]  # batch-equivalent


def main():
    from sm_hpss_mtl_tpu.utils import enable_compile_cache
    from sm_hpss_mtl_tpu.utils.benchmarking import time_op
    from sm_hpss_mtl_tpu.utils.device import (card_line, device_report,
                                              require_gpu)

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    enable_compile_cache()
    dev = require_gpu()
    note(f"device: {dev.device_kind}; card: {card_line()}")

    B, seconds = 16, 30.0
    fs = 16000
    rng = np.random.default_rng(0)
    audio_np = rng.standard_normal((B, int(seconds * fs))).astype(np.float32)
    audio = jnp.asarray(audio_np)
    audio_hours = B * seconds / 3600.0
    step = featurize_step()

    # Metric semantics: BEST-OBSERVED throughput (min time), consistent
    # with the min-over-repeats policy inside time_op; the median of
    # adjacent pairs is reported beside it as the sustained figure.
    # Geometry curve: the headline B16 x 30 s plus B32 x 30 s and
    # B16 x 120 s, measured interleaved within each round.
    geos = {"32x30": (32, 30.0), "16x120": (16, 120.0)}
    geo_audio = {
        name: (jnp.asarray(rng.standard_normal(
                   (gb, int(gs * fs))).astype(np.float32)),
               gb * gs / 3600.0)
        for name, (gb, gs) in geos.items()}

    rounds, sustained = [], []
    geo_rounds = {name: {"min": [], "median": []} for name in geos}
    for r in range(2):
        rounds.append(time_op(step, audio, iters=(3, 13), repeats=4))
        note(f"round {r}: {audio_hours / rounds[-1]:.1f} h/s")
        sustained.append(time_op(step, audio, iters=(3, 13), repeats=4,
                                 stat="median"))
        note(f"round {r} sustained: "
             f"{audio_hours / sustained[-1]:.1f} h/s")
        for name, (ga, gh) in geo_audio.items():
            geo_rounds[name]["min"].append(
                gh / time_op(step, ga, iters=(3, 13), repeats=4))
            geo_rounds[name]["median"].append(
                gh / time_op(step, ga, iters=(3, 13), repeats=4,
                             stat="median"))
            note(f"round {r} {name}: {geo_rounds[name]['min'][-1]:.1f} h/s "
                 f"(sustained {geo_rounds[name]['median'][-1]:.1f})")
    throughput = audio_hours / min(rounds)

    note("device rounds done; running CPU baseline")
    t_cpu = cpu_baseline_seconds(audio_np)
    cpu_throughput = audio_hours / t_cpu

    print(json.dumps({
        "metric": "hpss_featurize_throughput",
        "value": round(throughput, 2),
        "unit": "audio_hours_per_sec",
        "vs_baseline": round(throughput / cpu_throughput, 1),
        "rounds": [round(audio_hours / t, 2) for t in rounds],
        "value_sustained_median": round(
            audio_hours / statistics.median(sustained), 2),
        "rounds_sustained": [round(audio_hours / t, 2)
                             for t in sustained],
        "geometries": {
            "16x30": {"value": round(throughput, 2),
                      "value_sustained_median": round(
                          audio_hours / statistics.median(sustained), 2)},
            **{name: {
                "value": round(max(v["min"]), 2),
                "value_sustained_median": round(
                    statistics.median(v["median"]), 2),
                "rounds": [round(x, 2) for x in v["min"]]}
               for name, v in geo_rounds.items()},
        },
        "device": device_report(),
    }))


if __name__ == "__main__":
    main()
