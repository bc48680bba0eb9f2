"""Streaming-segmentation serving benchmark.

The reference's multi-hour broadcast use case
(``/root/reference/DAFx12_Speech_Music_Detection_B3_MTL_v2.py:634-676``)
is implemented twice in ``eval/segment.py`` — the reference-parity slab
loop (10,000-frame chunks, shift-1 dense windows, host window
extraction) and the single-``lax.scan`` program (one dispatch per
broadcast, on-device window extraction).  Both are correctness-tested;
this tool measures their throughput on the GPU:

  * audio-hours/sec and real-time factor for the dense-prediction stage
    of each driver (warm, compile excluded; compile time reported),
  * the featurization stage of the same broadcast,
  * the combined serving rate (featurize + predict in sequence).

Timing: whole-pass wall clock around work that ends on the host (the
passes are seconds long), min + median over repeats.  Each leg runs in
its own subprocess, one at a time; the parent never touches the device,
so exactly one JAX process holds the card.

    python tools/bench_serving.py --out bench_out/serving_bench.json
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache

SR = 16000
HOP = 160
N_MELS = 120
W = 68
CHUNK = 10000  # the reference's slab size


def broadcast_audio(hours: float) -> np.ndarray:
    """Synthetic broadcast: alternating speech-ish (pulsed noise) and
    music-ish (tone stack) minutes, like the radio scenarios."""
    n = int(hours * 3600 * SR)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / SR
    tones = sum(np.sin(2 * np.pi * f * t) for f in (220.0, 330.0, 440.0))
    noise = rng.standard_normal(n).astype(np.float32)
    gate = (np.sin(2 * np.pi * t / 120.0) > 0).astype(np.float32)
    return (0.3 * tones * gate + 0.2 * noise * (1 - gate)).astype(np.float32)


def featuregram_of(audio: np.ndarray, device_out: bool = False):
    # Serving featurization = the slabbed fixed-shape path (at most two
    # compiled programs per config regardless of broadcast length; the
    # whole-signal featuregram would pay a fresh XLA compile per
    # distinct duration).  device_out keeps the featuregram on the
    # device for the serve_dev leg (only audio goes up, probabilities
    # come down).
    from sm_hpss_mtl_tpu.ops.featuregram import featuregram_slabbed
    return featuregram_slabbed(
        np.asarray(audio, np.float32), feat_name="LogMelHarmPercSpec",
        n_mels=N_MELS, device_out=device_out)


def make_segmenter(use_scan: bool):
    from sm_hpss_mtl_tpu.eval.segment import StreamingSegmenter
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model, make_predict

    spec = get_model("Lemaire_et_al_MTL")
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=1000)
    sample = jnp.zeros((2, W, 2 * N_MELS), jnp.float32)
    state = TrainState.create(spec.module, opt, sample,
                              jax.random.PRNGKey(0))
    predict = make_predict(spec.module)
    return StreamingSegmenter(
        predict_fn=lambda x: predict(state, x), patch_size=W,
        chunk_frames=CHUNK, input_kind="time_mel",
        feat_name="LogMelHarmPercSpec", use_scan=use_scan)


def timed(fn, repeats: int):
    """(first_s, [warm_s...]) — first call includes compilation."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        warm.append(time.perf_counter() - t0)
    return first, warm


def run_child(leg: str, hours: float, repeats: int):
    from sm_hpss_mtl_tpu.utils.device import device_report

    audio = broadcast_audio(hours)

    if leg == "featurize":
        def once():
            fv = featuregram_of(audio)
            return fv
        first, warm = timed(once, repeats)
        n_frames = 1 + (len(audio) - 400) // HOP
    elif leg == "serve_dev":
        # The device serving chain: slab-featurize with the featuregram
        # assembled ON DEVICE, scan segmentation over the resident
        # array, fetch only the probability tracks.
        seg = make_segmenter(use_scan=True)

        def once():
            fv = featuregram_of(audio, device_out=True)
            tracks = seg.frame_probabilities(fv)
            return {k: float(np.sum(v)) for k, v in tracks.items()}
        first, warm = timed(once, repeats)
        n_frames = 1 + (len(audio) - 400) // HOP
    else:
        seg = make_segmenter(use_scan=(leg == "scan"))
        fv = featuregram_of(audio)
        n_frames = fv.shape[1]

        def once():
            tracks = seg.frame_probabilities(fv)
            # Force completion of every head.
            return {k: float(np.sum(v)) for k, v in tracks.items()}
        first, warm = timed(once, repeats)

    best, med = min(warm), statistics.median(warm)
    row = {"leg": leg, "hours": hours, "n_frames": n_frames,
           "first_s": round(first, 3),
           "warm_s": [round(t, 3) for t in warm],
           "best_s": round(best, 3), "median_s": round(med, 3),
           "audio_h_per_s": round(hours / best, 3),
           "audio_h_per_s_median": round(hours / med, 3),
           "realtime_factor": round(hours * 3600 / best, 1),
           "device": device_report()}
    print(json.dumps(row))
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, "bench_out",
                                                 "serving_bench.json"))
    p.add_argument("--hours", type=float, nargs="*", default=[0.5, 2.0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--legs", default="featurize,loop,scan",
                   help="comma list; the slab loop ships W-fold "
                        "duplicated windows to the device — cap it to "
                        "short broadcasts")
    p.add_argument("--merge", action="store_true",
                   help="merge new legs into an existing --out report")
    p.add_argument("--child", default=None, help="internal: 'leg:hours'")
    args = p.parse_args(argv)

    enable_compile_cache()
    if args.child:
        from sm_hpss_mtl_tpu.utils.device import require_gpu
        require_gpu()
        leg, hours = args.child.split(":")
        run_child(leg, float(hours), args.repeats)
        return

    legs = [(leg, h) for h in args.hours
            for leg in args.legs.split(",")]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    samples = {}
    for r in range(args.rounds):
        for leg, hours in legs:
            child = f"{leg}:{hours}"
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   child, "--repeats", str(args.repeats)]
            proc = subprocess.run(cmd, cwd=REPO, env=env,
                                  capture_output=True, text=True,
                                  timeout=3600)
            if proc.returncode != 0:
                raise RuntimeError(f"child {child} failed\n"
                                   f"{proc.stdout[-2000:]}\n"
                                   f"{proc.stderr[-2000:]}")
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            samples.setdefault(child, []).append(row)
            print(f"round {r} {child}: best {row['best_s']} s "
                  f"({row['audio_h_per_s']} h/s, "
                  f"RTF {row['realtime_factor']})", flush=True)

    first = next(iter(samples.values()))[0]
    report = {"device": first["device"],
              "model": "Lemaire_et_al_MTL", "chunk_frames": CHUNK,
              "patch_shift": 1, "rounds": args.rounds, "legs": {},
              "methodology": (
                  "whole-pass wall clock (warm; first_s includes "
                  "compile), per-leg single-program subprocesses, "
                  "rounds interleaved; shift-1 dense prediction at the "
                  "reference chunk size")}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            report["legs"] = json.load(f).get("legs", {})
    for child, rows in samples.items():
        best = min(r["best_s"] for r in rows)
        med = statistics.median([r["median_s"] for r in rows])
        hours = rows[0]["hours"]
        report["legs"][child] = dict(
            rows[0], best_s=round(best, 3), median_s=round(med, 3),
            audio_h_per_s=round(hours / best, 3),
            audio_h_per_s_median=round(hours / med, 3),
            realtime_factor=round(hours * 3600 / best, 1),
            rounds_best_s=[r["best_s"] for r in rows])
    # Combined serving rate: featurize + predict in sequence.
    for h in args.hours:
        f = report["legs"].get(f"featurize:{h}")
        for drv in ("loop", "scan"):
            d = report["legs"].get(f"{drv}:{h}")
            if f and d:
                tot = f["best_s"] + d["best_s"]
                report["legs"][f"serve_{drv}:{h}"] = {
                    "leg": f"serve_{drv}", "hours": h,
                    "best_s": round(tot, 3),
                    "audio_h_per_s": round(h / tot, 3),
                    "realtime_factor": round(h * 3600 / tot, 1)}

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("->", args.out)


if __name__ == "__main__":
    main()
