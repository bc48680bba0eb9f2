"""Training-pipeline throughput benchmark — interleaved, process-isolated.

Measures, at the reference scale (48-patch steps, W=68):

  * host pipeline:   BalancedBatcher host ms/batch in BOTH cache regimes
    (patch-LRU hot — small corpora; patch-LRU cold — production MUSAN,
    whose 163 h cannot fit ``patch_cache_mb``) and the patch-batch
    device step time (flagship Lemaire-MTL),
  * device pipeline: AudioCropBatcher host ms/batch and the fused
    audio->features->train device step time for EVERY MTL model family
    (Lemaire / Doukhan / Papakostas / Jang, each with its own featName
    preset and optimizer),

and reports the steady-state steps/s of each (host and device legs
overlap through the prefetcher, so throughput = 1/max(leg)).

Methodology:

  1. *Interleave*: legs are sampled once per round, rounds cycling
     A/B/A/B, and the speedup is the median of per-round matched
     ratios, so a clock or power-state change hits both arms alike.
  2. *Isolate*: every device leg runs in its OWN subprocess holding
     exactly one compiled program, one at a time, with the shared
     persistent compilation cache (``utils.compile_cache``) so only
     round 0 pays the compiles.  The parent never touches the device,
     so one JAX process holds the card.

    python tools/bench_pipeline.py --out bench_out/pipeline_bench.json
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

MTL_MODELS = ("Lemaire_et_al_MTL", "Doukhan_et_al_MTL",
              "Papakostas_et_al_MTL", "Jang_et_al_MTL")
CLASSES = ["music", "speech", "speech+music"]


def host_ms_per_batch(it, n=20):
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) / n * 1e3


# ---------------------------------------------------------------------------
# Shared setup (parent and children)
# ---------------------------------------------------------------------------

def ensure_corpus(root):
    from sm_hpss_mtl_tpu.data import make_toy_musan
    from sm_hpss_mtl_tpu.data.folds import (create_cv_folds,
                                            get_train_test_files)
    if not os.path.exists(os.path.join(root, "music")):
        make_toy_musan(root, n_per_class=12, duration_s=12.0)
    cv = create_cv_folds(root, seed=0)
    files, _ = get_train_test_files(cv, 0, class_names=CLASSES)
    return files


def make_host_batcher(root, files, *, patch_cache_mb=512):
    from sm_hpss_mtl_tpu.data.batcher import BalancedBatcher, BatcherConfig
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig, Featurizer
    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=120)
    fz = Featurizer(cfg, cache_dir=os.path.join(root, "featcache"))
    bcfg = BatcherConfig(batch_size=16, patch_size=68, patch_shift=68,
                         feat_name=cfg.feat_name, input_kind="time_mel",
                         augment_noise=False, seed=0,
                         patch_cache_mb=patch_cache_mb)
    return iter(BalancedBatcher(fz, root, files, bcfg)), cfg


def make_crop_batcher(root, files, cfg):
    from sm_hpss_mtl_tpu.data.audiostream import AudioCache, AudioCropBatcher
    cache = AudioCache(cache_dir=os.path.join(root, "audiocache"))
    return AudioCropBatcher(cache, root, files, cfg, clips_per_class=4,
                            n_patches_per_clip=4, patch_size=68, seed=0)


# ---------------------------------------------------------------------------
# Child: measure ONE device leg in a pristine single-program process
# ---------------------------------------------------------------------------

def run_child_leg(leg, root):
    import jax
    import jax.numpy as jnp
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.config import ExperimentConfig
    from sm_hpss_mtl_tpu.train.endtoend import (device_featurize_patches,
                                                make_audio_train_step)
    from sm_hpss_mtl_tpu.train.state import make_train_step
    from sm_hpss_mtl_tpu.utils.benchmarking import time_op

    files = ensure_corpus(root)
    rng = jax.random.PRNGKey(0)

    if leg == "host_step":
        host_it, _ = make_host_batcher(root, files)
        x, labels = next(host_it)
        x = jnp.asarray(x)
        labels = {k: jnp.asarray(v) for k, v in labels.items()}
        spec = get_model("Lemaire_et_al_MTL")
        opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=14000)
        state = TrainState.create(spec.module, opt, x, rng)
        step = make_train_step(spec.module, opt, mtl=True,
                               augment_noise=True)

        def carry(c):
            st, xx = c
            st2, m = step(st, xx, labels, rng)
            return (st2, xx * (1.0 + 1e-12 * m["loss"]))

        carry0 = carry((state, x))
    else:
        assert leg.startswith("fused_")
        model = leg[len("fused_"):]
        mcfg = ExperimentConfig(model=model).feature_config()
        mels_kw = {"n_mels": mcfg.n_mels} if mcfg.n_mels > 0 else {}
        mspec = get_model(model, **mels_kw)
        mopt, _ = for_model(model, tr_steps=14000)
        kind = "time_mel" if model.startswith("Lemaire") else "image"
        mb = make_crop_batcher(root, files, mcfg)
        audio, clabels = next(iter(mb))
        audio = jnp.asarray(audio)
        clabels = {k: jnp.asarray(v) for k, v in clabels.items()}
        sample = device_featurize_patches(audio, mcfg, patch_size=68,
                                          patch_shift=68, input_kind=kind)
        state = TrainState.create(mspec.module, mopt, sample, rng)
        astep = make_audio_train_step(mspec.module, mopt, mcfg,
                                      patch_size=68, patch_shift=68,
                                      mtl=True, augment_noise=True,
                                      input_kind=kind)

        def carry(c):
            st, aa = c
            st2, m = astep(st, aa, clabels, rng)
            return (st2, aa * (1.0 + 1e-12 * m["loss"]))

        carry0 = carry((state, audio))

    t = time_op(carry, carry0, iters=(2, 10), repeats=3)
    if t * 1e3 < 0.05:
        t = time_op(carry, carry0, iters=(10, 110), repeats=3)
    from sm_hpss_mtl_tpu.utils.device import device_report
    print(json.dumps({"leg": leg, "ms": round(t * 1e3, 3),
                      "device": device_report()}))


def measure_leg_subprocess(leg, root, timeout=900):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", leg,
           "--root", root]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"leg {leg} failed\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["leg"] == leg
    return row


# ---------------------------------------------------------------------------
# Parent: interleaved rounds over isolated legs
# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, "bench_out",
                                                 "pipeline_bench.json"))
    p.add_argument("--root", default=os.path.join(REPO, "bench_out",
                                                  "pipe_bench_corpus"))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--child", default=None, help="internal: measure one leg")
    args = p.parse_args(argv)

    from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.child:
        from sm_hpss_mtl_tpu.utils.device import require_gpu
        require_gpu()
        run_child_leg(args.child, args.root)
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    # The parent's own JAX work (featurizing the corpus for the host
    # batchers' caches) runs on the CPU, so the children, which time the
    # device legs one at a time, each find the card free.
    import jax
    jax.config.update("jax_platforms", "cpu")
    files = ensure_corpus(args.root)

    # Warm the host caches once (audio crops are host-side).
    host_hot, cfg = make_host_batcher(args.root, files)
    host_ms_per_batch(host_hot, n=5)
    host_cold, _ = make_host_batcher(args.root, files, patch_cache_mb=0)
    host_ms_per_batch(host_cold, n=5)
    dev_it = iter(make_crop_batcher(args.root, files, cfg))
    host_ms_per_batch(dev_it, n=5)

    device_legs = ["host_step"] + [f"fused_{m}" for m in MTL_MODELS]
    report = {
        "batch_patches": 48, "patch_size": 68, "rounds": args.rounds,
        "methodology": "interleaved rounds (median per leg; speedup = "
                       "median of per-round matched ratios); every device "
                       "leg measured in its own single-program subprocess, "
                       "one at a time, with a shared persistent compile "
                       "cache",
    }

    samples = {"host_batcher_ms": [], "host_batcher_cold_ms": [],
               "device_host_ms": []}
    for leg in device_legs:
        samples[leg + "_ms"] = []
    for r in range(args.rounds):
        samples["host_batcher_ms"].append(host_ms_per_batch(host_hot))
        samples["host_batcher_cold_ms"].append(host_ms_per_batch(host_cold))
        samples["device_host_ms"].append(host_ms_per_batch(dev_it))
        for leg in device_legs:
            row = measure_leg_subprocess(leg, args.root)
            report["device"] = row["device"]
            ms = row["ms"]
            samples[leg + "_ms"].append(ms)
            print(f"round {r} {leg}: {ms} ms", flush=True)
        # Checkpoint raw samples after every round so a timeout doesn't
        # lose the completed rounds.
        with open(args.out + ".partial", "w") as f:
            json.dump({"completed_rounds": r + 1, "samples": samples}, f)

    for k, v in samples.items():
        report[k] = round(statistics.median(v), 3)
        report[k + "_samples"] = [round(s, 3) for s in v]

    # Per-round matched speedups (flagship model), both host regimes.
    flag = "fused_Lemaire_et_al_MTL_ms"
    for regime, host_key in (("hot", "host_batcher_ms"),
                             ("cold", "host_batcher_cold_ms")):
        per_round = []
        for r in range(args.rounds):
            host_bound = max(samples[host_key][r],
                             samples["host_step_ms"][r])
            dev_bound = max(samples["device_host_ms"][r], samples[flag][r])
            per_round.append(host_bound / dev_bound)
        report[f"speedup_per_round_{regime}"] = [round(s, 2)
                                                 for s in per_round]
        report[f"speedup_{regime}"] = round(statistics.median(per_round), 2)

    report["host_steps_per_s"] = round(
        1e3 / max(report["host_batcher_ms"], report["host_step_ms"]), 1)
    report["host_steps_per_s_cold"] = round(
        1e3 / max(report["host_batcher_cold_ms"], report["host_step_ms"]), 1)
    report["device_steps_per_s"] = round(
        1e3 / max(report["device_host_ms"], report[flag]), 1)
    for m in MTL_MODELS:
        report[f"device_steps_per_s_{m}"] = round(
            1e3 / max(report["device_host_ms"], report[f"fused_{m}_ms"]), 1)
    # No bare "speedup" key: earlier artifacts used it for the hot
    # single-regime ratio, so redefining it to the cold regime would make
    # cross-run comparisons silently compare different quantities.  The
    # explicit speedup_hot / speedup_cold keys are the report.

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
