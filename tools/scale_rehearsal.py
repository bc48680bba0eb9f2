"""Reference-scale dress rehearsal.

Quality runs elsewhere are 15-40 epochs x 20-30 steps at batch 8, while
the reference derives ~10^3-10^4 steps/epoch from corpus duration
(``/root/reference/Proposed_Work_Results.py:816-831``).  This tool is
the at-scale run:

1. Synthesizes a MUSAN-shaped corpus (hundreds of files per class,
   variable minute-scale durations, ~25 h total with the synthesized
   speech+music class) under ``--root``.
2. Builds the real CV folds (genre/gender stratification, SMR-cycled
   pair synthesis) and derives TR/V/TS steps from duration exactly as
   the reference does (``with_steps_from_durations``).
3. Runs one full fold of Lemaire-MTL at reference geometry (batch
   16/class = 48, W=68, n_mels=120, 50-epoch budget with the
   reference's early stopping) through BOTH pipelines, in separate
   processes, measuring per-epoch wall clock (fold log), sustained
   steps/s over whole epochs (not microbenchmarks), cache behavior
   (featuregram mem/disk/compute counters, patch-LRU hit/miss/evict),
   and test accuracy.
4. Writes one JSON report (default ``bench_out/scale_rehearsal.json``).

    python tools/scale_rehearsal.py
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_MUSIC = 300            # ~5 h  at 30-90 s/file
N_SPEECH = 300           # ~10 h at 60-180 s/file
# speech+music inherits speech's duration in the fold accounting
# (cross_validation_info/musan/details.txt convention) -> ~25 h total.


def ensure_corpus(root: str, n_music: int = N_MUSIC,
                  n_speech: int = N_SPEECH, dur_scale: float = 1.0) -> str:
    from sm_hpss_mtl_tpu.data import make_toy_musan
    if os.path.exists(os.path.join(root, "music")):
        return root
    t0 = time.time()
    # Per-class counts/durations: music files shorter on average than
    # speech recordings, like MUSAN.
    make_toy_musan(root, n_per_class=n_music,
                   duration_s=(30.0 * dur_scale, 90.0 * dur_scale),
                   seed=11, only=("music",))
    make_toy_musan(root, n_per_class=n_speech,
                   duration_s=(60.0 * dur_scale, 180.0 * dur_scale),
                   seed=12, only=("speech",))
    print(f"corpus synthesized in {time.time() - t0:.0f} s", flush=True)
    return root


def run_pipeline(root: str, pipeline: str, epochs: int,
                 model: str = "Lemaire_et_al_MTL") -> dict:
    from sm_hpss_mtl_tpu.cli.experiment import run_experiment
    from sm_hpss_mtl_tpu.train import ExperimentConfig
    from sm_hpss_mtl_tpu.utils.device import device_report

    tag = pipeline if model == "Lemaire_et_al_MTL" else \
        f"{pipeline}_{model}"
    cfg = ExperimentConfig(
        model=model, data_root=root,
        feature_dir=os.path.join(root, "features_" + tag
                                 if pipeline == "device" else "features"),
        output_dir=os.path.join(root, "results_" + tag),
        epochs=epochs, batch_size=16, patch_size=68, patch_shift=68,
        pipeline=pipeline, seed=0)
    t0 = time.time()
    out = run_experiment(cfg, folds=[0], verbose=True, resume=False)[0]
    wall_total = time.time() - t0

    # Derived step counts actually used (run_experiment recomputes from
    # durations; recompute here the same way for the report).
    from sm_hpss_mtl_tpu.cli.experiment import load_or_create_folds
    cv = load_or_create_folds(cfg)
    keep = {"music", "speech", "speech+music"}
    cfg_steps = cfg.with_steps_from_durations(
        {k: v for k, v in cv["total_duration"].items() if k in keep})

    log_path = os.path.join(out["op_dir"], "fold0_log.csv")
    with open(log_path) as f:
        epochs_rows = list(csv.DictReader(f))
    epoch_s = [float(r["epoch_train_s"]) for r in epochs_rows]
    warm = epoch_s[1:] or epoch_s
    fit = out["fit"]
    row = {
        "pipeline": pipeline,
        "model": model,
        "tr_steps": cfg_steps.tr_steps, "v_steps": cfg_steps.v_steps,
        "ts_steps": cfg_steps.ts_steps,
        "corpus_hours": round(sum(
            v for k, v in cv["total_duration"].items() if k in keep), 2),
        "epochs_run": len(epochs_rows),
        "stopped_early": bool(fit.stopped_early),
        "epoch_train_s": [round(t, 1) for t in epoch_s],
        "first_epoch_s": round(epoch_s[0], 1),
        "warm_epoch_s_median": round(sorted(warm)[len(warm) // 2], 1),
        "sustained_steps_per_s_warm": round(
            cfg_steps.tr_steps / sorted(warm)[len(warm) // 2], 1),
        "steps_per_s_overall": round(
            cfg_steps.tr_steps * len(epochs_rows) / sum(epoch_s), 1),
        "train_wall_s": round(fit.wall_time, 1),
        "train_process_s": round(fit.training_time, 1),
        "total_wall_s": round(wall_total, 1),
        "accuracy": out["row"]["accuracy"],
        "gen_accuracy": out["row"].get("gen_accuracy"),
        "val_loss": out["row"]["val_loss"],
        "cache_stats": out["cache_stats"],
        "device": device_report(),
    }
    print(json.dumps(row))
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, "bench_out",
                                                 "scale_rehearsal.json"))
    p.add_argument("--root", default=os.path.join(REPO, "bench_out",
                                                  "scale_corpus"))
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--pipelines", nargs="*", default=["host", "device"])
    p.add_argument("--model", default="Lemaire_et_al_MTL",
                   help="model family for this rehearsal (e.g. a CNN "
                        "fold: Doukhan_et_al_MTL)")
    p.add_argument("--merge", action="store_true",
                   help="merge rows into an existing --out report "
                        "instead of overwriting it")
    p.add_argument("--n-music", type=int, default=N_MUSIC)
    p.add_argument("--n-speech", type=int, default=N_SPEECH)
    p.add_argument("--dur-scale", type=float, default=1.0,
                   help="scale factor on per-file durations (smoke runs)")
    p.add_argument("--child", default=None, help="internal: one pipeline")
    args = p.parse_args(argv)

    ensure_corpus(args.root, args.n_music, args.n_speech, args.dur_scale)

    if args.child:
        from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache
        from sm_hpss_mtl_tpu.utils.device import require_gpu
        enable_compile_cache()
        require_gpu()
        run_pipeline(args.root, args.child, args.epochs, args.model)
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    report = {"geometry": "Lemaire_et_al_MTL, batch 16/class=48, W=68, "
                          "n_mels=120, LogMelHarmPercSpec",
              "epoch_budget": args.epochs,
              "corpus": f"{N_MUSIC} music x 30-90 s + {N_SPEECH} speech "
                        "x 60-180 s + SMR-cycled speech+music pairs",
              "methodology": (
                  "one full CV fold per pipeline, separate processes; "
                  "steps derived from corpus duration exactly like the "
                  "reference (Proposed_Work_Results.py:816-831); "
                  "per-epoch wall clock from the fold log; sustained "
                  "steps/s = tr_steps / median warm-epoch time"),
              "pipelines": {}}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            report["pipelines"] = json.load(f).get("pipelines", {})
    for pipeline in args.pipelines:
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               pipeline, "--root", args.root, "--epochs",
               str(args.epochs), "--model", args.model]
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=14000)
        if proc.returncode != 0:
            raise RuntimeError(f"child {pipeline} failed\n"
                               f"{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        key = (pipeline if args.model == "Lemaire_et_al_MTL"
               else f"{pipeline}_{args.model}")
        report["pipelines"][key] = row
        print(pipeline, "->", {k: row[k] for k in
                               ("epochs_run", "first_epoch_s",
                                "warm_epoch_s_median",
                                "sustained_steps_per_s_warm",
                                "accuracy")}, flush=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print("->", args.out)


if __name__ == "__main__":
    main()
