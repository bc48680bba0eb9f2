"""Matched host-vs-device pipeline quality A/B.

Runs the SAME toy corpus, seeds, folds and epoch budget through:

  A. --pipeline host     (reference-parity patch batching)
  B. --pipeline device   (fused audio->features->train)

and writes per-fold test accuracy + macro-F1 for each arm to one JSON
report.  Identical data, identical label semantics knobs, only the
pipeline varies.  The
device pipeline's *sampling* semantics still differ by design (random
clip crops vs whole-file sweeps; crop-local standardization; clip-level
labels — ``data/audiostream.py:11-26``); this experiment measures
whether those deltas cost model quality.

    python tools/ab_pipeline.py --out bench_out/ab_pipeline.json
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARMS = {
    "host": ["--pipeline", "host"],
    "device": ["--pipeline", "device"],
}


def run_arm(name, extra, root, out_base, epochs, seed):
    out_dir = os.path.join(out_base, name)
    cmd = [sys.executable, "-m", "sm_hpss_mtl_tpu.cli.mtl",
           "--data", root,
           "--features", os.path.join(out_base, "feat_" + name),
           "--output", out_dir,
           "--epochs", str(epochs), "--batch-size", "8",
           "--patch-size", "32", "--patch-shift", "16",
           "--tr-steps", "20", "--v-steps", "4",
           "--lr-schedule-steps", "100000",
           "--seed", str(seed)] + extra
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=7200)
    if proc.returncode != 0:
        raise RuntimeError(f"arm {name} failed\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    perf = os.path.join(out_dir, "Lemaire_et_al_MTL", "LogMelHarmPercSpec",
                        "Performance.csv")
    folds = []
    with open(perf) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            vals = dict(zip(header, line.rstrip("\n").split("\t")))
            f1s = [float(v) for k, v in vals.items()
                   if k.startswith("F1_") and v]
            folds.append({
                "fold": int(vals["fold"]),
                "accuracy": float(vals["accuracy"]),
                "macro_f1": round(sum(f1s) / len(f1s), 4) if f1s else None,
                "per_class_f1": {k: round(float(v), 4)
                                 for k, v in vals.items()
                                 if k.startswith("F1_")},
            })
    return folds


def main(argv=None):
    ap = argparse.ArgumentParser()
    work = os.path.join(REPO, "bench_out", "ab_pipeline")
    ap.add_argument("--out", default=os.path.join(work, "ab_pipeline.json"))
    ap.add_argument("--root", default=os.path.join(work, "toy"))
    ap.add_argument("--work", default=work)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", nargs="*", default=list(ARMS))
    ap.add_argument("--key-suffix", default="",
                    help="suffix for report arm keys (e.g. '_h100'), so "
                         "the same arm run on another device doesn't "
                         "overwrite")
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.root, "music")):
        sys.path.insert(0, REPO)
        from sm_hpss_mtl_tpu.data import make_toy_musan
        make_toy_musan(args.root, n_per_class=24, duration_s=4.0, seed=7)

    # Merge into an existing report so arms can be (re)run per device.
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
        report.setdefault("arms", {})
    else:
        report = {"corpus": "toy 24/class x 4 s (seed 7)",
                  "settings": {"epochs": args.epochs, "batch_size": 8,
                               "patch": "32/16", "tr_steps": 20,
                               "seed": args.seed},
                  "arms": {}}
    for name in args.arms:
        key = name + args.key_suffix
        folds = run_arm(key, ARMS[name], args.root, args.work,
                        args.epochs, args.seed)
        accs = [f["accuracy"] for f in folds if f["accuracy"] is not None]
        report["arms"][key] = {
            "folds": folds,
            # Per-arm run settings: merged reports can mix invocations, so
            # the top-level "settings" block only describes the original
            # run — each arm records the settings it actually ran with.
            "epochs": args.epochs,
            "seed": args.seed,
            "mean_accuracy": round(sum(accs) / len(accs), 4) if accs else None,
        }
        print(key, "->", report["arms"][key]["mean_accuracy"],
              [f["accuracy"] for f in folds], flush=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
