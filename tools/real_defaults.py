"""Run the device pipeline on the real-audio corpus at its DEFAULTS.

On a small corpus, packing several patches per sampled clip
(``clip_patches=2``) starves each step of clip diversity and folds
early-stop collapse; ``clip_patches=0`` (adaptive, the default) resolves
to 1 for corpora whose smallest training class has <8*batch clips.
This tool runs the real-audio protocol (corpus from the reference's own
demo audio, 3 folds, 40 epochs x 30 steps, batch 8, patch 32/16,
seed 0, ``--pipeline device``) with NO clip_patches override and writes
the resolved setting and fold accuracies as ``device_pipeline_defaults``
— whether a user running defaults gets the diverse regime.

    python tools/real_defaults.py
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    work = os.path.join(REPO, "bench_out", "real_defaults")
    ap.add_argument("--root", default=os.path.join(work, "real_musan"))
    ap.add_argument("--work", default=work)
    ap.add_argument("--out", default=os.path.join(work, "real_defaults.json"))
    ap.add_argument("--epochs", type=int, default=40)
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.root, "music")):
        from tools.real_corpus import main as build
        build(["--out", args.root])

    from sm_hpss_mtl_tpu.cli.experiment import (resolve_clip_patches,
                                                run_experiment)
    from sm_hpss_mtl_tpu.train import ExperimentConfig
    from sm_hpss_mtl_tpu.utils.device import device_report

    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=args.root,
        feature_dir=os.path.join(args.work, "features"),
        output_dir=os.path.join(args.work, "results"),
        epochs=args.epochs, batch_size=8, patch_size=32, patch_shift=16,
        tr_steps=30, v_steps=8, lr_schedule_steps=100000,
        pipeline="device", seed=0)   # clip_patches stays the default (0)
    assert cfg.clip_patches == 0
    # Record what the adaptive default actually resolves to on this
    # corpus (fold-0 training split).
    from sm_hpss_mtl_tpu.cli.experiment import (_class_subset,
                                                class_names_for,
                                                load_or_create_folds,
                                                split_train_val)
    from sm_hpss_mtl_tpu.data import get_train_test_files
    cv = load_or_create_folds(cfg)
    tr, _ = get_train_test_files(cv, 0, class_names=class_names_for(3))
    trs, _ = split_train_val(_class_subset(tr, 3), seed=cfg.seed)
    resolved = resolve_clip_patches(cfg, trs)

    outs = run_experiment(cfg, folds=[0, 1, 2], verbose=True, resume=False)
    accs = [o["row"]["accuracy"] for o in outs]
    epochs_run = [o["row"]["epochs_run"] for o in outs]

    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
    report["device_pipeline_defaults"] = {
        "what": "Real-audio protocol at the DEFAULTS: clip_patches=0 "
                "resolves adaptively (smallest training class < 8*batch "
                "clips -> 1 patch per clip, max per-step clip diversity).",
        "device": device_report(),
        "resolved_clip_patches": resolved,
        "fold_accuracies": [round(a, 4) for a in accs],
        "mean": round(sum(accs) / len(accs), 4),
        "epochs_run": epochs_run,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["device_pipeline_defaults"], indent=1))


if __name__ == "__main__":
    main()
