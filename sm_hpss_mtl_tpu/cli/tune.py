"""Hyperparameter tuning drivers.

Two modes, covering three reference scripts:

- ``--mode grid``: sweep ONE hyperparameter over the reference's ranges
  (``/root/reference/Hyperparameter_Selection.py:541-552``): n_mels
  [20..120], l_harm/l_perc [11..51], W [25..100], loss_weights presets —
  one short training per value on fold 0.
- ``--mode search``: search over the TCN architecture space
  (``B3_architecture_tuning.py:251-259``: kernel_size 3..19 odd, Nd 3..8,
  nb_stacks 3..10, n_layers folded into stacks, n_filters {8,16,32},
  skip connections) or over the MTL head shapes
  (``B3_MTL_architecture_tuning.py:326-334``: per-head layers 1..3,
  widths {16,32,64,128}) with ``--space {arch,mtl-heads}``.  Both of the
  reference tuner's algorithms (``B3_architecture_tuning.py:251-289``)
  are available via ``--algo {random,bayes}``; bayes is GP expected
  improvement (``utils/bayesopt.py``), seeded and deterministic.

Results go to a tab-separated Tuning.csv; the best setting is printed.

    python -m sm_hpss_mtl_tpu.cli.tune --data corpus --mode grid --param l_harm
    python -m sm_hpss_mtl_tpu.cli.tune --data corpus --mode search \\
        --space arch --trials 20
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from ..train import ExperimentConfig
from ..utils.compile_cache import enable_compile_cache
from ..utils.results import append_results
from .experiment import run_experiment

GRID_RANGES = {
    "n_mels": [20, 40, 60, 80, 100, 120],
    "l_harm": [11, 21, 31, 41, 51],
    "l_perc": [11, 21, 31, 41, 51],
    "W": [25, 50, 75, 100],
    "loss_weights": [
        {"3C": 0.4, "R": 0.2, "M": 0.2, "S": 0.2},
        {"3C": 0.2, "R": 0.4, "M": 0.2, "S": 0.2},
        {"3C": 0.2, "R": 0.2, "M": 0.4, "S": 0.2},
        {"3C": 0.2, "R": 0.2, "M": 0.2, "S": 0.4},
    ],
}


def _apply_grid_value(cfg: ExperimentConfig, param: str, value):
    if param == "n_mels":
        return dataclasses.replace(cfg, n_mels_override=int(value))
    if param == "l_harm":
        return dataclasses.replace(cfg, l_harm=int(value))
    if param == "l_perc":
        return dataclasses.replace(cfg, l_perc=int(value))
    if param == "W":
        v = int(value)
        return dataclasses.replace(cfg, patch_size=v, patch_shift=v,
                                   test_patch_shift=v)
    if param == "loss_weights":
        return dataclasses.replace(cfg, loss_weights=value)
    raise ValueError(param)


def search_space(space: str) -> dict:
    from ..utils.bayesopt import ARCH_SPACE, MTL_HEADS_SPACE
    if space == "arch":
        return ARCH_SPACE
    if space == "mtl-heads":
        return MTL_HEADS_SPACE
    raise ValueError(space)


def sample_arch(rng: np.random.Generator, space: str) -> dict:
    return {k: (v[rng.integers(len(v))])
            for k, v in search_space(space).items()}


def run_vmapped_trials(base: ExperimentConfig, trials: list[dict],
                       fold: int, verbose: bool = False,
                       mesh=None) -> list[dict]:
    """Train all shape-invariant ``trials`` in ONE vmapped program
    (``train/multitrial.py``) sharing a single host batch stream — the
    vectorized replacement for the reference's sequential loss-weight
    grid (``Hyperparameter_Selection.py:541-552``) and for seed-replicate
    variance runs.  Host pipeline, single mesh device.
    """
    from ..data import BalancedBatcher, BatcherConfig, Featurizer
    from ..data.folds import get_train_test_files
    from ..models import get_model
    from ..train import for_model
    from ..train.multitrial import fit_multi
    from .experiment import (_class_subset, class_names_for,
                             load_or_create_folds, split_train_val)

    cv_file_list = load_or_create_folds(base)
    if not base.tr_steps:
        keep = set(class_names_for(base.n_classes))
        base = base.with_steps_from_durations(
            {k: v for k, v in cv_file_list["total_duration"].items()
             if k in keep})

    preset_mels = base.feature_config().n_mels
    mels_kw = {"n_mels": preset_mels} if preset_mels > 0 else {}
    spec = get_model(base.model, n_classes=base.n_classes,
                     dropout_rate=base.dropout_rate, **mels_kw,
                     **(base.arch_kwargs or {}))
    if spec.input_kind == "dual":
        raise ValueError("vmapped trials do not support dual-tower models")
    feat_cfg = base.feature_config()
    cache_dir = (os.path.join(base.feature_dir, base.model,
                              feat_cfg.feat_name)
                 if base.feature_dir else None)
    fz = Featurizer(feat_cfg, cache_dir=cache_dir)
    train_files, _ = get_train_test_files(
        cv_file_list, fold, class_names=class_names_for(base.n_classes))
    train_files = _class_subset(train_files, base.n_classes)
    tr_files, va_files = split_train_val(train_files, seed=base.seed)
    bcfg = BatcherConfig(
        batch_size=base.batch_size, patch_size=base.patch_size,
        patch_shift=base.patch_shift, feat_name=feat_cfg.feat_name,
        input_kind=base.input_kind, augment_noise=False, seed=base.seed)

    def _label_map(it):
        for x, labels in it:
            yield (x, labels) if spec.mtl else (x, labels["3C"])

    train_iter = _label_map(BalancedBatcher(fz, base.data_root, tr_files,
                                            bcfg))
    val_iter = _label_map(
        BalancedBatcher(fz, base.data_root, va_files,
                        dataclasses.replace(bcfg, seed=base.seed + 1)))
    optimizer, _ = for_model(base.model,
                             tr_steps=max(base.lr_schedule_steps
                                          or base.tr_steps, 1))
    sample_batch, _ = next(train_iter)
    result = fit_multi(
        spec.module, optimizer, train_iter, val_iter, mtl=spec.mtl,
        trials=trials, heads=spec.heads or None, sample_batch=sample_batch,
        epochs=base.epochs, steps_per_epoch=base.tr_steps,
        val_steps=max(base.v_steps, 1), l2_reg=base.l2_reg,
        base_seed=base.seed, mesh=mesh, verbose=verbose)
    rows = []
    for i, trial in enumerate(trials):
        rows.append({"trial": i, **{k: str(v) for k, v in trial.items()},
                     "val_loss": float(result.best_val_loss[i]),
                     "accuracy": float(result.best_accuracy[i]),
                     "best_epoch": int(result.best_epoch[i])})
    return rows


def _score(cfg: ExperimentConfig, fold: int, tag: str) -> dict:
    # Per-trial output dir: trials must not share (or resume from) each
    # other's checkpoints — their architectures differ.
    cfg = dataclasses.replace(
        cfg, output_dir=os.path.join(cfg.output_dir, tag))
    out = run_experiment(cfg, folds=[fold], verbose=False, resume=False)[0]
    return {"val_loss": out["row"]["val_loss"],
            "accuracy": out["row"]["accuracy"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--features", default="")
    p.add_argument("--output", default="./results/tuning")
    p.add_argument("--mode", choices=["grid", "search", "seeds"],
                   default="grid")
    p.add_argument("--vmap", action="store_true",
                   help="train shape-invariant trials as one vmapped "
                        "program (grid --param loss_weights only)")
    p.add_argument("--shard-trials", action="store_true",
                   help="with --vmap/--mode seeds: shard the trial axis "
                        "over all devices (trial count must divide the "
                        "device count)")
    p.add_argument("--param", choices=list(GRID_RANGES), default="l_harm")
    p.add_argument("--space", choices=["arch", "mtl-heads"], default="arch")
    p.add_argument("--algo", choices=["random", "bayes"], default="random")
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--tr-steps", type=int, default=0)
    p.add_argument("--v-steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    enable_compile_cache()

    base = ExperimentConfig(
        model=args.model, data_root=args.data, feature_dir=args.features,
        output_dir=args.output, epochs=args.epochs,
        batch_size=args.batch_size, patch_size=args.patch_size,
        patch_shift=args.patch_size, tr_steps=args.tr_steps,
        v_steps=args.v_steps, seed=args.seed)

    rows = []
    if args.mode == "seeds" or (args.mode == "grid" and args.vmap):
        if args.mode == "seeds":
            trials = [{"seed": args.seed + t} for t in range(args.trials)]
        elif args.param == "loss_weights":
            trials = [{"loss_weights": w}
                      for w in GRID_RANGES["loss_weights"]]
        else:
            raise SystemExit("--vmap supports --param loss_weights only "
                             "(other grid params change tensor shapes)")
        mesh = None
        if args.shard_trials:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh()
        rows = run_vmapped_trials(base, trials, args.fold, mesh=mesh)
        for row in rows:
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
        best = min(rows, key=lambda r: r["val_loss"])
    elif args.mode == "grid":
        for value in GRID_RANGES[args.param]:
            cfg = _apply_grid_value(base, args.param, value)
            score = _score(cfg, args.fold, f"{args.param}_{value if not isinstance(value, dict) else max(value, key=value.get)}")
            row = {args.param: str(value), **score}
            rows.append(row)
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
        best = min(rows, key=lambda r: r["val_loss"])
    else:
        rng = np.random.default_rng(args.seed)
        opt = None
        if args.algo == "bayes":
            from ..utils.bayesopt import BayesOptimizer
            opt = BayesOptimizer(search_space(args.space), seed=args.seed,
                                 n_init=min(5, max(args.trials // 4, 2)))
        for t in range(args.trials):
            arch = opt.ask() if opt else sample_arch(rng, args.space)
            cfg = dataclasses.replace(base, arch_kwargs=arch)
            score = _score(cfg, args.fold, f"trial{t}")
            if opt:
                opt.tell(arch, score["val_loss"])
            row = {"trial": t, **arch, **score}
            rows.append(row)
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
        best = min(rows, key=lambda r: r["val_loss"])
    print("best:", best)
    return rows, best


if __name__ == "__main__":
    main()
