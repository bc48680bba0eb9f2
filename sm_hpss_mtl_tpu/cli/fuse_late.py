"""Late-fusion driver: alpha-blend of two already-trained MTL models.

JAX equivalent of ``/root/reference/Late_Fusion_Results.py``:
loads a harmonic-feature model checkpoint and a percussive-feature model
checkpoint (trained with the mtl driver using LogMelHarmSpec /
LogMelPercSpec), blends their 3C posteriors at --alpha and reports
fold metrics.

    python -m sm_hpss_mtl_tpu.cli.fuse_late --data /path/to/musan \
        --ckpt-harm results/.../fold0_ckpt --ckpt-perc results/.../fold0_ckpt
"""

from __future__ import annotations

import argparse
import os

import jax

from ..data import Featurizer, get_train_test_files, load_cv_folds
from ..eval.fusion import LateFusionTester
from ..eval.metrics import accuracy
from ..eval.tester import FileWiseTester
from ..models import get_model
from ..train import (ExperimentConfig, TrainState, for_model, make_predict,
                     restore_checkpoint)
from ..utils.compile_cache import enable_compile_cache
from ..utils.results import append_results


def _load_tester(config, model_name, feat_name, ckpt_dir):
    import dataclasses
    spec = get_model(model_name, n_classes=config.n_classes,
                     dropout_rate=config.dropout_rate)
    feat_cfg = dataclasses.replace(config.feature_config(),
                                   feat_name=feat_name)
    fz = Featurizer(feat_cfg)
    # Build a template state to restore into.
    import jax.numpy as jnp
    dim = feat_cfg.dim
    sample = jnp.zeros((2, config.patch_size, dim))
    opt, _ = for_model(model_name, tr_steps=1)
    template = TrainState.create(spec.module, opt, sample,
                                 jax.random.PRNGKey(0))
    state, _ = restore_checkpoint(ckpt_dir, template)
    predict = make_predict(spec.module)
    return FileWiseTester(
        featurizer=fz, predict_fn=lambda x: predict(state, x),
        folder=config.data_root, feat_name=feat_name,
        input_kind=config.input_kind, patch_size=config.patch_size,
        test_patch_shift=config.test_patch_shift, mtl=spec.mtl)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--ckpt-harm", required=True)
    p.add_argument("--ckpt-perc", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--feat-harm", default="LogMelHarmSpec")
    p.add_argument("--feat-perc", default="LogMelPercSpec")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--output", default="./results")
    args = p.parse_args(argv)
    enable_compile_cache()

    config = ExperimentConfig(model=args.model, data_root=args.data,
                              output_dir=args.output,
                              patch_size=args.patch_size)
    cv = load_cv_folds(os.path.join(args.data, "cv_info"))
    _, test_files = get_train_test_files(cv, args.fold)

    fuser = LateFusionTester(
        tester_h=_load_tester(config, args.model, args.feat_harm,
                              args.ckpt_harm),
        tester_p=_load_tester(config, args.model, args.feat_perc,
                              args.ckpt_perc),
        alpha=args.alpha)
    res = fuser.test_model(test_files)
    row = {"alpha": args.alpha, "accuracy": accuracy(res["ConfMat"])}
    for i, cls in enumerate(["mu", "sp", "spmu"][:res["ConfMat"].shape[0]]):
        row[f"F1_{cls}"] = res["fscore"][i]
    op_dir = os.path.join(args.output, "Late_Fusion", args.model)
    append_results(op_dir, args.fold, row)
    print(row)
    return res


if __name__ == "__main__":
    main()
