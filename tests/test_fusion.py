"""Intermediate and late fusion tests."""

import os

import numpy as np
import pytest

from sm_hpss_mtl_tpu.data import make_toy_musan
from sm_hpss_mtl_tpu.train import ExperimentConfig
from sm_hpss_mtl_tpu.cli.experiment import run_experiment


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_fusion")
    return make_toy_musan(str(root), n_per_class=9, duration_s=2.0)


def test_intermediate_fusion_end_to_end(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL_IF", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=2, v_steps=1, augment_noise=False)
    results = run_experiment(cfg, folds=[0], verbose=False)
    row = results[0]["row"]
    assert np.isfinite(row["val_loss"])
    assert results[0]["test"]["ConfMat"].shape == (3, 3)


def test_late_fusion_cli(toy_root, tmp_path):
    # Train two tiny models (harm-feature and perc-feature), then fuse.
    from sm_hpss_mtl_tpu.cli import fuse_late
    # Train one model on the Cascaded preset (LogMelHarmSpec) and reuse
    # its checkpoint for both sides of the fusion — exercises the full
    # load-restore-blend path with minimal training cost.
    cfg = ExperimentConfig(
        model="Lemaire_et_al_Cascaded_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=2, v_steps=1, augment_noise=False)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    ckpt = os.path.join(out["op_dir"], "fold0_ckpt")
    assert os.path.exists(os.path.join(ckpt, "state.npz"))

    res = fuse_late.main([
        "--data", toy_root, "--ckpt-harm", ckpt, "--ckpt-perc", ckpt,
        "--model", "Lemaire_et_al_Cascaded_MTL",
        "--feat-harm", "LogMelHarmSpec", "--feat-perc", "LogMelHarmSpec",
        "--patch-size", "16", "--output", str(tmp_path / "results")])
    assert res["ConfMat"].shape == (3, 3)
    assert os.path.exists(tmp_path / "results" / "Late_Fusion" /
                          "Lemaire_et_al_Cascaded_MTL" / "Performance.csv")
