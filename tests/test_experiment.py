"""End-to-end experiment tests on the toy corpus (CPU, tiny settings)."""

import os

import numpy as np
import pytest

from sm_hpss_mtl_tpu.data import make_toy_musan
from sm_hpss_mtl_tpu.train import ExperimentConfig
from sm_hpss_mtl_tpu.cli.experiment import run_experiment, split_train_val


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_e2e")
    return make_toy_musan(str(root), n_per_class=9, duration_s=2.0)


def test_split_train_val_never_empty():
    tr, va = split_train_val({"music": ["a", "b"], "speech": ["c"]})
    assert tr["music"] and va["music"]
    assert tr["speech"] and va["speech"]


@pytest.mark.parametrize("model", ["Lemaire_et_al_MTL"])
def test_run_experiment_end_to_end(toy_root, tmp_path, model):
    cfg = ExperimentConfig(
        model=model, data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=2, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=2, v_steps=1, augment_noise=False, seed=0)
    results = run_experiment(cfg, folds=[0], verbose=False)
    assert len(results) == 1
    out = results[0]
    row = out["row"]
    assert np.isfinite(row["val_loss"])
    assert 0.0 <= row["accuracy"] <= 1.0
    assert set(out["test"]) >= {"ConfMat", "precision", "recall", "fscore"}
    # Artifacts: Performance.csv, Configuration.csv, epoch log, checkpoint.
    op_dir = out["op_dir"]
    assert os.path.exists(os.path.join(op_dir, "Performance.csv"))
    assert os.path.exists(os.path.join(op_dir, "fold0_log.csv"))
    with open(os.path.join(op_dir, "fold0_log.csv")) as f:
        header = f.readline()
    # Per-epoch wall clock for sustained-throughput reporting (r4).
    assert "epoch_train_s" in header
    assert "patch_lru" in out["cache_stats"]
    assert out["cache_stats"]["featurizer"]["computes"] > 0
    assert os.path.exists(os.path.join(op_dir, "fold0_ckpt", "state.npz"))
    cfg_csv = os.path.join(str(tmp_path / "results"), model,
                           "LogMelHarmPercSpec", "Configuration.csv")
    assert os.path.exists(cfg_csv)
    # Feature cache was populated with the reference's layout.
    cache = os.path.join(str(tmp_path / "features"), model,
                         "LogMelHarmPercSpec")
    assert os.path.isdir(os.path.join(cache, "speech"))


def test_baseline_single_task(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Lemaire_et_al", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=2, v_steps=1, augment_noise=False)
    results = run_experiment(cfg, folds=[0], verbose=False)
    assert np.isfinite(results[0]["row"]["val_loss"])


def test_resume_completes_interrupted_fold(toy_root, tmp_path):
    """A fold whose process died mid-budget must resume for the
    remaining epochs, not return under-trained weights as 'done'
    (the reference counts completed epochs from its CSV log,
    DAFx12_...py:534-545)."""
    import csv
    import dataclasses
    import json

    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=2, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=1, v_steps=1, augment_noise=False, seed=0)
    out1 = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert len(out1["fit"].history) == 2
    ckpt = os.path.join(out1["op_dir"], "fold0_ckpt")
    meta_path = os.path.join(ckpt, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["completed"] and meta["epochs_run"] == 2
    # Simulate a kill mid-budget: the completed stamp is only written
    # after fit() returns, so an interrupted fold has checkpoint +
    # partial epoch log but no stamp.
    for k in ("completed", "epochs_run", "stopped_early"):
        meta.pop(k, None)
    with open(meta_path, "w") as f:
        json.dump(meta, f)

    cfg4 = dataclasses.replace(cfg, epochs=4)
    out2 = run_experiment(cfg4, folds=[0], verbose=False)[0]
    # Trained exactly the remaining 2 epochs; the CSV log continues.
    assert len(out2["fit"].history) == 2
    log = os.path.join(out1["op_dir"], "fold0_log.csv")
    with open(log) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]
    with open(meta_path) as f:
        meta2 = json.load(f)
    assert meta2["completed"] and meta2["epochs_run"] == 4

    # A finished fold keeps the fast path: third run trains nothing.
    out3 = run_experiment(cfg4, folds=[0], verbose=False)[0]
    assert len(out3["fit"].history) == 0


def test_resume_status_replay():
    """Legacy checkpoints (no completed stamp): the early-stopping rule
    is replayed over the epoch log to tell finished from interrupted."""
    from sm_hpss_mtl_tpu.cli.experiment import _resume_status

    def write_log(path, losses):
        import csv
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["epoch", "loss", "val_loss"])
            w.writeheader()
            for i, v in enumerate(losses):
                w.writerow({"epoch": i, "loss": v, "val_loss": v})

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(d, "log.csv")
        # Interrupted: 2 of 10 epochs, still improving.
        write_log(log, [1.0, 0.8])
        assert _resume_status({"epoch": 1}, log, 10) == (False, 2)
        # Early-stopped in a prior run: 5 non-improving epochs.
        write_log(log, [1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
        finished, done = _resume_status({"epoch": 0}, log, 10)
        assert finished and done == 6
        # Full budget reached.
        write_log(log, [1.0, 0.9])
        assert _resume_status({"epoch": 1}, log, 2) == (True, 2)
        # Completed stamp wins regardless of the log.
        assert _resume_status({"completed": True, "epochs_run": 3},
                              log, 10) == (True, 3)
        # No log at all: fall back to the best-epoch metadata.
        assert _resume_status({"epoch": 4},
                              os.path.join(d, "none.csv"), 10) == (False, 5)


def test_resolve_clip_patches_adaptive():
    """clip_patches=0 adapts to corpus size: small classes get maximal
    per-step clip diversity (a real-audio ablation lost accuracy at
    several patches per clip), large corpora pack 4 patches per clip."""
    from sm_hpss_mtl_tpu.cli.experiment import resolve_clip_patches

    small = {c: [f"{c}{i}" for i in range(30)]
             for c in ("music", "speech", "speech+music")}
    large = {c: [f"{c}{i}" for i in range(300)]
             for c in ("music", "speech", "speech+music")}
    cfg = ExperimentConfig(batch_size=16)  # threshold 8*16 = 128
    assert resolve_clip_patches(cfg, small) == 1
    assert resolve_clip_patches(cfg, large) == 4
    # One starved class is enough to force the diverse setting.
    mixed = dict(large, speech=large["speech"][:50])
    assert resolve_clip_patches(cfg, mixed) == 1
    # Explicit values are always honored.
    import dataclasses
    assert resolve_clip_patches(
        dataclasses.replace(cfg, clip_patches=2), small) == 2


def test_hpss_resynth_cli(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import hpss_resynth
    sp = os.path.join(toy_root, "speech", "speech-toy-0000.wav")
    mu = os.path.join(toy_root, "music", "music-toy-0000.wav")
    hpss_resynth.main([sp, "--mix", mu, "--smr", "5", "--out-dir",
                       str(tmp_path)])
    outs = sorted(os.listdir(tmp_path))
    assert any("Harmonic" in f for f in outs)
    assert any("Percussive" in f for f in outs)
    from sm_hpss_mtl_tpu.data.audio import read_wav
    name = [f for f in outs if "Harmonic" in f][0]
    x, sr = read_wav(os.path.join(tmp_path, name))
    assert sr == 16000 and np.isfinite(x).all() and len(x) == 32000


def test_make_folds_cli(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import make_folds
    make_folds.main(["--data", toy_root, "--output", str(tmp_path / "cv")])
    assert os.path.exists(tmp_path / "cv" / "cv_file_list.pkl")
    assert os.path.exists(tmp_path / "cv" / "fold2.csv")
    # Reference sidecar artifacts (create_cross_validation_folds.py:
    # 286,328-333): key dump + duration maps.
    details = (tmp_path / "cv" / "details.txt").read_text()
    assert details.startswith("CV_folds:")
    assert "total_duration" in details
    import pickle
    with open(tmp_path / "cv" / "Dataset_Duration.pkl", "rb") as f:
        dur = pickle.load(f)
    assert set(dur) == {"total_duration", "filewise_duration"}
    assert dur["total_duration"]["music"] > 0


def test_feat_name_override():
    """feat_name_override reproduces the reference's free featName PARAMS
    (Late_Fusion side models: Lemaire-MTL on LogMelHarm/PercSpec)."""
    cfg = ExperimentConfig(model="Lemaire_et_al_MTL",
                           feat_name_override="LogMelPercSpec")
    assert cfg.feat_name == "LogMelPercSpec"
    assert cfg.feature_config().feat_name == "LogMelPercSpec"
    assert (ExperimentConfig(model="Lemaire_et_al_MTL").feat_name
            == "LogMelHarmPercSpec")


def test_pipeline_auto_resolves_to_host_on_cpu(toy_root, tmp_path):
    """pipeline='auto' must pick the host pipeline on the CPU
    (cli/experiment.py)."""
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        output_dir=str(tmp_path / "res"), epochs=1, batch_size=2,
        patch_size=16, patch_shift=16, tr_steps=2, v_steps=1,
        pipeline="auto", seed=0)
    out = run_experiment(cfg, folds=[0], verbose=False)
    assert np.isfinite(out[0]["row"]["accuracy"])


def test_generator_evaluation_metrics(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=1, v_steps=1, ts_steps=2, augment_noise=False)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert "gen_loss" in out["row"] and "gen_accuracy" in out["row"]
    assert np.isfinite(out["row"]["gen_loss"])


def test_doukhan_mtl_end_to_end(toy_root, tmp_path):
    # Image-kind model through the full pipeline. n_mels=20 keeps the
    # Doukhan conv stack valid at patch 68 (rows 2*20=40).
    import dataclasses
    cfg = ExperimentConfig(
        model="Doukhan_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=68, patch_shift=68,
        tr_steps=1, v_steps=1, augment_noise=False, n_mels_override=20)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert np.isfinite(out["row"]["val_loss"])
    assert out["test"]["ConfMat"].shape == (3, 3)


@pytest.mark.parametrize("model", ["Papakostas_et_al_MTL", "Jang_et_al_MTL"])
def test_image_cnn_models_end_to_end(toy_root, tmp_path, model):
    # Full-pipeline smoke for the remaining image-kind MTL models.
    cfg = ExperimentConfig(
        model=model, data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=1, patch_size=68, patch_shift=68,
        tr_steps=1, v_steps=1, augment_noise=False)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert np.isfinite(out["row"]["val_loss"])
    assert out["test"]["ConfMat"].shape == (3, 3)


def test_w249_variant_with_wraparound(toy_root, tmp_path):
    # The 2.5 s patch variant (W=249, shift 24): toy clips are ~2 s
    # (~197 frames < W), so this also exercises the short-clip tiling
    # rule through the whole pipeline.
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=249, patch_shift=24,
        test_patch_shift=68,  # the reference's hard-coded test shift
        tr_steps=1, v_steps=1, augment_noise=False, n_mels_override=16)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert np.isfinite(out["row"]["val_loss"])


def test_jang_baseline_single_task(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Jang_et_al", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=1, patch_size=68, patch_shift=68,
        tr_steps=1, v_steps=1, augment_noise=False)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert np.isfinite(out["row"]["val_loss"])
    assert out["test"]["ConfMat"].shape == (3, 3)


def test_classifier_inference_api(toy_root, tmp_path):
    # Train a tiny model, then classify through the public API.
    from sm_hpss_mtl_tpu.infer import Classifier
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=1, v_steps=1, augment_noise=False)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    ckpt = os.path.join(out["op_dir"], "fold0_ckpt")

    clf = Classifier.from_checkpoint(ckpt, patch_size=16, patch_shift=16)
    res = clf.classify_file(os.path.join(toy_root, "music",
                                         "music-toy-0000.wav"))
    assert res["class_name"] in ("music", "speech", "speech_music")
    assert res["probabilities"].shape == (3,)
    assert np.isclose(res["probabilities"].sum(), 1.0, atol=1e-4)
    assert set(res["heads"]) == {"S", "M", "R", "3C"}

    res2 = clf.classify_pair(
        os.path.join(toy_root, "speech", "speech-toy-0000.wav"),
        os.path.join(toy_root, "music", "music-toy-0001.wav"), 5.0)
    assert res2["probabilities"].shape == (3,)


@pytest.mark.quick
def test_metric_accumulation_matches_host_mean():
    """The on-device epoch-metric accumulation (one packed fetch per
    epoch instead of one per step) must agree with the
    naive per-row host mean it replaced."""
    import jax.numpy as jnp

    from sm_hpss_mtl_tpu.train.loop import _accumulate, _fetch_mean

    rng = np.random.default_rng(0)
    rows = [{"loss": jnp.asarray(rng.uniform(0, 5), jnp.float32),
             "acc": jnp.asarray(rng.uniform(), jnp.float32),
             "S_loss": float(rng.uniform())}          # host float leaf
            for _ in range(7)]
    acc = None
    for r in rows:
        acc = _accumulate(acc, r)
    got = _fetch_mean(acc, len(rows))
    for k in rows[0]:
        want = np.mean([float(r[k]) for r in rows])
        assert np.isclose(got[k], want, rtol=1e-5), (k, got[k], want)
        assert isinstance(got[k], float)
