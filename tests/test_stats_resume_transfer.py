"""Corpus stats, checkpoint-resume idiom, transfer learning."""

import os

import numpy as np
import pytest

import jax

from sm_hpss_mtl_tpu.data import (FeatureConfig, Featurizer, create_cv_folds,
                                  get_train_test_files, make_toy_musan)
from sm_hpss_mtl_tpu.data.stats import get_data_stats, load_or_compute_fold_stats
from sm_hpss_mtl_tpu.train import ExperimentConfig
from sm_hpss_mtl_tpu.cli.experiment import run_experiment


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_stats")
    return make_toy_musan(str(root), n_per_class=9, duration_s=2.0)


def test_get_data_stats(toy_root, tmp_path):
    cv = create_cv_folds(toy_root, cv=3, seed=0)
    train, _ = get_train_test_files(cv, 0)
    fz = Featurizer(FeatureConfig(feat_name="LogMelSpec", n_mels=12),
                    cache_dir=str(tmp_path))
    mean, stdev = get_data_stats(fz, toy_root, train)
    assert mean.shape == (12,) and stdev.shape == (12,)
    assert np.isfinite(mean).all() and np.all(stdev > 0)
    # cache round trip
    cache = str(tmp_path / "stats.npz")
    m2, s2 = load_or_compute_fold_stats(cache, fz, toy_root, train)
    np.testing.assert_allclose(m2, mean)
    m3, s3 = load_or_compute_fold_stats(cache, fz, toy_root, train)
    np.testing.assert_allclose(m3, mean)


def test_frame_level_scaling_end_to_end(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=1, v_steps=1, augment_noise=False,
        frame_level_scaling=True)
    results = run_experiment(cfg, folds=[0], verbose=False)
    assert np.isfinite(results[0]["row"]["val_loss"])
    stats_files = [f for f in os.listdir(tmp_path / "features")
                   if f.endswith("_stats.npz")]
    assert stats_files


def test_resume_skips_training(toy_root, tmp_path):
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=toy_root,
        feature_dir=str(tmp_path / "features"),
        output_dir=str(tmp_path / "results"),
        epochs=1, batch_size=2, patch_size=16, patch_shift=16,
        tr_steps=1, v_steps=1, augment_noise=False)
    r1 = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert len(r1["fit"].history) == 1
    # Second run restores the checkpoint: no training epochs run.
    r2 = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert len(r2["fit"].history) == 0
    p1 = jax.tree_util.tree_leaves(r1["fit"].state.params)
    p2 = jax.tree_util.tree_leaves(r2["fit"].state.params)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_transfer_learn_continues():
    import jax.numpy as jnp
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.transfer import transfer_learn

    spec = get_model("Lemaire_et_al_MTL", dropout_rate=0.0)
    bs = 2
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(rng, (3 * bs, 16, 12))
    y3 = np.zeros((3 * bs, 3), np.float32)
    y3[np.arange(3 * bs), np.repeat([0, 1, 2], bs)] = 1
    labels = {"S": jnp.asarray(np.repeat([0., 1., 0.], bs)),
              "M": jnp.asarray(np.repeat([1., 0., 0.], bs)),
              "R": jnp.asarray(np.tile([0.5, 0.5], (3 * bs, 1))),
              "3C": jnp.asarray(y3)}

    def stream():
        while True:
            yield x, labels

    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=10)
    state = TrainState.create(spec.module, opt, x, rng)
    res = transfer_learn(spec.module, opt, state, stream(), stream(),
                         mtl=True, epochs=3, steps_per_epoch=2, val_steps=1,
                         initial_epoch=1, verbose=False)
    assert len(res.history) <= 2 and len(res.history) >= 1
    assert int(res.state.step) >= 2
    # zero remaining epochs -> no-op
    res0 = transfer_learn(spec.module, opt, state, stream(), stream(),
                          mtl=True, epochs=2, steps_per_epoch=2, val_steps=1,
                          initial_epoch=2)
    assert res0.history == []


def test_transfer_learn_composes_with_audio_steps(rng):
    import jax
    import jax.numpy as jnp
    # The DAFx fine-tuning use case on un-cached corpora: transfer_learn
    # continues from a restored state with the on-device audio
    # train/eval steps (fit's prebuilt-step override).
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.endtoend import (device_featurize_patches,
                                                make_audio_eval_step,
                                                make_audio_train_step)
    from sm_hpss_mtl_tpu.train.transfer import transfer_learn

    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=8)
    B = 3
    rng_j = jax.random.PRNGKey(0)

    def labels_for(n):
        y = np.arange(n) % 3
        oh = np.zeros((n, 3), np.float32)
        oh[np.arange(n), y] = 1
        return {"S": jnp.asarray((y == 1).astype(np.float32)),
                "M": jnp.asarray((y == 0).astype(np.float32)),
                "R": jnp.asarray(np.stack([(y == 0), (y == 1)], -1)
                                 .astype(np.float32)),
                "3C": jnp.asarray(oh)}

    def stream():
        while True:
            a = jnp.asarray(rng.standard_normal((B, 16000))
                            .astype(np.float32))
            yield a, labels_for(B)

    spec = get_model("Lemaire_et_al_MTL", n_mels=8, dropout_rate=0.0)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    sample = device_featurize_patches(
        jnp.asarray(rng.standard_normal((B, 16000)).astype(np.float32)),
        cfg, patch_size=12, patch_shift=12)
    state = TrainState.create(spec.module, opt, sample, rng_j)

    kw = dict(patch_size=12, patch_shift=12)
    res = transfer_learn(
        spec.module, opt, state, stream(), stream(), mtl=True,
        epochs=2, steps_per_epoch=2, val_steps=1, initial_epoch=1,
        train_step=make_audio_train_step(spec.module, opt, cfg, **kw),
        eval_step=make_audio_eval_step(spec.module, cfg, **kw),
        sample_state_input=sample, verbose=False)
    assert int(res.state.step) >= 2          # 1 remaining epoch x 2 steps
    assert np.isfinite(res.best_val_loss)
