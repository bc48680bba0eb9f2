"""Tests for the on-device training pipeline's host side
(``data/audiostream.py``) and its experiment integration."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.data import make_toy_musan
from sm_hpss_mtl_tpu.data.audiostream import (AudioCache, AudioCropBatcher,
                                              crop_samples)
from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu.data.folds import create_cv_folds, get_train_test_files


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_audio")
    make_toy_musan(str(root), n_per_class=9, duration_s=2.0)
    cv = create_cv_folds(str(root), seed=0)
    files, _ = get_train_test_files(
        cv, 0, class_names=["music", "speech", "speech+music"])
    return str(root), files


def test_crop_samples_framing():
    cfg = FeatureConfig()
    # k windows of W frames at stride W: (k*W-1)*hop + win samples.
    assert crop_samples(4, 68, cfg) == (4 * 68 - 1) * 160 + 400
    # Strided overlap: (n-1)*shift + W frames.
    assert crop_samples(3, 68, cfg, patch_shift=10) == \
        ((2 * 10 + 68) - 1) * 160 + 400


def test_audio_cache_roundtrip(toy, tmp_path):
    root, files = toy
    cache = AudioCache(cache_dir=str(tmp_path / "ac"))
    sp = os.path.join(root, "speech", files["speech"][0])
    a1 = cache.get("speech", sp_path=sp)
    # second read: memmap from the npy (and the same cached object)
    a2 = cache.get("speech", sp_path=sp)
    assert a2 is a1
    assert a1.dtype == np.float32 and a1.ndim == 1 and len(a1) > 16000
    # mixtures keyed by (sp, mu, SMR)
    pair = files["speech+music"][0]
    mu = os.path.join(root, "music", pair["music"])
    sp2 = os.path.join(root, "speech", pair["speech"])
    m1 = cache.get("speech_music", sp2, mu, pair["SMR"])
    assert np.isfinite(m1).all()
    # in-memory mode works without a cache_dir
    mem = AudioCache(cache_dir=None)
    b = mem.get("speech", sp_path=sp)
    np.testing.assert_allclose(np.asarray(a1), b, atol=0)


def test_crop_batcher_shapes_balance_and_labels(toy):
    root, files = toy
    cfg = FeatureConfig()
    cache = AudioCache(cache_dir=None)
    c, k, W = 2, 2, 16
    ab = AudioCropBatcher(cache, root, files, cfg, clips_per_class=c,
                          n_patches_per_clip=k, patch_size=W, seed=0)
    audio, labels = next(ab)
    L = crop_samples(k, W, cfg)
    assert audio.shape == (3 * c, L) and audio.dtype == np.float32
    # Label encodings match BalancedBatcher's (clip-level rows).
    np.testing.assert_array_equal(labels["S"],
                                  [0, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(labels["M"],
                                  [1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(labels["3C"].argmax(-1),
                                  [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(labels["R"][:2], [[1, 0], [1, 0]])
    np.testing.assert_array_equal(labels["R"][2:4], [[0, 1], [0, 1]])
    # Mixture rows carry the SMR encoding (dB>=0 -> [10^(-dB/10), 1]).
    r_mix = labels["R"][4:]
    assert ((r_mix == 1).any(axis=-1)).all()
    assert (r_mix > 0).all() and (r_mix <= 1).all()
    # Short-clip crops wrap-tile rather than failing.
    ab_long = AudioCropBatcher(cache, root, files, cfg, clips_per_class=1,
                               n_patches_per_clip=8, patch_size=68, seed=0)
    audio2, _ = next(ab_long)   # 8*68 frames >> 2 s clips
    assert audio2.shape == (3, crop_samples(8, 68, cfg))
    assert np.isfinite(audio2).all()


def test_short_clip_wrap_is_rotated(toy):
    """Wrap-tiled crops of a short clip must vary across draws (random
    rotation phase) and contain only samples of the source clip — a
    fixed phase would kill crop augmentation whenever ``min_crop_s``
    exceeds the corpus clip length."""
    root, files = toy
    cfg = FeatureConfig()
    cache = AudioCache(cache_dir=None)
    ab = AudioCropBatcher(cache, root, files, cfg, clips_per_class=1,
                          n_patches_per_clip=8, patch_size=68, seed=0)
    n = len(files["music"])
    draws = [next(ab)[0][0].copy() for _ in range(max(4, 2 * n))]
    # Same source file recurs across a full queue cycle; with rotation
    # at least one pair of draws must differ.
    diffs = sum(not np.array_equal(a, b)
                for i, a in enumerate(draws) for b in draws[i + 1:])
    assert diffs > 0
    # Every crop is a rotation of a tiling: its sample multiset per
    # period must come from the clip (finite, bounded like the source).
    assert all(np.isfinite(d).all() for d in draws)


def test_audio_eval_step_matches_patch_eval(toy):
    """Featurize-in-eval must equal eval on the separately featurized
    patches with broadcast labels."""
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.endtoend import (_broadcast_labels,
                                                device_featurize_patches,
                                                make_audio_eval_step)
    from sm_hpss_mtl_tpu.train.state import make_eval_step

    root, files = toy
    cfg = FeatureConfig(n_mels=12)
    cache = AudioCache(cache_dir=None)
    ab = AudioCropBatcher(cache, root, files, cfg, clips_per_class=1,
                          n_patches_per_clip=2, patch_size=16, seed=0)
    audio, labels = next(ab)
    audio = jnp.asarray(audio)
    labels = {k: jnp.asarray(v) for k, v in labels.items()}

    spec = get_model("Lemaire_et_al_MTL", n_mels=12, dropout_rate=0.0)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=10)
    patches = device_featurize_patches(audio, cfg, patch_size=16,
                                       patch_shift=16)
    state = TrainState.create(spec.module, opt, patches,
                              jax.random.PRNGKey(0))

    a_eval = make_audio_eval_step(spec.module, cfg, patch_size=16,
                                  patch_shift=16)
    m1 = a_eval(state, audio, labels)
    k = patches.shape[0] // audio.shape[0]
    m2 = make_eval_step(spec.module, mtl=True)(
        state, patches, _broadcast_labels(labels, k))
    for key in m2:
        np.testing.assert_allclose(float(m1[key]), float(m2[key]),
                                   rtol=1e-5)


def test_experiment_device_pipeline_e2e(toy, tmp_path):
    from sm_hpss_mtl_tpu.cli.experiment import run_experiment
    from sm_hpss_mtl_tpu.train import ExperimentConfig

    root, _ = toy
    cfg = ExperimentConfig(
        model="Lemaire_et_al_MTL", data_root=root,
        feature_dir=str(tmp_path / "feat"),
        output_dir=str(tmp_path / "res"), epochs=2, batch_size=2,
        patch_size=16, patch_shift=16, tr_steps=2, v_steps=1,
        pipeline="device", clip_patches=2, seed=0)
    out = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert np.isfinite(out["row"]["val_loss"])
    assert "accuracy" in out["row"]
    # Resume restores from the device-pipeline checkpoint.
    out2 = run_experiment(cfg, folds=[0], verbose=False)[0]
    assert out2["fit"].best_epoch >= 0


def test_device_featurize_frame_scaling(rng):
    # fold_stats on the device path applies the corpus frame scaling
    # (scale_frames semantics) instead of per-featuregram
    # standardization, matching the host batcher.
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu.ops import featuregram as fg
    from sm_hpss_mtl_tpu.ops.patches import extract_patches
    from sm_hpss_mtl_tpu.train.endtoend import device_featurize_patches

    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=8)
    D = 16
    audio = jnp.asarray(rng.standard_normal((2, 16000)).astype(np.float32))
    mean = rng.standard_normal(D).astype(np.float32)
    stdev = np.abs(rng.standard_normal(D)).astype(np.float32) + 0.5
    got = device_featurize_patches(audio, cfg, patch_size=12,
                                   patch_shift=12, input_kind="image",
                                   fold_stats=(mean, stdev))[..., 0]
    fv = fg.featuregram(audio, feat_name=cfg.feat_name, n_mels=8)
    fv = (np.asarray(fv) - mean[None, :, None]) / (stdev[None, :, None]
                                                   + 1e-10)
    want = np.asarray(extract_patches(jnp.asarray(fv), patch_size=12,
                                      patch_shift=12))
    want = want.reshape((-1,) + want.shape[2:])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5)


def test_crop_samples_overlapping_shift(tmp_path):
    # Review fix: the device pipeline must size crops with patch_shift,
    # not patch_size — overlapping windows need fewer frames for the
    # same patch budget.
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu.data.audiostream import crop_samples
    from sm_hpss_mtl_tpu.ops.stft import n_frames

    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=8)
    for k, size, shift in ((4, 68, 34), (4, 68, 68), (3, 16, 8)):
        n = crop_samples(k, size, cfg, patch_shift=shift)
        T = n_frames(n, cfg.n_fft, cfg.hop_length)
        assert (T - size) // shift + 1 == k, (k, size, shift, T)


def test_device_featurize_skewness_vector(rng):
    # skewness_vector on the device path equals patch_statistics over the
    # plain patch output (the host batcher's transformation).
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu.ops.stats import patch_statistics
    from sm_hpss_mtl_tpu.train.endtoend import device_featurize_patches

    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=8)
    audio = jnp.asarray(rng.standard_normal((2, 16000)).astype(np.float32))
    plain = device_featurize_patches(audio, cfg, patch_size=12,
                                     patch_shift=12, input_kind="image")[..., 0]  # (N, D, W)
    for sv, axis in (("Row", 1), ("Col", 0)):
        got = device_featurize_patches(audio, cfg, patch_size=12,
                                       patch_shift=12, input_kind="image",
                                       skewness_vector=sv)[..., 0]
        want = np.asarray(patch_statistics(plain, stat_type="skew",
                                           axis=axis))
        want = want[:, :, None] if axis == 1 else want[:, None, :]
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)
