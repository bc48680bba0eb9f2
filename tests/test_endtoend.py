"""On-device end-to-end (audio -> features -> model) training step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu.models import get_model
from sm_hpss_mtl_tpu.ops.patches import extract_patches_np, standardize_rows
from sm_hpss_mtl_tpu.train import TrainState, for_model
from sm_hpss_mtl_tpu.train.endtoend import (device_featurize_patches,
                                            make_audio_train_step)

RNG = jax.random.PRNGKey(0)


def _clip_labels(B):
    y = np.arange(B) % 3
    onehot = np.zeros((B, 3), np.float32)
    onehot[np.arange(B), y] = 1
    return {
        "S": jnp.asarray((y == 1).astype(np.float32)),
        "M": jnp.asarray((y == 0).astype(np.float32)),
        "R": jnp.asarray(np.stack([(y == 0), (y == 1)], -1).astype(np.float32)),
        "3C": jnp.asarray(onehot),
    }


def test_device_patches_max_patches_trims_after_standardization(rng):
    """max_patches keeps the first k windows while the crop-local
    standardization still sees the WHOLE crop (the min_crop_s
    decoupling): the kept patches must equal the first k of the full
    extraction bit-for-bit."""
    cfg = FeatureConfig(feat_name="LogMelSpec", n_mels=12)
    audio = rng.standard_normal((3, 16000)).astype(np.float32)
    full = np.asarray(device_featurize_patches(
        jnp.asarray(audio), cfg, patch_size=16, patch_shift=16,
        input_kind="time_mel"))
    kept = np.asarray(device_featurize_patches(
        jnp.asarray(audio), cfg, patch_size=16, patch_shift=16,
        input_kind="time_mel", max_patches=2))
    assert kept.shape[0] == 2 * 3  # k * B
    np.testing.assert_array_equal(kept, full[:2 * 3])


def test_audio_crop_batcher_min_crop_s(tmp_path):
    """min_crop_s floors the crop length independently of the patch
    budget."""
    from sm_hpss_mtl_tpu.data import make_toy_musan
    from sm_hpss_mtl_tpu.data.audiostream import (AudioCache,
                                                  AudioCropBatcher,
                                                  crop_samples)
    from sm_hpss_mtl_tpu.data.folds import (create_cv_folds,
                                            get_train_test_files)
    toy_root = make_toy_musan(str(tmp_path / "toy"), n_per_class=6)
    cfg = FeatureConfig(feat_name="LogMelSpec", n_mels=12)
    cv = create_cv_folds(toy_root, seed=0)
    files, _ = get_train_test_files(
        cv, 0, class_names=["music", "speech", "speech+music"])
    cache = AudioCache()
    short = AudioCropBatcher(cache, toy_root, files, cfg,
                             clips_per_class=1, n_patches_per_clip=2,
                             patch_size=16, patch_shift=16, seed=0)
    floored = AudioCropBatcher(cache, toy_root, files, cfg,
                               clips_per_class=1, n_patches_per_clip=2,
                               patch_size=16, patch_shift=16, seed=0,
                               min_crop_s=2.0)
    assert short.L == crop_samples(2, 16, cfg, patch_shift=16)
    assert floored.L == 32000
    batch, labels = next(iter(floored))
    assert batch.shape == (3, 32000)


def test_device_patches_match_host_pipeline(rng):
    """Device featurize+standardize+patch must equal the host path."""
    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=16)
    fs = 16000
    audio = rng.standard_normal((2, fs)).astype(np.float32)

    got = np.asarray(device_featurize_patches(
        jnp.asarray(audio), cfg, patch_size=16, patch_shift=16,
        input_kind="time_mel"))

    from sm_hpss_mtl_tpu.ops import featuregram as fg
    k = None
    host = []
    for b in range(2):
        fv = np.asarray(fg.featuregram(jnp.asarray(audio[b]),
                                       feat_name=cfg.feat_name,
                                       n_mels=cfg.n_mels))
        half = fv.shape[0] // 2
        fv = np.concatenate([np.asarray(standardize_rows(fv[:half])),
                             np.asarray(standardize_rows(fv[half:]))], axis=0)
        p = extract_patches_np(fv, 16, 16)
        k = p.shape[0]
        host.append(np.transpose(p, (0, 2, 1)))
    # device layout: (k, B) flattened -> patch j of clip b at j*B + b
    for b in range(2):
        for j in range(k):
            np.testing.assert_allclose(got[j * 2 + b], host[b][j],
                                       rtol=1e-4, atol=1e-4)


def test_audio_train_step_learns(rng):
    cfg = FeatureConfig(feat_name="LogMelSpec", n_mels=12)
    spec = get_model("Lemaire_et_al_MTL", n_mels=12, dropout_rate=0.0)
    B, fs = 6, 16000
    t = np.arange(fs) / fs
    audio = np.stack([
        np.sin(2 * np.pi * (200 + 120 * (i % 3)) * t)
        + 0.05 * rng.standard_normal(fs) for i in range(B)]).astype(np.float32)
    labels = _clip_labels(B)

    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100000)
    sample = device_featurize_patches(jnp.asarray(audio), cfg,
                                      patch_size=16, patch_shift=16)
    state = TrainState.create(spec.module, opt, sample, RNG)
    step = make_audio_train_step(spec.module, opt, cfg, patch_size=16,
                                 patch_shift=16, mtl=True)
    rng_j = RNG
    losses = []
    for _ in range(8):
        rng_j, sub = jax.random.split(rng_j)
        state, m = step(state, jnp.asarray(audio), labels, sub)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(state.step) == 8


def test_audio_train_step_data_parallel():
    """The audio step shards over the data mesh like any other step."""
    from sm_hpss_mtl_tpu.parallel import make_mesh, shard_batch
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = FeatureConfig(feat_name="LogMelSpec", n_mels=12)
    spec = get_model("Lemaire_et_al_MTL", n_mels=12, dropout_rate=0.0)
    B, n = 8, 16000
    audio = jax.random.normal(RNG, (B, n))
    labels = _clip_labels(B)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    sample = device_featurize_patches(audio, cfg, patch_size=16,
                                      patch_shift=16)
    state = TrainState.create(spec.module, opt, sample, RNG)
    step = make_audio_train_step(spec.module, opt, cfg, patch_size=16,
                                 patch_shift=16, mtl=True)

    mesh = make_mesh()
    ab, lb = shard_batch((audio, labels), mesh)
    s1, m1 = step(state, ab, lb, RNG)
    assert np.isfinite(float(m1["loss"]))


def test_audio_steps_dual_tower(rng):
    # Device pipeline for the intermediate-fusion twin towers: the fused
    # featurization's harm|perc halves route into the model's dict
    # inputs and one train step runs end-to-end.
    from sm_hpss_mtl_tpu.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.endtoend import (device_featurize_patches,
                                                make_audio_eval_step,
                                                make_audio_train_step)

    cfg = FeatureConfig(feat_name="LogMelHarmPercSpec", n_mels=10)
    B = 3
    audio = jnp.asarray(rng.standard_normal((B, 16000)).astype(np.float32))
    sample = device_featurize_patches(audio, cfg, patch_size=12,
                                      patch_shift=12, input_kind="dual")
    assert set(sample) == {"harm_input", "perc_input"}
    assert sample["harm_input"].shape[-1] == 10

    spec = get_model("Lemaire_et_al_MTL_IF", n_mels=10, dropout_rate=0.0)
    opt, _ = for_model("Lemaire_et_al_MTL_IF", tr_steps=100)
    rng_j = jax.random.PRNGKey(0)
    state = TrainState.create(spec.module, opt, sample, rng_j)
    y = np.arange(B) % 3
    oh = np.zeros((B, 3), np.float32)
    oh[np.arange(B), y] = 1
    labels = {
        "S": jnp.asarray((y == 1).astype(np.float32)),
        "M": jnp.asarray((y == 0).astype(np.float32)),
        "R": jnp.asarray(np.stack([(y == 0), (y == 1)], -1)
                         .astype(np.float32)),
        "3C": jnp.asarray(oh),
    }
    step = make_audio_train_step(spec.module, opt, cfg, patch_size=12,
                                 patch_shift=12, input_kind="dual")
    state2, metrics = step(state, audio, labels, rng_j)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.step) == 1
    ev = make_audio_eval_step(spec.module, cfg, patch_size=12,
                              patch_shift=12, input_kind="dual")
    m = ev(state2, audio, labels)
    assert np.isfinite(float(m["loss"]))
