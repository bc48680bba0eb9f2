"""End-to-end on-device training: raw audio -> features -> model in ONE
jitted step.

The reference's pipeline (and our default path) featurizes on the host
and feeds patch batches to the device.  This module compiles the whole
chain — STFT, HPSS, mel/log, per-clip standardization, patch
windowing, forward/backward — into a single XLA program, so training
consumes raw audio batches directly.  Under GSPMD the audio batch shards
over the 'data' mesh axis and the featurization runs sharded alongside
the model.  Useful for fine-tuning on un-cached corpora (the DAFx
transfer-learning case) and as the serving-style one-hop path.

Batch convention: ``audio (B, n_samples)`` with per-clip labels; every
clip yields the same static number of patches ``k`` and labels broadcast
patch-wise (clip-level labels, like the reference's file-level classes).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..data.featurize import FeatureConfig
from ..ops import featuregram as fg
from ..ops.patches import extract_patches, standardize_rows
from .losses import categorical_crossentropy, mtl_loss
from .state import TrainState, _augment, l2_penalty


def device_featurize_patches(audio: jax.Array, cfg: FeatureConfig, *,
                             patch_size: int, patch_shift: int,
                             input_kind: str = "time_mel",
                             skewness_vector: str | None = None,
                             fold_stats=None,
                             max_patches: int | None = None) -> jax.Array:
    """``(B, n) audio -> (B*k, ...) model-ready patches`` on device.

    Applies the reference's per-featuregram row standardization (split
    per HPSS component for HarmPerc features) before windowing —
    unless ``fold_stats=(mean, stdev)`` is given, in which case the
    corpus frame-level scaling replaces it (``scale_frames`` /
    ``tools.pyx:138-166`` semantics, matching the host batcher);
    ``skewness_vector`` ('Row'/'Col') replaces each patch with its
    skewness vector, matching ``BalancedBatcher._patches_for``.

    ``max_patches`` keeps only the first k windows per clip while the
    standardization still sees the WHOLE crop's frames — this decouples
    the statistics context from the patch budget (short crops give
    noisy crop-local stats on non-stationary real audio; see
    ``AudioCropBatcher.min_crop_s``).
    """
    fv = fg.featuregram(audio, feat_name=cfg.feat_name, sr=cfg.sr,
                        n_fft=cfg.n_fft, win_length=cfg.win_length,
                        hop_length=cfg.hop_length, n_mels=cfg.n_mels,
                        l_harm=cfg.l_harm, l_perc=cfg.l_perc)  # (B, D, T)
    if fold_stats is not None:
        mean, stdev = (jnp.asarray(a, jnp.float32) for a in fold_stats)
        fv = (fv - mean[None, :, None]) / (stdev[None, :, None] + 1e-10)
    elif "HarmPerc" in cfg.feat_name:
        half = fv.shape[1] // 2
        fv = jnp.concatenate([standardize_rows(fv[:, :half]),
                              standardize_rows(fv[:, half:])], axis=1)
    else:
        fv = standardize_rows(fv)
    patches = extract_patches(fv, patch_size=patch_size,
                              patch_shift=patch_shift)  # (k, B, D, W)
    if max_patches is not None:
        patches = patches[:max_patches]
    k, B = patches.shape[0], patches.shape[1]
    patches = patches.reshape((k * B,) + patches.shape[2:])
    if skewness_vector:
        from ..ops.stats import patch_statistics
        axis = 1 if skewness_vector == "Row" else 0
        stats = patch_statistics(patches, stat_type="skew", axis=axis)
        patches = stats[:, :, None] if axis == 1 else stats[:, None, :]
    if input_kind == "dual":
        # Intermediate-fusion twin towers: split the stacked harm|perc
        # rows into the model's dict inputs (batcher.py:244-252 layout).
        half = patches.shape[1] // 2
        return {"harm_input": jnp.transpose(patches[:, :half], (0, 2, 1)),
                "perc_input": jnp.transpose(patches[:, half:], (0, 2, 1))}
    if input_kind == "time_mel":
        return jnp.transpose(patches, (0, 2, 1))
    return patches[..., None]


def _broadcast_labels(labels, k: int):
    """Tile per-clip labels to per-patch, matching the (k, B) -> k*B
    flatten order of :func:`device_featurize_patches`."""
    return jax.tree_util.tree_map(
        lambda y: jnp.tile(y, (k,) + (1,) * (y.ndim - 1)), labels)


def make_audio_train_step(model, optimizer, cfg: FeatureConfig, *,
                          patch_size: int, patch_shift: int,
                          input_kind: str = "time_mel", mtl: bool = True,
                          skewness_vector: str | None = None,
                          fold_stats=None,
                          loss_weights: dict | None = None,
                          l2_reg: float = 0.0,
                          augment_noise: bool = False,
                          n_patches_per_clip: int | None = None) -> Callable:
    """Jitted ``(state, audio (B,n), clip_labels, rng) -> (state, metrics)``
    doing featurization and the optimizer update in one program."""
    import optax

    def loss_fn(params, batch_stats, audio, labels, rng):
        batch = device_featurize_patches(
            audio, cfg, patch_size=patch_size, patch_shift=patch_shift,
            input_kind=input_kind, skewness_vector=skewness_vector,
            fold_stats=fold_stats,
            max_patches=n_patches_per_clip)
        if augment_noise:
            rng, aug = jax.random.split(rng)
            batch = _augment(batch, aug)
        n_rows = jax.tree_util.tree_leaves(batch)[0].shape[0]
        k = n_rows // audio.shape[0]
        labels = _broadcast_labels(labels, k)
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, batch,
            train=True, mutable=["batch_stats"], rngs={"dropout": rng})
        if mtl:
            total, per_head = mtl_loss(outputs, labels, loss_weights)
        else:
            total = categorical_crossentropy(outputs, labels)
            per_head = {"3C": total}
        if l2_reg:
            total = total + l2_reg * l2_penalty(params)
        return total, (per_head, mutated["batch_stats"], outputs, labels)

    @jax.jit
    def step(state: TrainState, audio, labels, rng):
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (total, (per_head, new_stats, outputs, plabels)), grads = grad_fn(
            state.params, state.batch_stats, audio, labels, rng)
        updates, new_opt = optimizer.update(grads, state.opt_state,
                                            state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {"loss": total,
                   **{f"{key}_loss": v for key, v in per_head.items()}}
        out3 = outputs["3C"] if mtl else outputs
        lab3 = plabels["3C"] if mtl else plabels
        acc = jnp.mean(jnp.argmax(out3, -1) == jnp.argmax(lab3, -1))
        metrics["3C_accuracy" if mtl else "accuracy"] = acc
        return TrainState(params=new_params, batch_stats=new_stats,
                          opt_state=new_opt, step=state.step + 1), metrics

    return step


def make_audio_eval_step(model, cfg: FeatureConfig, *, patch_size: int,
                         patch_shift: int, input_kind: str = "time_mel",
                         mtl: bool = True,
                         skewness_vector: str | None = None,
                         fold_stats=None,
                         loss_weights: dict | None = None,
                         n_patches_per_clip: int | None = None) -> Callable:
    """Jitted ``(state, audio, clip_labels) -> metrics`` — the eval analog
    of :func:`make_audio_train_step` (featurize + forward + losses in one
    program; keys match ``train.state.make_eval_step``)."""

    @jax.jit
    def eval_step(state: TrainState, audio, labels):
        batch = device_featurize_patches(
            audio, cfg, patch_size=patch_size, patch_shift=patch_shift,
            input_kind=input_kind, skewness_vector=skewness_vector,
            fold_stats=fold_stats,
            max_patches=n_patches_per_clip)
        k = jax.tree_util.tree_leaves(batch)[0].shape[0] // audio.shape[0]
        labels_p = _broadcast_labels(labels, k)
        outputs = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch, train=False)
        if mtl:
            total, per_head = mtl_loss(outputs, labels_p, loss_weights)
            acc = jnp.mean(jnp.argmax(outputs["3C"], -1)
                           == jnp.argmax(labels_p["3C"], -1))
            return {"loss": total, "accuracy": acc,
                    **{f"{key}_loss": v for key, v in per_head.items()}}
        total = categorical_crossentropy(outputs, labels_p)
        acc = jnp.mean(jnp.argmax(outputs, -1)
                       == jnp.argmax(labels_p, -1))
        return {"loss": total, "accuracy": acc}

    return eval_step
