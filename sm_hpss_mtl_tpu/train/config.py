"""Experiment configuration with per-model presets.

Replaces the reference's hard-coded ``PARAMS`` dicts
(``/root/reference/Proposed_Work_Results.py:723-833``,
``Baseline_Results.py:525-592``) with a dataclass whose defaults are the
reference's exact values: per-model featName / n_fft / n_mels / l_harm /
l_perc presets, Tw=25 ms, Ts=10 ms, W=68 (249 for the 2.5 s variant),
batch=16/class, 3 folds, 50 epochs, SMR test levels [-5,0,5,10,15,20],
and the derived TR/V/TS step counts computed from corpus duration
(:816-831).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from ..data.featurize import FeatureConfig

#: Per-model presets (Proposed_Work_Results.py:750-797 +
#: Baseline_Results.py:551-559).  input rows is the patch feature height
#: before any HarmPerc doubling.
MODEL_PRESETS = {
    "Lemaire_et_al": dict(feat_name="LogMelSpec", n_fft=400, n_mels=120),
    "Lemaire_et_al_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                              n_mels=120),
    "Lemaire_et_al_Cascaded_MTL": dict(feat_name="LogMelHarmSpec", n_fft=400,
                                       n_mels=120),
    "Lemaire_et_al_MTL_5class": dict(feat_name="LogMelHarmPercSpec",
                                     n_fft=400, n_mels=120),
    "Lemaire_et_al_MTL_IF": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                                 n_mels=120),
    "Doukhan_et_al": dict(feat_name="MelSpec", n_fft=400, n_mels=21),
    "Doukhan_et_al_MTL": dict(feat_name="MelHarmPercSpec", n_fft=400,
                              n_mels=120),
    "Papakostas_et_al": dict(feat_name="Spec", n_fft=400, n_mels=-1),
    "Papakostas_et_al_MTL": dict(feat_name="HarmPercSpec", n_fft=400,
                                 n_mels=-1),
    "Jang_et_al": dict(feat_name="LogSpec", n_fft=512, n_mels=-1),
    "Jang_et_al_MTL": dict(feat_name="LogHarmPercSpec", n_fft=512, n_mels=-1),
}

#: Models that take time-major (B, T, D) patches.
TIME_MAJOR_MODELS = ("Lemaire_et_al",)


@dataclass(frozen=True)
class ExperimentConfig:
    model: str = "Lemaire_et_al_MTL"
    data_root: str = ""
    feature_dir: str = ""
    output_dir: str = "./results"
    cv_folds: int = 3
    epochs: int = 50
    batch_size: int = 16
    n_classes: int = 3
    patch_size: int = 68          # W; 249 for the 2.5 s variant
    patch_shift: int = 68         # W_shift (training)
    test_patch_shift: int = 68    # the reference hard-codes 68 at test time
    Tw: int = 25
    Ts: int = 10
    l_harm: int = 21
    l_perc: int = 11
    test_smr_levels: tuple = (-5, 0, 5, 10, 15, 20)
    loss_weights: dict | None = None
    augment_noise: bool = True
    frame_level_scaling: bool = False
    skewness_vector: str | None = None
    dropout_rate: float = 0.275
    #: override the preset mel count (tuning sweeps); None = preset value
    n_mels_override: int | None = None
    #: override the preset featName (the reference sets featName freely
    #: in PARAMS — e.g. Late_Fusion's side models are Lemaire-MTL
    #: trained on LogMelHarmSpec and LogMelPercSpec respectively,
    #: ``Late_Fusion_Results.py``); None = preset value
    feat_name_override: str | None = None
    #: architecture overrides for the Lemaire family (tuning drivers)
    arch_kwargs: dict | None = None
    #: Keras kernel_regularizer=l2() strength on head/mel-kernel weights
    #: (the reference compiles its MTL heads and Jang layers with l2(),
    #: default 0.01); 0 disables
    l2_reg: float = 0.01
    #: parallel host pipelines feeding the training stream
    prefetch_workers: int = 2
    #: 'auto' (default) = host (on an H100 the device pipeline tied it
    #: end to end; PERF.md);
    #: 'host' = featurize on host, feed patch batches (reference-parity
    #: semantics); 'device' = host streams raw-audio crops and
    #: STFT/HPSS/mel/patching/training run in ONE XLA program
    #: (train.endtoend), with far less host work per step.  Semantic
    #: deltas are documented at data/audiostream.py:11-26.
    pipeline: str = "auto"
    #: device pipeline: patches per sampled clip crop (clips per class =
    #: ceil(batch_size / clip_patches)).  0 (default) = adaptive: 1 when
    #: the smallest training class has fewer than 8*batch_size clips
    #: (small corpora need maximal per-step clip diversity — at
    #: clip_patches>1 a real-audio ablation lost accuracy, with
    #: early-stop collapses), else 4 (large corpora: fewer host crop
    #: slices per step).  ROADMAP Reach 2 re-checks these defaults.
    clip_patches: int = 0
    #: device pipeline: floor on the crop length in seconds — the crop-
    #: local standardization sees at least this much context while only
    #: clip_patches windows train.  0 (default) keeps the minimal
    #: geometric crop; a real-audio ablation found
    #: no quality gain from longer standardization context, so this is
    #: an experiment knob, not a tuned default.
    min_crop_s: float = 0.0
    #: 'float32' (reference parity) or 'bfloat16' (mixed-precision compute;
    #: params, BatchNorm stats, head outputs and losses stay f32)
    compute_dtype: str = "float32"
    seed: int = 0
    # Derived step counts (0 = compute from durations).
    tr_steps: int = 0
    v_steps: int = 0
    ts_steps: int = 0
    #: Cap on the generator-eval protocol's TS_STEPS (the reference's
    #: ``model.evaluate(generator, steps=TS_STEPS)`` can derive thousands
    #: of batches from corpus duration); 0 = uncapped.  The runner logs
    #: whenever the cap binds.
    max_eval_steps: int = 200
    #: Horizon for the Lemaire SGD ExponentialDecay (0 = tr_steps).  The
    #: reference ties decay_steps to 3*TR_STEPS, which collapses the lr
    #: within a few epochs when tr_steps is overridden to a tiny value
    #: (smoke runs); set this to the realistic epoch size in that case.
    lr_schedule_steps: int = 0

    @property
    def feat_name(self) -> str:
        return (self.feat_name_override
                or MODEL_PRESETS[self.model]["feat_name"])

    @property
    def input_kind(self) -> str:
        return ("time_mel" if any(self.model.startswith(m)
                                  for m in TIME_MAJOR_MODELS) else "image")

    def feature_config(self) -> FeatureConfig:
        preset = MODEL_PRESETS[self.model]
        n_mels = (self.n_mels_override if self.n_mels_override is not None
                  else preset["n_mels"])
        return FeatureConfig(
            feat_name=self.feat_name, n_fft=preset["n_fft"],
            win_length=int(self.Tw * 16000 / 1000),
            hop_length=int(self.Ts * 16000 / 1000),
            n_mels=n_mels, l_harm=self.l_harm, l_perc=self.l_perc,
            Tw=self.Tw, Ts=self.Ts)

    def with_steps_from_durations(self, total_duration_hours: dict
                                  ) -> "ExperimentConfig":
        """The reference's TR/V/TS step derivation
        (``Proposed_Work_Results.py:816-831``)."""
        dt_ms = sum(total_duration_hours.values()) * 3600 * 1000
        tr_frac = ((self.cv_folds - 1) / self.cv_folds) * 0.7
        vl_frac = ((self.cv_folds - 1) / self.cv_folds) * 0.3
        ts_frac = 1 / self.cv_folds
        shift_ms = self.patch_shift * self.Ts
        denom = self.n_classes * self.batch_size
        n = math.floor(dt_ms / shift_ms)
        return replace(self,
                       tr_steps=int(n * tr_frac / denom),
                       v_steps=int(n * vl_frac / denom),
                       ts_steps=int(n * ts_frac / denom))
