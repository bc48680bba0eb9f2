"""sm_hpss_mtl_tpu — speech/music detection with HPSS + multi-task learning, in JAX.

A JAX/XLA framework with the capabilities of the
reference repo ``mrinmoy-iitg/SM_HPSS_MTL`` (TASLP 2023, DOI
10.1109/TASLP.2022.3164199): harmonic–percussive source separation (HPSS)
spectral front-end, class-balanced MUSAN data pipeline with SMR-controlled
speech+music mixing, a model zoo (dilated TCN, Doukhan / Papakostas / Jang
CNNs) with shared-trunk multi-task heads (speech, music, SMR regression,
N-class), and experiment entry points mirroring the reference scripts.

Layering (device-first, not a port):

- ``ops``      batched DSP on device: STFT/iSTFT, HPSS median filtering
               (selection networks XLA fuses) + Wiener soft masks,
               mel/log-mel featurization, patch windowing, silence gating,
               SMR mixing, patch statistics. Plus a numpy golden reference
               implementing the librosa algorithms the reference repo calls.
- ``data``     MUSAN manifests/annotations, CV fold construction, feature
               cache, class-balanced batcher with MTL labels, prefetch.
- ``models``   model zoo + MTL heads on a small Flax-style module layer
               (``models.nn``).
- ``train``    jit/pjit training harness: optax optimizers matching the
               reference, early stopping, npz checkpoints, CSV metrics.
- ``parallel`` device mesh helpers, data-parallel train step, time-axis
               sharded HPSS with halo exchange.
- ``eval``     confusion-matrix metrics, file-wise testing, SMR sweeps,
               fusion, long-audio streaming segmentation.
"""

__version__ = "0.1.0"
