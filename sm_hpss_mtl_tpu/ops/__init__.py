"""Batched DSP ops (JAX/XLA) + numpy golden reference.

Submodules:

- ``reference``   numpy golden implementations of the librosa algorithms
                  the reference repo calls (the parity oracle for tests).
- ``stft``        batched STFT / iSTFT / RMS framing (block-matmul DFT).
- ``mel``         mel filterbank matmul + power_to_db.
- ``hpss``        jnp HPSS (selection-network sliding medians + Wiener
                  soft masks).
- ``featuregram`` end-to-end featName dispatch (audio -> feature matrix).
- ``patches``     sliding-window patch extraction + per-file scaling.
- ``silence``     RMS silence removal (host-side segment logic).
- ``mixing``      SMR-controlled speech+music mixing.
- ``stats``       per-patch moment statistics (skew/kurtosis vectors).
"""

from . import (featuregram, hpss, mel, mixing, patches,  # noqa: F401
               reference, silence, stats, stft)
