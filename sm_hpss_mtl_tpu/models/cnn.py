"""Doukhan (MIREX 2018) and Papakostas (ESwA 2018) CNN baselines and
their MTL variants.

Mirrors ``get_Doukhan_model`` / ``get_Papakostas_model``
(``/root/reference/lib/baseline_architectures.py:43-122,128-191``) and
``get_Doukhan_MTL_model`` / ``get_Papakostas_MTL_model``
(``lib/proposed_architectures.py:425-511,516-588``).

Inputs are NHWC: ``(B, n_freq_rows, patch_size, 1)``; Doukhan expects
mel rows (21 baseline / 120(x2) MTL), Papakostas raw spectrogram rows
(201 baseline / 402 MTL HarmPerc).

LRN (Papakostas) is ``tf.nn.local_response_normalization`` semantics:
``x / (bias + alpha * sum_win x^2)^beta`` over an 11-channel window —
implemented as an avg-pool over the channel axis so XLA fuses it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import nn
from .pool import max_pool
from .heads import BN_KW, KDense, MTLHeads

#: Keras glorot_uniform (the reference's explicit Doukhan initializer,
#: VarianceScaling(fan_avg, uniform), and the Keras layer default).
_GLOROT = nn.initializers.glorot_uniform()
#: Papakostas initializers: RandomNormal(stddev=0.01), bias Constant(0.1)
#: (baseline_architectures.py:149-175).
_PAPA_K = nn.initializers.normal(stddev=0.01)
_PAPA_B = nn.initializers.constant(0.1)


def local_response_normalization(x, depth_radius: int = 5, bias: float = 1.0,
                                 alpha: float = 1e-4, beta: float = 0.75):
    """TF-semantics LRN over the channel (last) axis.

    The windowed channel sum is a banded (C, C) 0/1 matmul, so it runs
    as one matrix product over the channel axis instead of a cumsum
    along it.
    """
    C = x.shape[-1]
    i = jnp.arange(C)
    band = (jnp.abs(i[:, None] - i[None, :]) <= depth_radius)
    f32 = x.astype(jnp.float32)
    # HIGH: matches HIGHEST to 5e-6 here (bias dominates the denominator)
    # at half its measured cost; DEFAULT drifts to ~3e-4.
    summed = jnp.einsum("...c,cd->...d", f32 * f32,
                        band.astype(jnp.float32),
                        precision=jax.lax.Precision.HIGH)
    return (f32 / (bias + alpha * summed) ** beta).astype(x.dtype)


class _ConvBNRelu(nn.Module):
    features: int
    kernel: tuple
    strides: tuple = (1, 1)
    padding: str = "VALID"
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool):
        x = nn.Conv(self.features, self.kernel, strides=self.strides,
                    padding=self.padding, dtype=self.dtype,
                    kernel_init=_GLOROT, name="conv")(x)
        x = nn.BatchNorm(use_running_average=not train, name="bn", **BN_KW)(x)
        return nn.relu(x)


class _DenseBNReluDrop(nn.Module):
    features: int
    dropout: float
    dtype: object = None
    papakostas: bool = False

    @nn.compact
    def __call__(self, x, *, train: bool):
        x = nn.Dense(self.features, dtype=self.dtype,
                     kernel_init=(_PAPA_K if self.papakostas else _GLOROT),
                     bias_init=(_PAPA_B if self.papakostas else
                                nn.initializers.zeros),
                     name="dense")(x)
        x = nn.BatchNorm(use_running_average=not train, name="bn", **BN_KW)(x)
        x = nn.relu(x)
        return nn.Dropout(self.dropout, deterministic=not train)(x)


class DoukhanCNN(nn.Module):
    """4 conv + 4x Dense-512 trunk; ``mtl=False`` -> softmax only."""
    n_classes: int = 3
    mtl: bool = False
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        if self.dtype is not None:
            x = x.astype(self.dtype)
        x = _ConvBNRelu(64, (4, 5), dtype=self.dtype, name="c1")(x, train=train)
        x = max_pool(x, (2, 2), (2, 2), padding="VALID")
        x = _ConvBNRelu(128, (3, 3), dtype=self.dtype, name="c2")(x, train=train)
        x = _ConvBNRelu(128, (3, 3), dtype=self.dtype, name="c3")(x, train=train)
        x = max_pool(x, (2, 2), (2, 2), padding="SAME")
        x = _ConvBNRelu(256, (3, 3), dtype=self.dtype, name="c4")(x, train=train)
        x = max_pool(x, (1, 12), (1, 12), padding="VALID")
        x = x.reshape((x.shape[0], -1))
        for i, rate in enumerate([0.2, 0.3, 0.4, 0.5]):
            x = _DenseBNReluDrop(512, rate, dtype=self.dtype, name=f"fc{i + 1}")(x, train=train)
        if self.mtl:
            return MTLHeads(n_classes=self.n_classes, dtype=self.dtype,
                            name="heads")(x, train=train)
        return nn.softmax(
            nn.Dense(self.n_classes, kernel_init=_GLOROT,
                     name="out")(x).astype(jnp.float32))


class PapakostasCNN(nn.Module):
    """AlexNet-style CNN with LRN; ``mtl=False`` -> softmax only."""
    n_classes: int = 3
    mtl: bool = False
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        if self.dtype is not None:
            x = x.astype(self.dtype)
        x = nn.Conv(96, (5, 5), strides=(2, 2), padding="VALID",
                    dtype=self.dtype, kernel_init=_PAPA_K,
                    bias_init=_PAPA_B, name="c1")(x)
        x = local_response_normalization(x)
        x = nn.relu(x)
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        x = nn.Conv(384, (3, 3), strides=(2, 2), padding="VALID",
                    dtype=self.dtype, kernel_init=_PAPA_K,
                    bias_init=_PAPA_B, name="c2")(x)
        x = local_response_normalization(x)
        x = nn.relu(x)
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        x = nn.Conv(512, (3, 3), strides=(1, 1), padding="SAME",
                    dtype=self.dtype, kernel_init=_PAPA_K,
                    bias_init=_PAPA_B, name="c3")(x)
        x = nn.relu(x)
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        x = x.reshape((x.shape[0], -1))
        x = _DenseBNReluDrop(4096, 0.5, dtype=self.dtype, papakostas=True, name="fc1")(x, train=train)
        x = _DenseBNReluDrop(4096, 0.5, dtype=self.dtype, papakostas=True, name="fc2")(x, train=train)
        if self.mtl:
            return MTLHeads(n_classes=self.n_classes, dtype=self.dtype,
                            name="heads")(x, train=train)
        return nn.softmax(
            nn.Dense(self.n_classes, kernel_init=_PAPA_K, bias_init=_PAPA_B,
                     name="out")(x).astype(jnp.float32))
