"""Lemaire TCN model family: single-task, MTL, cascaded-MTL, and the
twin-tower intermediate-fusion variant.

Mirrors ``get_Lemaire_model`` (``/root/reference/lib/
baseline_architectures.py:196-300``), ``get_Lemaire_MTL_model`` /
``get_Lemaire_Cascaded_MTL_model`` / ``get_Lemaire_MTL_intermediate_
fusion_model`` (``lib/proposed_architectures.py:85-170,242-323,327-420``).

Input layout: ``(B, patch_size, n_mels)`` — time-major patches, the TCN
layout the reference feeds after its transpose at
``Proposed_Work_Results.py:236``.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import nn
from .heads import BN_KW, CascadedMTLHeads, KDense, MTLHeads
from .tcn import TCN


class LemaireTCN(nn.Module):
    """Single-task: TCN trunk -> flatten -> Dense softmax."""
    n_classes: int = 3
    n_filters: int = 32
    nb_stacks: int = 3
    kernel_size: int = 3
    Nd: int = 8
    use_skip_connections: bool = False
    dropout_rate: float = 0.275
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = TCN(n_filters=self.n_filters, nb_stacks=self.nb_stacks,
                kernel_size=self.kernel_size,
                dilations=tuple(2 ** d for d in range(self.Nd)),
                use_skip_connections=self.use_skip_connections,
                dropout_rate=self.dropout_rate, dtype=self.dtype,
                name="tcn")(x, deterministic=not train)
        x = x.reshape((x.shape[0], -1))
        return nn.softmax(
            KDense(self.n_classes, name="out")(x).astype(jnp.float32))


class LemaireMTL(nn.Module):
    """MTL: TCN trunk -> flatten -> {S, M, R, 3C} heads."""
    n_classes: int = 3
    n_filters: int = 32
    nb_stacks: int = 3
    kernel_size: int = 3
    Nd: int = 8
    use_skip_connections: bool = False
    dropout_rate: float = 0.275
    cascaded: bool = False
    with_noise: bool = False
    head_width: int = 16
    head_layers: int = 1
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = TCN(n_filters=self.n_filters, nb_stacks=self.nb_stacks,
                kernel_size=self.kernel_size,
                dilations=tuple(2 ** d for d in range(self.Nd)),
                use_skip_connections=self.use_skip_connections,
                dropout_rate=self.dropout_rate, dtype=self.dtype,
                name="tcn")(x, deterministic=not train)
        x = x.reshape((x.shape[0], -1))
        if self.cascaded:
            return CascadedMTLHeads(n_classes=self.n_classes,
                                    name="heads")(x, train=train)
        return MTLHeads(n_classes=self.n_classes, with_noise=self.with_noise,
                        head_width=self.head_width,
                        head_layers=self.head_layers, dtype=self.dtype,
                        name="heads")(x, train=train)


class LemaireMTLIntermediateFusion(nn.Module):
    """Twin TCN towers over harmonic and percussive features, fused by
    concatenation + BN before the heads.  Call with a dict
    ``{'harm_input': (B, T, n_mels), 'perc_input': (B, T, n_mels)}``."""
    n_classes: int = 3
    n_filters: int = 32
    nb_stacks: int = 3
    dropout_rate: float = 0.275
    dtype: object = None

    @nn.compact
    def __call__(self, inputs, *, train: bool = False):
        xh = TCN(n_filters=self.n_filters, nb_stacks=self.nb_stacks,
                 dropout_rate=self.dropout_rate, dtype=self.dtype,
                 name="tcn_H")(inputs["harm_input"], deterministic=not train)
        xp = TCN(n_filters=self.n_filters, nb_stacks=self.nb_stacks,
                 dropout_rate=self.dropout_rate, dtype=self.dtype,
                 name="tcn_P")(inputs["perc_input"], deterministic=not train)
        xh = xh.reshape((xh.shape[0], -1))
        xp = xp.reshape((xp.shape[0], -1))
        x = jnp.concatenate([xh, xp], axis=-1)
        x = nn.BatchNorm(use_running_average=not train, name="fusion_bn",
                         **BN_KW)(x)
        return MTLHeads(n_classes=self.n_classes, dtype=self.dtype,
                        name="heads")(x, train=train)
