"""Temporal Convolutional Network (Lemaire et al., ISMIR 2019 config).

JAX re-implementation of the TCN the reference builds through the
``keras-tcn`` package (``from tcn import TCN`` at
``/root/reference/lib/baseline_architectures.py:257`` and
``lib/proposed_architectures.py:124``), with the semantics of that
package's residual block as configured by the reference:

- initial 1-D conv to ``n_filters`` channels,
- ``nb_stacks`` stacks over dilations ``[2^0 .. 2^(Nd-1)]``, each block:
  dilated conv -> 'norm_relu' activation (ReLU followed by per-timestep
  channel max-abs normalization, ``x / (max_c |x| + 1e-5)``) -> spatial
  dropout (whole channels) -> 1x1 conv -> residual add,
- optional skip-connection summation, final ReLU, sequences returned.

Reference hyperparameters (``lib/proposed_architectures.py:127-138``):
kernel 3, Nd=8, 3 stacks, 1 layer, 32 filters, no skip connections,
'same' padding, construction-time random dropout in [0.05, 0.5) — here
the dropout rate is an explicit, seeded parameter (documented deviation
from the reference's irreproducible ``np.random.uniform`` draw).

Device notes: all convs are NTC-layout ``lax.conv_general_dilated``
calls; the channel-norm / dropout / residual adds fuse into the
surrounding elementwise passes.  Sequence length (68 or 249) and
channel count (32) are static, so one compiled program serves the whole
training run.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from . import nn


def channel_normalization(x: jnp.ndarray) -> jnp.ndarray:
    """Per-timestep max-abs channel normalization (keras-tcn 'norm_relu')."""
    max_values = jnp.max(jnp.abs(x), axis=-1, keepdims=True) + 1e-5
    return x / max_values


class SpatialDropout1D(nn.Module):
    """Drop whole channels (same mask across time), Keras SpatialDropout1D."""
    rate: float

    @nn.compact
    def __call__(self, x, *, deterministic: bool):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        rng = self.make_rng("dropout")
        mask_shape = x.shape[:-2] + (1, x.shape[-1])
        mask = jax.random.bernoulli(rng, keep, mask_shape)
        return jnp.where(mask, x / keep, 0.0)


class TCNResidualBlock(nn.Module):
    n_filters: int
    kernel_size: int
    dilation: int
    dropout_rate: float
    activation: str = "norm_relu"
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, deterministic: bool):
        original = x
        y = nn.Conv(self.n_filters, (self.kernel_size,),
                    kernel_dilation=(self.dilation,), padding="SAME",
                    dtype=self.dtype,
                    kernel_init=nn.initializers.glorot_uniform(),
                    name="dilated_conv")(x)
        if self.activation == "norm_relu":
            y = nn.relu(y)
            y = channel_normalization(y)
        else:
            raise NotImplementedError(self.activation)
        y = SpatialDropout1D(self.dropout_rate)(y, deterministic=deterministic)
        y = nn.Conv(self.n_filters, (1,), padding="SAME", dtype=self.dtype,
                    kernel_init=nn.initializers.glorot_uniform(),
                    name="conv_1x1")(y)
        return original + y, y


class TCN(nn.Module):
    """Returns sequences: ``(B, T, D) -> (B, T, n_filters)``."""
    n_filters: int = 32
    kernel_size: int = 3
    nb_stacks: int = 3
    dilations: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)
    use_skip_connections: bool = False
    dropout_rate: float = 0.275  # midpoint of the reference's U(0.05, 0.5)
    #: compute dtype (None = input dtype; jnp.bfloat16 for mixed precision)
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        if self.dtype is not None:
            x = x.astype(self.dtype)
        x = nn.Conv(self.n_filters, (self.kernel_size,), padding="SAME",
                    dtype=self.dtype,
                    kernel_init=nn.initializers.glorot_uniform(),
                    name="initial_conv")(x)
        skips = []
        for s in range(self.nb_stacks):
            for d in self.dilations:
                x, skip = TCNResidualBlock(
                    self.n_filters, self.kernel_size, d, self.dropout_rate,
                    dtype=self.dtype,
                    name=f"stack{s}_dilation{d}")(x, deterministic=deterministic)
                skips.append(skip)
        if self.use_skip_connections:
            x = sum(skips)
        return nn.relu(x)
