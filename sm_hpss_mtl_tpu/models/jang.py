"""Jang et al. (EURASIP 2019) Mel-scale-kernel CNN, single-task and MTL.

Mirrors ``get_Jang_model`` (``/root/reference/lib/baseline_architectures.py:
335-456``) and ``get_Jang_MTL_model`` + ``mel_scale_layer``
(``lib/proposed_architectures.py:594-764``).

The reference builds the mel-scale layer as ``n_mels`` separate Conv2D
layers, each on a ``Cropping2D`` band of the spectrogram with stride =
band height (so each band emits one output row), then concatenates the
rows (``proposed_architectures.py:623-646``).  That is 120 tiny convs —
hostile to any accelerator.

Reformulation: the whole layer is a single *banded* linear
operator.  With ``x`` the ``(B, F, T)`` spectrogram and a weight tensor
``W (n_mels, F, t_dim, 3)`` masked to each mel filter's support, the
output is ``out[b,m,t,c] = Σ_f Σ_dt W[m,f,dt,c] · x[b,f,t+dt-2]`` — one
contraction over ``(F, t_dim)``, mathematically identical
to the reference's per-band convs (stride = band height + 'same' padding
makes each band's conv exactly one weighted sum per time step; the
temporal 'same' zero padding is reproduced here).  Weights are
initialized from the mel filterbank exactly as
``get_kernel_initializer`` does (mel weight replicated across t_dim and
the 3 output channels), and the band mask keeps off-band entries zero
through training.

Inputs NHWC: single-task ``(B, 257, T, 1)``; MTL ``(B, 514, T, 1)``
(harmonic rows stacked over percussive rows, n_fft=512).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import reference as ref
from . import nn
from .pool import max_pool
from .heads import BN_KW, KDense, MTLHeads


def mel_band_weights(sr: int, n_fft: int, n_mels: int):
    """Mel filterbank and its band-support mask (host constants)."""
    M = ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32)
    mask = (M > 0).astype(np.float32)
    return M, mask


class MelScaleLayer(nn.Module):
    """Banded mel-kernel layer: ``(B, F, T) -> (B, n_mels, T, 3)``, tanh
    applied by the caller (the reference applies tanh after concat)."""
    sr: int = 16000
    n_fft: int = 512
    n_mels: int = 120
    t_dim: int = 5
    out_channels: int = 3

    @nn.compact
    def __call__(self, x):
        M, mask = mel_band_weights(self.sr, self.n_fft, self.n_mels)
        F = M.shape[1]
        if x.shape[1] != F:
            raise ValueError(f"expected {F} freq rows, got {x.shape[1]}")

        def init(key, shape, dtype=jnp.float32):
            # get_kernel_initializer: mel weight repeated over t_dim and
            # the 3 output channels.
            w = np.repeat(M[:, :, None], self.t_dim, axis=2)
            w = np.repeat(w[:, :, :, None], self.out_channels, axis=3)
            return jnp.asarray(w, dtype)

        W = self.param("kernel", init,
                       (self.n_mels, F, self.t_dim, self.out_channels))
        W = W * jnp.asarray(mask)[:, :, None, None]

        # The banded operator IS a 1-D conv over time with all F rows as
        # input channels: out[b,t,m*C+c] = sum_{k,f} x[b,t+k-half,f] *
        # W[m,f,k,c].  Lowered as lax.conv so fwd and both grads hit
        # XLA's conv kernels directly, and no (B,F,T,t_dim) shifted
        # stack is materialized.
        import jax
        mc = self.n_mels * self.out_channels
        kernel = jnp.transpose(W, (2, 1, 0, 3)).reshape(self.t_dim, F, mc)
        x_nhc = jnp.swapaxes(x, 1, 2)                  # (B, T, F)
        # Explicit symmetric padding: the shifted-stack formulation this
        # replaced padded t_dim//2 on BOTH sides; 'SAME' would shift the
        # time alignment by one frame for even t_dim.
        half = self.t_dim // 2
        out = jax.lax.conv_general_dilated(
            x_nhc, kernel, window_strides=(1,),
            padding=[(half, self.t_dim - 1 - half)],
            dimension_numbers=("NHC", "HIO", "NHC"),
            preferred_element_type=jnp.float32)        # (B, T, M*C)
        out = out.reshape(x.shape[0], x.shape[2], self.n_mels,
                          self.out_channels)
        return jnp.swapaxes(out, 1, 2)                 # (B, M, T, C)


class _ConvBlock(nn.Module):
    features: int
    dropout: float = 0.4
    pool_padding: str = "SAME"
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool):
        x = nn.Conv(self.features, (3, 3), padding="SAME", dtype=self.dtype,
                    kernel_init=nn.initializers.glorot_uniform(),
                    name="conv")(x)
        x = nn.BatchNorm(use_running_average=not train, name="bn", **BN_KW)(x)
        x = nn.relu(x)
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return max_pool(x, (2, 2), (2, 2), padding=self.pool_padding)


class JangCNN(nn.Module):
    """``mtl=False``: one mel tower, no FC stack (``baseline_architectures
    .py:426-442``).  ``mtl=True``: harmonic+percussive towers, FC 2048/1024,
    MTL heads (``proposed_architectures.py:694-751``)."""
    n_classes: int = 3
    mtl: bool = False
    n_mels: int = 120
    n_fft: int = 512
    t_dim: int = 5
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        # NHWC input with 1 channel -> (B, F, T).
        x = x[..., 0] if x.ndim == 4 else x
        n_bins = 1 + self.n_fft // 2

        if self.mtl:
            # Separate towers with separate weights, like the reference's
            # name='harm' / name='perc' layer pairs.
            xh = MelScaleLayer(n_fft=self.n_fft, n_mels=self.n_mels,
                               t_dim=self.t_dim, name="melCl_H")(x[:, :n_bins, :])
            xp2 = MelScaleLayer(n_fft=self.n_fft, n_mels=self.n_mels,
                                t_dim=self.t_dim, name="melCl_P")(x[:, n_bins:, :])
            y = jnp.concatenate([xh, xp2], axis=1)
        else:
            y = MelScaleLayer(n_fft=self.n_fft, n_mels=self.n_mels,
                              t_dim=self.t_dim, name="melCl")(x)
        y = jnp.tanh(y)

        if self.dtype is not None:
            y = y.astype(self.dtype)
        pool_pad = "SAME" if self.mtl else "VALID"
        y = _ConvBlock(32, pool_padding=pool_pad, dtype=self.dtype,
                       name="b1")(y, train=train)
        y = _ConvBlock(64, pool_padding=pool_pad, dtype=self.dtype,
                       name="b2")(y, train=train)
        y = _ConvBlock(128, pool_padding=pool_pad, dtype=self.dtype,
                       name="b3")(y, train=train)
        y = y.reshape((y.shape[0], -1))

        if self.mtl:
            for i, width in enumerate([2048, 1024]):
                y = KDense(width, dtype=self.dtype, name=f"fc{i + 1}")(y)
                y = nn.BatchNorm(use_running_average=not train,
                                 name=f"fc{i + 1}_bn", **BN_KW)(y)
                y = nn.relu(y)
                y = nn.Dropout(0.4, deterministic=not train)(y)
            return MTLHeads(n_classes=self.n_classes, dtype=self.dtype,
                            name="heads")(y, train=train)
        return nn.softmax(
            KDense(self.n_classes, name="out")(y).astype(jnp.float32))
