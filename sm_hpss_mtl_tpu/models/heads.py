"""Multi-task heads: S (speech), M (music), R (SMR regression), 3C/NC
classification, N (noise, 5-class variant), plus the cascaded wiring.

Mirrors ``MTL_modifications`` and ``cascade_MTL_modifications``
(``/root/reference/lib/proposed_architectures.py:25-80,175-236``).

Reference quirk, replicated *effectively* rather than literally: in the
reference the M and R heads each stack two Dense-16 blocks, but both
blocks read from the trunk ``x`` (``proposed_architectures.py:55-63,
68-76``), so the first block of each is dead code — its output is
overwritten before use.  The effective computation per head is one
Dense(16, l2) -> BatchNorm -> ReLU -> Dropout(0.4) block; that is what we
build (no dead parameters).

Output conventions (from the training labels at
``/root/reference/Proposed_Work_Results.py:170-262``):

- ``S``: sigmoid unit, 1 = speech only.  NOTE: speech+music is labeled 0
  in this driver (quirk; the tuning driver labels it 1).
- ``M``: sigmoid unit, 1 = music only; speech+music again 0.
- ``R``: 2 linear units [music_ratio, speech_ratio]; music [1,0],
  speech [0,1], speech+music [10^(-dB/10), 1] for dB>=0 else
  [1, 10^(dB/10)].
- ``3C``/``NC``: softmax over classes (music/speech/speech_music[,
  noise, speech_noise]).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from . import nn

# Keras BatchNormalization defaults (momentum 0.99, eps 1e-3).
BN_KW = dict(momentum=0.99, epsilon=1e-3)
#: Keras Dense/Conv default kernel initializer (``models.nn`` defaults
#: to lecun_normal; the reference's layers are glorot_uniform).
KDense = functools.partial(nn.Dense,
                           kernel_init=nn.initializers.glorot_uniform())


class HeadBlock(nn.Module):
    """Dense(width, l2-regularized) -> BN -> ReLU -> Dropout(0.4)."""
    width: int = 16
    dropout: float = 0.4
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train: bool):
        x = KDense(self.width, dtype=self.dtype, name="dense")(x)
        x = nn.BatchNorm(use_running_average=not train, name="bn", **BN_KW)(x)
        x = nn.relu(x)
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return x


class MTLHeads(nn.Module):
    """Parallel S / M / R heads over a shared trunk feature vector.

    ``with_noise`` adds the 5-class driver's N (noise) head and widens R
    to 3 units (SMNR: music, speech, noise ratios), matching the local
    ``MTL_modifications`` of ``5_class_classification.py:150-215``.

    ``head_width`` / ``head_layers`` expose the tuning driver's search
    space over per-head MLP shapes
    (``B3_MTL_architecture_tuning.py:326-334``): each head is
    ``head_layers`` Dense(head_width) blocks.
    """
    n_classes: int = 3
    with_noise: bool = False
    head_width: int = 16
    head_layers: int = 1
    dtype: object = None

    def _stack(self, x, name, train):
        for i in range(self.head_layers):
            x = HeadBlock(width=self.head_width, dtype=self.dtype,
                          name=f"{name}{'_l' + str(i) if i else ''}")(
                              x, train=train)
        return x

    @nn.compact
    def __call__(self, x, *, train: bool):
        out = {}
        s = self._stack(x, "S_block", train)
        out["S"] = nn.sigmoid(KDense(1, name="S_out")(s).astype(jnp.float32))
        m = self._stack(x, "M_block", train)
        out["M"] = nn.sigmoid(KDense(1, name="M_out")(m).astype(jnp.float32))
        if self.with_noise:
            n = self._stack(x, "N_block", train)
            out["N"] = nn.sigmoid(KDense(1, name="N_out")(n).astype(jnp.float32))
        r = self._stack(x, "R_block", train)
        r_dim = 3 if self.with_noise else 2
        out["R"] = KDense(r_dim, name="R_out")(r).astype(jnp.float32)
        out["3C"] = nn.softmax(KDense(self.n_classes, name="C_out")(x).astype(jnp.float32))
        return out


class CascadedMTLHeads(nn.Module):
    """Cascaded variant: the SMR prediction feeds the S and M heads
    (``cascade_MTL_modifications``, ``proposed_architectures.py:175-236``):
    each of S/M concatenates its block output with ``R`` and re-normalizes
    before the sigmoid."""
    n_classes: int = 3

    @nn.compact
    def __call__(self, x, *, train: bool):
        out = {}
        r = HeadBlock(name="R_block")(x, train=train)
        smr = KDense(2, name="R_out")(r).astype(jnp.float32)
        out["R"] = smr

        s = HeadBlock(name="S_block")(x, train=train)
        s = jnp.concatenate([s, smr], axis=-1)
        s = nn.BatchNorm(use_running_average=not train, name="S_cat_bn",
                         **BN_KW)(s)
        out["S"] = nn.sigmoid(KDense(1, name="S_out")(s).astype(jnp.float32))

        m = HeadBlock(name="M_block")(x, train=train)
        m = jnp.concatenate([m, smr], axis=-1)
        m = nn.BatchNorm(use_running_average=not train, name="M_cat_bn",
                         **BN_KW)(m)
        out["M"] = nn.sigmoid(KDense(1, name="M_out")(m).astype(jnp.float32))

        out["3C"] = nn.softmax(KDense(self.n_classes, name="C_out")(x).astype(jnp.float32))
        return out
