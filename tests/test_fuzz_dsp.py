"""Property-based fuzzing of the DSP core against the numpy golden.

Randomized shapes/params catch the boundary and parity bugs fixed-shape
tests miss (odd lengths, tiny windows, extreme dynamic ranges).
"""

import numpy as np
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import hpss as jhpss
from sm_hpss_mtl_tpu.ops.hpss import batcher_pairs, median_network
from sm_hpss_mtl_tpu.ops import reference as ref
from sm_hpss_mtl_tpu.ops import stft as jstft
from sm_hpss_mtl_tpu.ops.patches import extract_patches_np, num_patches

_SETTINGS = dict(max_examples=25, deadline=None)


@settings(**_SETTINGS)
@given(n=st.integers(1000, 30000),
       hop=st.sampled_from([80, 160, 200]),
       n_fft=st.sampled_from([256, 400, 512]),
       seed=st.integers(0, 2 ** 31))
def test_stft_parity_fuzz(n, hop, n_fft, seed):
    if n < n_fft:
        n = n_fft + n
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10 ** rng.uniform(-3, 2)).astype(np.float32)
    win = min(400, n_fft)
    got = np.asarray(jstft.stft_mag(jnp.asarray(x), n_fft=n_fft,
                                    win_length=win, hop_length=hop))
    want = ref.stft_mag(x, n_fft, win, hop)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-6)


@settings(**_SETTINGS)
@given(F=st.integers(5, 64), T=st.integers(5, 120),
       lh=st.sampled_from([3, 7, 21]), lp=st.sampled_from([3, 5, 11]),
       seed=st.integers(0, 2 ** 31))
def test_hpss_mask_parity_fuzz(F, T, lh, lp, seed):
    rng = np.random.default_rng(seed)
    S = np.abs(rng.standard_normal((F, T))).astype(np.float32)
    # sprinkle exact zeros to hit the softmask bad-index branch
    S[rng.random((F, T)) < 0.05] = 0.0
    mh, mp = jhpss.hpss_masks(jnp.asarray(S), l_harm=lh, l_perc=lp)
    gh, gp = ref.hpss_masks(S, lh, lp)
    np.testing.assert_allclose(np.asarray(mh), gh, atol=2e-6)
    np.testing.assert_allclose(np.asarray(mp), gp, atol=2e-6)


@settings(**_SETTINGS)
@given(T=st.integers(1, 600), W=st.integers(2, 260),
       shift=st.integers(1, 120), D=st.integers(1, 8),
       seed=st.integers(0, 2 ** 31))
def test_patches_fuzz(T, W, shift, D, seed):
    rng = np.random.default_rng(seed)
    FV = rng.standard_normal((D, T))
    got = extract_patches_np(FV, W, shift)
    # Oracle: literal restatement of the reference semantics.
    FV1 = FV.copy()
    full = FV.copy()
    while full.shape[1] <= W:
        full = np.append(full, FV1, axis=1)
    half = W // 2
    starts = [i - half for i in range(half, full.shape[1] - half, shift)]
    assert got.shape == (len(starts), D, W)
    assert num_patches(T, W, shift) == len(starts)
    for k, s in enumerate(starts):
        np.testing.assert_array_equal(got[k], full[:, s:s + W])


@settings(**_SETTINGS)
@given(n=st.integers(2, 64), seed=st.integers(0, 2 ** 31))
def test_median_network_fuzz(n, seed):
    # Networks must place the n//2 order statistic for ANY n (jnp.median
    # of odd windows = middle element; even n -> upper middle wire, which
    # is what the selection uses internally).
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((200, n))
    v = [x[:, i].copy() for i in range(n)]
    for i, j in median_network(n):
        lo = np.minimum(v[i], v[j])
        hi = np.maximum(v[i], v[j])
        v[i], v[j] = lo, hi
    want = np.sort(x, axis=1)[:, n // 2]
    np.testing.assert_allclose(v[n // 2], want)


@settings(**_SETTINGS)
@given(seed=st.integers(0, 2 ** 31), length=st.integers(400, 8000))
def test_istft_roundtrip_fuzz(seed, length):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(length + 800).astype(np.float32)
    S = jstft.stft(jnp.asarray(x), n_fft=400, win_length=400, hop_length=160)
    y = np.asarray(jstft.istft(S, n_fft=400, win_length=400, hop_length=160,
                               length=len(x)))
    err = np.abs(y[400:-400] - x[400:-400])
    assert err.max() < 1e-4
