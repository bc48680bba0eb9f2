"""HPSS selection-network tests.

The selection networks are validated exhaustively against ``np.median``;
the sliding medians they build, and the HPSS that consumes them, against
the numpy/scipy reference (``ops.reference``) — including planes shorter
than the median window, where the symmetric padding reflects more than
once.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import hpss as hp
from sm_hpss_mtl_tpu.ops import reference as ref

pytestmark = pytest.mark.quick


@pytest.mark.parametrize("n", [3, 5, 7, 11, 15, 21, 31])
def test_median_network_matches_np_median(rng, n):
    pairs = hp.median_network(n)
    assert len(pairs) <= len(hp.batcher_pairs(n))
    x = rng.standard_normal((5000, n))
    v = [x[:, i].copy() for i in range(n)]
    for i, j in pairs:
        lo = np.minimum(v[i], v[j])
        hi = np.maximum(v[i], v[j])
        v[i], v[j] = lo, hi
    np.testing.assert_allclose(v[n // 2], np.median(x, axis=1))


@pytest.mark.parametrize("l_harm,l_perc,F,T", [
    (21, 11, 201, 300),     # flagship geometry
    (21, 11, 257, 64),      # n_fft=512 (Jang presets)
    (21, 11, 31, 7),        # T < l_harm
    (21, 11, 9, 3),         # T and F below both windows
    (7, 5, 12, 1),          # a single frame
    (31, 17, 40, 64),
    (5, 3, 4, 2),
    (3, 3, 5, 5),
])
def test_sliding_median_matches_reference(l_harm, l_perc, F, T):
    S = np.abs(np.random.default_rng(F * 1000 + T).standard_normal(
        (2, F, T))).astype(np.float32)
    harm = np.asarray(hp._sliding_median(jnp.asarray(S), l_harm, axis=2))
    perc = np.asarray(hp._sliding_median(jnp.asarray(S), l_perc, axis=1))
    for b in range(2):
        want_h, want_p = ref.hpss_medians(S[b], l_harm, l_perc)
        np.testing.assert_array_equal(harm[b], want_h)
        np.testing.assert_array_equal(perc[b], want_p)


@pytest.mark.parametrize("l_harm,l_perc,F,T", [(21, 11, 201, 120),
                                                 (7, 5, 30, 40)])
def test_hpss_from_time_extended_matches_hpss(l_harm, l_perc, F, T):
    """A time axis pre-extended by the symmetric mirror gives exactly the
    whole-plane HPSS (the contract the time-sharded paths rely on)."""
    S = np.abs(np.random.default_rng(T).standard_normal(
        (2, F, T))).astype(np.float32)
    ht = l_harm // 2
    ext = np.pad(S, ((0, 0), (0, 0), (ht, ht)), mode="symmetric")
    H, P = hp.hpss_from_time_extended(jnp.asarray(ext), l_harm=l_harm,
                                      l_perc=l_perc)
    Hw, Pw = hp.hpss(jnp.asarray(S), l_harm=l_harm, l_perc=l_perc)
    # Same arithmetic, fused differently: equal to float32 rounding.
    np.testing.assert_allclose(np.asarray(H), np.asarray(Hw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(P), np.asarray(Pw), rtol=1e-6,
                               atol=1e-6)
