"""Model zoo shape/semantics tests + single-step training smoke tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model
from sm_hpss_mtl_tpu.models.cnn import local_response_normalization
from sm_hpss_mtl_tpu.models.jang import MelScaleLayer, mel_band_weights
from sm_hpss_mtl_tpu.models.tcn import channel_normalization
from sm_hpss_mtl_tpu.ops import reference as ref
from sm_hpss_mtl_tpu.train import TrainState, for_model, make_eval_step, make_train_step

pytestmark = pytest.mark.quick

RNG = jax.random.PRNGKey(0)


def _sample_input(kind, *, n_rows=24, T=32, n_mels=16):
    if kind == "time_mel":
        return jnp.zeros((2, T, n_mels))
    if kind == "image":
        return jnp.zeros((2, n_rows, T, 1))
    if kind == "dual":
        return {"harm_input": jnp.zeros((2, T, n_mels)),
                "perc_input": jnp.zeros((2, T, n_mels))}
    raise ValueError(kind)


def test_lemaire_mtl_outputs():
    spec = get_model("Lemaire_et_al_MTL")
    x = jax.random.normal(RNG, (3, 68, 120))
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    out = spec.module.apply(vars_, x, train=False)
    assert set(out) == {"S", "M", "R", "3C"}
    assert out["S"].shape == (3, 1) and out["M"].shape == (3, 1)
    assert out["R"].shape == (3, 2) and out["3C"].shape == (3, 3)
    np.testing.assert_allclose(np.asarray(out["3C"]).sum(-1), 1.0, rtol=1e-5)
    assert np.all(np.asarray(out["S"]) > 0) and np.all(np.asarray(out["S"]) < 1)


def test_lemaire_5class_outputs():
    spec = get_model("Lemaire_et_al_MTL_5class")
    x = jax.random.normal(RNG, (2, 68, 120))
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    out = spec.module.apply(vars_, x, train=False)
    assert set(out) == {"S", "M", "N", "R", "3C"}
    assert out["R"].shape == (2, 3) and out["3C"].shape == (2, 5)


def test_cascaded_heads_differ_from_parallel():
    spec = get_model("Lemaire_et_al_Cascaded_MTL")
    x = jax.random.normal(RNG, (2, 68, 120))
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    # The cascade concatenates R into S/M paths: S_out kernel has width 18.
    flat = jax.tree_util.tree_map(lambda a: a.shape, vars_["params"])
    s_kernel = vars_["params"]["heads"]["S_out"]["kernel"]
    assert s_kernel.shape[0] == 18  # 16 + 2 SMR units


def test_intermediate_fusion_forward():
    spec = get_model("Lemaire_et_al_MTL_IF")
    x = _sample_input("dual", T=68, n_mels=120)
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    out = spec.module.apply(vars_, x, train=False)
    assert out["3C"].shape == (2, 3)


@pytest.mark.parametrize("name,shape", [
    ("Doukhan_et_al", (2, 21, 68, 1)),
    ("Doukhan_et_al_MTL", (2, 240, 68, 1)),
    ("Papakostas_et_al", (2, 201, 68, 1)),
    ("Papakostas_et_al_MTL", (2, 402, 68, 1)),
])
def test_cnn_models_forward(name, shape):
    spec = get_model(name)
    x = jax.random.normal(RNG, shape)
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    out = spec.module.apply(vars_, x, train=False)
    if spec.mtl:
        assert out["3C"].shape == (2, 3)
    else:
        assert out.shape == (2, 3)
        np.testing.assert_allclose(np.asarray(out).sum(-1), 1.0, rtol=1e-5)


def test_lrn_matches_definition(rng):
    x = rng.standard_normal((2, 3, 4, 13)).astype(np.float32)
    got = np.asarray(local_response_normalization(jnp.asarray(x)))
    # Direct O(C*win) oracle.
    r, bias, alpha, beta = 5, 1.0, 1e-4, 0.75
    want = np.empty_like(x)
    C = x.shape[-1]
    for c in range(C):
        lo, hi = max(0, c - r), min(C, c + r + 1)
        denom = (bias + alpha * (x[..., lo:hi] ** 2).sum(-1)) ** beta
        want[..., c] = x[..., c] / denom
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_channel_normalization():
    x = jnp.asarray([[[3.0, -6.0, 1.5]]])
    out = np.asarray(channel_normalization(x))
    np.testing.assert_allclose(out, np.asarray(x) / (6.0 + 1e-5), rtol=1e-6)


def test_mel_scale_layer_equals_per_band_convs(rng):
    """The banded einsum must equal the reference's per-band cropped convs
    (stride = band height, 'same' temporal padding)."""
    sr, n_fft, n_mels, t_dim = 16000, 128, 8, 5
    M, mask = mel_band_weights(sr, n_fft, n_mels)
    F = M.shape[1]
    x = rng.standard_normal((1, F, 12)).astype(np.float32)

    layer = MelScaleLayer(sr=sr, n_fft=n_fft, n_mels=n_mels, t_dim=t_dim)
    vars_ = layer.init(RNG, jnp.asarray(x))
    out = np.asarray(layer.apply(vars_, jnp.asarray(x)))  # (1, n_mels, T, 3)

    # Oracle: for each band, crop rows and convolve with the mel-initialized
    # kernel, zero-padded temporally.
    T = x.shape[2]
    xp = np.pad(x, ((0, 0), (0, 0), (t_dim // 2, t_dim // 2)))
    for m in range(n_mels):
        rows = np.nonzero(M[m] > 0)[0]
        w = M[m, rows]  # (kw,)
        band = xp[0, rows, :]  # (kw, T+4)
        want_t = np.array([
            (band[:, t:t + t_dim] * w[:, None]).sum() for t in range(T)])
        for c in range(3):
            np.testing.assert_allclose(out[0, m, :, c], want_t,
                                       rtol=1e-4, atol=1e-4)


def test_jang_mtl_forward_smoke():
    spec = get_model("Jang_et_al_MTL", n_mels=24)
    x = jax.random.normal(RNG, (1, 514, 20, 1))
    vars_ = spec.module.init({"params": RNG, "dropout": RNG}, x, train=False)
    out = spec.module.apply(vars_, x, train=False)
    assert out["3C"].shape == (1, 3)


# ---------------------------------------------------------------------------
# Training smoke tests
# ---------------------------------------------------------------------------

def _mtl_labels(bs):
    n = 3 * bs
    y3 = np.zeros((n, 3), np.float32)
    y3[np.arange(n), np.repeat([0, 1, 2], bs)] = 1
    return {
        "S": jnp.asarray(np.repeat([0, 1, 0], bs).astype(np.float32)),
        "M": jnp.asarray(np.repeat([1, 0, 0], bs).astype(np.float32)),
        "R": jnp.asarray(np.concatenate([
            np.tile([1, 0], (bs, 1)), np.tile([0, 1], (bs, 1)),
            np.tile([0.5, 1], (bs, 1))]).astype(np.float32)),
        "3C": jnp.asarray(y3),
    }


def test_train_step_decreases_loss():
    spec = get_model("Lemaire_et_al_MTL", dropout_rate=0.1)
    bs = 4
    x = jax.random.normal(RNG, (3 * bs, 32, 20))
    labels = _mtl_labels(bs)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    state = TrainState.create(spec.module, opt, x, RNG)
    step = make_train_step(spec.module, opt, mtl=True)
    losses = []
    rng = RNG
    for i in range(12):
        rng, sub = jax.random.split(rng)
        state, metrics = step(state, x, labels, sub)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert int(state.step) == 12


def test_eval_step_runs():
    spec = get_model("Lemaire_et_al_MTL", dropout_rate=0.1)
    bs = 2
    x = jax.random.normal(RNG, (3 * bs, 32, 20))
    labels = _mtl_labels(bs)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    state = TrainState.create(spec.module, opt, x, RNG)
    ev = make_eval_step(spec.module, mtl=True)
    m = ev(state, x, labels)
    assert set(m) >= {"loss", "accuracy", "S_loss", "M_loss", "R_loss", "3C_loss"}
    assert np.isfinite(float(m["loss"]))


def test_batch_stats_update():
    spec = get_model("Lemaire_et_al_MTL", dropout_rate=0.0)
    bs = 2
    x = jax.random.normal(RNG, (3 * bs, 32, 20)) * 5 + 2
    labels = _mtl_labels(bs)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    state = TrainState.create(spec.module, opt, x, RNG)
    before = jax.tree_util.tree_leaves(state.batch_stats)[0].copy()
    step = make_train_step(spec.module, opt, mtl=True)
    state, _ = step(state, x, labels, RNG)
    after = jax.tree_util.tree_leaves(state.batch_stats)[0]
    assert not np.allclose(np.asarray(before), np.asarray(after))


def test_fast_max_pool_matches_flax(rng):
    """models.pool.max_pool (reshape-max / strided-slice-max) must equal
    flax's nn.max_pool for every config the models use."""
    import flax.linen as nn
    from sm_hpss_mtl_tpu.models.pool import max_pool

    cases = [
        ((2, 2), (2, 2), "VALID"), ((2, 2), (2, 2), "SAME"),
        ((1, 12), (1, 12), "VALID"), ((3, 3), (2, 2), "SAME"),
    ]
    for H, W in ((240, 68), (31, 17), (8, 24)):
        x = jnp.asarray(rng.standard_normal((2, H, W, 5)).astype(np.float32))
        for window, strides, pad in cases:
            if pad == "VALID" and (H < window[0] or W < window[1]):
                continue
            got = max_pool(x, window, strides, padding=pad)
            want = nn.max_pool(x, window, strides=strides, padding=pad)
            assert got.shape == want.shape, (window, strides, pad, H, W)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=0)
