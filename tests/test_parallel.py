"""Multi-chip tests on the virtual 8-device CPU mesh (conftest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model
from sm_hpss_mtl_tpu.ops import hpss as jhpss
from sm_hpss_mtl_tpu.parallel import (hpss_time_sharded, make_dp_train_step,
                                      make_mesh, shard_batch)
from sm_hpss_mtl_tpu.train import TrainState, for_model

RNG = jax.random.PRNGKey(0)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8 and mesh.shape["time"] == 1
    # TP-ready placeholder axis (SURVEY §2.5): always present, default 1.
    assert mesh.shape["model"] == 1
    mesh = make_mesh(n_data=4, n_time=2)
    assert mesh.shape["data"] == 4 and mesh.shape["time"] == 2
    mesh = make_mesh(n_time=2, n_model=2)
    assert mesh.shape == {"data": 2, "time": 2, "model": 2}


def test_model_sharding_placeholder():
    from sm_hpss_mtl_tpu.parallel import model_sharding
    mesh = make_mesh()
    sh = model_sharding(mesh, axis=1, ndim=2)
    x = jax.device_put(jnp.ones((4, 4)), sh)
    assert x.sharding.spec == jax.sharding.PartitionSpec(None, "model")


def test_hpss_time_sharded_matches_unsharded(rng):
    mesh = make_mesh(n_data=1, n_time=8)
    S = np.abs(rng.standard_normal((2, 31, 8 * 40))).astype(np.float32)
    H0, P0 = jhpss.hpss(jnp.asarray(S), l_harm=21, l_perc=11)
    H1, P1 = hpss_time_sharded(jnp.asarray(S), mesh, l_harm=21, l_perc=11)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P0), atol=1e-6)


def test_hpss_time_sharded_guards(rng):
    mesh = make_mesh(n_data=1, n_time=8)
    S = jnp.asarray(np.abs(rng.standard_normal((1, 8, 100))).astype(np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        hpss_time_sharded(S, mesh)
    small = jnp.asarray(np.abs(rng.standard_normal((1, 8, 8 * 8))).astype(np.float32))
    with pytest.raises(ValueError, match="halo"):
        hpss_time_sharded(small, mesh)


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


def test_dp_train_step_matches_single_device():
    """One DP step on an 8-device mesh must equal the single-device step
    (global-batch BN + summed grads make DP semantically transparent)."""
    from sm_hpss_mtl_tpu.train import make_train_step

    spec = get_model("Lemaire_et_al_MTL", dropout_rate=0.0)
    bs = 8  # 24 total rows -> divisible by 8 devices
    x = jax.random.normal(RNG, (3 * bs, 16, 12))
    labels = _mtl_labels(bs)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    state = TrainState.create(spec.module, opt, x, RNG)

    # Single device.
    step1 = make_train_step(spec.module, opt, mtl=True)
    s1, m1 = step1(state, x, labels, RNG)

    # 8-device DP.
    mesh = make_mesh()
    dp_step = make_dp_train_step(spec.module, opt, mesh, mtl=True)
    xb, lb = shard_batch((x, labels), mesh)
    s8, m8 = dp_step(state, xb, lb, RNG)

    np.testing.assert_allclose(float(m1["loss"]), float(m8["loss"]),
                               rtol=2e-5)
    l1 = jax.tree_util.tree_leaves(s1.params)
    l8 = jax.tree_util.tree_leaves(s8.params)
    for a, b in zip(l1, l8):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_frontend_time_sharded_matches_unsharded(rng):
    # Audio->mel frontend sharded over 'time' with audio halo ppermute:
    # equal to the unsharded chain to f32 rounding, including the
    # edge-mirror selection at the global-edge shards.
    from jax.sharding import Mesh
    from sm_hpss_mtl_tpu.ops import mel as mel_mod
    from sm_hpss_mtl_tpu.ops.featuregram import stft_hpss
    from sm_hpss_mtl_tpu.parallel import stft_hpss_mel_time_sharded

    M = mel_mod.mel_filterbank(22050, 400, 24)
    T = 192                                # 8 shards x 24 frames
    y = rng.standard_normal((2, 400 + (T - 1) * 160)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("time",))
    Hs, Ps = stft_hpss_mel_time_sharded(jnp.asarray(y), M, mesh)
    Hu, Pu = stft_hpss(jnp.asarray(y), M)
    np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(Ps), np.asarray(Pu), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("feat_name", ["LogMelHarmPercSpec", "HarmPercSpec"])
def test_featuregram_time_sharded_matches_on_meshes(rng, n_dev, feat_name):
    """The multi-device featuregram (frame count not divisible by the
    mesh, so the tail splice runs) equals the one-device featuregram."""
    from jax.sharding import Mesh
    from sm_hpss_mtl_tpu.ops.featuregram import featuregram
    from sm_hpss_mtl_tpu.parallel import featuregram_time_sharded

    y = rng.standard_normal((2, 16000 * 2 + 37)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("time",))
    got = np.asarray(featuregram_time_sharded(
        jnp.asarray(y), mesh, feat_name=feat_name, n_mels=24))
    want = np.asarray(featuregram(jnp.asarray(y), feat_name=feat_name,
                                  n_mels=24))
    assert got.shape == want.shape
    scale = 1.0 if feat_name.startswith("Log") else np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_frontend_time_sharded_validations(rng):
    from jax.sharding import Mesh
    from sm_hpss_mtl_tpu.ops import mel as mel_mod
    from sm_hpss_mtl_tpu.parallel import stft_hpss_mel_time_sharded

    M = mel_mod.mel_filterbank(22050, 400, 8)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("time",))
    y = jnp.zeros((1, 400 + 97 * 160))     # T=98, not divisible by 8
    with pytest.raises(ValueError, match="not divisible"):
        stft_hpss_mel_time_sharded(y, M, mesh)
    y = jnp.zeros((1, 400 + 95 * 160))     # T=96 -> T_local=12 < 2*ht
    with pytest.raises(ValueError, match="smaller than"):
        stft_hpss_mel_time_sharded(y, M, mesh)


def test_featuregram_time_sharded_matches_featuregram(rng):
    # Long-audio multi-chip featuregram (DAFx path): T=205 not divisible
    # by 8 -> exercises the pad + tail-splice; parity vs ops.featuregram.
    from jax.sharding import Mesh
    from sm_hpss_mtl_tpu.ops import featuregram as fg
    from sm_hpss_mtl_tpu.parallel import featuregram_time_sharded

    T = 205
    y = rng.standard_normal((400 + (T - 1) * 160,)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("time",))
    got = featuregram_time_sharded(jnp.asarray(y), mesh,
                                   feat_name="LogMelHarmPercSpec",
                                   n_mels=24)
    want = fg.featuregram(jnp.asarray(y), feat_name="LogMelHarmPercSpec",
                          n_mels=24)
    assert got.shape == want.shape == (48, T)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError, match="HPSS featName"):
        featuregram_time_sharded(jnp.asarray(y), mesh, feat_name="LogSpec")


def test_featuregram_time_sharded_fullres(rng):
    # Non-mel HPSS family over the sharded frontend (Papakostas/Jang
    # featNames): full-resolution rows, tail splice exercised.
    from jax.sharding import Mesh
    from sm_hpss_mtl_tpu.ops import featuregram as fg
    from sm_hpss_mtl_tpu.parallel import featuregram_time_sharded

    T = 203
    y = rng.standard_normal((400 + (T - 1) * 160,)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("time",))
    got = featuregram_time_sharded(jnp.asarray(y), mesh,
                                   feat_name="LogHarmPercSpec")
    want = fg.featuregram(jnp.asarray(y), feat_name="LogHarmPercSpec")
    assert got.shape == want.shape == (402, T)
    # dB-domain features at full resolution carry the bf16x3 DFT error
    # (~0.01 dB, no mel averaging) — use the PARITY dB bar.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=0.05)
