"""Tests that need a GPU: the featurizer and one train step as compiled
for the card, against the numpy reference and the CPU.

Marked ``gpu``; the ``gpu`` fixture skips them where JAX finds no GPU.
On a card: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``
(``chip_smoke.py`` runs them as its last phase).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import featuregram as fg
from sm_hpss_mtl_tpu.ops import hpss as hp
from sm_hpss_mtl_tpu.ops import reference as ref

pytestmark = pytest.mark.gpu


def _audio(seconds=4.0, seed=0):
    from sm_hpss_mtl_tpu.data.audio import _synth_music, _synth_speech
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    x = _synth_music(rng, n, 16000) + _synth_speech(rng, n, 16000)
    return (x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("feat_name", ["LogMelHarmPercSpec", "HarmPercSpec",
                                       "LogMelSpec", "LogHarmPercSpec"])
def test_featuregram_on_gpu_matches_reference(gpu, feat_name):
    x = _audio()
    got = np.asarray(fg.featuregram(jax.device_put(x[None], gpu),
                                    feat_name=feat_name))[0]
    want = ref.featuregram(x, feat_name)
    assert got.shape == want.shape
    if feat_name.startswith("Log"):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())


def test_hpss_masks_on_gpu_fidelity(gpu):
    """The BASELINE.md bar, <1e-3 relative mask error, on the card."""
    S = ref.stft_mag(_audio().astype(np.float64), 400, 400,
                     160).astype(np.float32)
    mh, mp = hp.hpss_masks(jax.device_put(S, gpu))
    gh, gp = ref.hpss_masks(S, 21, 11)
    for got, want in ((mh, gh), (mp, gp)):
        rel = np.abs(np.asarray(got) - want) / (np.abs(want) + 1e-3)
        assert rel.max() < 1e-3


def test_featuregram_slabbed_on_gpu_matches_whole(gpu):
    x = _audio(seconds=12.0, seed=1)
    whole = np.asarray(fg.featuregram(jax.device_put(x[None], gpu),
                                      feat_name="LogMelHarmPercSpec"))[0]
    got = fg.featuregram_slabbed(x, feat_name="LogMelHarmPercSpec",
                                 slab_frames=256)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-3)


def test_train_step_on_gpu_matches_cpu(gpu):
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model, make_train_step

    spec = get_model("Lemaire_et_al_MTL", n_mels=40, dropout_rate=0.0)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=100)
    x = np.random.default_rng(2).standard_normal((12, 68, 80)).astype(
        np.float32)
    y3 = np.eye(3, dtype=np.float32)[np.repeat([0, 1, 2], 4)]
    labels = {"S": y3[:, 1], "M": y3[:, 0],
              "R": np.stack([y3[:, 0] + 0.5 * y3[:, 2],
                             y3[:, 1] + y3[:, 2]], 1), "3C": y3}
    key = jax.random.PRNGKey(0)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        state = TrainState.create(spec.module, opt, jnp.asarray(x), key)
    losses = []
    with jax.default_matmul_precision("highest"):
        step = make_train_step(spec.module, opt, mtl=True)
        for dev in (gpu, cpu):
            _, m = step(*jax.device_put((state, x, labels, key), dev))
            losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
