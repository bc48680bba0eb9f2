"""The numpy classification metrics against sklearn, and the ``.npz``
checkpointer's round trip."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.eval.metrics import (accuracy, confusion_matrix,
                                          get_performance)


@pytest.mark.parametrize("seed,n,labels,extra", [
    (0, 200, [0, 1, 2], []),            # three classes, all present
    (1, 50, [0, 1, 2, 3, 4], []),       # five classes, some absent
    (2, 120, [0, 1, 2], [7]),           # labels outside ``labels``
    (3, 9, ["mu", "sp", "spmu"], []),   # string labels
    (4, 1, [0, 1], []),                 # one sample: zero denominators
])
def test_get_performance_matches_sklearn(seed, n, labels, extra):
    from sklearn.metrics import confusion_matrix as sk_conf
    from sklearn.metrics import precision_recall_fscore_support

    rng = np.random.default_rng(seed)
    pool = np.asarray(list(labels) + list(extra), dtype=object)
    y_true = list(rng.choice(pool, n))
    y_pred = list(rng.choice(pool, n))
    conf, p, r, f = get_performance(y_pred, y_true, labels)
    np.testing.assert_array_equal(conf, sk_conf(y_true, y_pred,
                                                labels=labels))
    sp, sr, sf, _ = precision_recall_fscore_support(
        y_true, y_pred, labels=labels, average=None, zero_division=0)
    np.testing.assert_array_equal(p, np.round(sp, 4))
    np.testing.assert_array_equal(r, np.round(sr, 4))
    np.testing.assert_array_equal(f, np.round(sf, 4))


def test_confusion_matrix_and_accuracy():
    conf = confusion_matrix([0, 0, 1, 2, 2, 2], [0, 1, 1, 2, 0, 2],
                            labels=[0, 1, 2])
    np.testing.assert_array_equal(conf, [[1, 1, 0], [0, 1, 0], [1, 0, 2]])
    assert accuracy(conf) == round(4 / 6, 4)
    assert accuracy(np.zeros((2, 2), np.int64)) == 0.0


def _state(seed):
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import (TrainState, for_model,
                                       make_train_step)

    spec = get_model("Lemaire_et_al_MTL", n_mels=8)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=10)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (6, 16, 16)), jnp.float32)
    key = jax.random.PRNGKey(seed)
    state = TrainState.create(spec.module, opt, x, key)
    y3 = np.eye(3, dtype=np.float32)[np.repeat([0, 1, 2], 2)]
    labels = {"S": y3[:, 1], "M": y3[:, 0],
              "R": np.stack([y3[:, 0] + 0.5 * y3[:, 2],
                             y3[:, 1] + y3[:, 2]], 1), "3C": y3}
    state, _ = make_train_step(spec.module, opt, mtl=True)(state, x,
                                                           labels, key)
    return state


def test_checkpoint_round_trip(tmp_path):
    from sm_hpss_mtl_tpu.train.checkpoint import (checkpoint_exists,
                                                  restore_checkpoint,
                                                  save_checkpoint,
                                                  update_metadata)

    state = _state(0)                  # one step taken: Adam moments set
    path = str(tmp_path / "ckpt")
    assert not checkpoint_exists(path)
    save_checkpoint(path, state, {"epochs": 3, "lr": 1e-3})
    update_metadata(path, {"completed": True})
    assert checkpoint_exists(path)
    assert sorted(os.listdir(path)) == ["metadata.json", "state.npz"]

    restored, meta = restore_checkpoint(path, _state(1))
    assert meta == {"epochs": 3, "lr": 1e-3, "completed": True}
    want = jax.tree_util.tree_flatten_with_path(state)[0]
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # A template of another structure is refused, not silently filled.
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    other = get_model("Lemaire_et_al", n_mels=8)
    opt, _ = for_model("Lemaire_et_al", tr_steps=10)
    template = TrainState.create(other.module, opt,
                                 jnp.zeros((2, 16, 16)), jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        restore_checkpoint(path, template)
