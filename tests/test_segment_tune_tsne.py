"""Tests for streaming segmentation, tuning drivers, and t-SNE prep."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.data import make_toy_musan
from sm_hpss_mtl_tpu.eval.segment import (StreamingSegmenter,
                                          interval_annotations_to_markers,
                                          mode_filtering, smooth_predictions)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_seg")
    return make_toy_musan(str(root), n_per_class=9, duration_s=2.0)


def test_interval_markers():
    rows = [(0.0, 10.0, 1), (20.0, 10.0, 0), (30.0, 10.0, 1)]
    m = interval_annotations_to_markers(rows, n_frames=40)
    # total annotated span = 40 s -> 1 frame per second
    assert m[:10].sum() == 10
    assert m[20:30].sum() == 0      # label 0 intervals ignored
    assert m[30:39].sum() >= 9


def test_mode_filtering_matches_reference_loop():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, 200)
    win = 11
    got = mode_filtering(x.copy(), win)
    # reference loop oracle (DAFx12_...py:81-90)
    want = x.copy()
    half = win // 2
    for i in range(half, len(x) - half):
        w = x[i - half:i + half]
        u, c = np.unique(w, return_counts=True)
        want[i] = u[np.argmax(c)]
    np.testing.assert_array_equal(got, want)


def test_smooth_predictions():
    prob = np.array([0.0] * 50 + [1.0] * 50)
    prob[10] = 1.0  # spike gets removed
    sm, lab = smooth_predictions(prob, 5)
    assert lab[10] == 0 and lab[75] == 1


def test_streaming_segmenter_chunks():
    """A fake predictor marks windows whose mean exceeds 0; chunked
    streaming must reproduce the whole track seamlessly."""
    rng = np.random.default_rng(0)
    D, T, W = 6, 500, 16
    fv = (0.1 * rng.standard_normal((D, T)) - 1.0).astype(np.float32)
    fv[:, 200:300] += 3.0

    def fake_predict(batch):  # (B, W, D) time_mel
        s = 20.0 * jnp.mean(batch, axis=(1, 2), keepdims=False)
        return {"S": jax.nn.sigmoid(s)[:, None], "3C": jnp.zeros((batch.shape[0], 3))}

    seg = StreamingSegmenter(predict_fn=fake_predict, patch_size=W,
                             chunk_frames=100, feat_name="LogMelSpec",
                             standardize=False)
    prob, labels, tracks = seg.segment(fv, head="S", smooth_win=5)
    assert len(prob) == T - W + 1
    # the loud region should be detected
    assert labels[240:260].mean() > 0.9
    assert labels[:100].mean() < 0.2
    # chunk boundaries leave no seams: recompute unchunked
    seg2 = StreamingSegmenter(predict_fn=fake_predict, patch_size=W,
                              chunk_frames=10000, feat_name="LogMelSpec",
                              standardize=False)
    prob2, _, _ = seg2.segment(fv, head="S", smooth_win=5)
    np.testing.assert_allclose(prob, prob2, atol=1e-6)


def test_streaming_segmenter_scan_matches_slab_loop():
    """The lax.scan driver must reproduce the Python slab loop exactly on
    a long track, including ragged final slabs and chunk boundaries."""
    rng = np.random.default_rng(1)
    D, T, W = 6, 1237, 16   # n_windows=1222: not a multiple of chunk=100
    fv = (0.1 * rng.standard_normal((D, T)) - 1.0).astype(np.float32)
    fv[:, 400:700] += 3.0

    def fake_predict(batch):  # (B, W, D) time_mel, jax-traceable
        s = 20.0 * jnp.mean(batch, axis=(1, 2))
        return {"S": jax.nn.sigmoid(s)[:, None],
                "M": jax.nn.sigmoid(-s)[:, None]}

    kw = dict(predict_fn=fake_predict, patch_size=W, chunk_frames=100,
              feat_name="LogMelSpec", standardize=False)
    loop = StreamingSegmenter(**kw)
    scan = StreamingSegmenter(**kw, use_scan=True)
    t1 = loop.frame_probabilities(fv)
    t2 = scan.frame_probabilities(fv)
    assert set(t1) == set(t2)
    for k in t1:
        assert t1[k].shape == t2[k].shape == (T - W + 1, 1)
        np.testing.assert_allclose(t1[k], t2[k], atol=1e-6)


def test_streaming_segmenter_chunk_scope_standardization():
    """standardize=True == slab-local ('chunk') scope: each slab is
    row-standardized independently (the training-featuregram analog for
    streaming), and the scan
    driver matches the slab loop under it."""
    rng = np.random.default_rng(3)
    # full-slab geometry (n_windows = 500 = 5 slabs): on ragged tails the
    # scan driver standardizes its edge-padded final slab, a documented
    # approximation the plain loop doesn't share
    D, T, W, chunk = 6, 515, 16, 100
    fv = rng.standard_normal((D, T)).astype(np.float32)
    fv[:, 200:] += 50.0   # scope matters: global stats != slab stats

    def fake_predict(batch):  # (B, W, D)
        return {"S": jnp.mean(batch, axis=(1, 2))[:, None]}

    kw = dict(predict_fn=fake_predict, patch_size=W, chunk_frames=chunk,
              feat_name="LogMelSpec")
    t_chunk = StreamingSegmenter(**kw, standardize=True)
    t_glob = StreamingSegmenter(**kw, standardize="featuregram")
    t_none = StreamingSegmenter(**kw, standardize=False)
    p_chunk = t_chunk.frame_probabilities(fv)["S"]
    p_glob = t_glob.frame_probabilities(fv)["S"]
    p_none = t_none.frame_probabilities(fv)["S"]
    # all three scopes are genuinely different on this input
    assert np.abs(p_chunk - p_glob).max() > 1e-3
    assert np.abs(p_chunk - p_none).max() > 1e-3
    # manual slab-local standardization of the first slab reproduces the
    # chunk-scope windows
    from sm_hpss_mtl_tpu.ops.patches import standardize_rows
    seg0 = np.asarray(standardize_rows(fv[:, :chunk + W - 1]))
    manual = np.stack([seg0[:, k:k + W].T.mean() for k in range(chunk)])
    np.testing.assert_allclose(p_chunk[:chunk, 0], manual, atol=1e-5)
    # scan driver matches the slab loop under chunk scope
    p_scan = StreamingSegmenter(**kw, standardize=True,
                                use_scan=True).frame_probabilities(fv)["S"]
    np.testing.assert_allclose(p_chunk, p_scan, atol=1e-5)


def test_streaming_segmenter_device_featuregram():
    """A jax.Array featuregram (featuregram_slabbed(device_out=True) —
    the device serving chain) must produce the same tracks as the
    host array through BOTH drivers, with standardization on (the
    production default)."""
    rng = np.random.default_rng(7)
    D, T, W = 6, 337, 16

    def fake_predict(batch):  # (B, W, D)
        s = 5.0 * jnp.mean(batch, axis=(1, 2))
        return {"S": jax.nn.sigmoid(s)[:, None]}

    fv = rng.standard_normal((D, T)).astype(np.float32)
    for scan in (False, True):
        for scope in (True, "featuregram"):
            kw = dict(predict_fn=fake_predict, patch_size=W,
                      chunk_frames=100, feat_name="LogMelSpec",
                      standardize=scope, use_scan=scan)
            t_host = StreamingSegmenter(**kw).frame_probabilities(fv)
            t_dev = StreamingSegmenter(**kw).frame_probabilities(
                jnp.asarray(fv))
            np.testing.assert_allclose(t_host["S"], t_dev["S"], atol=1e-6)


def test_streaming_segmenter_scan_mel_time_kind():
    rng = np.random.default_rng(2)
    D, T, W = 4, 96, 8

    def fake_predict(batch):  # (B, D, W, 1) mel_time
        return jnp.mean(batch, axis=(1, 2, 3), keepdims=False)[:, None]

    fv = rng.standard_normal((D, T)).astype(np.float32)
    kw = dict(predict_fn=fake_predict, patch_size=W, chunk_frames=30,
              input_kind="mel_time", feat_name="LogMelSpec",
              standardize=False)
    t1 = StreamingSegmenter(**kw).frame_probabilities(fv)
    t2 = StreamingSegmenter(**kw, use_scan=True).frame_probabilities(fv)
    np.testing.assert_allclose(t1["3C"], t2["3C"], atol=1e-6)


def test_tsne_grid_search_scores_and_best():
    from sm_hpss_mtl_tpu.cli.tsne import grid_search_tsne
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 1, (30, 5)),
                        rng.normal(6, 1, (30, 5))])
    rows, best = grid_search_tsne(X, perplexities=[5, 10],
                                  exaggerations=[4], learning_rates=[100],
                                  seed=0)
    assert len(rows) == 2
    assert all(np.isfinite(r["kl"]) for r in rows)
    assert best["kl"] == min(r["kl"] for r in rows)
    assert best["embedding"].shape == (60, 2)


def test_tune_grid_tiny(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import tune
    rows, best = tune.main([
        "--data", toy_root, "--output", str(tmp_path),
        "--mode", "grid", "--param", "l_perc", "--epochs", "1",
        "--batch-size", "2", "--patch-size", "16",
        "--tr-steps", "1", "--v-steps", "1"])
    assert len(rows) == 5
    assert os.path.exists(tmp_path / "Performance_Tuning.csv")
    assert np.isfinite(best["val_loss"])


def test_tune_search_tiny(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import tune
    rows, best = tune.main([
        "--data", toy_root, "--output", str(tmp_path),
        "--mode", "search", "--space", "mtl-heads", "--trials", "2",
        "--epochs", "1", "--batch-size", "2", "--patch-size", "16",
        "--tr-steps", "1", "--v-steps", "1"])
    assert len(rows) == 2
    assert {"head_layers", "head_width"} <= set(rows[0])


def test_tune_search_bayes_tiny(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import tune
    rows, best = tune.main([
        "--data", toy_root, "--output", str(tmp_path),
        "--mode", "search", "--space", "mtl-heads", "--algo", "bayes",
        "--trials", "3", "--epochs", "1", "--batch-size", "2",
        "--patch-size", "16", "--tr-steps", "1", "--v-steps", "1"])
    assert len(rows) == 3
    assert {"head_layers", "head_width"} <= set(rows[0])
    # distinct configurations (the optimizer dedups its asks)
    keys = {(r["head_layers"], r["head_width"]) for r in rows}
    assert len(keys) == 3
    assert np.isfinite(best["val_loss"])


def test_tsne_cli(toy_root, tmp_path):
    from sm_hpss_mtl_tpu.cli import tsne
    out = str(tmp_path / "tsne.npz")
    emb, y = tsne.main([
        "--data", toy_root, "--out", out, "--feat-name", "LogMelSpec",
        "--n-mels", "16", "--stat", "Row", "--patch-size", "16",
        "--clusters", "5", "--max-patches", "50"])
    assert emb.shape[1] == 2
    assert len(np.unique(y)) == 3
    assert os.path.exists(out)


def test_scan_segmenter_caches_compiled_program(rng):
    # Review fix: the scan driver must reuse its jitted program across
    # calls of the same shape (a fresh jax.jit per call recompiles the
    # whole scan for every broadcast).
    from sm_hpss_mtl_tpu.eval.segment import StreamingSegmenter

    def predict(batch):
        return {"S": batch.mean(axis=(1, 2)), "M": batch.mean(axis=(1, 2))}

    seg = StreamingSegmenter(predict_fn=predict, patch_size=8,
                             chunk_frames=16, use_scan=True,
                             standardize=False)
    fv = rng.standard_normal((6, 80)).astype(np.float32)
    out1 = seg.frame_probabilities(fv)
    prog1 = seg._scan_cache[1]
    out2 = seg.frame_probabilities(fv + 1.0)
    assert seg._scan_cache[1] is prog1          # same compiled program
    assert out1["S"].shape == out2["S"].shape
    # Different shape -> new program.
    seg.frame_probabilities(rng.standard_normal((6, 120)).astype(np.float32))
    assert seg._scan_cache[1] is not prog1


def test_featurize_broadcast_uses_slabbed_path(monkeypatch):
    # Long broadcasts must featurize via the fixed-shape
    # slabbed path (two compiled programs per config) and match the
    # whole-signal featuregram.  Shrink the threshold so the test stays
    # small.
    from sm_hpss_mtl_tpu.cli import segment as seg_cli
    from sm_hpss_mtl_tpu.ops import featuregram as fg

    monkeypatch.setattr(seg_cli, "SLAB_THRESHOLD_FRAMES", 64)
    called = {}
    orig = fg.featuregram_slabbed

    def spy(*a, **kw):
        called["yes"] = True
        kw.setdefault("slab_frames", 64)
        return orig(*a, **kw)

    monkeypatch.setattr(fg, "featuregram_slabbed", spy)
    # Non-mel feature so the 8-virtual-device conftest mesh does not
    # divert to the time-sharded branch (that leg has its own tests).
    preset = {"feat_name": "LogHarmPercSpec", "n_fft": 400, "n_mels": 24}
    rng_l = np.random.default_rng(7)
    x = rng_l.standard_normal(400 + 199 * 160).astype(np.float32)  # 200 frames
    got = seg_cli._featurize_broadcast(x, preset)
    assert called.get("yes"), "long broadcast did not take the slabbed path"
    whole = np.asarray(fg.featuregram(
        jnp.asarray(x)[None], feat_name="LogHarmPercSpec", n_mels=24)[0])
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, whole, rtol=1e-4, atol=5e-3)
