"""Smoke tests for the benchmark tools' subprocess child modes.

The tools run every device leg / model profile in its own subprocess,
one at a time, so each program is timed alone and one JAX process holds
the card.  These tests exercise the child entry points in-process on the
CPU mesh so the plumbing (corpus setup, batcher construction, leg
selection, JSON row format) can't bitrot between GPU runs.  Times are
meaningless on CPU; only structure is asserted.
"""

import json
import sys

import pytest


@pytest.fixture(autouse=True)
def fast_time_op(request, monkeypatch):
    """CPU timings are meaningless here; run each leg's program once for
    validity and skip the multi-chain timing loops.

    Tests marked ``real_time_op`` opt out and get the genuine timing
    path (reloading the module mid-test to undo the stub is fragile:
    it recreates every module object and fights monkeypatch teardown).
    """
    if request.node.get_closest_marker("real_time_op"):
        yield
        return
    from sm_hpss_mtl_tpu.utils import benchmarking

    def stub(fn, carry, **kw):
        import jax
        jax.block_until_ready(fn(carry))
        return 1e-3
    monkeypatch.setattr(benchmarking, "time_op", stub)
    # profile_models binds time_op at import; patch that binding too.
    sys.path.insert(0, "/root/repo")
    import tools.profile_models as pm
    monkeypatch.setattr(pm, "time_op", stub)
    yield


@pytest.fixture(scope="module")
def bench_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe_bench"))
    sys.path.insert(0, "/root/repo")
    from tools.bench_pipeline import ensure_corpus
    files = ensure_corpus(root)
    assert set(files) == {"music", "speech", "speech+music"}
    return root


def test_bench_pipeline_host_leg(bench_corpus, capsys):
    from tools.bench_pipeline import run_child_leg
    run_child_leg("host_step", bench_corpus)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["leg"] == "host_step"
    assert row["ms"] > 0


def test_bench_pipeline_fused_leg(bench_corpus, capsys):
    from tools.bench_pipeline import run_child_leg
    run_child_leg("fused_Lemaire_et_al_MTL", bench_corpus)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["leg"] == "fused_Lemaire_et_al_MTL"
    assert row["ms"] > 0


def test_bench_pipeline_host_batchers(bench_corpus):
    from tools.bench_pipeline import (host_ms_per_batch, make_crop_batcher,
                                      make_host_batcher)
    it_hot, cfg = make_host_batcher(bench_corpus, _files(bench_corpus))
    it_cold, _ = make_host_batcher(bench_corpus, _files(bench_corpus),
                                   patch_cache_mb=0)
    crop = iter(make_crop_batcher(bench_corpus, _files(bench_corpus), cfg))
    for it in (it_hot, it_cold, crop):
        assert host_ms_per_batch(it, n=2) > 0


def _files(root):
    from tools.bench_pipeline import ensure_corpus
    return ensure_corpus(root)


def test_profile_models_child_row():
    from tools.profile_models import model_row, peaks_for
    row = model_row("Lemaire_et_al_MTL",
                    peaks=peaks_for("NVIDIA H100 80GB HBM3"))
    for key in ("train_step_ms", "train_step_gflops",
                "train_step_bytes_gb", "train_step_achieved_gbps",
                "train_step_hbm_frac", "forward_ms"):
        assert key in row, key
    assert row["train_step_ms"] > 0
    assert row["train_step_gflops"] > 0


def test_bench_serving_child_rows(capsys):
    """featurize / loop / scan / serve_dev legs on a seconds-scale
    broadcast."""
    from tools.bench_serving import run_child
    hours = 30.0 / 3600.0  # 30 s of audio
    for leg in ("featurize", "loop", "scan", "serve_dev"):
        row = run_child(leg, hours, repeats=1)
        out_row = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        assert out_row == row
        assert row["leg"] == leg and row["n_frames"] > 0
        assert row["best_s"] > 0 and row["realtime_factor"] > 0


def test_scale_rehearsal_pipeline_row(tmp_path, capsys):
    """The scale-rehearsal child runs a full (tiny) fold end-to-end and
    reports duration-derived steps, per-epoch wall clock, and cache
    stats — the plumbing the at-scale run depends on."""
    from tools.scale_rehearsal import ensure_corpus, run_pipeline
    root = str(tmp_path / "scale_smoke")
    ensure_corpus(root, n_music=4, n_speech=4, dur_scale=0.08)
    row = run_pipeline(root, "host", epochs=2)
    out_row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_row == row
    assert row["pipeline"] == "host"
    assert row["tr_steps"] >= 1 and row["corpus_hours"] > 0
    assert row["epochs_run"] >= 1
    assert len(row["epoch_train_s"]) == row["epochs_run"]
    assert row["sustained_steps_per_s_warm"] > 0
    assert "cache_stats" in row


@pytest.mark.quick
@pytest.mark.real_time_op
def test_time_op_median_stat():
    """The drift-robust stat='median' path returns a positive per-iter
    time consistent with stat='min' on a deterministic op."""
    import jax.numpy as jnp
    from sm_hpss_mtl_tpu.utils import benchmarking

    def step(x):
        return jnp.tanh(x @ x) * 1.0001

    x = jnp.eye(256, dtype=jnp.float32)
    # Noisy CI can make a differenced timing negative, which time_op
    # clamps to 1e-9; retry once before settling, and only compare the
    # two stats when neither sample was clamped.
    for _ in range(2):
        t_min = benchmarking.time_op(step, x, iters=(2, 10), repeats=3)
        t_med = benchmarking.time_op(step, x, iters=(2, 10), repeats=3,
                                     stat="median")
        if t_min > 1e-9 and t_med > 1e-9:
            break
    assert t_min > 0 and t_med > 0
    if t_min > 1e-9 and t_med > 1e-9:
        # Same op, same machine: the two stats agree within an order of
        # magnitude (min <= ~median by construction up to timer noise).
        assert t_med < 50 * t_min and t_min < 50 * t_med
