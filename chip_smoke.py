"""Smoke check of the system's main path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: featurize, train, serve, GPU tests
    python chip_smoke.py --four-gpus  # four GPUs: the multi-device paths only

Drives the featurizer, the trainer and the segmenter through the entry
points a user calls, at the flagship's full width (Lemaire_et_al_MTL on
LogMelHarmPercSpec: n_mels 120, W=68 patches, batch 48 = 16 per class),
with random weights and synthetic audio made from a seed.  Each device
result is compared with the plain numpy reference (``ops.reference``) or
with the same program run on the CPU.

Phases (one GPU):

1. device     JAX's first device must be a GPU; prints its kind and the
              card's name and power limit.
2. featurize  ``featuregram`` on 16 x 30 s of audio for LogMelHarmPercSpec
              and HarmPercSpec (F=201); two items against the float64
              reference: log-mel within 0.02 dB, HPSS masks within 1e-3
              relative (the BASELINE.md fidelity bars).
3. train      ``cli.mtl.main`` on a toy corpus through the host and the
              device pipeline, with steps/s from the epoch log; then one
              train step on the GPU against the same step on the CPU
              (loss within rtol 1e-4 at ``highest`` matmul precision; the
              default-precision difference is printed, not gated).
4. serve      ``cli.segment.main`` on a 10-minute recording (the slabbed
              featurizer path) with phase 3's checkpoint: finite tracks of
              the right shape; ``featuregram_slabbed`` equals the
              whole-signal ``featuregram``.
5. gpu-tests  the tests marked ``gpu`` (``pytest -m gpu``).

With ``--four-gpus`` only the multi-device paths run, each against one
device: ``featuregram_time_sharded`` on a 4-device time mesh (the route
``cli.segment`` takes with several devices) and ``make_dp_train_step``
on a 4-device data mesh at ``highest`` precision.

Any failure exits non-zero.  The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
import tempfile
import time

# The CPU backend is the reference for the train-step check; keep it
# available beside the GPU when the platform list is pinned.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 16000
MODEL = "Lemaire_et_al_MTL"
FEAT = "LogMelHarmPercSpec"
N_MELS = 120
W = 68
PER_CLASS = 16                      # batch 48 over the three classes
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


@contextlib.contextmanager
def phase(name: str):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        log(f"== phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        raise
    log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")


def synth_audio(rng, n_items: int, seconds: float) -> np.ndarray:
    """Music-plus-speech mixtures, peak-normalized, float32."""
    from sm_hpss_mtl_tpu.data.audio import _synth_music, _synth_speech
    n = int(seconds * SR)
    out = np.empty((n_items, n), np.float32)
    for i in range(n_items):
        x = _synth_music(rng, n, SR) + _synth_speech(rng, n, SR)
        out[i] = x / np.abs(x).max()
    return out


def mtl_labels(per_class: int) -> dict:
    n = 3 * per_class
    y3 = np.zeros((n, 3), np.float32)
    y3[np.arange(n), np.repeat([0, 1, 2], per_class)] = 1
    return {
        "S": np.repeat([0, 1, 0], per_class).astype(np.float32),
        "M": np.repeat([1, 0, 0], per_class).astype(np.float32),
        "R": np.concatenate([np.tile([1, 0], (per_class, 1)),
                             np.tile([0, 1], (per_class, 1)),
                             np.tile([0.5, 1], (per_class, 1))]
                            ).astype(np.float32),
        "3C": y3,
    }


def abs_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# One GPU
# ---------------------------------------------------------------------------

def phase_featurize(rng) -> None:
    from sm_hpss_mtl_tpu.ops import featuregram as fg
    from sm_hpss_mtl_tpu.ops import hpss as hpss_mod
    from sm_hpss_mtl_tpu.ops import reference as ref

    audio = synth_audio(rng, 16, 30.0)
    y = jnp.asarray(audio)
    B = audio.shape[0]
    items = (0, B - 1)
    for name in (FEAT, "HarmPercSpec"):
        t0 = time.perf_counter()
        out = np.asarray(fg.featuregram(y, feat_name=name, n_mels=N_MELS))
        dt = time.perf_counter() - t0
        D = fg.feature_dim(name, n_mels=N_MELS)
        T = 1 + (audio.shape[1] - 400) // 160
        check(out.shape == (B, D, T), f"{name}: shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{name}: non-finite output")
        for i in items:
            want = ref.featuregram(audio[i], name, n_mels=N_MELS)
            if name.startswith("Log"):
                err = float(np.max(np.abs(out[i] - want)))
                log(f"{name} item {i}: max |dB error| {err:.3e} "
                    f"(bar 0.02)")
                check(err <= 0.02, f"{name} item {i}: {err} dB > 0.02")
            else:
                err = rel_err(out[i], want)
                log(f"{name} item {i}: max error / peak {err:.3e}")
                check(err <= 1e-3, f"{name} item {i}: {err} > 1e-3")
        log(f"{name}: ({B}, {D}, {T}) in {dt:.2f} s (first call, "
            f"compile included)")

    # The masks' own error: the GPU's HPSS and the reference's from one
    # float32 spectrogram (the STFT's agreement is the HarmPercSpec check
    # above), as tests/test_dsp_parity.py measures it.
    for i in items:
        S = ref.stft_mag(audio[i].astype(np.float64), 400, 400,
                         160).astype(np.float32)
        mh, mp = (np.asarray(m) for m in hpss_mod.hpss_masks(jnp.asarray(S)))
        gh, gp = ref.hpss_masks(S, 21, 11)
        for tag, got, want in (("harmonic", mh, gh),
                               ("percussive", mp, gp)):
            err = float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))
            log(f"{tag} mask item {i}: max relative error {err:.3e} "
                f"(bar 1e-3)")
            check(err < 1e-3, f"{tag} mask item {i}: {err} >= 1e-3")


def _epoch_rates(op_dir: str, tr_steps: int) -> list[float]:
    with open(os.path.join(op_dir, "fold0_log.csv")) as f:
        rows = list(csv.DictReader(f))
    # Epoch 0 compiles; later epochs are the steady state.
    return [tr_steps / float(r["epoch_train_s"]) for r in rows[1:]]


def phase_train(work: str) -> str:
    """Both pipelines through ``cli.mtl``; returns a checkpoint dir."""
    from sm_hpss_mtl_tpu.cli import mtl
    from sm_hpss_mtl_tpu.data import make_toy_musan

    root = make_toy_musan(os.path.join(work, "toy"), n_per_class=24,
                          duration_s=4.0, seed=SEED)
    tr_steps = 100
    ckpt = None
    for pipeline in ("host", "device"):
        t0 = time.perf_counter()
        results = mtl.main([
            "--data", root, "--model", MODEL,
            "--features", os.path.join(work, "features"),
            "--output", os.path.join(work, f"results_{pipeline}"),
            "--epochs", "3", "--batch-size", str(PER_CLASS),
            "--patch-size", str(W), "--patch-shift", str(W),
            "--tr-steps", str(tr_steps), "--v-steps", "2", "--folds", "0",
            "--pipeline", pipeline, "--seed", str(SEED)])
        row = results[0]["row"]
        check(np.isfinite(row["val_loss"]), f"{pipeline}: val loss "
              f"{row['val_loss']}")
        rates = _epoch_rates(results[0]["op_dir"], tr_steps)
        log(f"pipeline {pipeline}: steps/s per steady epoch "
            f"{[round(r, 2) for r in rates]} (batch {3 * PER_CLASS}, "
            f"W={W}, n_mels {N_MELS}); fold run "
            f"{time.perf_counter() - t0:.1f} s")
        if ckpt is None:
            ckpt = os.path.join(results[0]["op_dir"], "fold0_ckpt")
    check(os.path.exists(os.path.join(ckpt, "state.npz")),
          f"no checkpoint in {ckpt}")

    # One train step on the GPU against the same step on the CPU.
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model, make_train_step

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    spec = get_model(MODEL, n_mels=N_MELS)
    opt, _ = for_model(MODEL, tr_steps=1000)
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((3 * PER_CLASS, W, 2 * N_MELS)).astype(np.float32)
    labels = mtl_labels(PER_CLASS)
    key = jax.random.PRNGKey(SEED)
    with jax.default_device(cpu):
        state = TrainState.create(spec.module, opt, jnp.asarray(x), key)

    def one_step(device, precision):
        with jax.default_matmul_precision(precision):
            step = make_train_step(spec.module, opt, mtl=True)
            args = jax.device_put((state, x, labels, key), device)
            new, metrics = step(*args)
            return float(metrics["loss"]), jax.device_get(new.params)

    for precision in ("highest", "default"):
        l_gpu, p_gpu = one_step(gpu, precision)
        l_cpu, p_cpu = one_step(cpu, precision)
        d_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
        d_par = max(abs_err(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(p_gpu), jax.tree_util.tree_leaves(p_cpu)))
        log(f"train step GPU vs CPU at {precision} precision: loss "
            f"{l_gpu:.6f} vs {l_cpu:.6f} (relative {d_loss:.2e}); "
            f"max |updated-param difference| {d_par:.2e}")
        if precision == "highest":
            check(d_loss <= 1e-4, f"loss differs by {d_loss} > 1e-4")
    return ckpt


def phase_serve(work: str, ckpt: str, rng) -> None:
    from sm_hpss_mtl_tpu.cli import segment
    from sm_hpss_mtl_tpu.data.audio import write_wav
    from sm_hpss_mtl_tpu.ops.featuregram import (featuregram,
                                                 featuregram_slabbed)

    x = synth_audio(rng, 1, 600.0)[0]
    T = 1 + (len(x) - 400) // 160
    check(T > segment.SLAB_THRESHOLD_FRAMES, "recording too short for slabs")
    wav = os.path.join(work, "broadcast.wav")
    write_wav(wav, x, SR)
    out = os.path.join(work, "labels.npz")
    t0 = time.perf_counter()
    prob, labels = segment.main([wav, "--ckpt", ckpt, "--model", MODEL,
                                 "--out", out])
    dt = time.perf_counter() - t0
    with np.load(out) as z:
        tracks = {k: z[k] for k in z.files if k.startswith("track_")}
    check(len(prob) == len(labels) > 0, "empty label track")
    check(bool(np.isfinite(prob).all()), "non-finite probabilities")
    for k, v in tracks.items():
        check(v.shape[0] == len(prob), f"{k}: {v.shape} vs {len(prob)}")
        check(bool(np.isfinite(v).all()), f"{k}: non-finite")
    log(f"segment: {T} frames -> {len(labels)} labels, tracks "
        f"{ {k: v.shape for k, v in tracks.items()} }, {dt:.1f} s "
        f"(compile included)")

    # Audio as written to and read back from the wav file.
    from sm_hpss_mtl_tpu.data.audio import read_audio
    x, _ = read_audio(wav)
    slab = np.asarray(featuregram_slabbed(x, feat_name=FEAT, n_mels=N_MELS))
    whole = np.asarray(featuregram(jnp.asarray(x)[None], feat_name=FEAT,
                                   n_mels=N_MELS))[0]
    err = float(np.max(np.abs(slab - whole)))
    log(f"featuregram_slabbed vs whole-signal featuregram "
        f"{whole.shape}: max |dB difference| {err:.3e}")
    check(slab.shape == whole.shape, f"{slab.shape} vs {whole.shape}")
    check(err <= 1e-3, f"slabbed featuregram differs by {err} dB")


def phase_gpu_tests() -> None:
    import pytest

    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")])
    finally:
        os.environ.clear()
        os.environ.update(env)
    check(rc == 0, f"pytest -m gpu exited {int(rc)}")


# ---------------------------------------------------------------------------
# Four GPUs
# ---------------------------------------------------------------------------

def phase_four_gpus(rng) -> None:
    from jax.sharding import Mesh

    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.ops.featuregram import featuregram
    from sm_hpss_mtl_tpu.parallel import featuregram_time_sharded
    from sm_hpss_mtl_tpu.parallel.dp import make_dp_train_step, shard_batch
    from sm_hpss_mtl_tpu.parallel.mesh import make_mesh
    from sm_hpss_mtl_tpu.train import TrainState, for_model, make_train_step

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-gpus needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]

    x = synth_audio(rng, 1, 600.0)[0]
    mesh_t = Mesh(np.asarray(devs), ("time",))
    t0 = time.perf_counter()
    got = np.asarray(featuregram_time_sharded(jnp.asarray(x), mesh_t,
                                              feat_name=FEAT, n_mels=N_MELS))
    dt = time.perf_counter() - t0
    want = np.asarray(featuregram(jax.device_put(x[None], devs[0]),
                                  feat_name=FEAT, n_mels=N_MELS))[0]
    err = float(np.max(np.abs(got - want)))
    log(f"featuregram_time_sharded on 4 GPUs vs one GPU {want.shape}: max "
        f"|dB difference| {err:.3e}; {dt:.1f} s (compile included)")
    check(got.shape == want.shape, f"{got.shape} vs {want.shape}")
    check(err <= 1e-3, f"time-sharded featuregram differs by {err} dB")

    spec = get_model(MODEL, n_mels=N_MELS, dropout_rate=0.0)
    opt, _ = for_model(MODEL, tr_steps=1000)
    xb = rng.standard_normal((3 * PER_CLASS, W, 2 * N_MELS)).astype(np.float32)
    labels = mtl_labels(PER_CLASS)
    key = jax.random.PRNGKey(SEED)
    with jax.default_matmul_precision("highest"):
        # Uncommitted on the default device, so both steps may place it.
        state = TrainState.create(spec.module, opt, jnp.asarray(xb), key)
        step1 = make_train_step(spec.module, opt, mtl=True)
        s1, m1 = step1(state, xb, labels, key)
        mesh = make_mesh(n_data=4, n_time=1, devices=devs)
        dp_step = make_dp_train_step(spec.module, opt, mesh, mtl=True)
        s4, m4 = dp_step(state, *shard_batch((xb, labels), mesh), key)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    d_loss = abs(l1 - l4) / abs(l1)
    d_stats = max(rel_err(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(s4.batch_stats),
        jax.tree_util.tree_leaves(s1.batch_stats)))
    d_par = max(abs_err(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(s4.params),
        jax.tree_util.tree_leaves(s1.params)))
    log(f"DP step on 4 GPUs vs one GPU at highest precision: loss {l4:.6f} "
        f"vs {l1:.6f} (relative {d_loss:.2e}); max batch-stat error / "
        f"peak {d_stats:.2e}; max |updated-param difference| {d_par:.2e}")
    check(d_loss <= 1e-4, f"DP loss differs by {d_loss} > 1e-4")
    check(d_stats <= 1e-4, f"DP batch stats differ by {d_stats} > 1e-4")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the multi-device paths, on four GPUs")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    with phase("device"):
        sys.path.insert(0, REPO)
        from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache
        from sm_hpss_mtl_tpu.utils.device import card_line, device_report
        log(f"device_kind: {dev.device_kind}; {len(jax.devices())} device(s)")
        log(card_line())
        log(f"compile cache: {enable_compile_cache()}")

    rng = np.random.default_rng(SEED)
    if args.four_gpus:
        with phase("four-gpus"):
            phase_four_gpus(rng)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            with phase("featurize"):
                phase_featurize(rng)
            with phase("train"):
                ckpt = phase_train(work)
            with phase("serve"):
                phase_serve(work, ckpt, rng)
        with phase("gpu-tests"):
            phase_gpu_tests()

    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
