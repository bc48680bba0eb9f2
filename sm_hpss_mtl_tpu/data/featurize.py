"""File-level featurization with on-device compute and npy caching.

Mirrors ``get_featuregram`` (``/root/reference/lib/preprocessing.py:
355-457``): per (class, file[, mix partner, SMR]) featuregrams, cached as
``<cache_dir>/<classname>/<name>.npy`` with the reference's exact cache
naming (``spstem_mustem_<dB>dB`` for mixtures), so a cache written by one
run is reusable by any driver.

The compute itself runs on the accelerator through
``ops.featuregram.featuregram`` (STFT -> HPSS -> mel ->
log in one program).  Audio is featurized at its exact length — compile
once per distinct length; the persistent JAX compile cache plus the npy
cache make this a first-epoch-only cost, matching the reference's
"slow epoch 1, then disk" behavior with a far faster epoch 1.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import featuregram as fg
from ..ops.mixing import mix_signals_np
from .audio import load_and_preprocess_signal


@dataclass(frozen=True)
class FeatureConfig:
    """Per-model feature settings (the reference's featName/n_fft/n_mels/
    l_harm/l_perc PARAMS sub-dicts, ``Proposed_Work_Results.py:750-797``)."""
    feat_name: str = "LogMelHarmPercSpec"
    sr: int = 16000
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 120
    l_harm: int = 21
    l_perc: int = 11
    Tw: int = 25
    Ts: int = 10

    @property
    def dim(self) -> int:
        return fg.feature_dim(self.feat_name, n_fft=self.n_fft,
                              n_mels=self.n_mels)


def mixture_cache_name(sp_path: str, mu_path: str, target_db) -> str:
    stem = lambda p: os.path.basename(p).rsplit(".", 1)[0]
    if sp_path and mu_path:
        return f"{stem(sp_path)}_{stem(mu_path)}_{target_db}dB"
    return stem(sp_path or mu_path)


def bucket_length(n: int, min_n: int = 16000, ratio: float = 1.1) -> int:
    """Geometric length buckets: the smallest grid point >= n.

    Every distinct audio length compiles a fresh XLA program; on a
    corpus of ragged files that is thousands of compiles.
    Bucketing caps the number of compiled shapes at
    ~log_ratio(max/min) ≈ 50 for 1 s..3 h at ratio 1.1.
    """
    m = min_n
    while m < n:
        m = int(m * ratio) + 1
    return m


def _reflect_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Pad 1-D ``x`` to ``target`` samples by repeated symmetric
    reflection (handles pads longer than the signal)."""
    out = x
    flip = True
    while len(out) < target:
        out = np.concatenate([out, x[::-1] if flip else x])
        flip = not flip
    return out[:target]


class Featurizer:
    """Callable file -> (D, T) featuregram with optional disk cache.

    ``bucket=True`` (default) reflect-pads audio up to a geometric
    length bucket before the device computation and slices the result to
    the exact frame count.  Frames 0..T-1 of the STFT are bit-identical
    to the exact-length computation (framing only looks forward);
    the HPSS harmonic median of the last ``l_harm//2`` frames (~100 ms)
    sees reflected-tail context instead of scipy's symmetric boundary —
    a documented approximation of the training cache.  ``bucket=False``
    gives the exact-boundary path (used by parity tests and file-wise
    evaluation when exactness matters over compile count).
    """

    def __init__(self, config: FeatureConfig, cache_dir: str | None = None,
                 bucket: bool = True, mem_cache_mb: int = 512):
        self.config = config
        self.cache_dir = cache_dir
        self.bucket = bucket
        # Bounded in-memory LRU over the npy cache: avoids re-parsing +
        # re-reading featuregrams the balanced batcher revisits often.
        self._mem_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._mem_bytes = 0
        self._mem_limit = mem_cache_mb * (1 << 20)
        #: featuregram-cache behavior counters (scale-rehearsal artifact)
        self.stats = {"mem_hits": 0, "disk_hits": 0, "computes": 0}

    def _mem_get(self, key: str):
        fv = self._mem_cache.get(key)
        if fv is not None:
            self._mem_cache.move_to_end(key)
        return fv

    def _mem_put(self, key: str, fv: np.ndarray):
        if fv.nbytes > self._mem_limit:
            return
        self._mem_cache[key] = fv
        self._mem_bytes += fv.nbytes
        while self._mem_bytes > self._mem_limit:
            _, old = self._mem_cache.popitem(last=False)
            self._mem_bytes -= old.nbytes

    def _compute(self, audio: np.ndarray) -> np.ndarray:
        c = self.config
        n = len(audio)
        valid = None
        true_T = None
        if self.bucket:
            from ..ops.stft import n_frames
            true_T = n_frames(n, c.n_fft, c.hop_length)
            audio = _reflect_pad_to(audio, bucket_length(n))
            valid = jnp.asarray(true_T, jnp.int32)
        out = fg.featuregram(
            jnp.asarray(audio), feat_name=c.feat_name, sr=c.sr,
            n_fft=c.n_fft, win_length=c.win_length, hop_length=c.hop_length,
            n_mels=c.n_mels, l_harm=c.l_harm, l_perc=c.l_perc,
            valid_frames=valid)
        out = np.asarray(out, dtype=np.float32)
        if self.bucket:
            out = out[:, :true_T]
        return out

    def featuregram(self, classname: str, sp_path: str = "",
                    mu_path: str = "", target_db=None,
                    save_feat: bool = True) -> np.ndarray:
        """Featuregram for one item; ``classname`` in {'speech', 'music',
        'speech_music', 'speech_noise', 'noise', 'muspeak'}."""
        name = mixture_cache_name(sp_path, mu_path, target_db)
        key = f"{classname}/{name}"
        cached = self._mem_get(key)
        if cached is not None:
            self.stats["mem_hits"] += 1
            return cached
        cache_path = None
        if self.cache_dir:
            cache_path = os.path.join(self.cache_dir, classname, name + ".npy")
            if os.path.exists(cache_path):
                fv = np.load(cache_path, allow_pickle=False)
                self._mem_put(key, fv)
                self.stats["disk_hits"] += 1
                return fv
        self.stats["computes"] += 1

        c = self.config
        if classname in ("speech_music", "speech_noise"):
            sp, _ = load_and_preprocess_signal(sp_path, c.Tw, c.Ts)
            mu, _ = load_and_preprocess_signal(mu_path, c.Tw, c.Ts)
            audio = mix_signals_np(sp, mu, target_db).astype(np.float32)
        elif classname in ("speech", "muspeak"):
            audio, _ = load_and_preprocess_signal(sp_path, c.Tw, c.Ts)
        else:  # music / noise
            audio, _ = load_and_preprocess_signal(mu_path, c.Tw, c.Ts)

        fv = self._compute(audio)
        if cache_path and save_feat:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.save(cache_path, fv)
        if save_feat:
            self._mem_put(key, fv)
        return fv


    # ------------------------------------------------------------------
    # Bulk cache prewarming
    # ------------------------------------------------------------------
    def precompute(self, items: list[tuple], batch_size: int = 16,
                   verbose: bool = False) -> int:
        """Featurize many files at once, grouped by length bucket.

        ``items``: list of (classname, sp_path, mu_path, target_db)
        tuples (the ``featuregram`` signature).  Files sharing a length
        bucket are stacked into device batches of up to ``batch_size`` —
        one featuregram program per (bucket, batch) instead of one
        per-file dispatch — then cached individually.  Returns the number
        of newly computed featuregrams.
        """
        from ..ops.stft import n_frames

        c = self.config
        pending = []  # (key, cache_path, audio, true_T, bucket)
        for classname, sp_path, mu_path, target_db in items:
            name = mixture_cache_name(sp_path, mu_path, target_db)
            key = f"{classname}/{name}"
            cache_path = (os.path.join(self.cache_dir, classname,
                                       name + ".npy")
                          if self.cache_dir else None)
            if cache_path and os.path.exists(cache_path):
                continue
            if classname in ("speech_music", "speech_noise"):
                sp, _ = load_and_preprocess_signal(sp_path, c.Tw, c.Ts)
                mu, _ = load_and_preprocess_signal(mu_path, c.Tw, c.Ts)
                audio = mix_signals_np(sp, mu, target_db).astype(np.float32)
            elif classname in ("speech", "muspeak"):
                audio, _ = load_and_preprocess_signal(sp_path, c.Tw, c.Ts)
            else:
                audio, _ = load_and_preprocess_signal(mu_path, c.Tw, c.Ts)
            true_T = n_frames(len(audio), c.n_fft, c.hop_length)
            bucket = bucket_length(len(audio))
            pending.append((key, cache_path, audio, true_T, bucket))

        # Group by bucket; one batched program per group chunk.
        by_bucket: dict[int, list] = {}
        for entry in pending:
            by_bucket.setdefault(entry[4], []).append(entry)

        done = 0
        for bucket, group in sorted(by_bucket.items()):
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                batch = np.stack([_reflect_pad_to(e[2], bucket)
                                  for e in chunk])
                valid = jnp.asarray([e[3] for e in chunk], jnp.int32)
                out = fg.featuregram(
                    jnp.asarray(batch), feat_name=c.feat_name, sr=c.sr,
                    n_fft=c.n_fft, win_length=c.win_length,
                    hop_length=c.hop_length, n_mels=c.n_mels,
                    l_harm=c.l_harm, l_perc=c.l_perc,
                    valid_frames=valid[:, None, None])
                out = np.asarray(out, dtype=np.float32)
                for (key, cache_path, _, true_T, _), fv in zip(chunk, out):
                    fv = fv[:, :true_T]
                    if cache_path:
                        os.makedirs(os.path.dirname(cache_path),
                                    exist_ok=True)
                        np.save(cache_path, fv)
                    self._mem_put(key, fv)
                    done += 1
                if verbose:
                    print(f"bucket {bucket}: {done}/{len(pending)} done",
                          flush=True)
        return done
