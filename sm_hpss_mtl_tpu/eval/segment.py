"""Long-audio streaming segmentation (cross-corpus broadcast use case).

JAX equivalent of the DAFx12 driver
(``/root/reference/DAFx12_Speech_Music_Detection_B3_MTL_v2.py``):

- :func:`interval_annotations_to_markers` — time-interval CSV rows
  (tmin, dur, label) -> per-frame 0/1 markers (:145-224 semantics,
  including the normalize-by-max-annotated-duration frame mapping).
- :class:`StreamingSegmenter` — chunked dense inference: the featuregram
  of an arbitrarily long recording is processed in fixed slabs
  (default 10,000 frames, :634-647) with shift-1 windows, producing a
  per-frame speech and music probability track from the MTL S/M heads.
  Window extraction is XLA's strided-patch op, the slab loop is plain
  Python over jit-compiled fixed-shape calls (one compile total).
- :func:`smooth_predictions` / :func:`mode_filtering` — median smoothing
  of probability tracks (win 501) and mode smoothing of label tracks
  (:81-103).
- segment-level metrics via frame markers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.signal import medfilt

import jax
import jax.numpy as jnp

from ..ops.patches import standardize_rows


def interval_annotations_to_markers(rows, n_frames: int,
                                    audio_length: float | None = None
                                    ) -> np.ndarray:
    """``rows``: iterable of (tmin_seconds, duration_seconds, label);
    returns a 0/1 marker of length ``n_frames`` set where label==1.

    Frame mapping matches the reference: positions are scaled by the
    total annotated duration (max tmin+dur over rows unless
    ``audio_length`` is given)."""
    rows = [(float(t), float(d), int(l)) for t, d, l in rows]
    if audio_length is None:
        audio_length = max((t + d for t, d, _ in rows), default=0.0)
    marker = np.zeros(n_frames)
    if audio_length <= 0:
        return marker
    for tmin, dur, label in rows:
        if dur == 0.0 or label != 1:
            continue
        tmax = tmin + dur
        start = max(0, int(np.floor(tmin / audio_length * n_frames)))
        end = min(int(np.ceil(tmax / audio_length * n_frames)), n_frames - 1)
        marker[start:end] = 1
    return marker


def read_interval_csv(path: str) -> list[tuple]:
    """DAFx-style CSV: header row then (tmin, dur, label) rows."""
    import csv
    out = []
    with open(path, newline="\n") as f:
        for i, row in enumerate(csv.reader(f, delimiter=",", quotechar="|")):
            if not row or i == 0:
                continue
            out.append((row[0], row[1], row[2]))
    return out


def mode_filtering(labels: np.ndarray, win_size: int) -> np.ndarray:
    """Sliding-mode smoothing of an integer label track (:81-90).

    Matches the reference loop exactly, including its asymmetric window
    ``X[i-half : i+half]`` (the right edge is excluded) and the
    smallest-label tie break of ``np.unique`` + ``argmax``.  Vectorized
    as one-hot counts via cumulative sums."""
    if win_size % 2 == 0:
        win_size += 1
    half = win_size // 2
    n = len(labels)
    out = labels.copy()
    if n <= 2 * half:
        return out
    uniq = np.unique(labels)
    onehot = (labels[None, :] == uniq[:, None]).astype(np.int64)
    cs = np.concatenate([np.zeros((len(uniq), 1), np.int64),
                         np.cumsum(onehot, axis=1)], axis=1)
    # Window for position i covers [i-half, i+half): count = cs[i+half]-cs[i-half]
    idx = np.arange(half, n - half)
    counts = cs[:, idx + half] - cs[:, idx - half]
    out[idx] = uniq[np.argmax(counts, axis=0)]
    return out


def smooth_predictions(prob: np.ndarray, win_size: int = 501
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Median-smooth a probability track and threshold at 0.5 (:94-99)."""
    if win_size % 2 == 0:
        win_size += 1
    sm = medfilt(prob, win_size)
    return sm, (sm > 0.5).astype(int)


@dataclass
class StreamingSegmenter:
    """Dense per-frame S/M probabilities over an arbitrarily long
    featuregram.

    Two slab drivers produce identical tracks:

    - ``use_scan=False`` (default): plain Python over one jit-compiled
      fixed-shape call per slab — the direct analog of the reference's
      10,000-frame loop (``DAFx12_...py:634-676``).
    - ``use_scan=True``: the whole slab loop is a single
      ``lax.scan`` program — the on-device unbounded-broadcast form
      SURVEY.md §5 names: one dispatch for the entire recording, window
      extraction via static strided slices inside the scan body.
      Requires ``predict_fn`` to be jax-traceable.
    """
    predict_fn: callable           # (B, T, D) or (B, D, W, 1) -> head dict
    patch_size: int = 68
    chunk_frames: int = 10000
    input_kind: str = "time_mel"
    feat_name: str = "LogMelHarmPercSpec"
    #: Standardization scope.  Training standardizes each featuregram —
    #: a single file/clip (``lib/preprocessing.py:146-148``) — but the
    #: reference's DAFx streaming path feeds UNstandardized slabs
    #: (its local ``get_feature_patches``, ``DAFx12_...py:260-294``, has
    #: no StandardScaler), a train/test mismatch its protocol papers
    #: over with transfer learning.  On a real mixed broadcast,
    #: whole-broadcast standardization collapsed the S head on speech,
    #: so the default is ``True`` == 'chunk': slab-local stats, the
    #: closest streaming analog of the training scope.
    #: 'featuregram' = whole-recording stats; False/'none' = reference
    #: DAFx parity (no standardization).
    standardize: bool | str = True
    use_scan: bool = False

    def _scope(self) -> str:
        if self.standardize is True:
            return "chunk"
        if self.standardize is False:
            return "none"
        return self.standardize

    def _standardize_parts(self, arr):
        """Per-row standardization, split per HPSS component for dual
        HarmPerc features (np or traced jnp input)."""
        xp = jnp if isinstance(arr, jax.Array) else np
        if "HarmPerc" in self.feat_name:
            half = arr.shape[0] // 2
            return xp.concatenate([standardize_rows(arr[:half]),
                                   standardize_rows(arr[half:])], axis=0)
        return standardize_rows(arr)

    def _window_batch(self, fv: np.ndarray, start: int, count: int
                      ) -> np.ndarray:
        """``count`` shift-1 windows of width patch_size beginning at
        window index ``start`` of featuregram ``fv (D, T)``."""
        W = self.patch_size
        seg = fv[:, start:start + count + W - 1]
        if self._scope() == "chunk":
            seg = np.asarray(self._standardize_parts(seg))
        # strided view via as_strided-free slicing: stack once per offset
        # would be O(W); use stride tricks on the host copy instead.
        from numpy.lib.stride_tricks import sliding_window_view
        wins = sliding_window_view(seg, W, axis=1)   # (D, count, W)
        return np.ascontiguousarray(np.moveaxis(wins, 1, 0))  # (count, D, W)

    def frame_probabilities(self, fv) -> dict:
        """``fv``: (D, T) featuregram -> dict of per-window probability
        tracks (length T - patch_size + 1).

        ``fv`` may be a host array or a ``jax.Array`` (e.g. from
        ``featuregram_slabbed(device_out=True)``); the scan driver keeps
        a device featuregram resident — the device serving chain
        then ships only raw audio up and probability tracks down.  The
        plain-loop driver extracts windows host-side, so it fetches a
        device featuregram once."""
        is_dev = isinstance(fv, jax.Array)
        if self._scope() == "featuregram":
            fv = self._standardize_parts(fv)
            if not is_dev:
                fv = np.asarray(fv)
        D, T = fv.shape
        n_windows = T - self.patch_size + 1
        if n_windows <= 0:
            raise ValueError("featuregram shorter than one window")
        if self.use_scan:
            return self._frame_probabilities_scan(fv, n_windows)
        if is_dev:
            fv = np.asarray(fv)

        chunk = min(self.chunk_frames, n_windows)
        tracks: dict[str, list] = {}
        start = 0
        while start < n_windows:
            count = min(chunk, n_windows - start)
            wins = self._window_batch(fv, start, count)
            if count < chunk:  # pad to the compiled shape
                pad = np.repeat(wins[-1:], chunk - count, axis=0)
                wins = np.concatenate([wins, pad], axis=0)
            if self.input_kind == "time_mel":
                batch = np.transpose(wins, (0, 2, 1))
            else:
                batch = wins[..., None]
            out = self.predict_fn(jnp.asarray(batch))
            if not isinstance(out, dict):
                out = {"3C": out}
            for k, v in out.items():
                tracks.setdefault(k, []).append(np.asarray(v)[:count])
            start += count
        return {k: np.concatenate(v, axis=0) for k, v in tracks.items()}

    def _frame_probabilities_scan(self, fv, n_windows: int) -> dict:
        """One ``lax.scan`` over slabs: the entire recording's dense
        prediction is a single XLA program (one dispatch, weights stay
        resident, no host round-trips between slabs).

        Under 'chunk'-scope standardization a ragged final slab is
        standardized over its edge-padded width (static shapes), a small
        approximation relative to the plain loop, which standardizes the
        true ragged tail; full slabs are identical between drivers."""
        import jax
        from jax import lax

        W = self.patch_size
        D, T = fv.shape
        chunk = min(self.chunk_frames, n_windows)
        n_slabs = -(-n_windows // chunk)
        # Edge-pad time so every slab is full width; the surplus windows
        # are trimmed after the scan, so the pad values never escape.
        T_pad = n_slabs * chunk + W - 1
        xp = jnp if isinstance(fv, jax.Array) else np
        fvp = xp.pad(fv, ((0, 0), (0, T_pad - T)), mode="edge")

        def program(fv_dev):
            starts = jnp.arange(n_slabs) * chunk

            def step(carry, start):
                seg = lax.dynamic_slice(fv_dev, (0, start),
                                        (D, chunk + W - 1))
                if self._scope() == "chunk":
                    seg = self._standardize_parts(seg)
                # (chunk, D, W) windows from W static strided slices — no
                # gathers.
                wins = jnp.stack(
                    [lax.slice_in_dim(seg, k, k + chunk, axis=1)
                     for k in range(W)], axis=-1)
                wins = jnp.moveaxis(wins, 1, 0)
                if self.input_kind == "time_mel":
                    batch = jnp.transpose(wins, (0, 2, 1))
                else:
                    batch = wins[..., None]
                out = self.predict_fn(batch)
                if not isinstance(out, dict):
                    out = {"3C": out}
                return carry, out

            _, outs = lax.scan(step, None, starts)
            return outs

        # Cache the compiled program: a fresh jax.jit wrapper per call
        # would retrace + recompile the whole scan for every broadcast
        # of the same shape.
        # id(predict_fn) invalidates the cache when new weights are
        # swapped onto a reused segmenter — the jitted closure captures
        # predict_fn, so a stale program would keep serving old weights.
        key = (D, T_pad, chunk, n_slabs, self.input_kind, self._scope(),
               id(self.predict_fn))
        cached = getattr(self, "_scan_cache", None)
        if cached is None or cached[0] != key:
            self._scan_cache = (key, jax.jit(program))
        outs = self._scan_cache[1](jnp.asarray(fvp))
        return {k: np.asarray(v).reshape((-1,) + v.shape[2:])[:n_windows]
                for k, v in outs.items()}

    def segment(self, fv: np.ndarray, *, head: str = "S",
                smooth_win: int = 501):
        """Per-frame smoothed 0/1 labels for one head ('S' or 'M')."""
        tracks = self.frame_probabilities(fv)
        prob = tracks[head][:, 0] if tracks[head].ndim > 1 else tracks[head]
        sm, labels = smooth_predictions(prob, smooth_win)
        return sm, labels, tracks
