"""Training loop: epochs over a balanced stream with early stopping,
best-checkpoint saving, and CSV epoch logs.

Reproduces the reference's ``train_model`` callbacks
(``/root/reference/Proposed_Work_Results.py:275-312``):
``EarlyStopping(monitor=val_loss, min_delta=0.01, patience=5,
restore_best_weights=True)``, best-only ``ModelCheckpoint``, and
``CSVLogger``; plus the 70/30 train/val file split (:287-295) handled by
the caller.  Timing is recorded like the reference's
``trainingTimeTaken`` (:280-310).
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from .state import TrainState, make_eval_step, make_train_step

#: Reference early-stopping policy (EarlyStopping(min_delta=0.01,
#: patience=5), Proposed_Work_Results.py:276).  Shared between fit()
#: and the resume replay in cli.experiment._resume_status so a tuned
#: value can never drift between training and its resume logic.
EARLY_STOP_PATIENCE = 5
EARLY_STOP_MIN_DELTA = 0.01


@dataclass
class FitResult:
    state: TrainState
    history: list = field(default_factory=list)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    #: host CPU time, the reference's ``time.process_time`` semantics
    #: (``Proposed_Work_Results.py:280-310``) — most step time is
    #: device wall-clock this does NOT count, so ``wall_time`` is the
    #: honest figure and ``training_time`` the parity one.
    training_time: float = 0.0
    wall_time: float = 0.0
    stopped_early: bool = False


@jax.jit
def _tree_add(a, b):
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.add, a, b)


def _accumulate(acc, metrics):
    """Running on-device sum of per-step metric pytrees.

    One tiny jitted add per step (async dispatch), NO host fetch: each
    scalar fetched from the device is a synchronizing round trip that
    stalls the dispatch queue, so fetching every step's metrics
    leaf-by-leaf would serialize host and device.
    """
    import jax.numpy as jnp
    metrics = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), metrics)
    return metrics if acc is None else _tree_add(acc, metrics)


def _fetch_mean(acc, n: int) -> dict:
    """Mean metrics with ONE device->host transfer (leaves packed)."""
    import jax.numpy as jnp
    leaves, treedef = jax.tree_util.tree_flatten(acc)
    flat = np.asarray(jnp.concatenate(
        [jnp.ravel(x) for x in leaves])) / max(n, 1)
    out, i = [], 0
    for x in leaves:
        size = int(np.prod(np.shape(x))) if np.shape(x) else 1
        out.append(float(flat[i]) if size == 1
                   else flat[i:i + size].reshape(np.shape(x)))
        i += size
    return jax.tree_util.tree_unflatten(treedef, out)


def fit(model, optimizer, train_iter, val_iter, *, mtl: bool,
        epochs: int, steps_per_epoch: int, val_steps: int,
        state: TrainState | None = None, sample_batch=None,
        loss_weights: dict | None = None, l2_reg: float = 0.0,
        augment_noise: bool = False, rng=None,
        patience: int = EARLY_STOP_PATIENCE,
        min_delta: float = EARLY_STOP_MIN_DELTA,
        checkpoint_dir: str | None = None, csv_log: str | None = None,
        train_step=None, eval_step=None, sample_state_input=None,
        initial_epoch: int = 0, initial_best: float = float("inf"),
        verbose: bool = True) -> FitResult:
    """Train with early stopping on val loss; restores best weights.

    ``train_step``/``eval_step`` override the default patch-batch steps —
    the on-device audio pipeline passes
    ``endtoend.make_audio_{train,eval}_step`` here, with
    ``sample_state_input`` the model-ready sample that initializes the
    state when the iterator yields raw audio instead of patches.

    ``initial_epoch``/``initial_best`` continue an interrupted run for
    the remaining budget (the reference's count-completed-epochs resume,
    ``DAFx12_...py:534-545``): epoch numbering and the CSV log continue
    where they left off, and checkpoints only overwrite the restored
    best when val loss actually improves on ``initial_best``.  The
    early-stopping wait counter restarts at zero, like the reference's
    re-`fit` (patience measures epochs-since-best within ONE run).
    """
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    if state is None:
        if sample_state_input is None:
            if sample_batch is None:
                sample_batch, _ = next(train_iter)
            sample_state_input = sample_batch
        state = TrainState.create(model, optimizer, sample_state_input, rng)

    if train_step is None:
        train_step = make_train_step(model, optimizer, mtl=mtl,
                                     loss_weights=loss_weights,
                                     l2_reg=l2_reg,
                                     augment_noise=augment_noise)
    if eval_step is None:
        eval_step = make_eval_step(model, mtl=mtl, loss_weights=loss_weights)

    result = FitResult(state=state, best_val_loss=initial_best,
                       best_epoch=initial_epoch - 1 if initial_epoch else -1)
    best_payload = None
    wait = 0
    t0 = time.process_time()
    w0 = time.perf_counter()

    csv_writer = None
    csv_file = None

    for epoch in range(initial_epoch, epochs):
        e0 = time.perf_counter()
        train_acc = None
        for _ in range(steps_per_epoch):
            batch, labels = next(train_iter)
            rng, sub = jax.random.split(rng)
            state, metrics = train_step(state, batch, labels, sub)
            train_acc = _accumulate(train_acc, metrics)
        # Per-epoch wall clock of the TRAIN phase (async dispatch: the
        # packed mean-metrics fetch below depends on every step's
        # output, so it forces the whole epoch; measure after).
        tr = _fetch_mean(train_acc, steps_per_epoch)
        t_train = time.perf_counter() - e0
        val_acc = None
        for _ in range(val_steps):
            batch, labels = next(val_iter)
            val_acc = _accumulate(val_acc, eval_step(state, batch, labels))
        va = _fetch_mean(val_acc, val_steps)
        row = {"epoch": epoch, "epoch_train_s": round(t_train, 3),
               **tr, **{f"val_{k}": v for k, v in va.items()}}
        result.history.append(row)
        if verbose:
            print(f"epoch {epoch}: loss={tr['loss']:.4f} "
                  f"val_loss={va['loss']:.4f}", flush=True)

        if csv_log:
            if csv_writer is None:
                os.makedirs(os.path.dirname(csv_log) or ".", exist_ok=True)
                # Resumed runs append to the existing epoch log so the
                # completed-epoch count survives further interruptions.
                append = initial_epoch > 0 and os.path.exists(csv_log)
                csv_file = open(csv_log, "a" if append else "w", newline="")
                csv_writer = csv.DictWriter(csv_file, fieldnames=row.keys())
                if not append:
                    csv_writer.writeheader()
            csv_writer.writerow(row)
            csv_file.flush()

        val_loss = va["loss"]
        if val_loss < result.best_val_loss - min_delta:
            result.best_val_loss = val_loss
            result.best_epoch = epoch
            best_payload = jax.tree_util.tree_map(np.asarray,
                                                  (state.params,
                                                   state.batch_stats))
            wait = 0
            if checkpoint_dir:
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_dir, state,
                                {"epoch": epoch, "val_loss": float(val_loss)})
        else:
            wait += 1
            if wait >= patience:
                result.stopped_early = True
                if verbose:
                    print(f"early stopping at epoch {epoch} "
                          f"(best={result.best_epoch})", flush=True)
                break

    if csv_file:
        csv_file.close()

    result.training_time = time.process_time() - t0
    result.wall_time = time.perf_counter() - w0
    if best_payload is not None:
        params, batch_stats = best_payload
        result.state = TrainState(params=params, batch_stats=batch_stats,
                                  opt_state=state.opt_state, step=state.step)
    else:
        result.state = state
    return result


def evaluate_generator(model, state: TrainState, test_iter, steps: int, *,
                       mtl: bool, loss_weights: dict | None = None) -> dict:
    """Mean metrics over ``steps`` balanced test batches — the
    reference's ``model.evaluate(generator, steps=TS_STEPS)``
    (``Proposed_Work_Results.py:678-700``)."""
    eval_step = make_eval_step(model, mtl=mtl, loss_weights=loss_weights)
    acc = None
    for _ in range(steps):
        batch, labels = next(test_iter)
        acc = _accumulate(acc, eval_step(state, batch, labels))
    return _fetch_mean(acc, steps)
