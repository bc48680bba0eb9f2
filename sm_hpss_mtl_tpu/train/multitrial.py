"""Vmapped multi-trial training: N shape-invariant trials as ONE program.

The reference tunes sequentially — keras-tuner trains one trial at a
time (``/root/reference/B3_architecture_tuning.py:402-411``) and the
loss-weight grid retrains the model once per setting
(``/root/reference/Hyperparameter_Selection.py:541-552``).  On a
device, trials whose *parameter shapes* agree (loss-weight settings, learning
rates, seed replicates) need not be sequential: stack their states along
a leading trial axis and ``jax.vmap`` the train step, so all trials
advance in a single XLA program per step, sharing one host batch stream
and one compilation.  For the small reference models this turns the
4-point loss-weight grid (or an N-seed variance estimate) into roughly
the cost of one training run.

Per-trial hyperparameters ride through the vmap as traced inputs:

- ``loss_weights`` — a dict of per-head scalars fed to
  :func:`..train.losses.mtl_loss` (traced, so each trial weighs heads
  differently inside the same program).
- ``lr_scale`` — multiplies the optimizer's *final* update.  Every
  optimizer here (SGD+momentum, Adam — ``train/optimizers.py``) produces
  updates linear in the learning rate (momentum velocity is linear in
  lr; Adam's step is ``-lr * mhat/(sqrt(vhat)+eps)``), so scaling the
  end-of-chain update by ``s`` is *exactly* training at ``s * lr``,
  while per-tensor clipnorm still sees the raw gradients as Keras does.

Seed replicates come from vmapping ``TrainState.create`` over per-trial
PRNG keys (different inits + dropout streams, identical shapes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .losses import categorical_crossentropy, mtl_loss
from .state import TrainState, _augment, l2_penalty


def stack_hyperparams(trials: list[dict], heads: tuple | None) -> dict:
    """Turn a list of per-trial hyperparam dicts into stacked arrays.

    Each trial dict may carry ``loss_weights`` (head -> float; missing
    heads default to 1.0) and ``lr_scale`` (default 1.0).  Returns a
    pytree whose leaves have leading dim ``len(trials)``.
    """
    n = len(trials)
    out: dict[str, Any] = {
        "lr_scale": jnp.asarray(
            [float(t.get("lr_scale", 1.0)) for t in trials], jnp.float32)}
    if heads:
        out["loss_weights"] = {
            h: jnp.asarray(
                [float((t.get("loss_weights") or {}).get(h, 1.0))
                 for t in trials], jnp.float32)
            for h in heads}
    assert all(v.shape[0] == n for v in jax.tree_util.tree_leaves(out))
    return out


def init_trials(model, optimizer, sample_input, seeds) -> TrainState:
    """Stacked TrainState: one leading trial axis over params, stats and
    optimizer state, initialized from per-trial seeds."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])

    def one(key):
        return TrainState.create(model, optimizer, sample_input, key)

    return jax.vmap(one)(keys)


def unstack_trial(stacked, i: int):
    """Extract trial ``i`` from a stacked pytree (host numpy leaves)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x[i]), stacked)


def make_multi_train_step(model, optimizer, *, mtl: bool,
                          augment_noise: bool = False,
                          l2_reg: float = 0.0) -> Callable:
    """Build ``(stacked_state, batch, labels, rngs, hyper) ->
    (stacked_state, stacked_metrics)`` — the vmapped analog of
    :func:`..train.state.make_train_step`.

    ``batch``/``labels`` are SHARED across trials (in_axes None): every
    trial sees the same data, isolating the hyperparameter effect; only
    states, rng keys and hyperparams carry the trial axis.
    """

    def loss_fn(params, batch_stats, batch, labels, rng, weights):
        if augment_noise:
            rng, aug_rng = jax.random.split(rng)
            batch = _augment(batch, aug_rng)
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, batch,
            train=True, mutable=["batch_stats"], rngs={"dropout": rng})
        if mtl:
            total, per_head = mtl_loss(outputs, labels, weights)
        else:
            total = categorical_crossentropy(outputs, labels)
            per_head = {"3C": total}
        if l2_reg:
            total = total + l2_reg * l2_penalty(params)
        return total, (per_head, mutated["batch_stats"], outputs)

    def single(state: TrainState, batch, labels, rng, hyper):
        weights = hyper.get("loss_weights")
        (total, (per_head, new_stats, outputs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats, batch,
                                   labels, rng, weights)
        updates, new_opt = optimizer.update(grads, state.opt_state,
                                            state.params)
        scale = hyper["lr_scale"]
        updates = jax.tree_util.tree_map(
            lambda u: (u * scale).astype(u.dtype), updates)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {"loss": total,
                   **{f"{k}_loss": v for k, v in per_head.items()}}
        out = outputs["3C"] if mtl else outputs
        y = labels["3C"] if mtl else labels
        key = "3C_accuracy" if mtl else "accuracy"
        metrics[key] = jnp.mean(jnp.argmax(out, -1) == jnp.argmax(y, -1))
        return TrainState(params=new_params, batch_stats=new_stats,
                          opt_state=new_opt, step=state.step + 1), metrics

    return jax.jit(jax.vmap(single, in_axes=(0, None, None, 0, 0)))


def make_multi_eval_step(model, *, mtl: bool) -> Callable:
    """Vmapped eval step sharing the batch across trials."""

    def single(state: TrainState, batch, labels, hyper):
        outputs = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch, train=False)
        if mtl:
            total, per_head = mtl_loss(outputs, labels,
                                       hyper.get("loss_weights"))
            acc = jnp.mean(jnp.argmax(outputs["3C"], -1)
                           == jnp.argmax(labels["3C"], -1))
            return {"loss": total, "accuracy": acc,
                    **{f"{k}_loss": v for k, v in per_head.items()}}
        total = categorical_crossentropy(outputs, labels)
        acc = jnp.mean(jnp.argmax(outputs, -1) == jnp.argmax(labels, -1))
        return {"loss": total, "accuracy": acc}

    return jax.jit(jax.vmap(single, in_axes=(0, None, None, 0)))


@dataclass
class MultiFitResult:
    state: TrainState  # stacked; trial i extractable via unstack_trial
    n_trials: int
    best_val_loss: np.ndarray = None  # (n,)
    best_epoch: np.ndarray = None  # (n,)
    best_accuracy: np.ndarray = None  # (n,) val accuracy at the best epoch
    history: list = field(default_factory=list)  # per-epoch dict of (n,) arrays
    training_time: float = 0.0


def fit_multi(model, optimizer, train_iter, val_iter, *, mtl: bool,
              trials: list[dict], heads: tuple | None, sample_batch,
              epochs: int, steps_per_epoch: int, val_steps: int,
              augment_noise: bool = False, l2_reg: float = 0.0,
              base_seed: int = 0,
              patience: int = 5, min_delta: float = 0.01,
              mesh=None, verbose: bool = True) -> MultiFitResult:
    """Train all ``trials`` simultaneously on a shared batch stream.

    Early stopping is joint: training stops once EVERY trial has gone
    ``patience`` epochs without a ``min_delta`` val-loss improvement
    (each trial's best epoch is tracked individually, mirroring the
    reference's per-run ``EarlyStopping``,
    ``Proposed_Work_Results.py:275-312``).

    ``mesh``: shard the TRIAL axis over the mesh's 'data' axis — tuner
    parallelism: with T trials on D devices each device trains T/D
    trials, no cross-device communication (the trials are independent;
    batches are replicated).  ``len(trials)`` must divide evenly.
    """
    import time as _time
    n = len(trials)
    hyper = stack_hyperparams(trials, heads)
    seeds = [int(t.get("seed", base_seed)) for t in trials]
    state = init_trials(model, optimizer, sample_batch, seeds)

    train_step = make_multi_train_step(model, optimizer, mtl=mtl,
                                       augment_noise=augment_noise,
                                       l2_reg=l2_reg)
    eval_step = make_multi_eval_step(model, mtl=mtl)

    _put_trial = _put_shared = lambda x: x  # noqa: E731
    if mesh is not None:
        n_data = mesh.shape["data"]
        if n % n_data:
            raise ValueError(f"{n} trials do not shard over {n_data} "
                             "devices; pad the trial list")
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P
        t, r = P("data"), P()
        # shard_map, not GSPMD sharding annotations: each device runs the
        # whole (un-partitioned) vmapped step on its local trial shard —
        # the trials are independent, so there is no communication to
        # insert, and the SPMD partitioner never sees the vmapped
        # batched-kernel convolutions (whose grouped-conv lowering it
        # miscompiles: two stacked vmapped convs with the kernel batch
        # axis sharded return wrong values on the CPU backend —
        # reproduced 2026-08, see tests/test_multitrial.py).
        train_step = jax.jit(shard_map(
            train_step, mesh=mesh, in_specs=(t, r, r, t, t),
            out_specs=(t, t), check_vma=False))
        eval_step = jax.jit(shard_map(
            eval_step, mesh=mesh, in_specs=(t, r, r, t), out_specs=t,
            check_vma=False))
        tshard = NamedSharding(mesh, t)
        rep = NamedSharding(mesh, r)
        state = jax.device_put(state, tshard)
        hyper = jax.device_put(hyper, tshard)
        _put_trial = lambda x: jax.device_put(x, tshard)  # noqa: E731
        _put_shared = lambda x: jax.device_put(x, rep)  # noqa: E731

    rng = jax.random.PRNGKey(base_seed)
    result = MultiFitResult(state=state, n_trials=n,
                            best_val_loss=np.full(n, np.inf),
                            best_epoch=np.full(n, -1),
                            best_accuracy=np.full(n, np.nan))
    best_payload = [None] * n
    wait = np.zeros(n, int)
    t0 = _time.process_time()

    for epoch in range(epochs):
        tr_loss = []
        for _ in range(steps_per_epoch):
            batch, labels = next(train_iter)
            batch, labels = _put_shared(batch), _put_shared(labels)
            rng, sub = jax.random.split(rng)
            subs = _put_trial(jax.random.split(sub, n))
            state, metrics = train_step(state, batch, labels, subs, hyper)
            tr_loss.append(np.asarray(metrics["loss"]))
        va_rows = []
        for _ in range(val_steps):
            batch, labels = next(val_iter)
            batch, labels = _put_shared(batch), _put_shared(labels)
            va_rows.append(eval_step(state, batch, labels, hyper))
        val_loss = np.mean([np.asarray(r["loss"]) for r in va_rows], axis=0)
        val_acc = np.mean([np.asarray(r["accuracy"]) for r in va_rows],
                          axis=0)
        result.history.append({"epoch": epoch,
                               "loss": np.mean(tr_loss, axis=0),
                               "val_loss": val_loss,
                               "val_accuracy": val_acc})
        if verbose:
            print(f"epoch {epoch}: val_loss="
                  f"{np.array2string(val_loss, precision=4)}", flush=True)

        improved = val_loss < result.best_val_loss - min_delta
        if improved.any():
            host = jax.tree_util.tree_map(np.asarray,
                                          (state.params, state.batch_stats))
            for i in np.flatnonzero(improved):
                best_payload[i] = jax.tree_util.tree_map(
                    lambda x: x[i], host)
        result.best_val_loss = np.where(improved, val_loss,
                                        result.best_val_loss)
        result.best_epoch = np.where(improved, epoch, result.best_epoch)
        result.best_accuracy = np.where(improved, val_acc,
                                        result.best_accuracy)
        wait = np.where(improved, 0, wait + 1)
        if (wait >= patience).all():
            if verbose:
                print(f"all trials early-stopped at epoch {epoch}",
                      flush=True)
            break

    result.training_time = _time.process_time() - t0
    # Restore each trial's best weights into the stacked state.
    if any(p is not None for p in best_payload):
        cur = jax.tree_util.tree_map(np.asarray,
                                     (state.params, state.batch_stats))
        stacked = jax.tree_util.tree_map(
            lambda *leaves: np.stack(leaves),
            *[best_payload[i] if best_payload[i] is not None
              else jax.tree_util.tree_map(lambda x: x[i], cur)
              for i in range(n)])
        params, batch_stats = stacked
        result.state = TrainState(params=params, batch_stats=batch_stats,
                                  opt_state=state.opt_state, step=state.step)
    else:
        result.state = state
    return result
