"""Train state and jitted train/eval steps.

The reference trains through ``model.fit`` on a compiled Keras model
(``/root/reference/Proposed_Work_Results.py:298-307``).  Here the train
step is one jitted function — forward, loss, backward, optimizer update,
BatchNorm running-stat update — so a whole step is a single XLA program
on the device.  The same step function runs under ``pjit``/``shard_map``
for data parallelism (see ``sm_hpss_mtl_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from ..models.nn import flatten_dict
from .losses import categorical_crossentropy, mtl_loss


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray

    @classmethod
    def create(cls, model, optimizer, sample_input, rng):
        variables = model.init({"params": rng, "dropout": rng}, sample_input,
                               train=False)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        return cls(params=params, batch_stats=batch_stats,
                   opt_state=optimizer.init(params),
                   step=jnp.zeros((), jnp.int32))


def l2_penalty(params) -> jax.Array:
    """Sum of squared head and mel-layer kernels: the layers the
    reference gives a Keras ``kernel_regularizer=l2()``."""
    return sum(jnp.sum(x ** 2) for path, x in flatten_dict(params).items()
               if path[-1] == "kernel"
               and any("heads" in p or "melCl" in p for p in path))


#: Gaussian augmentation scales (``Proposed_Work_Results.py:240``).
NOISE_SCALES = (5e-3, 1e-3, 5e-4, 1e-4)


def _augment(batch, rng):
    """The reference's noise augmentation (:239-242), on device: one
    scale drawn per step from NOISE_SCALES, Gaussian noise added to the
    whole batch.  Host-side this costs ~10 ms/batch of numpy RNG; here it
    fuses into the forward pass."""
    k1, k2 = jax.random.split(rng)

    def leaf(x, key):
        scale = jnp.asarray(NOISE_SCALES)[jax.random.randint(k1, (), 0, 4)]
        return x + scale * jax.random.normal(key, x.shape, x.dtype)

    if isinstance(batch, dict):
        keys = jax.random.split(k2, len(batch))
        return {k: leaf(v, key) for (k, v), key in
                zip(sorted(batch.items()), keys)}
    return leaf(batch, k2)


def make_train_step(model, optimizer, *, mtl: bool,
                    loss_weights: dict | None = None,
                    l2_reg: float = 0.0,
                    augment_noise: bool = False) -> Callable:
    """Build a jitted ``(state, batch, labels, rng) -> (state, metrics)``.

    ``l2_reg`` adds ``l2 * sum(kernel^2)`` over head Dense kernels,
    approximating Keras' per-layer ``kernel_regularizer=l2()`` terms.
    ``augment_noise`` applies the reference's Gaussian augmentation on
    device.
    """

    def loss_fn(params, batch_stats, batch, labels, rng):
        if augment_noise:
            rng, aug_rng = jax.random.split(rng)
            batch = _augment(batch, aug_rng)
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, batch,
            train=True, mutable=["batch_stats"], rngs={"dropout": rng})
        if mtl:
            total, per_head = mtl_loss(outputs, labels, loss_weights)
        else:
            total = categorical_crossentropy(outputs, labels)
            per_head = {"3C": total}
        if l2_reg:
            total = total + l2_reg * l2_penalty(params)
        return total, (per_head, mutated["batch_stats"], outputs)

    @jax.jit
    def train_step(state: TrainState, batch, labels, rng):
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (total, (per_head, new_stats, outputs)), grads = grad_fn(
            state.params, state.batch_stats, batch, labels, rng)
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {"loss": total, **{f"{k}_loss": v for k, v in per_head.items()}}
        if mtl:
            metrics["3C_accuracy"] = jnp.mean(
                jnp.argmax(outputs["3C"], -1) == jnp.argmax(labels["3C"], -1))
        else:
            metrics["accuracy"] = jnp.mean(
                jnp.argmax(outputs, -1) == jnp.argmax(labels, -1))
        return TrainState(params=new_params, batch_stats=new_stats,
                          opt_state=new_opt, step=state.step + 1), metrics

    return train_step


def make_eval_step(model, *, mtl: bool,
                   loss_weights: dict | None = None) -> Callable:
    @jax.jit
    def eval_step(state: TrainState, batch, labels):
        outputs = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch, train=False)
        if mtl:
            total, per_head = mtl_loss(outputs, labels, loss_weights)
            acc = jnp.mean(jnp.argmax(outputs["3C"], -1)
                           == jnp.argmax(labels["3C"], -1))
            return {"loss": total, "accuracy": acc,
                    **{f"{k}_loss": v for k, v in per_head.items()}}
        total = categorical_crossentropy(outputs, labels)
        acc = jnp.mean(jnp.argmax(outputs, -1) == jnp.argmax(labels, -1))
        return {"loss": total, "accuracy": acc}

    return eval_step


def make_predict(model) -> Callable:
    @jax.jit
    def predict(state: TrainState, batch):
        return model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch, train=False)

    return predict
