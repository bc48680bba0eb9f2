"""Checkpointing as a numpy ``.npz`` of the flattened state pytree.

The reference persists three artifacts per model — weights ``.h5``,
architecture JSON, hyperparams/timing ``.npz``
(``/root/reference/Proposed_Work_Results.py:370-374``) — plus a
best-val-loss ``ModelCheckpoint``.  Here one checkpoint directory
carries the same triple: ``state.npz`` with the model state (params +
batch_stats + opt_state + step, one array per leaf in tree order, keyed
by leaf path), and ``metadata.json`` with the run metadata (epochs,
batch size, learning rate, trainingTimeTaken) and the config dict.

Both files are written to a temporary name and renamed into place, so a
process killed mid-save leaves the previous checkpoint whole.  Restoring
needs a template state of the same structure (built from the model and
optimizer), which supplies the tree definition.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from .state import TrainState

_STATE = "state.npz"
_META = "metadata.json"


def _payload(state: TrainState) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step}


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState,
                    metadata: dict | None = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree_util.tree_flatten_with_path(_payload(state))[0]
    arrays = {f"{i:05d}{jax.tree_util.keystr(k)}": np.asarray(v)
              for i, (k, v) in enumerate(leaves)}
    _write_atomic(os.path.join(path, _STATE),
                  lambda f: np.savez(f, **arrays))
    if metadata is not None:
        _write_json(path, metadata)


def restore_checkpoint(path: str, template: TrainState
                       ) -> tuple[TrainState, dict]:
    path = os.path.abspath(path)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        _payload(template))
    with np.load(os.path.join(path, _STATE)) as z:
        names = sorted(z.files)
        if len(names) != len(leaves):
            raise ValueError(f"checkpoint has {len(names)} arrays, the "
                             f"template {len(leaves)}")
        restored = []
        for name, (key, like) in zip(names, leaves):
            if name[5:] != jax.tree_util.keystr(key):
                raise ValueError(f"checkpoint leaf {name[5:]} does not "
                                 f"match template leaf "
                                 f"{jax.tree_util.keystr(key)}")
            arr = z[name]
            if arr.shape != np.shape(like):
                raise ValueError(f"{name[5:]}: shape {arr.shape} != "
                                 f"{np.shape(like)}")
            restored.append(jnp.asarray(arr, dtype=like.dtype))
    out = jax.tree_util.tree_unflatten(treedef, restored)
    return TrainState(**out), _read_json(path)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(os.path.abspath(path), _STATE))


def _read_json(path: str) -> dict:
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _write_json(path: str, meta: dict) -> None:
    text = json.dumps(meta, indent=2, default=str).encode()
    _write_atomic(os.path.join(path, _META), lambda f: f.write(text))


def update_metadata(path: str, fields: dict) -> None:
    """Merge ``fields`` into the checkpoint's ``metadata.json``.

    Used by the experiment runner to stamp ``completed`` /
    ``epochs_run`` after training finishes, so a later resume can tell a
    finished fold from one whose process died mid-budget."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = _read_json(path)
    meta.update(fields)
    _write_json(path, meta)
