"""Result/config CSV writers matching ``lib/misc.py``.

``append_results`` reproduces ``print_results`` (``/root/reference/lib/
misc.py:109-133``): tab-separated ``Performance.csv`` with a
write-header-once convention, one row per fold.  ``dump_configuration``
reproduces ``print_configuration`` (:138-153).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, is_dataclass


def append_results(op_dir: str, fold: int, res: dict,
                   suffix: str = "") -> str:
    os.makedirs(op_dir, exist_ok=True)
    name = f"Performance_{suffix}.csv" if suffix else "Performance.csv"
    path = os.path.join(op_dir, name)
    new_file = not os.path.exists(path) or os.path.getsize(path) == 0
    heading = "fold" + "".join(f"\t{k}" for k in res)
    values = str(fold) + "".join(f"\t{v}" for v in res.values())
    with open(path, "a", encoding="utf-8") as f:
        if new_file:
            f.write(heading + "\n")
        f.write(values + "\n")
    return path


def dump_configuration(op_dir: str, config) -> str:
    os.makedirs(op_dir, exist_ok=True)
    path = os.path.join(op_dir, "Configuration.csv")
    items = asdict(config) if is_dataclass(config) else dict(config)
    with open(path, "a", encoding="utf-8") as f:
        for k, v in items.items():
            try:
                f.write(f"{k}\t{json.dumps(v)}\n")
            except TypeError:
                f.write(f"{k}\tERROR\n")
    return path


def append_analysis(path: str, results: dict) -> str:
    """``misc.print_analysis`` (``/root/reference/lib/misc.py:158-181``):
    tab-separated key:value rows with a write-header-once convention."""
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new_file = not os.path.exists(path) or os.path.getsize(path) == 0
    heading = "\t".join(str(k) for k in results)
    values = "\t".join(str(v) for v in results.values())
    with open(path, "a", encoding="utf-8") as f:
        if new_file:
            f.write(heading + "\n")
        f.write(values + "\n")
    return path


def dump_model_summary(path: str, module, sample_input, *,
                       train: bool = False) -> str:
    """Write a Keras-style parameter table (``misc.print_model_summary``,
    ``/root/reference/lib/misc.py:184-189``) via ``models.nn.param_table``."""
    import os

    import jax

    from ..models.nn import param_table

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    table = param_table(module, {"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(0)},
                        sample_input, train=train)
    with open(path, "w", encoding="utf-8") as f:
        f.write(table)
    return path
