"""Model registry mirroring the reference's model names.

``get_model(name, ...)`` returns a module (``models.nn``) plus its expected input
spec.  Names match the reference drivers' ``PARAMS['Model']`` values
(``/root/reference/Proposed_Work_Results.py:749``,
``Baseline_Results.py:546``) with two additions: the intermediate-fusion
and 5-class variants, which the reference configures through separate
driver scripts rather than model names.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cnn import DoukhanCNN, PapakostasCNN
from .jang import JangCNN
from .lemaire import LemaireMTL, LemaireMTLIntermediateFusion, LemaireTCN


@dataclass(frozen=True)
class ModelSpec:
    module: object
    #: 'time_mel' = (B, T, D); 'image' = (B, D, T, 1); 'dual' = dict of two
    #: 'time_mel' inputs.
    input_kind: str
    mtl: bool
    #: head loss names when mtl
    heads: tuple = ()


def get_model(name: str, *, n_classes: int = 3, n_mels: int = 120,
              dropout_rate: float = 0.275, dtype=None,
              **arch_kwargs) -> ModelSpec:
    """``arch_kwargs`` (Lemaire family only): kernel_size, Nd, nb_stacks,
    n_filters, use_skip_connections, head_width, head_layers — the tuning
    drivers' search space.  ``dtype=jnp.bfloat16`` enables mixed-precision
    compute (params and losses stay f32)."""
    if arch_kwargs and not name.startswith("Lemaire"):
        raise ValueError(f"arch_kwargs not supported for {name!r}")
    common_tcn = dict(n_classes=n_classes, dropout_rate=dropout_rate,
                      dtype=dtype, **arch_kwargs)
    if name == "Lemaire_et_al":
        kwargs = {k: v for k, v in common_tcn.items()
                  if k not in ("head_width", "head_layers")}
        return ModelSpec(LemaireTCN(**kwargs), "time_mel", False)
    if name == "Lemaire_et_al_MTL":
        return ModelSpec(LemaireMTL(**common_tcn), "time_mel", True,
                         ("S", "M", "R", "3C"))
    if name == "Lemaire_et_al_Cascaded_MTL":
        return ModelSpec(LemaireMTL(cascaded=True, **common_tcn), "time_mel",
                         True, ("S", "M", "R", "3C"))
    if name == "Lemaire_et_al_MTL_5class":
        return ModelSpec(LemaireMTL(with_noise=True,
                                    **{**common_tcn, "n_classes": 5}),
                         "time_mel", True, ("S", "M", "N", "R", "3C"))
    if name == "Lemaire_et_al_MTL_IF":
        kwargs = {k: v for k, v in common_tcn.items()
                  if k not in ("head_width", "head_layers", "kernel_size",
                               "Nd", "use_skip_connections")}
        return ModelSpec(LemaireMTLIntermediateFusion(**kwargs), "dual",
                         True, ("S", "M", "R", "3C"))
    if name == "Doukhan_et_al":
        return ModelSpec(DoukhanCNN(n_classes=n_classes, dtype=dtype),
                         "image", False)
    if name == "Doukhan_et_al_MTL":
        return ModelSpec(DoukhanCNN(n_classes=n_classes, mtl=True,
                                    dtype=dtype), "image",
                         True, ("S", "M", "R", "3C"))
    if name == "Papakostas_et_al":
        return ModelSpec(PapakostasCNN(n_classes=n_classes, dtype=dtype),
                         "image", False)
    if name == "Papakostas_et_al_MTL":
        return ModelSpec(PapakostasCNN(n_classes=n_classes, mtl=True,
                                       dtype=dtype), "image",
                         True, ("S", "M", "R", "3C"))
    if name == "Jang_et_al":
        return ModelSpec(JangCNN(n_classes=n_classes, n_mels=64, dtype=dtype),
                         "image", False)
    if name == "Jang_et_al_MTL":
        return ModelSpec(JangCNN(n_classes=n_classes, mtl=True,
                                 n_mels=n_mels, dtype=dtype), "image", True,
                         ("S", "M", "R", "3C"))
    raise ValueError(f"unknown model {name!r}")


MODEL_NAMES = (
    "Lemaire_et_al", "Lemaire_et_al_MTL", "Lemaire_et_al_Cascaded_MTL",
    "Lemaire_et_al_MTL_5class", "Lemaire_et_al_MTL_IF",
    "Doukhan_et_al", "Doukhan_et_al_MTL",
    "Papakostas_et_al", "Papakostas_et_al_MTL",
    "Jang_et_al", "Jang_et_al_MTL",
)
