"""5-class driver: music / speech / speech+music / noise / speech+noise.

JAX equivalent of ``/root/reference/5_class_classification.py``:
the Lemaire-MTL model with the extra noise head and 3-dim SMNR
regression, trained on folds that include the noise class and
speech+noise pairs (make them with ``make_folds --with-noise``).

    python -m sm_hpss_mtl_tpu.cli.five_class --data /path/to/musan
"""

from __future__ import annotations

from ..utils.compile_cache import enable_compile_cache
from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    parser = build_parser(default_model="Lemaire_et_al_MTL_5class")
    parser.set_defaults(n_classes=5)
    args = parser.parse_args(argv)
    enable_compile_cache()
    args.n_classes = 5
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()
