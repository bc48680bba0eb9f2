"""Baseline driver: the four single-task models on 2- or 3-class MUSAN.

JAX equivalent of ``/root/reference/Baseline_Results.py``.

    python -m sm_hpss_mtl_tpu.cli.baseline --data /path/to/musan \
        --model Lemaire_et_al --epochs 50
"""

from __future__ import annotations

from ..utils.compile_cache import enable_compile_cache
from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    args = build_parser(default_model="Lemaire_et_al").parse_args(argv)
    enable_compile_cache()
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()
