"""Intermediate-fusion driver: twin harmonic/percussive TCN towers.

JAX equivalent of ``/root/reference/Intermediate_Fusion_Results.py``:
the Lemaire-MTL model with separate harm/perc towers fused by
concatenation, fed dict batches {'harm_input', 'perc_input'}.

    python -m sm_hpss_mtl_tpu.cli.fuse_intermediate --data /path/to/musan
"""

from __future__ import annotations

from ..utils.compile_cache import enable_compile_cache
from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    parser = build_parser(default_model="Lemaire_et_al_MTL_IF")
    args = parser.parse_args(argv)
    enable_compile_cache()
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()
