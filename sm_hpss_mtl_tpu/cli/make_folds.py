"""Create cross-validation folds for a MUSAN-layout corpus.

JAX equivalent of ``/root/reference/create_cross_validation_folds.py``
(and the 5-class variant via --with-noise).

    python -m sm_hpss_mtl_tpu.cli.make_folds --data /path/to/musan [--with-noise]
"""

from __future__ import annotations

import argparse
import os

from ..data import create_cv_folds, save_cv_folds
from ..utils.compile_cache import enable_compile_cache


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--output", default=None,
                   help="default: <data>/cv_info")
    p.add_argument("--cv", type=int, default=3)
    p.add_argument("--with-noise", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    enable_compile_cache()
    cv = create_cv_folds(args.data, cv=args.cv, with_noise=args.with_noise,
                         seed=args.seed)
    out = args.output or os.path.join(args.data, "cv_info")
    save_cv_folds(cv, out)
    for cls in ("music", "speech"):
        sizes = [len(cv[cls][f"fold{k}"]) for k in range(args.cv)]
        print(f"{cls}: folds {sizes}")
    print(f"dataset_size: {cv['dataset_size']:.2f} h -> {out}")


if __name__ == "__main__":
    main()
