"""Bulk feature-cache prewarming.

Builds the featuregram cache for a whole corpus up front with batched
device featurization (files grouped by length bucket), instead of the
reference's lazy epoch-1 per-file computation.

    python -m sm_hpss_mtl_tpu.cli.featurize --data D --features CACHE \
        [--model Lemaire_et_al_MTL] [--n-classes 3] [--batch-size 16]
"""

from __future__ import annotations

import argparse
import os

from ..data import Featurizer, load_cv_folds
from ..data.folds import create_cv_folds
from ..train.config import MODEL_PRESETS, ExperimentConfig
from ..utils.compile_cache import enable_compile_cache
from .experiment import class_names_for


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--n-classes", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    args = p.parse_args(argv)
    enable_compile_cache()

    config = ExperimentConfig(model=args.model, data_root=args.data,
                              n_classes=args.n_classes)
    feat_cfg = config.feature_config()
    cache = os.path.join(args.features, args.model, feat_cfg.feat_name)
    fz = Featurizer(feat_cfg, cache_dir=cache)

    with_noise = args.n_classes == 5
    cv_path = os.path.join(args.data,
                           "cv_info_5_class" if with_noise else "cv_info")
    if os.path.exists(os.path.join(cv_path, "cv_file_list.pkl")):
        cv = load_cv_folds(cv_path)
    else:
        cv = create_cv_folds(args.data, with_noise=with_noise)

    items = []
    for cls in class_names_for(args.n_classes):
        for k in range(cv["CV_folds"]):
            for item in cv[cls][f"fold{k}"]:
                if isinstance(item, dict):
                    partner = "music" if "music" in item else "noise"
                    items.append((
                        "speech_music" if partner == "music" else "speech_noise",
                        os.path.join(args.data, "speech", item["speech"]),
                        os.path.join(args.data, partner, item[partner]),
                        item["SMR"]))
                elif cls == "speech":
                    items.append(("speech",
                                  os.path.join(args.data, "speech", item),
                                  "", None))
                else:
                    items.append((cls, "",
                                  os.path.join(args.data, cls, item), None))

    done = fz.precompute(items, batch_size=args.batch_size, verbose=True)
    print(f"computed {done} new featuregrams "
          f"({len(items) - done} already cached) -> {cache}")


if __name__ == "__main__":
    main()
