"""Rotating 3D embedding of an experiment's features (after the repo's
``scripts/umap_3d_visualizer.py``): extract the features of the
experiment's ``best_model`` over the ``eval.*`` datasets, project the
train and val features together to 3D, and write ``umap_3d_rotation.gif``
into the experiment directory where matplotlib and PIL are installed
(:func:`..evaluators.embedding_analysis.create_3d_umap_animation`).

    python -m vit_ssl_tpu_torch.scripts.umap_3d_visualizer eval.experiment_path=<run> [--device cpu]
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", "-cn", default="eval_config")
    parser.add_argument("--config-path", "-cp", default="configs")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from ..config import compose
    from ..evaluators import (create_3d_umap_animation, merge_with_experiment_config,
                              prepare_combined_features)
    from ..evaluators.unsupervised_evaluator import feature_bank

    config = compose(args.config_path, args.config_name, args.overrides)
    if "experiment_path" in config.get("eval", {}):
        config = merge_with_experiment_config(config)
    bank = feature_bank(config, device=args.device)
    features, labels = prepare_combined_features(bank.train_features, bank.train_labels,
                                                 bank.val_features, bank.val_labels)
    return create_3d_umap_animation(features, labels, config["eval"]["experiment_path"],
                                    device=args.device)


if __name__ == "__main__":
    main()
