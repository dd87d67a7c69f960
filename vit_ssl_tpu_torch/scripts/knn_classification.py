"""k-NN classification of an experiment's features (after the repo's
``scripts/knn_classification.py``): extract the features of the
experiment's ``best_model`` over the ``eval.*`` datasets, fit cosine k-NN
(k = ``eval.num_classes``), log the top-1 accuracy.

    python -m vit_ssl_tpu_torch.scripts.knn_classification eval.experiment_path=<run> [--device cpu]
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
    from ..evaluators import merge_with_experiment_config, run_knn_evaluation
    from ..evaluators.unsupervised_evaluator import feature_bank

    config = compose(args.config_path, args.config_name, args.overrides)
    if "experiment_path" in config.get("eval", {}):
        config = merge_with_experiment_config(config)
    bank = feature_bank(config, device=args.device)
    return run_knn_evaluation(bank.train_features, bank.train_labels,
                              bank.val_features, bank.val_labels,
                              int(config["eval"]["num_classes"]), device=args.device)


if __name__ == "__main__":
    main()
