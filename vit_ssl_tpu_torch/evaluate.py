"""Evaluation entry point of the port (after the repo's ``evaluate.py``):

    python -m vit_ssl_tpu_torch.evaluate --config-name eval_config eval.experiment_path=<run>
    python -m vit_ssl_tpu_torch.evaluate --config-name supervised_eval eval.experiment_path=<run>
    python -m vit_ssl_tpu_torch.evaluate --config-name unsupervised_eval 'eval.mode=[eval_knn,eval_umap]'
    python -m vit_ssl_tpu_torch.evaluate -m eval.experiment_path=<run a>,<run b>
    python -m vit_ssl_tpu_torch.evaluate --device cpu ...

A config with ``eval.mode`` (checked by ``validate_eval_config``) runs the
unsupervised evaluation (KNN, linear probe, UMAP); one without it the
supervised accuracy, predictions and confusion matrix. Either merges the
experiment's saved config and loads its ``best_model``. ``-m`` expands
comma-list overrides into the cartesian product of jobs, evaluated one
after another. It runs on the CUDA card unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("vit_ssl_tpu_torch.evaluate")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", "-cn", default="eval_config")
    parser.add_argument("--config-path", "-cp", default="configs")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    parser.add_argument("overrides", nargs="*")
    parser.add_argument(
        "-m", "--multirun", action="store_true",
        help="Hydra-style sweep: expand comma-list overrides into the cartesian "
             "product of jobs and evaluate them one after another")
    return parser.parse_args(argv)


def run_one(config_path, config_name, overrides, device=None):
    from .config import compose, validate_eval_config

    config = compose(config_path, config_name, overrides)
    if config.get("eval", {}).get("mode"):
        validate_eval_config(config)
        from .evaluators.unsupervised_evaluator import run_evaluation
    else:
        from .evaluators.supervised_evaluator import run_evaluation
    return run_evaluation(config, device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    if args.multirun:
        from .config import expand_multirun

        jobs = expand_multirun(args.overrides)
        logger.info("Multirun: %d evaluation job(s)", len(jobs))
        return [run_one(args.config_path, args.config_name, job, args.device)
                for job in jobs]
    return run_one(args.config_path, args.config_name, args.overrides, args.device)


if __name__ == "__main__":
    main()
