"""Training entry point of the port (after the repo's ``train.py``):

    python -m vit_ssl_tpu_torch.train                        # configs/config.yaml (dino)
    python -m vit_ssl_tpu_torch.train --config-name dino training.num_epochs=50
    python -m vit_ssl_tpu_torch.train --device cpu ...       # the plain path on the CPU
    python -m vit_ssl_tpu_torch.train -m training.warmup_final_learning_rate=1e-4,1e-3

It composes the config (:mod:`vit_ssl_tpu_torch.config`), creates the run
directory from ``hydra.run.dir`` (saving ``.hydra/config.yaml`` and
``overrides.yaml`` as Hydra does), builds the loaders, the network on the
device and the trainer, resumes from ``training.resume_from_checkpoint``
when it is set, and runs ``fit``. It runs on the CUDA card unless
``--device cpu`` asks for the CPU; with no card and no such request it
raises. The port trains every mode of the JAX package
(``training.type``): DINO, SimMIM, supervised and finetune.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
from typing import List, Optional

logger = logging.getLogger("vit_ssl_tpu_torch.train")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", "-cn", default="config",
                        help="config root to compose")
    parser.add_argument("--config-path", "-cp", default="configs",
                        help="config directory")
    parser.add_argument("--device", default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument(
        "overrides", nargs="*",
        help="hydra-style overrides: dotlist (a.b=c) and config groups "
             "(group@package=option, +group@package=option)")
    parser.add_argument(
        "-m", "--multirun", action="store_true",
        help="Hydra-style sweep: expand comma-list overrides into the "
             "cartesian product of jobs and run them sequentially under "
             "multirun/<date>/<time>/<job>")
    return parser.parse_args(argv)


def get_save_path(config) -> str:
    """A resume re-homes into the checkpoint's run directory; otherwise
    ``hydra.run.dir``."""
    resume = config["training"].get("resume_from_checkpoint", None)
    if resume:
        resume_dir = os.path.dirname(resume)
        if not os.path.exists(resume_dir):
            raise FileNotFoundError(
                f"resume_from_checkpoint: {resume_dir} does not exist")
        return resume_dir
    return config.get("hydra", {}).get("run", {}).get("dir", ".")


def save_run_config(config, overrides, save_path: str) -> None:
    from ..config import save_yaml, to_container

    hydra_dir = os.path.join(save_path, ".hydra")
    os.makedirs(hydra_dir, exist_ok=True)
    cfg = to_container(config)
    cfg.pop("hydra", None)
    save_yaml(cfg, os.path.join(hydra_dir, "config.yaml"))
    save_yaml(list(overrides), os.path.join(hydra_dir, "overrides.yaml"))


def check_mode(mode: str) -> None:
    """Raise unless the port trains ``mode``."""
    if mode not in ("supervised", "finetune", "simmim", "dino"):
        raise ValueError(f"Unknown training mode: {mode}")


def get_trainer(mode, network, save_path, config, train_loader, val_loader, device):
    """The trainer of ``mode``: supervised and finetune share one."""
    from .trainers import DINOTrainer, SimMIMTrainer, SupervisedTrainer

    check_mode(mode)
    cls = {"dino": DINOTrainer, "simmim": SimMIMTrainer}.get(mode, SupervisedTrainer)
    return cls(network, save_path, config, train_loader, val_loader, device)


def run_single(config_path, config_name, overrides, device=None) -> str:
    from ..config import compose, preflight_eval_data, validate_train_config
    from ..data.builder import prepare_dataloaders
    from ..device import resolve_device
    from ..models.builder import build_model

    config = compose(config_path, config_name, overrides)
    validate_train_config(config)
    preflight_eval_data(config)
    mode = str(config["training"]["type"]).lower()
    device = resolve_device(device)
    logger.info("Starting training with mode: %s on %s", mode, device)

    check_mode(mode)
    train_loader, val_loader = prepare_dataloaders(config, mode)
    network = build_model(config, device)

    save_path = get_save_path(config)
    os.makedirs(save_path, exist_ok=True)
    save_run_config(config, overrides, save_path)
    logger.info("Run directory: %s", save_path)

    trainer = get_trainer(mode, network, save_path, config, train_loader,
                          val_loader, device)
    resume = config["training"].get("resume_from_checkpoint", None)
    if resume:
        trainer.resume_from(resume)
    if bool(config["training"].get("preempt_checkpointing", True)):
        logger.info("training.preempt_checkpointing: no SIGTERM handler is "
                    "installed yet (ROADMAP.md queue A item 8)")
    trainer.fit(int(config["training"]["num_epochs"]))
    logger.info("Training completed for mode: %s", mode)
    return save_path


def run_multirun(args) -> List[str]:
    """The cartesian product of comma-list overrides, one job after another,
    each in ``<sweep_dir>/<job_idx>`` (``multirun/<date>/<time>/<n>``), the
    sweep's overrides in ``<sweep_dir>/multirun.yaml``."""
    from ..config import expand_multirun, save_yaml

    jobs = expand_multirun(args.overrides)
    now = datetime.datetime.now()
    sweep_dir = os.path.join("multirun", now.strftime("%Y-%m-%d"),
                             now.strftime("%H-%M-%S"))
    os.makedirs(sweep_dir, exist_ok=True)
    save_yaml({"overrides": list(args.overrides), "n_jobs": len(jobs)},
              os.path.join(sweep_dir, "multirun.yaml"))
    logger.info("Multirun: %d job(s) under %s", len(jobs), sweep_dir)
    run_dirs = []
    for idx, job_overrides in enumerate(jobs):
        job_dir = os.path.join(sweep_dir, str(idx))
        logger.info("Multirun job %d/%d: %s", idx, len(jobs), " ".join(job_overrides))
        # pinned last, so that it wins over a user's hydra.run.dir
        run_dirs.append(run_single(args.config_path, args.config_name,
                                   list(job_overrides) + [f"hydra.run.dir={job_dir}"],
                                   args.device))
    return run_dirs


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    if args.multirun:
        return run_multirun(args)
    return run_single(args.config_path, args.config_name, args.overrides,
                      args.device)


if __name__ == "__main__":
    main()
