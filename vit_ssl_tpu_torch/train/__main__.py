"""Training entry point of the port (after the repo's ``train.py``):

    python -m vit_ssl_tpu_torch.train                        # configs/config.yaml (dino)
    python -m vit_ssl_tpu_torch.train --config-name dino training.num_epochs=50
    python -m vit_ssl_tpu_torch.train --device cpu ...       # the plain path on the CPU
    python -m vit_ssl_tpu_torch.train -m training.warmup_final_learning_rate=1e-4,1e-3

It composes the config (:mod:`vit_ssl_tpu_torch.config`), creates the run
directory from ``hydra.run.dir`` (saving ``.hydra/config.yaml`` and
``overrides.yaml`` as Hydra does), builds the loaders, the network on the
device and the trainer, resumes from ``training.resume_from_checkpoint``
when it is set, and runs ``fit`` through :func:`fit_with_preemption`. It
runs on the CUDA card unless ``--device cpu`` asks for the CPU; with no card
and no such request it raises. The port trains every mode of the JAX
package (``training.type``): DINO, SimMIM, supervised and finetune.

Several processes, one device each (the parallel axes, ``parallel.*``):

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m vit_ssl_tpu_torch.train --config-name vit_b_imagenet    # dp=8 cards
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m vit_ssl_tpu_torch.train --device cpu parallel.sp=2 ...  # dp=2 × sp=2, gloo

Under the launcher (``WORLD_SIZE`` > 1), or with ``parallel.multihost=true``,
the entry point starts the process group from the launcher's environment
(:func:`init_distributed`): NCCL with each process on ``cuda:$LOCAL_RANK``,
or gloo with ``--device cpu``; a card whose NCCL fails raises, never falls
back to gloo. The mesh of ``parallel.*`` is published before the loaders
are built (they shard by the data rank). Rank 0 alone writes the run
directory, ``.hydra/``, checkpoints and evaluations; the group is destroyed
at the end, and a preemption exits 75 on every rank.

Preemption (:mod:`..utils.preempt`): with ``training.preempt_checkpointing``
(the default) SIGTERM or SIGUSR1 makes the trainer stop at the next batch
boundary, write ``<run>/preempt_model`` and exit with code 75. Rerun with
``training.resume_from_checkpoint=<run>/preempt_model`` (then
``training.num_epochs`` counts the epochs to run, the interrupted one
included), or rerun the same command with ``training.auto_resume=true`` and
a pinned ``hydra.run.dir``: it picks ``preempt_model`` up, trains up to the
original ``training.num_epochs`` and removes it at the end, so a retry loop
(``until python -m vit_ssl_tpu_torch.train ...; do :; done``) converges to
the uninterrupted run bit for bit.
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


def init_distributed(config, device=None):
    """Start the process group when the launcher started several processes
    (``WORLD_SIZE`` > 1 in the environment) or ``parallel.multihost`` asks
    for one: ``env://`` rendezvous, gloo with a CPU device, else NCCL with
    this process on ``cuda:$LOCAL_RANK``. Returns (device, whether it
    started the group). No card and no ``--device cpu`` raises, as for one
    process; an NCCL failure raises too."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    multihost = bool((config.get("parallel", {}) or {}).get("multihost", False))
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(device)
    if (world_size <= 1 and not multihost) or dist.is_initialized():
        return device, False
    if "MASTER_ADDR" not in os.environ:
        raise RuntimeError(
            "parallel.multihost=true needs the launcher's environment (RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT): run under python -m "
            "torch.distributed.run")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")
    logger.info("Process group: rank %d of %d (%s) on %s", dist.get_rank(),
                dist.get_world_size(), dist.get_backend(), device)
    return device, True


def run_single(config_path, config_name, overrides, device=None) -> str:
    from ..config import compose, preflight_eval_data, validate_train_config
    from ..data.builder import prepare_dataloaders
    from ..models.builder import build_model
    from ..parallel import context as parallel_context
    from ..parallel.mesh import mesh_from_config

    config = compose(config_path, config_name, overrides)
    validate_train_config(config)
    preflight_eval_data(config)
    mode = str(config["training"]["type"]).lower()
    device, started = init_distributed(config, device)
    try:
        logger.info("Starting training with mode: %s on %s", mode, device)
        check_mode(mode)
        mesh = mesh_from_config(config)
        parallel_context.set_parallel_context(mesh)
        logger.info("Device mesh: %s", mesh)
        train_loader, val_loader = prepare_dataloaders(config, mode)
        network = build_model(config, device)

        save_path = get_save_path(config)
        if parallel_context.is_rank_zero():
            os.makedirs(save_path, exist_ok=True)
            save_run_config(config, overrides, save_path)
            logger.info("Run directory: %s", save_path)
        parallel_context.barrier()

        trainer = get_trainer(mode, network, save_path, config, train_loader,
                              val_loader, device)
        fit_with_preemption(trainer, config, save_path)
        logger.info("Training completed for mode: %s", mode)
        parallel_context.barrier()
        return save_path
    finally:
        parallel_context.set_parallel_context(None)
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def fit_with_preemption(trainer, config, save_path: str) -> None:
    """Resume, fit and handle a preemption, as ``train.py`` does for the JAX
    package: ``training.resume_from_checkpoint`` resumes and fits
    ``num_epochs`` more; otherwise ``training.auto_resume`` picks up
    ``<save_path>/preempt_model`` when there is one and fits up to
    ``num_epochs`` in all. With ``training.preempt_checkpointing`` the
    signal handler is installed for the fit. On ``PreemptionRequested`` the
    trainer writes ``preempt_model`` and this raises ``SystemExit(75)``; the
    handler is always uninstalled. An auto-resumed fit that ends removes the
    ``preempt_model`` it consumed."""
    import shutil

    from ..utils.preempt import (PREEMPT_EXIT_CODE, PreemptionRequested,
                                 install_preemption_handler,
                                 uninstall_preemption_handler)

    training = config["training"]
    resume = training.get("resume_from_checkpoint", None)
    auto_resumed = False
    if not resume and bool(training.get("auto_resume", False)):
        candidate = os.path.join(save_path, "preempt_model")
        if os.path.isdir(candidate):
            resume, auto_resumed = candidate, True
            logger.info("auto_resume: picking up %s", candidate)
    if resume:
        trainer.resume_from(resume)
    epochs = int(training["num_epochs"])
    if auto_resumed:
        epochs = max(0, epochs - trainer.start_epoch)
    if bool(training.get("preempt_checkpointing", True)):
        install_preemption_handler()
    try:
        trainer.fit(epochs)
    except PreemptionRequested as e:
        path = trainer.save_preempt(e)
        logger.warning("Preempted at epoch %d after %d batches; state saved to %s. "
                       "Resume with training.resume_from_checkpoint=%s, or rerun "
                       "with training.auto_resume=true", e.epoch, e.batches_done,
                       path, path)
        raise SystemExit(PREEMPT_EXIT_CODE)
    finally:
        uninstall_preemption_handler()
    if auto_resumed:
        from ..parallel import context as parallel_context

        parallel_context.barrier()  # every rank has read it
        if parallel_context.is_rank_zero():
            shutil.rmtree(os.path.join(save_path, "preempt_model"), ignore_errors=True)


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
