"""Base trainer (after ``vit_ssl_tpu/train/trainers/base.py``): the fit loop,
the train state, checkpoints and resume.

``fit`` runs, per epoch: ``train_epoch`` → ``validate`` → log → the best
checkpoint (each trainer keys "best" its own way) → ``last_model``;
checkpoints embed the config. As in the JAX package:

- the step's outputs stay on the device through the epoch and are fetched
  once at its end: no per-step host sync;
- host batches reach the device ``depth`` = 3 batches ahead of the step
  (pinned host memory, ``non_blocking`` copies on the card), and the time
  spent waiting on the host loader is logged once an epoch as the input
  pipeline's goodput line;
- ``last_model`` also records the best score so far (``best_key``:
  ``best_val_score`` for DINO, ``best_val_acc`` for the supervised
  trainer), so a resume from it restores the best policy;
- the optimizer freezes what ``_trainable_mask`` says, and
  ``_init_state`` of a trainer that finetunes loads its pretrained weights
  (``_apply_pretrained``) into the freshly drawn network;
- one snapshot a checkpointed epoch, a completed copy to host memory taken
  before the next step runs (the port's train state is updated in place,
  so a copy that lagged would hold a later step's weights); the file is
  written on a thread while the next epoch trains.

Refused by name, each with its ``ROADMAP.md`` queue-A item:
``training.auto_resume`` and ``training.fault_inject_preempt_step`` (item
8), ``parallel.{tp,pp,sp,ep} > 1``, ``parallel.fsdp`` and
``parallel.multihost`` (item 10), and an automatic evaluation that would
fire (item 7; :func:`refuse_automatic_evaluation`).
``training.preempt_checkpointing`` is accepted; no SIGTERM handler is
installed yet (item 8).
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from abc import ABC, abstractmethod
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...config import to_container
from ...device import resolve_device
from ...models.builder import config_mode
from ...utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from ...utils.history import TrainingHistory
from ...utils.logger import Logger
from ...utils.metrics import MetricHandler
from ..schedules import lr_schedule_from_config
from ..state import make_optimizer

logger = logging.getLogger(__name__)


def refuse_unported_training(config) -> None:
    """Raise on a training option the port does not run yet, naming its
    ``ROADMAP.md`` queue-A item."""
    training = config.get("training", {}) or {}
    if bool(training.get("auto_resume", False)):
        raise NotImplementedError(
            "training.auto_resume=true (elastic restart from preempt_model) is "
            "not ported yet; see ROADMAP.md queue A item 8")
    if int(training.get("fault_inject_preempt_step", 0) or 0) > 0:
        raise NotImplementedError(
            "training.fault_inject_preempt_step > 0 (preemption fault "
            "injection) is not ported yet; see ROADMAP.md queue A item 8")
    parallel = config.get("parallel", {}) or {}
    for axis in ("tp", "pp", "sp", "ep"):
        if int(parallel.get(axis, 1) or 1) > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1 is not ported yet; see ROADMAP.md queue A "
                "item 10")
    for flag in ("fsdp", "multihost"):
        if bool(parallel.get(flag, False)):
            raise NotImplementedError(
                f"parallel.{flag}=true is not ported yet; see ROADMAP.md queue A "
                "item 10")


def refuse_automatic_evaluation(config, needs_mode: bool = True) -> None:
    """Raise when ``fit`` would reach an automatic evaluation (the
    condition ``preflight_eval_data`` checks): ``eval.interval`` > 0 (and,
    with ``needs_mode``, as the SSL trainers have it, ``eval.mode`` set) on
    a run that reaches a multiple of the interval. The evaluators are
    ``ROADMAP.md`` queue A item 7."""
    eval_cfg = config.get("eval", {}) or {}
    interval = int(eval_cfg.get("interval", 0) or 0)
    if not interval or (needs_mode and not eval_cfg.get("mode")):
        return
    training = config.get("training", {}) or {}
    num_epochs = int(training.get("num_epochs", 0) or 0)
    if num_epochs < interval and not training.get("resume_from_checkpoint"):
        return
    raise NotImplementedError(
        f"eval.interval={interval}"
        + (f" with eval.mode={eval_cfg.get('mode')}" if needs_mode else "")
        + " would run the automatic evaluation, and the evaluators are not "
        "ported yet (ROADMAP.md queue A item 7); set eval.interval=0")


def to_host(tree: Any) -> Any:
    """A completed copy of ``tree``'s tensors in host memory (a new tensor
    also for those already there)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree


class BaseTrainer(ABC):
    # the metadata key of the best score (last_model, best_model, resume)
    best_key = "best_val_score"

    def __init__(self, network: torch.nn.Module, save_path: str, config,
                 train_loader, val_loader, device=None):
        refuse_unported_training(config)
        self.device = resolve_device(device)
        self.network = network
        self.mode = config_mode(config)
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.save_path = save_path
        self.warmup_epochs = int(config["training"]["warmup_epochs"])
        self.num_epochs = int(config["training"]["num_epochs"])
        self.eval_interval = int(config["eval"].get("interval", 0) or 0)

        self.lr_schedule = lr_schedule_from_config(config, max(1, len(train_loader)))
        self.optimizer = make_optimizer(config, self.lr_schedule,
                                        self._mask_list(self._trainable_mask()))

        self.metric_handler = MetricHandler(config)
        self.train_logger = Logger(
            self.metric_handler.metric_names,
            len(train_loader),
            len(val_loader) if val_loader is not None else 0,
            self.num_epochs + 1,
            plain=bool(config["training"].get("plain_logging", False)),
        )
        self.history = TrainingHistory(save_path)

        self.best_score = -math.inf  # each trainer keys "best" its own way
        self.current_epoch = 0
        self.start_epoch = 0
        self._snapshot = None
        self._snapshot_epoch = -1
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        # per train epoch: host seconds waiting on the loader, wall seconds,
        # batches (the goodput line); per checkpoint: its snapshot and write
        self.epoch_input_stats: List[Dict[str, float]] = []
        self.save_times: List[Dict[str, Any]] = []

        self.state = self._init_state()
        self._build_steps()

    # -- hooks ---------------------------------------------------------------
    def _trainable_mask(self) -> Optional[Dict[str, bool]]:
        """Trainable by parameter name, or None: all of them."""
        return None

    def _mask_list(self, mask: Optional[Dict[str, bool]]) -> Optional[List[bool]]:
        """A mask by name as one bool a parameter, in ``parameters()``
        order (the optimizer's)."""
        if mask is None:
            return None
        return [mask[name] for name, _ in self.network.named_parameters()]

    @abstractmethod
    def _init_state(self):
        """The train state, from ``training.random_seed``."""

    @abstractmethod
    def _build_steps(self):
        """The step functions against ``self.optimizer``."""

    @abstractmethod
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        ...

    @abstractmethod
    def validate(self) -> Dict[str, float]:
        ...

    @abstractmethod
    def _save_if_best(self, epoch: int, val_metrics: Dict[str, float]):
        """Save ``best_model`` when the epoch beats ``best_score``."""

    # -- profiling -------------------------------------------------------------
    def _maybe_start_profile(self, epoch: int):
        """A ``torch.profiler`` window over the second epoch of this run
        (the first when it trains one), with ``training.profile``."""
        if not bool(self.config["training"].get("profile", False)):
            return None
        if epoch != self.start_epoch + 2 and not (
            self.num_epochs == 1 and epoch == self.start_epoch + 1
        ):
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profile(self, profiler, epoch: int):
        if profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        trace_dir = os.path.join(self.save_path, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace_epoch_{epoch}.json")
        profiler.export_chrome_trace(path)
        logger.info("torch.profiler trace of epoch %d written to %s", epoch, path)

    # -- fit loop ---------------------------------------------------------------
    def fit(self, num_epochs: int):
        end_epoch = self.start_epoch + num_epochs
        with self.train_logger:
            for epoch in range(self.start_epoch + 1, end_epoch + 1):
                self.current_epoch = epoch
                profiling = self._maybe_start_profile(epoch)
                train_metrics = self.train_epoch(epoch)
                self._stop_profile(profiling, epoch)
                val_metrics = self.validate()
                self._log_metrics(train_metrics, val_metrics)
                self.history.update(train_metrics, val_metrics)
                self._save_if_best(epoch, val_metrics)
                self._save_last(epoch)
            self._join_pending_save()
        self._vizualize()

    def _log_memory_once(self):
        """One line after the first trained epoch: the card's peak memory."""
        if getattr(self, "_memory_logged", False):
            return
        self._memory_logged = True
        if self.device.type == "cuda":
            logger.info("Device memory after first epoch: peak %.2f GB "
                        "(torch.cuda.max_memory_allocated)",
                        torch.cuda.max_memory_allocated(self.device) / 1e9)

    def _log_metrics(self, train_metrics, val_metrics):
        self._log_memory_once()
        self._log_input_goodput()
        self.train_logger.log_train_epoch(**train_metrics)
        self.train_logger.log_val_epoch(**val_metrics)

    def _log_input_goodput(self):
        """One line per train epoch: images a second of wall, the share of
        the epoch the host spent blocked on the loader (inside
        ``next(loader)`` in :meth:`_device_batches`), and the rate with that
        wait removed."""
        stats = self.epoch_input_stats[-1] if self.epoch_input_stats else None
        if not stats or stats["wall_s"] <= 0 or not stats["batches"]:
            return
        images = stats["batches"] * int(self.config["training"]["batch_size"])
        compute_s = max(stats["wall_s"] - stats["wait_s"], 1e-9)
        logger.info(
            "Input pipeline: goodput %.0f img/s over the epoch "
            "(input-wait %.0f%% of wall; step roofline ~%.0f img/s)",
            images / stats["wall_s"], 100.0 * stats["wait_s"] / stats["wall_s"],
            images / compute_s,
        )

    # -- checkpointing ------------------------------------------------------------
    def _save(self, name: str, epoch: int, extra: Dict[str, Any]):
        """One host snapshot per epoch (best and last share it), then the
        write on a thread."""
        os.makedirs(self.save_path, exist_ok=True)
        metadata = {
            "epoch": epoch,
            "config": to_container(self.config),
            "mode": self.mode,
            **extra,
        }
        snapshot_ms = 0.0
        if self._snapshot_epoch != epoch:
            t0 = time.perf_counter()
            self._snapshot = to_host(self.state.state_dict())
            snapshot_ms = (time.perf_counter() - t0) * 1e3
            self._snapshot_epoch = epoch
        self._join_pending_save()
        path = os.path.join(self.save_path, name)
        snapshot = self._snapshot

        def write():
            t0 = time.perf_counter()
            try:
                save_checkpoint(path, snapshot, metadata)
            except BaseException as e:  # re-raised by _join_pending_save
                self._save_error = e
                return
            self.save_times.append({"name": name, "epoch": epoch,
                                    "snapshot_ms": snapshot_ms,
                                    "write_s": time.perf_counter() - t0})

        self._save_thread = threading.Thread(target=write, daemon=True)
        self._save_thread.start()

    def _join_pending_save(self):
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            error, self._save_error = self._save_error, None
            raise RuntimeError("writing a checkpoint failed") from error

    def _save_last(self, epoch: int):
        """``last_model`` carries the best score too (the JAX package's
        writes it only into preemption checkpoints), so that a run resumed
        from it keeps its best policy."""
        best = ({self.best_key: self.best_score}
                if math.isfinite(self.best_score) else {})
        self._save("last_model", epoch, best)

    def resume_from(self, path: str):
        """Restore the train state, the epoch and the best score."""
        if not checkpoint_exists(path):
            logger.warning("Resume path %s does not exist. Starting from scratch.",
                           path)
            return
        tree, metadata = load_checkpoint(path)
        self._restore(tree, metadata)
        self.start_epoch = int(metadata.get("epoch", 0))
        self.best_score = float(metadata.get(self.best_key, -math.inf))
        logger.info("Resuming from epoch %d.", self.start_epoch + 1)

    def _restore(self, tree, metadata):
        """Load a checkpoint's tree into the train state."""
        self.state.load_state_dict(tree)

    def _vizualize(self):
        try:
            self.history.vizualize(self.num_epochs)
        except ImportError:
            logger.info("matplotlib is not installed: the metric plots were skipped")

    # -- helpers -------------------------------------------------------------------
    def _put(self, batch):
        """The batch on the trainer's device: numpy arrays and tensors (in
        dicts and lists) are copied, from pinned memory and without
        blocking the host on the card; other values pass as they are."""
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            if self.device.type == "cuda" and batch.device.type == "cpu":
                return batch.pin_memory().to(self.device, non_blocking=True)
            return batch.to(self.device)
        if isinstance(batch, dict):
            return {k: self._put(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return [self._put(v) for v in batch]
        return batch

    def _device_batches(self, loader, depth: int = 3, train_epoch=None):
        """Yield ``loader``'s batches on the device, their copies issued
        ``depth`` batches ahead of the step that takes them. With
        ``train_epoch`` (train loops only) the epoch's input-wait, wall
        time and batch count go to :attr:`epoch_input_stats`."""
        sentinel = object()
        it = iter(loader)
        wall0 = time.perf_counter()
        input_wait = 0.0
        done = 0
        pending = deque()
        while True:
            t0 = time.perf_counter()
            batch = next(it, sentinel)
            input_wait += time.perf_counter() - t0
            if batch is sentinel:
                break
            pending.append(self._put(batch))
            if len(pending) > depth:
                yield pending.popleft()
                done += 1
        while pending:
            yield pending.popleft()
            done += 1
        if train_epoch is not None:
            self.epoch_input_stats.append({
                "epoch": train_epoch,
                "wait_s": input_wait,
                "wall_s": time.perf_counter() - wall0,
                "batches": done,
            })
