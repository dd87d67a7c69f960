"""Base trainer (after ``vit_ssl_tpu/train/trainers/base.py``): the fit loop,
the train state, checkpoints and resume.

``fit`` runs, per epoch: ``train_epoch`` → ``validate`` → log → the best
checkpoint (each trainer keys "best" its own way) → ``last_model`` → the
automatic evaluation, when ``eval.interval`` and ``eval.mode`` are set and
the epoch is a multiple of the interval (:meth:`BaseTrainer._evaluate`:
the unsupervised evaluation of ``eval.mode`` into ``epoch_{n}/``);
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
  written on a thread while the next epoch trains;
- the evaluation starts after that snapshot, reads the weights only (its
  randomness comes from generators of its own) and gives every module its
  train flag back, so a fit ends bit-equal with it or without it;
- preemption (:mod:`...utils.preempt`): the train loop polls the flag at
  each batch boundary and raises ``PreemptionRequested(epoch,
  batches_done)``, the batches already copied ahead dropped;
  ``training.fault_inject_preempt_step=N`` raises it after N train batches
  of this process. :meth:`BaseTrainer.save_preempt` writes
  ``preempt_model`` synchronously, and :meth:`BaseTrainer.resume_from` of
  it restarts inside the interrupted epoch, skipping its trained batches
  (:meth:`BaseTrainer._train_batches`).

Several processes (``torch.distributed``; ``train/__main__.py`` starts
them under ``torch.distributed.run``): the trainer publishes the mesh of
``parallel.*`` (:mod:`...parallel.context`) before it builds its steps,
starts every rank from rank 0's weights, and wraps the optimizer so that
each update takes the gradients summed over the ``data`` axis
(:class:`...parallel.data_parallel.DataParallelOptimizer`); with
``parallel.fsdp`` the state's large leaves are sharded over it
(:class:`...parallel.fsdp.ShardedState`). ``parallel.sp`` rings attention
over the ``seq`` axis inside the model. Epoch metrics are reduced over the
data ranks, so every rank reports the single-process figures. Rank 0 alone
writes checkpoints (full tensors) and runs the evaluations, over unsharded
loaders with the mesh suspended, while the others wait; a preemption is
agreed on by every rank at the same batch boundary.

Refused by name, with its ``ROADMAP.md`` queue-A item:
``parallel.{tp,pp,ep} > 1`` (item 10).
"""

from __future__ import annotations

import contextlib
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
from ...parallel import context as parallel_context
from ...parallel.data_parallel import DataParallelOptimizer
from ...parallel.fsdp import ShardedState
from ...parallel.mesh import DATA_AXIS, axis_sizes, broadcast_module, mesh_from_config, world
from ...utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from ...utils.history import TrainingHistory
from ...utils.logger import Logger
from ...utils.metrics import MetricHandler
from ...utils.preempt import PreemptionRequested, preemption_requested, request_preemption
from ..schedules import lr_schedule_from_config
from ..state import make_optimizer

logger = logging.getLogger(__name__)


def refuse_unported_training(config) -> None:
    """Raise on a training option the port does not run yet, naming its
    ``ROADMAP.md`` queue-A item: tensor, pipeline and expert parallelism.
    dp, ``parallel.sp``, ``parallel.fsdp`` and ``parallel.multihost`` run."""
    parallel = config.get("parallel", {}) or {}
    for axis in ("tp", "pp", "ep"):
        if int(parallel.get(axis, 1) or 1) > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1 is not ported yet; see ROADMAP.md queue A "
                "item 10")


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


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
        self.mesh = self._publish_mesh(config)
        self.data_group = self.mesh.groups.get(DATA_AXIS)
        self._fsdp = None
        self.network = network
        self.mode = config_mode(config)
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.save_path = save_path
        self.warmup_epochs = int(config["training"]["warmup_epochs"])
        self.num_epochs = int(config["training"]["num_epochs"])
        self.eval_interval = int(config["eval"].get("interval", 0) or 0)
        self.eval_mode = config["eval"].get("mode")
        # the evaluation's (train, val) loaders; None: the eval.* datasets,
        # loaded at each evaluation
        self.eval_loaders = None

        self.lr_schedule = lr_schedule_from_config(config, max(1, len(train_loader)))
        self.optimizer = self._make_optimizer(self._mask_list(self._trainable_mask()))

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
        # preemption: the mid-epoch resume offset (epoch, batches done), the
        # train batches this process stepped, the fault-injection trigger
        self._mid_epoch_skip = None
        self._train_batches_seen = 0
        self._fault_inject = int(
            config["training"].get("fault_inject_preempt_step", 0) or 0)

        self.state = self._init_state()
        self._distribute_state()
        self._build_steps()
        self._wrap_steps()

    # -- the parallel axes ------------------------------------------------------
    @staticmethod
    def _publish_mesh(config):
        """The mesh of ``parallel.*`` over the started processes, published
        (the one already published when it has the same axes)."""
        mesh = parallel_context.current_mesh()
        if (mesh is None or mesh.shape != axis_sizes(config, world()[1])
                or (mesh.device_mesh is not None) != _distributed()):
            mesh = mesh_from_config(config)
            parallel_context.set_parallel_context(mesh)
        return mesh

    def _make_optimizer(self, mask_list):
        """The config's optimizer, wrapped to sum gradients over the data
        axis when there is a process group."""
        optimizer = make_optimizer(self.config, self.lr_schedule, mask_list)
        if self.data_group is None:
            return optimizer
        return DataParallelOptimizer(optimizer, self.data_group, self._fsdp)

    def _state_modules(self) -> List[torch.nn.Module]:
        return [m for m in (getattr(self.state, n, None)
                            for n in ("student", "teacher", "model")) if m is not None]

    def _trained_params(self):
        return self.optimizer.select(self.state.params)

    def _distribute_state(self):
        """Every rank starts from rank 0's weights (JAX's ``replicate``);
        with ``parallel.fsdp`` the large leaves are then sharded over the
        data axis and the optimizer updates the chunks."""
        if self.data_group is None:
            return
        for module in self._state_modules():
            broadcast_module(module)
        if bool(self.config.get("parallel", {}).get("fsdp", False)):
            self._fsdp = ShardedState(self._state_modules(), self.state.opt_state,
                                      self._trained_params(), self.data_group)
            self.optimizer.sharded = self._fsdp

    def _wrap_steps(self):
        """Under fsdp the steps run on the gathered parameters."""
        if self._fsdp is not None:
            self.train_step = self._fsdp.around(self.train_step)
            self.eval_step = self._fsdp.around(self.eval_step)

    def _host_state(self, keep: bool = True):
        """The train state in host memory, full tensors (every rank takes
        part under fsdp; ranks without ``keep`` get None)."""
        if self._fsdp is not None:
            return self._fsdp.host_state_dict(self.state, self._trained_params(), keep)
        return to_host(self.state.state_dict()) if keep else None

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
                if self.eval_interval and self.eval_mode and epoch % self.eval_interval == 0:
                    self._evaluate(epoch)
            self._join_pending_save()
        self._vizualize()

    def _eval_network(self) -> torch.nn.Module:
        """The network whose features the evaluation reads."""
        return self.network

    def _evaluate(self, epoch: int):
        """The unsupervised evaluation of ``eval.mode`` into
        ``save_path/epoch_{epoch}`` (``evaluation_summary.*`` and the UMAP
        reports), over :attr:`eval_loaders`: rank 0 alone, on the full
        weights, with the mesh suspended, while the other ranks wait."""
        from ...evaluators.unsupervised_evaluator import run_evaluation

        logger.info("Running automatic evaluation (mode: %s)...", self.eval_mode)
        self.train_logger.pause()
        with self._materialized():
            if parallel_context.is_rank_zero():
                with parallel_context.suspended():
                    run_evaluation(self.config, network=self._eval_network(),
                                   save_path=os.path.join(self.save_path,
                                                          f"epoch_{epoch}"),
                                   loaders=self.eval_loaders, device=self.device)
            parallel_context.barrier()
        self.train_logger.resume()

    def _materialized(self):
        """The full parameters inside (under fsdp; a no-op otherwise)."""
        return self._fsdp.materialized() if self._fsdp is not None \
            else contextlib.nullcontext()

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
        write on a thread; rank 0 alone snapshots and writes (under fsdp
        every rank takes part in gathering the full tensors)."""
        rank_zero = parallel_context.is_rank_zero()
        if not rank_zero:
            if self._fsdp is not None and self._snapshot_epoch != epoch:
                self._host_state(keep=False)
                self._snapshot_epoch = epoch
            return
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
            self._snapshot = self._host_state()
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
        self._save("last_model", epoch, self._best_extra())

    def _best_extra(self) -> Dict[str, float]:
        """The best score, for a checkpoint's metadata, once there is one."""
        return ({self.best_key: float(self.best_score)}
                if math.isfinite(self.best_score) else {})

    def save_preempt(self, exc: PreemptionRequested) -> str:
        """The mid-epoch checkpoint ``<run>/preempt_model``, written
        synchronously after the pending epoch save: the state as the last
        completed step left it, ``epoch`` (completed epochs),
        ``preempt_epoch`` and ``preempt_batches_done`` for
        :meth:`resume_from`, the config, the mode and the best score. Its
        host snapshot and write times go to :attr:`save_times`."""
        self._join_pending_save()
        path = os.path.join(self.save_path, "preempt_model")
        rank_zero = parallel_context.is_rank_zero()
        t0 = time.perf_counter()
        tree = self._host_state(keep=rank_zero)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        if not rank_zero:
            parallel_context.barrier()  # rank 0 has written it
            return path
        os.makedirs(self.save_path, exist_ok=True)
        metadata = {
            "epoch": exc.epoch - 1,
            "preempt_epoch": exc.epoch,
            "preempt_batches_done": exc.batches_done,
            "config": to_container(self.config),
            "mode": self.mode,
            **self._best_extra(),
        }
        t0 = time.perf_counter()
        save_checkpoint(path, tree, metadata)
        self.save_times.append({"name": "preempt_model", "epoch": exc.epoch,
                                "snapshot_ms": snapshot_ms,
                                "write_s": time.perf_counter() - t0})
        parallel_context.barrier()
        return path

    def resume_from(self, path: str):
        """Restore the train state, the epoch and the best score; from a
        preemption checkpoint, restart inside the interrupted epoch."""
        if not checkpoint_exists(path):
            logger.warning("Resume path %s does not exist. Starting from scratch.",
                           path)
            return
        tree, metadata = load_checkpoint(path)
        self._restore(tree, metadata)
        self.start_epoch = int(metadata.get("epoch", 0))
        self.best_score = float(metadata.get(self.best_key, -math.inf))
        if "preempt_epoch" in metadata:
            p_epoch = int(metadata["preempt_epoch"])
            p_done = int(metadata.get("preempt_batches_done", 0))
            self._mid_epoch_skip = (p_epoch, p_done)
            logger.info("Resuming from a preemption checkpoint: restarting inside "
                        "epoch %d after %d already-trained batches.", p_epoch, p_done)
            return
        logger.info("Resuming from epoch %d.", self.start_epoch + 1)

    def _consume_mid_epoch_skip(self, epoch: int) -> int:
        """The number of already-trained batches of ``epoch`` to skip, as
        :meth:`resume_from` recorded them from a preemption checkpoint.
        One-shot; an offset recorded for another epoch is dropped."""
        if not self._mid_epoch_skip:
            return 0
        skip_epoch, k = self._mid_epoch_skip
        self._mid_epoch_skip = None
        if skip_epoch != epoch:
            logger.warning("Mid-epoch resume offset was recorded for epoch %d but "
                           "training reached epoch %d first; training the full epoch",
                           skip_epoch, epoch)
            return 0
        if k:
            logger.info("Mid-epoch resume: skipping %d already-trained batches of "
                        "epoch %d", k, epoch)
        return k

    def _restore(self, tree, metadata):
        """Load a checkpoint's tree (full tensors, of any world size) into
        the train state."""
        if self._fsdp is not None:
            self._fsdp.load_state_dict(self.state, tree, self._trained_params())
        else:
            self.state.load_state_dict(tree)

    def _vizualize(self):
        if not parallel_context.is_rank_zero():
            return
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

    def _train_batches(self, loader, epoch: int):
        """``(index, batch)`` of the train epoch ``epoch`` on the device,
        the index the batch's position in the whole epoch: a resumed epoch
        skips its already-trained batches and counts on from them."""
        skip = self._consume_mid_epoch_skip(epoch)
        return enumerate(self._device_batches(loader, train_epoch=epoch, skip=skip),
                         start=skip)

    def _preempt_now(self) -> bool:
        """The preemption flag, or the fault injection's trigger reached; with
        several processes, true on every rank when it is on any (one host
        all-reduce over the mesh's gloo group), so all stop at the same
        batch boundary."""
        now = preemption_requested()
        if not now and self._fault_inject and \
                self._train_batches_seen >= self._fault_inject:
            logger.warning("Fault injection: simulating preemption after %d train "
                           "batches (training.fault_inject_preempt_step)",
                           self._train_batches_seen)
            request_preemption()
            now = True
        group = self.mesh.host_group
        if group is not None and torch.distributed.get_world_size(group) > 1:
            flag = torch.tensor([int(now)], dtype=torch.int32)
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                         group=group)
            if int(flag) and not now:
                request_preemption()
            now = bool(int(flag))
        return now

    def _device_batches(self, loader, depth: int = 3, train_epoch=None, skip: int = 0):
        """Yield ``loader``'s batches on the device, their copies issued
        ``depth`` batches ahead of the step that takes them. With
        ``train_epoch`` (train loops only): the first ``skip`` batches are
        drawn and dropped (a resumed epoch's trained ones), a preemption
        raises :class:`PreemptionRequested` at the next batch boundary
        (the copies ahead are dropped, not counted), and the epoch's
        input-wait, wall time and batch count go to
        :attr:`epoch_input_stats`. A signal during validation is handled
        at the next train boundary."""
        sentinel = object()
        it = iter(loader)
        done = 0
        if train_epoch is not None:
            for _ in range(skip):
                next(it, None)
            done = skip
        wall0 = time.perf_counter()
        input_wait = 0.0
        pending = deque()

        def stepped():
            nonlocal done
            done += 1
            if train_epoch is not None:
                self._train_batches_seen += 1

        while True:
            t0 = time.perf_counter()
            batch = next(it, sentinel)
            input_wait += time.perf_counter() - t0
            if batch is sentinel:
                break
            if train_epoch is not None and self._preempt_now():
                raise PreemptionRequested(train_epoch, done)
            pending.append(self._put(batch))
            if len(pending) > depth:
                yield pending.popleft()
                stepped()
        while pending:
            if train_epoch is not None and self._preempt_now():
                raise PreemptionRequested(train_epoch, done)
            yield pending.popleft()
            stepped()
        if train_epoch is not None:
            self.epoch_input_stats.append({
                "epoch": train_epoch,
                "wait_s": input_wait,
                "wall_s": time.perf_counter() - wall0,
                "batches": done - skip,
            })
