"""DINO trainer (after ``vit_ssl_tpu/train/trainers/dino.py``).

Per epoch: the teacher temperature and momentum from their cosine (or
linear) schedules at the epoch index, as the reference steps them, or with
``training.step_granular_schedules`` at each step's fractional epoch
index, computed on the host and carried with the batch; multi-view
batches (made on the device from uint8 images with
``data.device_augment``); the collapse metrics from the epoch's **last
batch only**; the best checkpoint keyed on
``CosineSim - |CenterNorm-1| - |StudentSTD-TeacherSTD|``. Validation
advances the center, as the reference's teacher forward does. The
automatic evaluation reads the teacher's backbone (its CLS features).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ...config import to_container
from ...models.dino import cosine_momentum_schedule, teacher_temp_schedule
from ...parallel.context import dp_sum
from ..state import TrainState
from ..steps import make_dino_steps
from .base import BaseTrainer

logger = logging.getLogger(__name__)


def _f32(x: float) -> float:
    return float(np.float32(x))


class DINOTrainer(BaseTrainer):
    def __init__(self, network, save_path: str, config, train_loader, val_loader,
                 device=None):
        super().__init__(network, save_path, config, train_loader, val_loader,
                         device)
        training = self.config.training
        self.m_start = float(training.teacher_momentum_start)
        self.m_end = float(training.teacher_momentum_final)
        temp_final = training.get("teacher_temp_final", None)
        if temp_final is None:
            temp_final = training.teacher_temp
        self.t_start = float(training.teacher_temp)
        self.t_end = float(temp_final)
        self.temp_kind = str(training.get("teacher_temp_scheduler", "cosine"))
        # the reference steps both schedules once per epoch; with
        # training.step_granular_schedules=true they advance every step
        # along the same curve, meeting the epoch values at each boundary
        self.step_granular = bool(training.get("step_granular_schedules", False))

    def _init_state(self) -> TrainState:
        seed = int(self.config["training"].get("random_seed", 0))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.network.reset_parameters(generator)
        return TrainState(self.network, self.optimizer, seed)

    def _eval_network(self):
        return self.state.teacher

    def _build_steps(self):
        training = self.config.training
        view_fn = None
        if bool(self.config.get("data", {}).get("device_augment", False)):
            from ...data.device_augment import make_multicrop_fn

            transforms = to_container(self.config["transforms"])
            view_fn = make_multicrop_fn(
                transforms["globals"], transforms["locals"],
                int(training.num_global_views), int(training.num_all_views))
            logger.info("Device-side multi-crop augmentation enabled")
        self.train_step, self.eval_step = make_dino_steps(
            self.optimizer,
            num_global_views=int(training.num_global_views),
            num_all_views=int(training.num_all_views),
            student_temp=float(training.student_temp),
            center_momentum=float(self.config.model.center_momentum),
            teacher_dropout=bool(training.get("teacher_dropout", True)),
            view_fn=view_fn,
            grad_accum=int(training.get("grad_accum_steps", 1)),
            pack_locals=bool(self.config.model.get("dino_pack_locals", False)),
        )

    def _teacher_temp(self, epoch: int) -> float:
        return _f32(teacher_temp_schedule(epoch, self.t_start, self.t_end,
                                          self.num_epochs, self.temp_kind))

    def _teacher_momentum(self, epoch: int) -> float:
        return _f32(cosine_momentum_schedule(epoch, self.m_start, self.m_end,
                                             self.num_epochs))

    def _schedule_point(self, epoch: int, idx: int, steps: int) -> float:
        """Fractional epoch index of step ``idx``: ``epoch`` exactly at the
        epoch's last batch."""
        steps = max(int(steps), 1)
        return (epoch - 1) + (idx + 1) / steps

    def _host_schedule_values(self, at: float):
        """The teacher temperature and momentum at fractional epoch ``at``."""
        return (_f32(teacher_temp_schedule(at, self.t_start, self.t_end,
                                           self.num_epochs, self.temp_kind)),
                _f32(cosine_momentum_schedule(at, self.m_start, self.m_end,
                                              self.num_epochs)))

    def _with_step_schedules(self, loader, epoch: int):
        """Each host batch with its step's schedule values attached."""
        steps = len(loader)
        for idx, batch in enumerate(loader):
            temp, mom = self._host_schedule_values(
                self._schedule_point(epoch, idx, steps))
            yield {**batch, "t_temp": temp, "t_momentum": mom}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        outs = []
        if self.step_granular:
            # the schedule values ride with each host batch, attached before
            # a resumed epoch's trained batches are skipped: each step reads
            # its own position's values
            batches = self._train_batches(
                self._with_step_schedules(self.train_loader, epoch), epoch)
            for idx, batch in batches:
                t_temp, t_momentum = batch.pop("t_temp"), batch.pop("t_momentum")
                outs.append(self.train_step(self.state, batch, t_temp, t_momentum))
                self.train_logger.train_log_step(epoch, idx)
            return self._epoch_metrics(outs)
        t_temp, t_momentum = self._teacher_temp(epoch), self._teacher_momentum(epoch)
        for idx, batch in self._train_batches(self.train_loader, epoch):
            outs.append(self.train_step(self.state, batch, t_temp, t_momentum))
            self.train_logger.train_log_step(epoch, idx)
        return self._epoch_metrics(outs)

    def validate(self) -> Dict[str, float]:
        t_temp = self._teacher_temp(self.current_epoch)
        outs = []
        for idx, batch in enumerate(self._device_batches(self.val_loader)):
            outs.append(self.eval_step(self.state, batch, t_temp))
            self.train_logger.val_log_step(idx)
        return self._epoch_metrics(outs)

    def _epoch_metrics(self, outs) -> Dict[str, float]:
        """One device-to-host fetch an epoch: every step's loss (summed over
        the data ranks: each holds its share) and the last step's collapse
        statistics (the global batch's already)."""
        names = list(outs[-1]["dino_stats"])
        losses = dp_sum(torch.stack([o["loss"].float() for o in outs]))
        host = torch.cat([losses, torch.stack(
            [outs[-1]["dino_stats"][k].float() for k in names])]).cpu()
        losses, stats = host[:len(outs)], host[len(outs):]
        metrics = self.metric_handler.calculate_metrics(
            dino_stats=dict(zip(names, stats.tolist())))
        metrics["Loss"] = float(losses.double().sum()) / max(len(outs), 1)
        return metrics

    def _save_if_best(self, epoch: int, val_metrics: Dict[str, float]):
        score = (
            val_metrics["CosineSim"]
            - abs(val_metrics["CenterNorm"] - 1)
            - abs(val_metrics["StudentSTD"] - val_metrics["TeacherSTD"])
        )
        if score > self.best_score:
            self.best_score = float(score)
            logger.info("New best validation score: %.4f. Saving model...",
                        self.best_score)
            self._save("best_model", epoch, {"best_val_score": self.best_score})
