"""Supervised and finetune trainer (after
``vit_ssl_tpu/train/trainers/supervised.py``).

Per epoch: the cross-entropy steps (``make_supervised_steps``, the train
augmentation on the device with ``data.device_augment``), the epoch loss
weighted by each step's sample weights, Accuracy/F1Score/Recall/Precision
from the epoch's predictions of its real rows (one device-to-host fetch an
epoch), and the best checkpoint keyed on val accuracy (``best_val_acc``).

Finetune (``training.type=finetune``) loads ``training.pretrained_path``
into the freshly drawn ViT through the port's weight surgery
(:func:`~...models.builder.load_weights`, with
``training.extended_transfer``) and counts what matched
(:func:`~...models.builder.check_loaded_model`). With
``training.freeze_backbone`` the optimizer freezes the encoder blocks and
the patch embedding (its CLS token excepted); at the start of epoch
``freeze_backbone_epochs`` (a top-level key) the backbone unfreezes and
the optimizer is rebuilt: the moments are dropped and the count restarts,
so the lr schedule restarts from its first step, as in the reference. A
run resumed from a checkpoint written after that epoch starts unfrozen.

An automatic evaluation that would fire (``eval.interval`` > 0 on a run
that reaches a multiple of it) is refused at construction: the evaluators
are ``ROADMAP.md`` queue A item 7.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch

from ...config import to_container
from ...models.builder import (
    all_trainable_mask,
    check_loaded_model,
    freeze_backbone_mask,
    load_pretrained,
    load_weights,
)
from ..state import SupervisedTrainState, make_optimizer
from ..steps import make_criterion, make_supervised_steps
from .base import BaseTrainer, refuse_automatic_evaluation

logger = logging.getLogger(__name__)


class SupervisedTrainer(BaseTrainer):
    best_key = "best_val_acc"

    def __init__(self, network, save_path: str, config, train_loader, val_loader,
                 device=None):
        refuse_automatic_evaluation(config, needs_mode=False)
        super().__init__(network, save_path, config, train_loader, val_loader,
                         device)
        self.freeze_backbone = bool(self.config["training"].get("freeze_backbone", False))
        self.freeze_backbone_epochs = self.config.get("freeze_backbone_epochs", math.inf)

    # -- construction -----------------------------------------------------------
    def _trainable_mask(self):
        if not bool(self.config["training"].get("freeze_backbone", False)):
            return None
        logger.info("Freezing model backbone...")
        return freeze_backbone_mask(self.network)

    def _init_state(self) -> SupervisedTrainState:
        seed = int(self.config["training"].get("random_seed", 0))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.network.reset_parameters(generator)
        self._apply_pretrained()
        return SupervisedTrainState(self.network, self.optimizer, seed)

    def _apply_pretrained(self):
        """Finetune: the pretrained checkpoint's weights into the network."""
        if self.mode != "finetune":
            return
        pretrained = load_pretrained(str(self.config["training"]["pretrained_path"]))
        extended = bool(self.config["training"].get("extended_transfer", False))
        state = load_weights(self.network.state_dict(), pretrained, extended)
        self.network.load_state_dict(state, strict=True)
        self.loaded = check_loaded_model(self.network.state_dict(), pretrained,
                                         extended)

    def _build_steps(self):
        make_criterion(self.config)  # the step computes cross-entropy only
        self.train_step, self.eval_step = make_supervised_steps(
            self.optimizer, augment_fn=self._device_augment_fn(),
            grad_accum=int(self.config["training"].get("grad_accum_steps", 1)))

    def _device_augment_fn(self):
        if not bool(self.config.get("data", {}).get("device_augment", False)):
            return None
        from ...data.device_augment import make_batch_augment_fn, supports_pipeline

        seq = to_container(self.config["transforms"]["train"])
        if not supports_pipeline(seq):
            logger.warning("device_augment requested but pipeline unsupported")
            return None
        logger.info("Device-side train augmentation enabled")
        return make_batch_augment_fn(seq)

    # -- epochs -------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        outs = []
        for idx, batch in enumerate(
                self._device_batches(self.train_loader, train_epoch=epoch)):
            outs.append(self.train_step(self.state, batch))
            self.train_logger.train_log_step(epoch, idx)
        return self._epoch_metrics(outs)

    def validate(self) -> Dict[str, float]:
        outs = []
        for idx, batch in enumerate(self._device_batches(self.val_loader)):
            outs.append(self.eval_step(self.state, batch))
            self.train_logger.val_log_step(idx)
        return self._epoch_metrics(outs)

    def _epoch_metrics(self, outs) -> Dict[str, float]:
        """One device-to-host fetch an epoch: every step's loss and weight
        sum, and the predictions, labels and weights of every row (class
        indices are exact in fp32)."""
        n = len(outs)
        host = torch.cat(
            [torch.stack([o["loss"].float() for o in outs]),
             torch.stack([o["weight_sum"].float() for o in outs])]
            + [torch.cat([o[key].float() for o in outs])
               for key in ("preds", "labels", "weight")]).cpu().numpy()
        losses, weight_sums = host[:n], host[n:2 * n]
        rows = (len(host) - 2 * n) // 3
        preds, labels, weight = (host[2 * n + i * rows: 2 * n + (i + 1) * rows]
                                 for i in range(3))
        real = weight > 0
        preds, labels = preds[real].astype(np.int64), labels[real].astype(np.int64)
        metrics = self.metric_handler.calculate_metrics(
            correct=int((preds == labels).sum()), total=int(len(labels)),
            y_pred=preds, y_true=labels)
        loss_sum = sum(loss * w for loss, w in zip(losses, weight_sums))
        metrics["Loss"] = float(loss_sum) / max(float(weight_sums.sum()), 1.0)
        return metrics

    # -- fit (the unfreeze) --------------------------------------------------------
    def fit(self, num_epochs: int):
        end_epoch = self.start_epoch + num_epochs
        with self.train_logger:
            for epoch in range(self.start_epoch + 1, end_epoch + 1):
                self.current_epoch = epoch
                if self.freeze_backbone and epoch == self.freeze_backbone_epochs:
                    self._unfreeze_backbone()
                profiling = self._maybe_start_profile(epoch)
                train_metrics = self.train_epoch(epoch)
                self._stop_profile(profiling, epoch)
                val_metrics = self.validate()
                self._log_metrics(train_metrics, val_metrics)
                self.history.update(train_metrics, val_metrics)
                self._save_if_best(epoch, val_metrics["Accuracy"])
                self._save_last(epoch)
            self._join_pending_save()
        self._vizualize()

    def _unfreeze_backbone(self):
        """Every parameter trains from here, under a new optimizer: its
        buffers start at zero and its count (the lr schedule's step) at 0,
        as the reference rebuilds its optimizer."""
        logger.info("Unfreezing backbone and rebuilding optimizer...")
        self.optimizer = make_optimizer(
            self.config, self.lr_schedule,
            self._mask_list(all_trainable_mask(self.network)))
        self.state.opt_state = self.optimizer.init(self.state.params)
        self._build_steps()

    def _restore(self, tree, metadata):
        """A checkpoint written at or after the unfreeze epoch holds the
        unfrozen optimizer's buffers: unfreeze before loading them."""
        if self.freeze_backbone and int(metadata.get("epoch", 0)) >= self.freeze_backbone_epochs:
            self._unfreeze_backbone()
        super()._restore(tree, metadata)

    def _save_if_best(self, epoch: int, val_accuracy: float):
        if val_accuracy > self.best_score:
            self.best_score = float(val_accuracy)
            logger.info("New best validation accuracy: %.4f. Saving model...",
                        self.best_score)
            self._save("best_model", epoch, {self.best_key: self.best_score})
