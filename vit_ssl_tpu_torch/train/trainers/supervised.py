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
run resumed from a checkpoint written after the unfreeze (a preemption
checkpoint inside that epoch included) starts unfrozen.

Every ``eval.interval`` epochs (when set) the supervised evaluation
writes the epoch's validation predictions (``predictions.csv``, and the
confusion matrix with ``eval.save_confusion_matrix``) into
``epoch_{n}/``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Tuple

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
from ...parallel import context as parallel_context
from ..state import SupervisedTrainState
from ..steps import make_criterion, make_supervised_steps
from .base import BaseTrainer

logger = logging.getLogger(__name__)


class SupervisedTrainer(BaseTrainer):
    best_key = "best_val_acc"

    def __init__(self, network, save_path: str, config, train_loader, val_loader,
                 device=None):
        super().__init__(network, save_path, config, train_loader, val_loader,
                         device)
        self.freeze_backbone = bool(self.config["training"].get("freeze_backbone", False))
        self.freeze_backbone_epochs = self.config.get("freeze_backbone_epochs", math.inf)
        self._unfrozen = False

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
        for idx, batch in self._train_batches(self.train_loader, epoch):
            outs.append(self.train_step(self.state, batch))
            self.train_logger.train_log_step(epoch, idx)
        return self._epoch_metrics(outs)

    def validate(self) -> Tuple[Dict[str, float], np.ndarray, np.ndarray]:
        """The val metrics, and the predictions and labels of the real rows."""
        outs = []
        for idx, batch in enumerate(self._device_batches(self.val_loader)):
            outs.append(self.eval_step(self.state, batch))
            self.train_logger.val_log_step(idx)
        return self._epoch_metrics(outs, return_preds=True)

    def _epoch_metrics(self, outs, return_preds: bool = False):
        """One device-to-host fetch an epoch: every step's loss and weight
        sum, and the predictions, labels and weights of every row (class
        indices are exact in fp32); with ``return_preds`` also the real
        rows' predictions and labels. The losses and weight sums are summed
        over the data ranks, the rows gathered in the global batches'
        order."""
        n = len(outs)
        sums = parallel_context.dp_sum(torch.stack(
            [torch.stack([o["loss"].float() for o in outs]),
             torch.stack([o["weight_sum"].float() for o in outs])]))
        rows = parallel_context.dp_gather_rows(torch.stack(
            [torch.cat([o[key].float() for o in outs])
             for key in ("preds", "labels", "weight")]), n)
        sums, rows = sums.cpu().numpy(), rows.cpu().numpy()
        losses, weight_sums = sums[0], sums[1]
        preds, labels, weight = rows[0], rows[1], rows[2]
        real = weight > 0
        preds, labels = preds[real].astype(np.int64), labels[real].astype(np.int64)
        metrics = self.metric_handler.calculate_metrics(
            correct=int((preds == labels).sum()), total=int(len(labels)),
            y_pred=preds, y_true=labels)
        loss_sum = sum(loss * w for loss, w in zip(losses, weight_sums))
        metrics["Loss"] = float(loss_sum) / max(float(weight_sums.sum()), 1.0)
        if return_preds:
            return metrics, preds, labels
        return metrics

    # -- fit (the unfreeze) --------------------------------------------------------
    def fit(self, num_epochs: int):
        end_epoch = self.start_epoch + num_epochs
        with self.train_logger:
            for epoch in range(self.start_epoch + 1, end_epoch + 1):
                self.current_epoch = epoch
                if (self.freeze_backbone and epoch == self.freeze_backbone_epochs
                        and not self._unfrozen):
                    self._unfreeze_backbone()
                profiling = self._maybe_start_profile(epoch)
                train_metrics = self.train_epoch(epoch)
                self._stop_profile(profiling, epoch)
                val_metrics, preds, labels = self.validate()
                self._log_metrics(train_metrics, val_metrics)
                self.history.update(train_metrics, val_metrics)
                self._save_if_best(epoch, val_metrics["Accuracy"])
                self._save_last(epoch)
                if self.eval_interval and epoch % self.eval_interval == 0:
                    self._evaluate_predictions(epoch, val_metrics["Accuracy"], preds,
                                               labels)
            self._join_pending_save()
        self._vizualize()

    def _evaluate_predictions(self, epoch: int, accuracy: float, preds, labels):
        """The supervised evaluation of the epoch's validation predictions
        into ``save_path/epoch_{epoch}``."""
        from ...evaluators.supervised_evaluator import run_evaluation

        logger.info("Running automatic evaluation...")
        self.train_logger.pause()
        if parallel_context.is_rank_zero():
            run_evaluation(self.config,
                           save_path=os.path.join(self.save_path, f"epoch_{epoch}"),
                           accuracy=accuracy, preds=preds, labels=labels,
                           device=self.device)
        self.train_logger.resume()

    def _unfreeze_backbone(self):
        """Every parameter trains from here, under a new optimizer: its
        buffers start at zero and its count (the lr schedule's step) at 0,
        as the reference rebuilds its optimizer."""
        logger.info("Unfreezing backbone and rebuilding optimizer...")
        self._unfrozen = True
        self.optimizer = self._make_optimizer(
            self._mask_list(all_trainable_mask(self.network)))
        self.state.opt_state = self.optimizer.init(self.state.params)
        self._build_steps()
        self._wrap_steps()

    def _restore(self, tree, metadata):
        """A checkpoint written after the unfreeze (at the end of that epoch
        or later, or inside it by a preemption) holds the unfrozen
        optimizer's buffers: unfreeze before loading them, and not again."""
        reached = (int(metadata["preempt_epoch"]) if "preempt_epoch" in metadata
                   else int(metadata.get("epoch", 0)))
        if self.freeze_backbone and reached >= self.freeze_backbone_epochs:
            self._unfreeze_backbone()
        super()._restore(tree, metadata)

    def _save_if_best(self, epoch: int, val_accuracy: float):
        if val_accuracy > self.best_score:
            self.best_score = float(val_accuracy)
            logger.info("New best validation accuracy: %.4f. Saving model...",
                        self.best_score)
            self._save("best_model", epoch, {self.best_key: self.best_score})
