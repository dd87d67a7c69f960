"""SimMIM trainer (after ``vit_ssl_tpu/train/trainers/simmim.py``).

Per epoch: the masked-reconstruction steps (``make_simmim_steps``, the
train augmentation on the device with ``data.device_augment``), PSNR and
SSIM from the epoch's summed ingredients, Loss the mean of the batch
losses (one device-to-host fetch an epoch), and the best checkpoint keyed
on ``SSIM + 0.01·PSNR`` of the val metrics (``best_val_score``). Val batch
i draws its mask from a generator seeded from (``training.random_seed`` +
1, i), as the JAX package folds ``PRNGKey(seed + 1)`` with i, so every
epoch's validation masks the same patches.

The train state is a :class:`~..state.SupervisedTrainState` over the
``SimMIMViT``: one model, its optimizer buffers, the step and the seed.

An automatic evaluation that would fire (``configs/simmim/eval.yaml`` has
``interval: 1`` with KNN, linear probe and UMAP) is refused at
construction: the evaluators are ``ROADMAP.md`` queue A item 7.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from ...config import to_container
from ..state import SupervisedTrainState, step_generators
from ..steps import make_criterion, make_simmim_steps
from .base import BaseTrainer, refuse_automatic_evaluation

logger = logging.getLogger(__name__)

_SUMS = ("psnr_sse", "psnr_count", "ssim_sum", "ssim_count")


class SimMIMTrainer(BaseTrainer):
    def __init__(self, network, save_path: str, config, train_loader, val_loader,
                 device=None):
        refuse_automatic_evaluation(config)
        super().__init__(network, save_path, config, train_loader, val_loader,
                         device)

    def _init_state(self) -> SupervisedTrainState:
        seed = int(self.config["training"].get("random_seed", 0))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.network.reset_parameters(generator)
        return SupervisedTrainState(self.network, self.optimizer, seed)

    def _build_steps(self):
        model = self.config["model"]
        self.train_step, self.eval_step = make_simmim_steps(
            self.optimizer, patch_size=int(model["patch_size"]),
            channels=int(model["in_channels"]), criterion=make_criterion(self.config),
            augment_fn=self._device_augment_fn(),
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

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        outs = []
        for idx, batch in enumerate(
                self._device_batches(self.train_loader, train_epoch=epoch)):
            outs.append(self.train_step(self.state, batch))
            self.train_logger.train_log_step(epoch, idx)
        return self._epoch_metrics(outs)

    def validate(self) -> Dict[str, float]:
        seed = int(self.config["training"].get("random_seed", 0)) + 1
        outs = []
        for idx, batch in enumerate(self._device_batches(self.val_loader)):
            (mask_generator,) = step_generators(seed, idx, 1, self.device)
            outs.append(self.eval_step(self.state, batch, mask_generator))
            self.train_logger.val_log_step(idx)
        return self._epoch_metrics(outs)

    def _epoch_metrics(self, outs) -> Dict[str, float]:
        """One device-to-host fetch an epoch: each step's loss and four
        sums."""
        host = torch.stack([torch.stack([o[k].float() for k in ("loss",) + _SUMS])
                            for o in outs]).cpu().double()
        totals = dict(zip(_SUMS, host[:, 1:].sum(dim=0).tolist()))
        metrics = self.metric_handler.calculate_metrics(**totals)
        metrics["Loss"] = float(host[:, 0].sum()) / max(len(outs), 1)
        return metrics

    def _save_if_best(self, epoch: int, val_metrics: Dict[str, float]):
        score = val_metrics["SSIM"] + 0.01 * val_metrics["PSNR"]
        if score > self.best_score:
            self.best_score = float(score)
            logger.info("New best validation score: %.4f. Saving model...",
                        self.best_score)
            self._save("best_model", epoch, {self.best_key: self.best_score})
