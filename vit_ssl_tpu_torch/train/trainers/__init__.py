"""Trainers of the port (mirrors ``vit_ssl_tpu/train/trainers``): the fit
loop, DINO's, and the supervised and finetune trainer."""

from .base import BaseTrainer
from .dino import DINOTrainer
from .supervised import SupervisedTrainer

__all__ = ["BaseTrainer", "DINOTrainer", "SupervisedTrainer"]
