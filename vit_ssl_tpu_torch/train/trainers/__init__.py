"""Trainers of the port (mirrors ``vit_ssl_tpu/train/trainers``): the fit
loop, DINO's, SimMIM's, and the supervised and finetune trainer."""

from .base import BaseTrainer
from .dino import DINOTrainer
from .simmim import SimMIMTrainer
from .supervised import SupervisedTrainer

__all__ = ["BaseTrainer", "DINOTrainer", "SimMIMTrainer", "SupervisedTrainer"]
