"""Trainers of the port (mirrors ``vit_ssl_tpu/train/trainers``): the fit
loop and DINO's."""

from .base import BaseTrainer
from .dino import DINOTrainer

__all__ = ["BaseTrainer", "DINOTrainer"]
