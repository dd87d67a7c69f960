"""Training of the port (mirrors ``vit_ssl_tpu/train``): the DINO step,
its train state and AdamW, and the learning-rate schedules."""

from .schedules import lr_schedule_from_config, reference_lr_schedule
from .state import AdamW, AdamWState, TrainState
from .steps import make_dino_steps, weighted_dino_loss

__all__ = [
    "AdamW",
    "AdamWState",
    "TrainState",
    "lr_schedule_from_config",
    "make_dino_steps",
    "reference_lr_schedule",
    "weighted_dino_loss",
]
