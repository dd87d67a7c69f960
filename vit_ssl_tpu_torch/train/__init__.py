"""Training of the port (mirrors ``vit_ssl_tpu/train``): the supervised and
DINO steps, their train states and AdamW, the learning-rate schedules, and
the DINO trainer (:mod:`.trainers`); ``python -m vit_ssl_tpu_torch.train``
is the entry point (:mod:`.__main__`)."""

from .schedules import lr_schedule_from_config, reference_lr_schedule
from .state import (
    AdamW,
    AdamWState,
    SupervisedTrainState,
    TrainState,
    make_optimizer,
)
from .steps import (
    cross_entropy_loss,
    make_dino_steps,
    make_supervised_steps,
    weighted_dino_loss,
)

__all__ = [
    "AdamW",
    "AdamWState",
    "SupervisedTrainState",
    "TrainState",
    "cross_entropy_loss",
    "lr_schedule_from_config",
    "make_dino_steps",
    "make_optimizer",
    "make_supervised_steps",
    "reference_lr_schedule",
    "weighted_dino_loss",
]
