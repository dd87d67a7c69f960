"""Training logger (after ``vit_ssl_tpu/utils/logger.py``), in its plain line
mode: one log record and one printed line per epoch and split.

The surface is the JAX logger's (``train_log_step``, ``val_log_step``,
``log_train_epoch``, ``log_val_epoch``, ``pause``, ``resume``, the context
manager), so the trainers call it as they call that one. Its rich live
two-pane view is not ported (``ROADMAP.md`` queue A item 7):
``plain`` is accepted and every mode logs lines.
"""

from __future__ import annotations

import logging
from typing import List

logger = logging.getLogger(__name__)


class Logger:
    def __init__(self, metric_names: List[str], train_total_batches: int,
                 val_total_batches: int, num_epochs: int, plain: bool = True):
        """The JAX logger's arguments; only ``metric_names`` shapes the
        lines (every mode is the plain one)."""
        self.metric_names = list(metric_names) + ["Loss"]
        self._epoch = 0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def pause(self):
        pass

    def resume(self):
        pass

    def train_log_step(self, epoch: int, batch_idx: int):
        self._epoch = epoch

    def val_log_step(self, batch_idx: int):
        pass

    def _line(self, split: str, metrics) -> None:
        parts = ", ".join(f"{n}={metrics.get(n, 0):.4f}" for n in self.metric_names)
        logger.info("epoch %d %s: %s", self._epoch, split, parts)
        print(f"[epoch {self._epoch}] {split + ':':<6} {parts}", flush=True)

    def log_train_epoch(self, **metrics: float):
        self._line("train", metrics)

    def log_val_epoch(self, **metrics: float):
        self._line("val", metrics)
