"""Training logger (after ``vit_ssl_tpu/utils/logger.py``): rich's live
two-pane view, or one log record and one printed line per epoch and split.

The live view (``plain=False``, the config's ``training.plain_logging``
false) is the JAX logger's: left, the train progress bar (description,
count/total, elapsed, remaining) over the epoch's Type/Value table; right,
the validation bar over its table; ``pause`` and ``resume`` stop and
restart the live region, so that the evaluators' and checkpoints' output
does not tear it. rich is imported in the constructor only: on a host
without it the logger falls back to the lines, with one log record naming
rich.
"""

from __future__ import annotations

import logging
from typing import List

logger = logging.getLogger(__name__)


class Logger:
    def __init__(self, metric_names: List[str], train_total_batches: int,
                 val_total_batches: int, num_epochs: int, plain: bool = False):
        self.metric_names = list(metric_names) + ["Loss"]
        self.train_total_batches = train_total_batches
        self.val_total_batches = max(val_total_batches, 1)
        self.num_epochs = num_epochs
        self.plain = plain
        self._epoch = 0
        if self.plain:
            return
        try:
            from rich.console import Console, Group
            from rich.layout import Layout
            from rich.live import Live
            from rich.progress import (BarColumn, Progress, TextColumn,
                                       TimeElapsedColumn, TimeRemainingColumn)
            from rich.table import Table
        except ImportError:
            logger.warning("rich is not installed: the training log is plain lines "
                           "instead of the live view")
            self.plain = True
            return
        self._rich_group, self._rich_table = Group, Table
        self.console = Console()

        def progress():
            return Progress(TextColumn("[bold cyan]{task.description}"), BarColumn(),
                            TextColumn("{task.completed}/{task.total}"),
                            TimeElapsedColumn(), TimeRemainingColumn(),
                            console=self.console, transient=True)

        self.train_table = self._new_table("Training")
        self.val_table = self._new_table("Validation")
        self.left_progress, self.right_progress = progress(), progress()
        self.layout = Layout()
        self.layout.split_row(Layout(name="left"), Layout(name="right"))
        self._refresh_layout()
        self.live = Live(self.layout, refresh_per_second=10, console=self.console)

    def _new_table(self, title: str):
        table = self._rich_table(expand=True, title=title, show_lines=True)
        table.add_column("Type")
        table.add_column("Value")
        return table

    def _refresh_layout(self):
        self.layout["left"].update(self._rich_group(self.left_progress, self.train_table))
        self.layout["right"].update(self._rich_group(self.right_progress, self.val_table))

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self):
        if not self.plain:
            self.live.start()
            self.train_task = self.left_progress.add_task(
                "Train", total=self.train_total_batches)
            self.val_task = self.right_progress.add_task(
                "Val", total=self.val_total_batches)
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self.plain:
            self.live.stop()

    def pause(self):
        if not self.plain:
            self.live.stop()

    def resume(self):
        if not self.plain:
            self._refresh_layout()
            self.live.start()

    # -- per step -----------------------------------------------------------

    def train_log_step(self, epoch: int, batch_idx: int):
        self._epoch = epoch
        if not self.plain:
            self.left_progress.update(
                self.train_task, description=f"Epoch {epoch} / {self.num_epochs} Train",
                completed=batch_idx + 1)

    def val_log_step(self, batch_idx: int):
        if not self.plain:
            self.right_progress.update(self.val_task, description="Val",
                                       completed=batch_idx + 1)

    # -- per epoch ----------------------------------------------------------

    def _line(self, split: str, metrics) -> None:
        parts = ", ".join(f"{n}={metrics.get(n, 0):.4f}" for n in self.metric_names)
        logger.info("epoch %d %s: %s", self._epoch, split, parts)
        print(f"[epoch {self._epoch}] {split + ':':<6} {parts}", flush=True)

    def _table(self, title: str, metrics):
        table = self._new_table(title)
        for name in self.metric_names:
            table.add_row(name, f"{metrics.get(name, 0):.4f}")
        return table

    def log_train_epoch(self, **metrics: float):
        if self.plain:
            return self._line("train", metrics)
        self.train_table = self._table("Train", metrics)
        self._refresh_layout()

    def log_val_epoch(self, **metrics: float):
        if self.plain:
            return self._line("val", metrics)
        self.val_table = self._table("Validation", metrics)
        self._refresh_layout()
