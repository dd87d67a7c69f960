"""Preemption-safe training (port of ``vit_ssl_tpu/utils/preempt.py``):
signal-triggered mid-epoch checkpoints.

- :func:`install_preemption_handler` hooks SIGTERM and SIGUSR1, the
  signals cluster managers send as a preemption warning. The handler only
  sets a flag: no work runs in signal context.
- ``BaseTrainer`` polls the flag at train-batch boundaries and raises
  :class:`PreemptionRequested` carrying ``(epoch, batches_done)``.
- ``python -m vit_ssl_tpu_torch.train`` catches it, writes
  ``<run>/preempt_model`` with the mid-epoch train state (parameters,
  optimizer moments, teacher, center, step count) and exits with
  :data:`PREEMPT_EXIT_CODE` (75, ``EX_TEMPFAIL``) so that a scheduler
  retries.
- ``training.resume_from_checkpoint=<run>/preempt_model``, or
  ``training.auto_resume=true`` with the same run directory, resumes bit
  for bit: the loader's order is a function of ``(seed, epoch)``, each
  step's generators of ``(seed, step)``, and the trainer skips the
  ``batches_done`` batches of the interrupted epoch that were already
  trained. The interrupted epoch's logged train metrics cover only its
  remainder.

``training.fault_inject_preempt_step=N`` simulates a preemption after N
train batches of a process, to test the save and resume path without a
real signal.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)

_PREEMPT_EVENT = threading.Event()
_INSTALLED: list = []  # [(signum, previous handler)] for uninstall

PREEMPT_EXIT_CODE = 75  # EX_TEMPFAIL: a transient failure, retry the job
PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class PreemptionRequested(Exception):
    """Raised at a train-batch boundary after a preemption signal.

    ``epoch`` is the interrupted (1-based) epoch; ``batches_done`` the
    number of that epoch's optimizer steps already applied to the state."""

    def __init__(self, epoch: int, batches_done: int):
        super().__init__(f"preemption requested at epoch {epoch} "
                         f"after {batches_done} batches")
        self.epoch = int(epoch)
        self.batches_done = int(batches_done)


def _handler(signum, frame):
    logger.warning("Received signal %d: will checkpoint at the next batch "
                   "boundary and exit %d", signum, PREEMPT_EXIT_CODE)
    _PREEMPT_EVENT.set()


def install_preemption_handler() -> None:
    """Idempotent; installs only from the main thread (the signal API's
    rule), and warns elsewhere."""
    if _INSTALLED:
        return
    for signum in PREEMPT_SIGNALS:
        try:
            previous = signal.signal(signum, _handler)
        except ValueError:  # not the main thread
            logger.warning("Cannot install signal handlers off the main thread")
            return
        _INSTALLED.append((signum, previous))


def uninstall_preemption_handler() -> None:
    """Restore the previous handlers and clear the flag."""
    while _INSTALLED:
        signum, previous = _INSTALLED.pop()
        try:
            signal.signal(signum, previous)
        except (ValueError, TypeError):
            pass
    _PREEMPT_EVENT.clear()


def request_preemption() -> None:
    """Set the flag from code (fault injection, tests)."""
    _PREEMPT_EVENT.set()


def clear_preemption() -> None:
    _PREEMPT_EVENT.clear()


def preemption_requested() -> bool:
    return _PREEMPT_EVENT.is_set()
