"""The port's training logger (``vit_ssl_tpu_torch.utils.logger``) against
the JAX package's (``vit_ssl_tpu.utils.logger``), on the CPU.

- The live view: both loggers go through the same calls (train and val
  steps, the epoch tables, ``pause``/``resume`` and exit), each writing to
  a rich ``Console`` on a ``StringIO`` at a fixed width; off a terminal rich
  prints the whole layout at each stop. Their text is equal once the
  elapsed and remaining columns (the only clock readings) are masked.
- Plain mode: the same printed lines and log records as JAX's.
- Without rich (its modules blocked), the port falls back to the lines
  with one record naming rich.
"""

import io
import logging
import re
import sys

import pytest

rich_console = pytest.importorskip("rich.console")

import vit_ssl_tpu.utils.logger as jax_logger  # noqa: E402
from vit_ssl_tpu_torch.utils import logger as port_logger  # noqa: E402

WIDTH = 100
METRICS = ["Accuracy", "F1Score"]
# the elapsed and remaining columns: h:mm:ss, or rich's unknown remaining time
CLOCK = re.compile(r"-?\d+:\d\d:\d\d|-:--:--")


def _drive(log):
    """Two epochs of three train and two val steps, the tables after each,
    an evaluation's pause and resume after the first, then exit."""
    with log:
        for epoch in (1, 2):
            for i in range(3):
                log.train_log_step(epoch, i)
            for i in range(2):
                log.val_log_step(i)
            log.log_train_epoch(Accuracy=0.5 * epoch, F1Score=0.25, Loss=1.0 / epoch)
            log.log_val_epoch(Accuracy=0.4 * epoch, Loss=2.0 / epoch)
            if epoch == 1:
                log.pause()
                log.resume()


def _live_text(monkeypatch, module, console_owner):
    """The text ``module``'s live logger writes, its Console on a StringIO."""
    buf, console = io.StringIO(), rich_console.Console

    with monkeypatch.context() as m:
        m.setattr(console_owner, "Console", lambda: console(file=buf, width=WIDTH))
        log = module.Logger(METRICS, 3, 2, 2, plain=False)
    assert not log.plain
    _drive(log)
    return buf.getvalue()


def test_live_view_renders_the_jax_frames(monkeypatch):
    want = _live_text(monkeypatch, jax_logger, jax_logger)
    got = _live_text(monkeypatch, port_logger, rich_console)
    # one whole frame at the pause and one at exit, each with both panes
    assert want.count("Validation") == 2 and "Epoch 2 / 2 Train" in want
    assert "3/3" in want and "2/2" in want and "1.0000" in want
    assert CLOCK.sub("T", got) == CLOCK.sub("T", want)


def test_plain_lines_equal_jax(capsys, caplog):
    caplog.set_level(logging.INFO)
    outputs = []
    for module in (jax_logger, port_logger):
        caplog.clear()
        _drive(module.Logger(METRICS, 3, 2, 2, plain=True))
        records = [r.getMessage() for r in caplog.records
                   if r.name == module.__name__]
        outputs.append((capsys.readouterr().out, records))
    (want_out, want_records), (got_out, got_records) = outputs
    assert got_out == want_out
    assert "[epoch 2] val:   Accuracy=0.8000, F1Score=0.0000, Loss=1.0000" in got_out
    assert got_records == want_records and len(got_records) == 4


def test_without_rich_logs_lines_and_one_record(monkeypatch, capsys, caplog):
    for name in [m for m in sys.modules if m == "rich" or m.startswith("rich.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "rich", None)
    caplog.set_level(logging.INFO)
    log = port_logger.Logger(METRICS, 3, 2, 2, plain=False)
    assert log.plain
    _drive(log)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "rich" in warnings[0].getMessage()
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "[epoch 1] train: Accuracy=0.5000, F1Score=0.2500, Loss=1.0000",
        "[epoch 1] val:   Accuracy=0.4000, F1Score=0.0000, Loss=2.0000",
        "[epoch 2] train: Accuracy=1.0000, F1Score=0.2500, Loss=0.5000",
        "[epoch 2] val:   Accuracy=0.8000, F1Score=0.0000, Loss=1.0000",
    ]
