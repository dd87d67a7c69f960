"""The port's training entry point, ``python -m vit_ssl_tpu_torch.train``, run
as a user runs it, on the CPU:

- ``--config-name dino --device cpu`` on ``tests/make_synthetic_data.py``'s
  PNGs at a tiny width: the run directory with ``.hydra/config.yaml``,
  ``best_model`` and ``last_model``; a resume from ``last_model`` continues
  at epoch 3;
- without ``--device``, on a host with no card, it refuses to start;
- with ``yaml``, ``cv2``, ``PIL``, ``pandas``, ``rich``, ``matplotlib``,
  ``orbax`` and ``jax`` blocked (the card machine has none of them), the
  trainer path imports, composes ``configs/dino.yaml`` and trains two steps
  over an in-memory dataset.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from make_synthetic_data import make

REPO = Path(__file__).resolve().parent.parent
TINY = ["data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.output_dim=32", "training.batch_size=8", "training.warmup_epochs=1",
        "eval.interval=0", "data.num_workers=0"]
BLOCKED = ("yaml", "cv2", "PIL", "pandas", "rich", "matplotlib", "orbax", "jax")


def _start(args):
    """``python args...`` from the repo root, with no card visible and two
    CPU threads (the test suite runs beside other worker processes)."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=150):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _meta(run, name):
    with open(os.path.join(run, name, "metadata.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def blocked_run(tmp_path_factory):
    """The blocked-import run, started first: it runs beside the CLI runs."""
    path = tmp_path_factory.mktemp("blocked")
    proc = _start(["-c", BLOCKED_RUN, str(path)])
    yield path, proc
    proc.kill()


def test_cli_trains_and_resumes_on_the_cpu(tmp_path, blocked_run):
    data_root = make(str(tmp_path / "synth"), n=16, size=16, num_classes=3)
    run = str(tmp_path / "run")
    common = ["-m", "vit_ssl_tpu_torch.train", "--config-name", "dino",
              "--device", "cpu", f"data.data_dir={data_root}/unlabeled_images", *TINY,
              "training.plain_logging=true"]
    out = _finish(_start(common + ["training.num_epochs=2", f"hydra.run.dir={run}"]))
    assert out.returncode == 0, out.stderr[-3000:]
    for path in (".hydra/config.yaml", ".hydra/overrides.yaml",
                 "best_model/state.pt", "last_model/state.pt"):
        assert os.path.exists(os.path.join(run, path)), path
    meta = _meta(run, "last_model")
    assert meta["epoch"] == 2 and meta["mode"] == "dino"
    assert meta["config"]["model"]["embed_dim"] == 32
    assert "best_val_score" in _meta(run, "best_model")
    assert "[epoch 2] val:" in out.stdout
    assert "Input pipeline: goodput" in out.stderr

    out = _finish(_start(common + ["training.num_epochs=1",
                                   f"training.resume_from_checkpoint={run}/last_model"]))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Resuming from epoch 3." in out.stderr
    assert "[epoch 3] train:" in out.stdout
    assert _meta(run, "last_model")["epoch"] == 3


def test_cli_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    """The entry point's ``main`` (what ``python -m`` runs) with no
    ``--device`` raises before it creates the run directory."""
    import torch

    from vit_ssl_tpu_torch.train.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main(["--config-path", str(REPO / "configs"), "--config-name", "dino",
              "eval.interval=0", f"hydra.run.dir={tmp_path / 'run'}"])
    assert not (tmp_path / "run").exists()


BLOCKED_RUN = f"""
import logging, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
logging.basicConfig(level=logging.INFO)
import numpy as np
from vit_ssl_tpu_torch.config import compose, validate_train_config
from vit_ssl_tpu_torch.data.builder import make_loaders
from vit_ssl_tpu_torch.data.datasets import Dataset
from vit_ssl_tpu_torch.models.builder import build_dino_network
from vit_ssl_tpu_torch.train.__main__ import get_trainer, save_run_config

class InMemory(Dataset):
    def __init__(self, images):
        self.images = images
    def __len__(self):
        return len(self.images)
    def __getitem__(self, idx, rng=None):
        return self.images[idx]

overrides = {TINY + ["training.batch_size=4", "training.num_epochs=1"]!r}
config = compose("configs", "dino", overrides)
validate_train_config(config)
images = np.random.default_rng(0).integers(0, 256, (10, 16, 16, 3), dtype=np.uint8)
train, val = make_loaders(config, InMemory(images))
run = sys.argv[1]
save_run_config(config, overrides, run)
trainer = get_trainer("dino", build_dino_network(config, "cpu"), run, config, train,
                      val, "cpu")
trainer.fit(1)
assert trainer.state.step == 2, trainer.state.step
loaded = sorted(m for m in {BLOCKED!r} if sys.modules.get(m) is not None)
print("STEPS", trainer.state.step, "LOADED", loaded)
"""


def test_trainer_path_runs_without_the_missing_packages(blocked_run):
    """Two train steps and one val step (10 images, val_split 0.2, batch
    4) with the packages the card machine lacks blocked; the metric plots
    are skipped with one line."""
    path, proc = blocked_run
    out = _finish(proc)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STEPS 2 LOADED []" in out.stdout
    assert "the metric plots were skipped" in out.stderr
    assert (path / ".hydra" / "config.yaml").exists()
    assert _meta(str(path), "last_model")["epoch"] == 1
