"""``python -m vit_ssl_tpu_torch.train --device cpu --config-name supervised``
and ``finetune``, run as a user runs them, on ``tests/make_synthetic_data.py``'s
PNGs at a tiny width.

Each mode runs three epochs straight, and two epochs then a resume from
``last_model`` for one more: the resumed run's ``last_model`` equals the
straight run's bit for bit (a warmup longer than the run keeps the lr
schedule independent of ``training.num_epochs``). Finetune starts from a
DINO ``.pth`` of the port's DINO network, with the extended transfer, the
backbone frozen and unfrozen at epoch 2, so its resume starts after the
unfreeze. Both write ``best_model`` (with ``best_val_acc``) and
``last_model``, and print the four supervised metrics.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from make_synthetic_data import make

REPO = Path(__file__).resolve().parent.parent
TINY = ["data.img_size=16", "model.embed_dim=32", "model.num_heads=2",
        "model.num_blocks=2", "model.mlp_dim=64", "model.patch_size=8",
        "model.num_classes=3", "training.batch_size=8", "training.warmup_epochs=10",
        "eval.interval=0", "data.num_workers=0"]
FINETUNE = ["training.extended_transfer=true", "training.freeze_backbone=true",
            "+freeze_backbone_epochs=2"]


def _start(args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", "vit_ssl_tpu_torch.train",
                             "--device", "cpu", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=150):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return out, err


def _meta(run, name):
    with open(os.path.join(run, name, "metadata.json")) as f:
        return json.load(f)


def _state(run):
    return torch.load(os.path.join(run, "last_model", "state.pt"), weights_only=True)


def _equal(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _dino_pth(path):
    """A reference-layout DINO ``.pth`` of the port's DINO network."""
    from vit_ssl_tpu_torch.models import DINONetwork
    from vit_ssl_tpu_torch.train.state import AdamW, TrainState

    net = DINONetwork(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
                      num_heads=2, mlp_dim=64, output_dim=16)
    net.reset_parameters(torch.Generator().manual_seed(4))
    state = TrainState(net, AdamW(lambda step: 0.0), seed=0)
    torch.save({"model_state_dict": state.model_state_dict(), "epoch": 1}, path)
    return path


@pytest.mark.parametrize("mode", ["supervised", "finetune"])
def test_cli_trains_and_resumes_bit_exactly(tmp_path, mode):
    data = make(str(tmp_path / "synth"), n=30, size=16, num_classes=3)
    common = ["--config-name", mode, f"data.data_dir={data}/train_images",
              f"data.data_csv={data}/train_labels.json", *TINY]
    if mode == "finetune":
        common += FINETUNE + [f"training.pretrained_path={_dino_pth(tmp_path / 'dino.pth')}"]
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    procs = [_start(common + ["training.num_epochs=3", f"hydra.run.dir={straight}"]),
             _start(common + ["training.num_epochs=2", f"hydra.run.dir={split}"])]
    (out, err), _ = [_finish(p) for p in procs]
    for name in ("best_model/state.pt", "last_model/state.pt", ".hydra/config.yaml"):
        assert os.path.exists(os.path.join(straight, name)), name
    assert "best_val_acc" in _meta(straight, "best_model")
    assert _meta(straight, "last_model")["mode"] == mode
    assert "[epoch 3] val:" in out and "Accuracy=" in out
    if mode == "supervised":
        assert all(f"{m}=" in out for m in ("F1Score", "Recall", "Precision"))
    else:
        assert "Matched parameters from checkpoint: 28" in err
        assert "Unfreezing backbone and rebuilding optimizer" in err

    out, err = _finish(_start(common + ["training.num_epochs=1",
                                        f"training.resume_from_checkpoint={split}/last_model"]))
    assert "Resuming from epoch 3." in err
    assert "[epoch 3] train:" in out
    assert _meta(split, "last_model")["epoch"] == _meta(straight, "last_model")["epoch"] == 3
    _equal(_state(split), _state(straight))
