"""Tensor parallelism through the port's entry point:
``python -m torch.distributed.run --standalone --nproc_per_node N -m
vit_ssl_tpu_torch.train --device cpu ... parallel.tp=2`` (gloo), at the JAX
package's tiny widths (``tests/test_parallel_cli.py``), each run's
``last_model`` (whole tensors, the reference layout) held to the same
config in one process:

- supervised at tp = 2, dropout 0 (atol 5e-5, JAX's ``tp2`` bound) and
  dropout 0.1 (5e-5: the ranks draw one process's masks), and dp = 2 ×
  tp = 2 over four processes (5e-5);
- finetune at tp = 2 from a DINO ``.pth`` (extended transfer, the backbone
  frozen for epoch 1 and unfrozen for epoch 2: the optimizer rebuilt on
  the shards) (5e-5);
- DINO at tp = 2 with the device multi-crop (5e-5) and SimMIM at tp = 2
  (5e-5); DINO's automatic evaluation (rank 0 alone, on an unsharded copy
  of the teacher gathered from the shards) writes the one-process run's
  summary;
- tp = 2 × sp = 2 over four processes (5e-4, JAX's ``test_combined_tp_sp``
  bound);
- the tp = 2 run's ``last_model`` resumed by one process for an epoch ends
  where the one-process run's resumed epoch ends, and its model loads
  ``strict=True`` into an unsharded port ViT.

The supervised runs have 3 classes, so the classification head stays
replicated (the rule's fallback); the heads (4) and widths divide tp.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from make_synthetic_data import make
from test_torch_parallel_cli import DINO, REPO, SUPERVISED, _close, _state

from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.models.builder import build_model
from vit_ssl_tpu_torch.train.__main__ import main as port_main

# the JAX package's tp test widths (tests/test_parallel_cli.py)
SUP = [a for a in SUPERVISED if not a.startswith("model.mlp_dim=")] + ["model.mlp_dim=64"]
SIMMIM = ["--config-name", "simmim", "--device", "cpu", "data.img_size=16",
          "data.num_workers=0", "model.embed_dim=32", "model.num_heads=2",
          "model.num_blocks=2", "model.mlp_dim=64", "model.patch_size=4",
          "model.dropout=0.0", "model.compute_dtype=float32", "training.batch_size=8",
          "training.num_epochs=1", "training.warmup_epochs=1",
          "training.plain_logging=true", "eval.interval=0", "data.val_split=0.25"]

# (name, processes, base, extra overrides)
RUNS = [
    ("sup_tp2", 2, "sup", ["parallel.tp=2"]),
    ("sup_dp2_tp2", 4, "sup", ["parallel.tp=2"]),
    ("finetune_tp2", 2, "finetune", ["parallel.tp=2"]),
    ("sup_drop_tp2", 2, "sup", ["parallel.tp=2", "model.dropout=0.1"]),
    ("dino_tp2", 2, "dino_eval", ["parallel.tp=2"]),
    ("simmim_tp2", 2, "simmim", ["parallel.tp=2"]),
    ("sup_tp2_sp2", 4, "sup", ["parallel.tp=2", "parallel.sp=2"]),
]
ONE_PROCESS = [("sup", "sup", []), ("sup_drop", "sup", ["model.dropout=0.1"]),
               ("finetune", "finetune", []), ("dino", "dino_eval", []),
               ("simmim", "simmim", [])]


def _dino_pth(path):
    """A reference-layout DINO ``.pth`` of the port's DINO network at the
    supervised runs' width."""
    from vit_ssl_tpu_torch.models import DINONetwork
    from vit_ssl_tpu_torch.train.state import AdamW, TrainState

    net = DINONetwork(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
                      num_heads=4, mlp_dim=64, output_dim=16)
    net.reset_parameters(torch.Generator().manual_seed(4))
    state = TrainState(net, AdamW(lambda step: 0.0), seed=0)
    torch.save({"model_state_dict": state.model_state_dict(), "epoch": 1}, path)
    return path


def _args(base, data_root):
    if base == "finetune":
        return ["--config-name", "finetune"] + _args("sup", data_root)[2:] + [
            "training.num_epochs=2", "training.extended_transfer=true",
            "training.freeze_backbone=true", "+freeze_backbone_epochs=2",
            f"training.pretrained_path={data_root}/dino.pth"]
    if base == "dino_eval":
        return _args("dino", data_root) + [
            "eval.interval=1", f"eval.data_dir={data_root}/train_images",
            f"eval.data_csv={data_root}/train_labels.json"]
    if base == "sup":
        return SUP + [f"data.data_dir={data_root}/train_images",
                      f"data.data_csv={data_root}/train_labels.json"]
    if base == "simmim":
        return SIMMIM + [f"data.data_dir={data_root}/unlabeled_images"]
    return DINO + [f"data.data_dir={data_root}/unlabeled_images"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every distributed run launched at once, and the one-process runs in
    this process while they train."""
    root = tmp_path_factory.mktemp("tpcli")
    data_root = make(str(root / "synth"), n=32, size=24, num_classes=3)
    _dino_pth(f"{data_root}/dino.pth")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = {}
    for name, n, base, extra in RUNS:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", "-m", "vit_ssl_tpu_torch.train",
               *_args(base, data_root), *extra, f"hydra.run.dir={root / name}"]
        procs[name] = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for name, base, extra in ONE_PROCESS:
            port_main(_args(base, data_root) + extra + [f"hydra.run.dir={root / name}"])
    finally:
        torch.set_num_threads(threads)
        outs = {}
        for name, p in procs.items():
            try:
                outs[name] = p.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                outs[name] = p.communicate()[0] + "\n(killed at the time limit)"
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{outs[name][-6000:]}"
    return root, data_root, outs


@pytest.mark.parametrize("name,want,atol", [
    ("sup_tp2", "sup", 5e-5), ("sup_drop_tp2", "sup_drop", 5e-5),
    ("sup_dp2_tp2", "sup", 5e-5), ("finetune_tp2", "finetune", 5e-5),
    ("dino_tp2", "dino", 5e-5), ("simmim_tp2", "simmim", 5e-5),
    ("sup_tp2_sp2", "sup", 5e-4)])
def test_tp_run_matches_one_process(runs, name, want, atol):
    """The whole saved state (model or student and teacher, DINO's center,
    the optimizer's buffers) of the tp run equals one process's."""
    root, _, outs = runs
    assert "'model': 2}: " in outs[name] and "parameters sharded" in outs[name]
    if name == "finetune_tp2":
        assert "Unfreezing backbone and rebuilding optimizer" in outs[name]
    _close(_state(root / name), _state(root / want), atol)


def test_tp_sp_runs_rang_and_head_fell_back(runs):
    """tp × sp rang over the seq axis (no fallback), and the 3-class head
    stayed replicated with the rule's warning."""
    _, _, outs = runs
    assert "'seq': 2" in outs["sup_tp2_sp2"] and "does not divide sequence" \
        not in outs["sup_tp2_sp2"]
    assert "classification_head.linear.weight" in outs["sup_tp2"]


def test_tp_evaluation_matches_one_process(runs):
    """The tp run's evaluation (KNN, the linear probe, UMAP's quality) reads
    the same teacher as one process's: the same summary."""
    root, _, _ = runs
    summaries = [(root / name / "epoch_1" / "evaluation_summary.csv").read_text()
                 for name in ("dino_tp2", "dino")]
    assert summaries[0] == summaries[1]
    assert "eval_knn" in summaries[0]


def test_tp_state_resumes_at_world_size_one(runs, tmp_path):
    """The tp run's last_model, resumed by one process for an epoch, ends
    where the one-process run's resumed epoch ends."""
    root, data_root, _ = runs
    ends = {}
    for name in ("dino_tp2", "dino"):
        resumed = tmp_path / name
        shutil.copytree(root / name / "last_model", resumed / "last_model")
        port_main(_args("dino", data_root) + [
            f"training.resume_from_checkpoint={resumed / 'last_model'}"])
        ends[name] = _state(resumed)
    _close(ends["dino_tp2"], ends["dino"], 5e-5)


def test_tp_last_model_loads_strictly_unsharded(runs):
    """The tp run's model is whole, in the reference layout: it loads
    ``strict=True`` into an unsharded port ViT built from the same config."""
    root, data_root, _ = runs
    config = compose(str(REPO / "configs"), "supervised",
                     [a for a in _args("sup", data_root)
                      if "=" in a and not a.startswith("--")])
    model = build_model(config, "cpu")
    model.load_state_dict(_state(root / "sup_tp2")["model"], strict=True)
