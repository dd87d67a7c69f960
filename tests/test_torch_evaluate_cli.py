"""The evaluation in training and ``python -m vit_ssl_tpu_torch.evaluate``,
run as a user runs them, on ``tests/make_synthetic_data.py``'s PNGs at a
tiny width, on the CPU.

- ``python -m vit_ssl_tpu_torch.train --config-name dino`` for two epochs
  with ``eval.interval=1`` and the config's three modes writes
  ``epoch_{1,2}/evaluation_summary.{csv,txt}`` and the UMAP reports, and
  its ``last_model`` equals, bit for bit, that of the same run with
  ``eval.interval=0``: the evaluation does not move training.
- ``python -m vit_ssl_tpu_torch.evaluate --device cpu --config-name
  eval_config eval.experiment_path=<that run>`` loads its ``best_model``
  and writes the KNN summary into the run directory, at the accuracy of
  the in-training evaluation of best_model's epoch; the KNN and
  linear-probing scripts give that epoch's accuracies too.
- ``--config-name supervised`` with its ``eval.interval: 1`` writes each
  epoch's ``predictions.csv`` (every val row) and its accuracy equals the
  logged val Accuracy.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from make_synthetic_data import make

REPO = Path(__file__).resolve().parent.parent
DINO = ["data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.output_dim=32", "training.batch_size=8", "training.num_epochs=2",
        "training.warmup_epochs=1", "data.num_workers=0"]
SUPERVISED = ["data.img_size=16", "model.embed_dim=32", "model.num_heads=2",
              "model.num_blocks=2", "model.mlp_dim=64", "model.patch_size=8",
              "model.num_classes=4", "training.batch_size=8", "training.num_epochs=2",
              "training.warmup_epochs=1", "data.num_workers=0",
              "eval.save_confusion_matrix=false"]


def _start(module, args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", module, "--device", "cpu", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=150):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return out, err


def _state(run):
    return torch.load(os.path.join(run, "last_model", "state.pt"), weights_only=True)


def _equal(got, want, where="state"):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _equal(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{where}[{i}]")
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("synth")), n=40, size=20, num_classes=4)


@pytest.fixture(scope="module")
def dino_runs(data, tmp_path_factory):
    """Two DINO CLI runs over the same data: with ``eval.interval=1`` and
    with ``eval.interval=0``; their directories and the first's stderr."""
    tmp = tmp_path_factory.mktemp("dino")
    common = DINO + [f"data.data_dir={data}/unlabeled_images", *_eval_data(data)]
    runs = {name: str(tmp / name) for name in ("eval", "plain")}
    procs = [_start("vit_ssl_tpu_torch.train",
                    ["--config-name", "dino", *common, f"eval.interval={interval}",
                     f"hydra.run.dir={runs[name]}"])
             for name, interval in (("eval", 1), ("plain", 0))]
    (_, err), _ = [_finish(p) for p in procs]
    return runs, err


def _eval_data(data):
    return [f"eval.data_dir={data}/train_images", f"eval.data_csv={data}/train_labels.json"]


def _summary(path):
    with open(os.path.join(path, "evaluation_summary.csv")) as f:
        return {r["Evaluation_Mode"]: r for r in csv.DictReader(f)}


def _best_epoch(run):
    with open(os.path.join(run, "best_model", "metadata.json")) as f:
        return json.load(f)["epoch"]


def test_dino_evaluates_each_epoch_without_moving_training(dino_runs):
    runs, err = dino_runs
    assert err.count("Running automatic evaluation (mode: ['eval_knn', 'eval_linear', "
                     "'eval_umap'])") == 2
    for epoch in (1, 2):
        written = set(os.listdir(os.path.join(runs["eval"], f"epoch_{epoch}")))
        assert {"evaluation_summary.csv", "evaluation_summary.txt",
                "umap_feature_quality_results.csv",
                "umap_feature_quality_report.txt"} <= written
        assert list(_summary(os.path.join(runs["eval"], f"epoch_{epoch}"))) == [
            "eval_knn", "eval_linear", "eval_umap"]
    assert not any(name.startswith("epoch_") for name in os.listdir(runs["plain"]))
    _equal(_state(runs["eval"]), _state(runs["plain"]))


def test_evaluate_cli_reproduces_the_best_epochs_knn(dino_runs, data):
    """``python -m vit_ssl_tpu_torch.evaluate`` on the run loads best_model
    and writes the KNN summary into the run directory: the accuracy of the
    in-training evaluation of best_model's epoch."""
    run = dino_runs[0]["eval"]
    _, err = _finish(_start("vit_ssl_tpu_torch.evaluate", [
        "--config-name", "eval_config", f"eval.experiment_path={run}", *_eval_data(data)]))
    assert f"Loaded checkpoint '{run}/best_model'" in err
    rows = _summary(run)
    assert [(m, r["Method"]) for m, r in rows.items()] == [("eval_knn", "KNN")]
    best = _summary(os.path.join(run, f"epoch_{_best_epoch(run)}"))
    assert rows["eval_knn"]["Accuracy"] == best["eval_knn"]["Accuracy"]


def test_scripts_reproduce_the_best_epochs_knn_and_probe(dino_runs, data):
    """The KNN and linear-probing scripts on the run's best_model give the
    in-training evaluation's accuracies of its epoch."""
    from vit_ssl_tpu_torch.scripts import knn_classification, linear_probing

    run = dino_runs[0]["eval"]
    args = ["--device", "cpu", f"eval.experiment_path={run}", *_eval_data(data)]
    best = _summary(os.path.join(run, f"epoch_{_best_epoch(run)}"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        knn = knn_classification.main(args)
        probe = linear_probing.main(args)
    finally:
        torch.set_num_threads(threads)
    assert f"{knn['accuracy'] * 100:.2f}%" == best["eval_knn"]["Accuracy"]
    assert f"{probe['accuracy'] * 100:.2f}%" == best["eval_linear"]["Accuracy"]


def test_supervised_writes_predictions_each_epoch(data, tmp_path):
    run = str(tmp_path / "sup")
    out, err = _finish(_start("vit_ssl_tpu_torch.train", [
        "--config-name", "supervised", *SUPERVISED, f"data.data_dir={data}/train_images",
        f"data.data_csv={data}/train_labels.json", "training.plain_logging=true",
        f"hydra.run.dir={run}"]))
    val_lines = [line for line in out.splitlines() if line.startswith("[epoch")
                 and "val:" in line]
    assert len(val_lines) == 2
    for epoch, line in zip((1, 2), val_lines):
        with open(os.path.join(run, f"epoch_{epoch}", "predictions.csv")) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 8  # every val row: 40 images at val_split 0.2
        accuracy = sum(r["label"] == r["prediction"] for r in rows) / len(rows)
        assert f"Accuracy={accuracy:.4f}" in line
