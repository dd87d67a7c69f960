"""Supervised evaluation (after
``vit_ssl_tpu/evaluators/supervised_evaluator.py``): top-1 accuracy,
``predictions.csv`` and the confusion-matrix heatmap.

:func:`run_evaluation` takes the trainer's validation predictions when it
has them (the in-training hook) and otherwise runs the model over the val
loader. ``predictions.csv`` is byte-equal to the JAX package's. The
heatmap (``confusion_matrix.png``, with ``eval.save_confusion_matrix``) is
a host file: matplotlib and seaborn are imported inside the function that
draws it, and on a host without them a warning names the skipped file.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .embedding_analysis import write_csv
from .evaluator_utils import extract_features, merge_with_experiment_config

logger = logging.getLogger(__name__)


def evaluate(network: torch.nn.Module, dataloader, device=None):
    """The argmax of the logits over a loader's real rows: (accuracy,
    predictions, labels)."""
    logits, labels = extract_features(network, dataloader, device)
    preds = np.argmax(logits, axis=-1)
    accuracy = float((preds == labels).mean())
    return accuracy, preds, labels


def confusion_matrix(labels, preds) -> np.ndarray:
    """Counts by (true, predicted) over the sorted classes either holds."""
    classes = np.unique(np.concatenate([labels, preds]))
    t, p = np.searchsorted(classes, labels), np.searchsorted(classes, preds)
    cm = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def _draw_confusion_matrix(labels, preds, path) -> bool:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError:
        logger.warning("matplotlib or seaborn is not installed: skipped the figure %s",
                       path)
        return False
    plt.figure(figsize=(10, 8))
    sns.heatmap(confusion_matrix(labels, preds), annot=True, fmt="d", cmap="Blues")
    plt.xlabel("Predicted")
    plt.ylabel("True")
    plt.title("Confusion Matrix")
    plt.savefig(path)
    plt.close()
    return True


def save_results(save_confusion_matrix, accuracy, preds, labels, output_dir):
    os.makedirs(output_dir, exist_ok=True)
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    write_csv(os.path.join(output_dir, "predictions.csv"), ("label", "prediction"),
              zip(labels.tolist(), preds.tolist()))
    results = {"top1_accuracy": accuracy}
    heatmap_path = os.path.join(output_dir, "confusion_matrix.png")
    if save_confusion_matrix and _draw_confusion_matrix(labels, preds, heatmap_path):
        results["confusion_matrix_image"] = heatmap_path
    logger.info("Top-1 Accuracy: %.2f%%", accuracy * 100)
    logger.info("Results saved to %s", output_dir)
    return results


def run_evaluation(config, network: Optional[torch.nn.Module] = None,
                   save_path: Optional[str] = None, accuracy: Optional[float] = None,
                   preds=None, labels=None, loaders=None, device=None):
    """Write the supervised results of ``accuracy``, ``preds`` and
    ``labels``, or, when any is missing, of the model over the val loader
    (``loaders``' second, default the ``eval.*`` datasets')."""
    device = resolve_device(device)
    if save_path:
        os.makedirs(save_path, exist_ok=True)
    if "experiment_path" in (config.get("eval", {}) or {}):
        config = merge_with_experiment_config(config)
    if any(x is None for x in (accuracy, preds, labels)):
        if network is None:
            from .unsupervised_evaluator import load_model_state

            network = load_model_state(config, device)
        if loaders is None:
            from ..data.builder import prepare_dataloaders

            loaders = prepare_dataloaders(config, "eval_knn")
        accuracy, preds, labels = evaluate(network, loaders[1], device)
    return save_results(config["eval"].get("save_confusion_matrix", False),
                        accuracy, preds, labels,
                        config["eval"].get("experiment_path") or save_path)
