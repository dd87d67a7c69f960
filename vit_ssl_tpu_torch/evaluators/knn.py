"""Cosine k-NN classifier on the device (after
``vit_ssl_tpu/evaluators/knn.py``).

Both feature sets are L2-normalised (norm floored at 1e-12); 256 val rows
at a time take their similarities to every train row (``vb @ tfᵀ``), the
``k`` most similar, and a one-hot vote over ``max(train label) + 1``
classes whose ``argmax`` (the first maximum, as ``jnp.argmax``) is the
prediction. ``k = min(num_classes, n_train)``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def knn_predict(train_f: torch.Tensor, train_y: torch.Tensor, val_f: torch.Tensor,
                num_classes_onehot: int, k: int, block: int = 256) -> torch.Tensor:
    """Predicted class of every val row, on the features' device."""
    tf = _normalize(train_f.float())
    vf = _normalize(val_f.float())
    preds = []
    for start in range(0, vf.shape[0], block):
        sims = vf[start:start + block] @ tf.T  # cosine similarity
        idx = torch.topk(sims, k, dim=1).indices
        votes = torch.nn.functional.one_hot(train_y[idx], num_classes_onehot).sum(dim=1)
        preds.append(torch.argmax(votes, dim=-1))
    return torch.cat(preds)


def run_knn_evaluation(train_features, train_labels, val_features, val_labels,
                       num_classes, device=None):
    """k-NN evaluation (k = num_classes, cosine): accuracy and predictions."""
    device = resolve_device(device)
    train_f = torch.as_tensor(np.asarray(train_features)).to(device)
    val_f = torch.as_tensor(np.asarray(val_features)).to(device)
    train_y = torch.as_tensor(np.asarray(train_labels).astype(np.int64)).to(device)
    k = min(int(num_classes), train_f.shape[0])
    onehot_classes = int(np.asarray(train_labels).max()) + 1
    preds = knn_predict(train_f, train_y, val_f, onehot_classes, k).cpu().numpy()
    accuracy = float((preds == np.asarray(val_labels)).mean())
    logger.info("Top-1 k-NN Accuracy: %.2f%%", accuracy * 100)
    return {
        "method": "knn",
        "accuracy": accuracy,
        "predictions": preds,
        "num_neighbors": k,
    }
