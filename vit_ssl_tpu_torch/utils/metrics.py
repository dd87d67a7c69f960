"""Training metrics (port of the DINO and supervised parts of
``vit_ssl_tpu/utils/metrics.py``).

:func:`dino_distribution_stats` computes the eight collapse-monitoring
metrics that ``configs/dino/metrics.yaml`` names, in one pass on the
device: the center's norm, the teacher's and the student's mean, unbiased
STD and variance, and the mean teacher×student cosine similarity.
Accuracy, F1Score, Recall and Precision (``configs/supervised/metrics.yaml``)
are computed on the host from an epoch's predictions and labels: the
macro means over classes 0 … max(label) of the per-class scores, a class
with no predictions or no labels scoring 0. :class:`MetricHandler` turns
the ones a config's ``metrics`` list names into host floats, as the JAX
package's name-keyed registry does.

SimMIM's PSNR and SSIM are not ported yet (``ROADMAP.md`` queue A item 6).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

DINO_METRICS = ("CenterNorm", "TeacherMean", "TeacherSTD", "TeacherVar",
                "StudentMean", "StudentSTD", "StudentVar", "CosineSim")


def _stats(x, prefix: str, w=None) -> Dict[str, torch.Tensor]:
    """Mean, unbiased STD and variance of x (V, B, K); with per-sample
    weights w (B,), each real sample contributes its V·K elements."""
    if w is None:
        flat = x.reshape(-1)
        mean, var = flat.mean(), flat.var(correction=1)
    else:
        wb = w[None, :, None]
        count = torch.clamp(x.shape[0] * x.shape[2] * w.sum(), min=2.0)
        mean = (x * wb).sum() / count
        var = (wb * (x - mean) ** 2).sum() / (count - 1.0)
    return {f"{prefix}Mean": mean, f"{prefix}STD": torch.sqrt(var),
            f"{prefix}Var": var}


def dino_distribution_stats(teacher, student, center,
                            weight=None) -> Dict[str, torch.Tensor]:
    """teacher (Vt, B, K), student (Vs, B, K), center (1, K); ``weight``
    (B,) excludes padding rows (0/1 weights give the truncated batch's
    stats exactly). Returns 0-d fp32 tensors keyed by ``DINO_METRICS``."""
    t, s = teacher.float(), student.float()
    w = None if weight is None else weight.float()
    t_norm = torch.linalg.vector_norm(t, dim=-1)  # (Vt, B)
    s_norm = torch.linalg.vector_norm(s, dim=-1)  # (Vs, B)
    dot = torch.einsum("tbk,sbk->tsb", t, s)
    cos = dot / (t_norm[:, None] * s_norm[None] + 1e-8)
    if w is None:
        cos_mean = cos.mean()
    else:
        cos_mean = (cos * w[None, None, :]).sum() / torch.clamp(
            cos.shape[0] * cos.shape[1] * w.sum(), min=1.0)
    return {
        "CenterNorm": torch.linalg.vector_norm(center.float()),
        **_stats(t, "Teacher", w),
        **_stats(s, "Student", w),
        "CosineSim": cos_mean,
    }


def _per_class_counts(y_pred: np.ndarray, y_true: np.ndarray):
    """(tp, fp, fn) of each class 0 … max(y_true)."""
    for cls in range(int(y_true.max()) + 1):
        tp = int(((y_pred == cls) & (y_true == cls)).sum())
        fp = int(((y_pred == cls) & (y_true != cls)).sum())
        fn = int(((y_pred != cls) & (y_true == cls)).sum())
        yield tp, fp, fn


def _ratio(a: int, b: int) -> float:
    return a / b if b > 0 else 0.0


def _macro(scores: List[float]) -> float:
    return sum(scores) / len(scores) if scores else 0.0


def accuracy(*, correct, total, **kwargs) -> float:
    return float(correct) / float(total)


def f1_score(*, y_pred, y_true, **kwargs) -> float:
    f1s = []
    for tp, fp, fn in _per_class_counts(np.asarray(y_pred), np.asarray(y_true)):
        p, r = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
        f1s.append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)
    return _macro(f1s)


def recall(*, y_pred, y_true, **kwargs) -> float:
    return _macro([_ratio(tp, tp + fn) for tp, _, fn in
                   _per_class_counts(np.asarray(y_pred), np.asarray(y_true))])


def precision(*, y_pred, y_true, **kwargs) -> float:
    return _macro([_ratio(tp, tp + fp) for tp, fp, _ in
                   _per_class_counts(np.asarray(y_pred), np.asarray(y_true))])


def _dino_stat(key: str):
    def compute(*, dino_stats: Dict[str, Any], **kwargs) -> float:
        return float(dino_stats[key])
    return compute


# name -> fn(**what the trainer passes) -> float, as the JAX registry maps
# names to metric classes
_REGISTRY = {name: _dino_stat(name) for name in DINO_METRICS}
_REGISTRY.update({"Accuracy": accuracy, "F1Score": f1_score, "Recall": recall,
                  "Precision": precision})
# SimMIM's metrics, with the queue-A item that ports them
_NOT_PORTED = {"PSNR": 6, "SSIM": 6}


class MetricHandler:
    """Name-keyed metric dispatch over a config's ``metrics`` list: each
    DINO name reads its value from the step's ``dino_stats``; the
    supervised names take ``correct``, ``total``, ``y_pred`` and
    ``y_true``."""

    def __init__(self, config):
        self.metric_names: List[str] = []
        for name in config.get("metrics", []) or []:
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"metric '{name}' is not ported yet; see ROADMAP.md queue A "
                    f"item {_NOT_PORTED[name]}")
            if name not in _REGISTRY:
                raise ValueError(f"Unknown metric '{name}'")
            self.metric_names.append(name)

    def calculate_metrics(self, **kwargs) -> Dict[str, float]:
        return {name: _REGISTRY[name](**kwargs) for name in self.metric_names}
