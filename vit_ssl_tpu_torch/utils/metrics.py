"""Training metrics (port of the DINO part of ``vit_ssl_tpu/utils/metrics.py``).

:func:`dino_distribution_stats` computes the eight collapse-monitoring
metrics that ``configs/dino/metrics.yaml`` names, in one pass on the
device: the center's norm, the teacher's and the student's mean, unbiased
STD and variance, and the mean teacher×student cosine similarity.
"""

from __future__ import annotations

from typing import Dict

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
