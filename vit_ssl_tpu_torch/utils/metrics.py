"""Training metrics (port of the DINO, supervised and SimMIM parts of
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

SimMIM's PSNR and SSIM: the steps sum their ingredients on the device over
the masked patches (:func:`psnr_stats`: the squared error and its element
count; :func:`ssim_stats`: each patch's mean SSIM and the patch count, both
weighted by mask × sample weight); the host turns the epoch's sums into
PSNR (data range 1) and the mean SSIM. SSIM takes a Gaussian window of
11 × 11, σ 1.5, over reflect-padded patches (ignite's scheme, as the JAX
package), a smaller odd window for patches too small to reflect-pad, as a
depthwise convolution in fp32.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.context import dp_sum

DINO_METRICS = ("CenterNorm", "TeacherMean", "TeacherSTD", "TeacherVar",
                "StudentMean", "StudentSTD", "StudentVar", "CosineSim")


def _stats(x, prefix: str) -> Dict[str, torch.Tensor]:
    """Mean, unbiased STD and variance of all of x."""
    flat = x.reshape(-1)
    mean, var = flat.mean(), flat.var(correction=1)
    return {f"{prefix}Mean": mean, f"{prefix}STD": torch.sqrt(var),
            f"{prefix}Var": var}


def _weighted_stats(t, s, cos, w) -> Dict[str, torch.Tensor]:
    """The weighted means, unbiased STDs and variances of t and s (V, B, K)
    and the mean cosine (Vt, Vs, B), each real sample contributing its
    V·K elements, over the global batch: each rank's sums through two
    all-reduces over the data axis (the means first, then the squared
    deviations from them; one process sums alone)."""
    wb = w[None, :, None]
    first = dp_sum(torch.stack([(t * wb).sum(), (s * wb).sum(),
                                (cos * w[None, None, :]).sum(), w.sum()]))
    t_mean = first[0] / torch.clamp(t.shape[0] * t.shape[2] * first[3], min=2.0)
    s_mean = first[1] / torch.clamp(s.shape[0] * s.shape[2] * first[3], min=2.0)
    second = dp_sum(torch.stack([(wb * (t - t_mean) ** 2).sum(),
                                 (wb * (s - s_mean) ** 2).sum()]))
    out = {}
    for prefix, x, mean, dev in (("Teacher", t, t_mean, second[0]),
                                 ("Student", s, s_mean, second[1])):
        count = torch.clamp(x.shape[0] * x.shape[2] * first[3], min=2.0)
        var = dev / (count - 1.0)
        out.update({f"{prefix}Mean": mean, f"{prefix}STD": torch.sqrt(var),
                    f"{prefix}Var": var})
    out["CosineSim"] = first[2] / torch.clamp(
        cos.shape[0] * cos.shape[1] * first[3], min=1.0)
    return out


def dino_distribution_stats(teacher, student, center,
                            weight=None) -> Dict[str, torch.Tensor]:
    """teacher (Vt, B, K), student (Vs, B, K), center (1, K); ``weight``
    (B,) excludes padding rows (0/1 weights give the truncated batch's
    stats exactly). Returns 0-d fp32 tensors keyed by ``DINO_METRICS``.
    With a weight they are the global batch's under a data axis
    (:mod:`..parallel.context`), as one process computes them."""
    t, s = teacher.float(), student.float()
    t_norm = torch.linalg.vector_norm(t, dim=-1)  # (Vt, B)
    s_norm = torch.linalg.vector_norm(s, dim=-1)  # (Vs, B)
    dot = torch.einsum("tbk,sbk->tsb", t, s)
    cos = dot / (t_norm[:, None] * s_norm[None] + 1e-8)
    center_norm = torch.linalg.vector_norm(center.float())
    if weight is not None:
        return {"CenterNorm": center_norm,
                **_weighted_stats(t, s, cos, weight.float())}
    return {"CenterNorm": center_norm, **_stats(t, "Teacher"), **_stats(s, "Student"),
            "CosineSim": cos.mean()}


def psnr_stats(preds, targets, weight):
    """(Σ w·(p − t)², Σ w) in fp32, ``weight`` broadcast against ``preds``
    (e.g. (B, N, 1) mask × sample weight)."""
    err = (preds.float() - targets.float()) ** 2
    w = torch.broadcast_to(weight.float(), err.shape)
    return (err * w).sum(), w.sum()


def gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    """(size, size) normalised Gaussian window, fp32."""
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_per_image(preds, targets, kernel_size: int = 11, sigma: float = 1.5,
                   data_range: float = 1.0):
    """Mean SSIM of each image of (M, C, H, W): the five filtered maps
    (x, y, x², y², xy) in one depthwise convolution over reflect-padded
    inputs."""
    c, h = preds.shape[1], preds.shape[2]
    k = kernel_size
    if h < (k + 1) // 2 + 1:
        k = max(3, (2 * h - 3) | 1)
    pad = (k - 1) // 2
    x, y = preds.float(), targets.float()
    maps = torch.cat([x, y, x * x, y * y, x * y], dim=1)  # (M, 5C, H, W)
    kern = gaussian_kernel(k, sigma, maps.device).expand(5 * c, 1, k, k)
    filtered = F.conv2d(F.pad(maps, (pad, pad, pad, pad), mode="reflect"), kern,
                        groups=5 * c)
    mu_x, mu_y, e_xx, e_yy, e_xy = filtered.split(c, dim=1)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x, sigma_y, sigma_xy = e_xx - mu_x2, e_yy - mu_y2, e_xy - mu_xy
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_stats(pred_patches, target_patches, weight, patch_size: int,
               channels: int):
    """(Σ w·SSIM of each patch, Σ w) over (B, N, C·p²) patches in
    torch-unfold order, ``weight`` (B, N) mask × sample weight."""
    b, n, _ = pred_patches.shape
    shape = (b * n, channels, patch_size, patch_size)
    per_patch = ssim_per_image(pred_patches.reshape(shape),
                               target_patches.reshape(shape))
    w = weight.reshape(b * n).float()
    return (per_patch * w).sum(), w.sum()


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


def psnr(*, psnr_sse, psnr_count, **kwargs) -> float:
    """PSNR at data range 1 from the summed squared error and count."""
    mse = float(psnr_sse) / max(float(psnr_count), 1.0)
    if mse <= 0:
        return float("inf")
    return float(-10.0 * np.log10(mse))


def ssim(*, ssim_sum, ssim_count, **kwargs) -> float:
    return float(ssim_sum) / max(float(ssim_count), 1.0)


def _dino_stat(key: str):
    def compute(*, dino_stats: Dict[str, Any], **kwargs) -> float:
        return float(dino_stats[key])
    return compute


# name -> fn(**what the trainer passes) -> float, as the JAX registry maps
# names to metric classes
_REGISTRY = {name: _dino_stat(name) for name in DINO_METRICS}
_REGISTRY.update({"Accuracy": accuracy, "F1Score": f1_score, "Recall": recall,
                  "Precision": precision, "PSNR": psnr, "SSIM": ssim})


class MetricHandler:
    """Name-keyed metric dispatch over a config's ``metrics`` list: each
    DINO name reads its value from the step's ``dino_stats``; the
    supervised names take ``correct``, ``total``, ``y_pred`` and
    ``y_true``; PSNR takes ``psnr_sse`` and ``psnr_count``, SSIM
    ``ssim_sum`` and ``ssim_count``."""

    def __init__(self, config):
        self.metric_names: List[str] = []
        for name in config.get("metrics", []) or []:
            if name not in _REGISTRY:
                raise ValueError(f"Unknown metric '{name}'")
            self.metric_names.append(name)

    def calculate_metrics(self, **kwargs) -> Dict[str, float]:
        return {name: _REGISTRY[name](**kwargs) for name in self.metric_names}
