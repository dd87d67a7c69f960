"""Embedding-space analysis (after
``vit_ssl_tpu/evaluators/embedding_analysis.py``): the 2D projection, the
quality metrics, the rubric and the reports, with the JAX package's metric
definitions, thresholds, grades and file names.

sklearn is not used; its functions are rebuilt here:

- :func:`silhouette_samples` / :func:`silhouette_score`: exact euclidean
  silhouettes in float64 on the evaluation's device, in row blocks (no
  n × n tensor);
- :func:`adjusted_rand_score`: from the pair confusion matrix, in exact
  integers;
- :func:`stratified_subsample`: ``train_test_split(..., test_size=cap,
  stratify=labels, random_state=42)``'s test rows, by sklearn's
  ``StratifiedShuffleSplit`` draws from ``np.random.RandomState(42)``, so
  the chosen indices are sklearn's;
- :func:`kmeans`: ``KMeans(n_clusters, n_init, max_iter)``'s algorithm
  (greedy k-means++ seeding, Lloyd iterations to sklearn's tolerance, the
  lowest inertia of ``n_init`` runs) on the device, from a
  ``torch.Generator``; its draws are not sklearn's, so its clusters are
  held to sklearn's by their agreement with the labels.

The projector is :class:`~.umap_native.NativeUMAP` (umap-learn is not
used). The figures (``umap_visualization.png``,
``comprehensive_umap_analysis.png``) and the rotating 3D view
(``umap_3d_rotation.gif``, :func:`create_3d_umap_animation`) are host
files: matplotlib (and PIL, for the GIF) is imported inside the function
that draws them, and on a host without it one warning names each skipped
file; the CSV and TXT reports are written with ``csv`` and plain writes
either way.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .umap_native import row_blocks

logger = logging.getLogger(__name__)

FIGURES = ("umap_visualization.png", "comprehensive_umap_analysis.png")
ANIMATION = "umap_3d_rotation.gif"


def projector_name() -> str:
    """The projector named in titles and reports."""
    return "UMAP (native)"


def _project(features: np.ndarray, n_components: int, umap_params: Optional[Dict],
             device=None):
    from .umap_native import NativeUMAP

    params = {"n_components": n_components, "n_neighbors": 15, "min_dist": 0.1,
              "metric": "euclidean", "random_state": 42}
    params.update(umap_params or {})
    return np.asarray(NativeUMAP(**params, device=device).fit_transform(features))


def prepare_combined_features(train_features, train_labels, val_features, val_labels):
    features = np.concatenate([np.asarray(train_features), np.asarray(val_features)])
    labels = np.concatenate([np.asarray(train_labels), np.asarray(val_labels)])
    return features, labels


# --- sklearn's functions, rebuilt --------------------------------------------

def _approximate_mode(class_counts, n_draws, rng):
    """sklearn's ``utils.extmath._approximate_mode``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_test_indices(labels, test_size: int, random_state: int = 42):
    """The test indices of sklearn's ``StratifiedShuffleSplit(n_splits=1,
    test_size=test_size, random_state=random_state)`` split of ``labels``."""
    labels = np.asarray(labels)
    n_samples = len(labels)
    if not 0 < test_size < n_samples:
        raise ValueError(f"test_size={test_size} should be positive and smaller "
                         f"than the number of samples {n_samples}")
    n_test, n_train = int(test_size), n_samples - int(test_size)
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True,
                                                 return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, "
                         f"which is too few: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be "
                         f"at least the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    test = []
    for i in range(len(classes)):
        permutation = rng.permutation(class_counts[i])
        members = class_indices[i].take(permutation, mode="clip")
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    rng.permutation(len(labels) - len(test))  # the train rows' shuffle comes first
    return rng.permutation(test)


def stratified_subsample(features, labels, cap: int):
    """At most ``cap`` points, class-stratified, as the JAX package draws
    them with sklearn's ``train_test_split``."""
    if len(features) <= cap:
        return features, labels
    test = stratified_test_indices(labels, cap)
    return np.asarray(features)[test], np.asarray(labels)[test]


def silhouette_samples(x, labels, device=None) -> np.ndarray:
    """Each point's euclidean silhouette (sklearn's definition: 0 for a
    point alone in its cluster), float64 on ``device``."""
    device = resolve_device(device)
    labels = np.asarray(labels)
    classes, codes, counts = np.unique(labels, return_inverse=True, return_counts=True)
    n = len(labels)
    if not 2 <= len(classes) <= n - 1:
        raise ValueError(f"Number of labels is {len(classes)}. Valid values are 2 "
                         "to n_samples - 1 (inclusive)")
    xt = torch.as_tensor(np.asarray(x, np.float64)).to(device)
    sq = (xt * xt).sum(dim=1)
    code_t = torch.as_tensor(codes.astype(np.int64)).to(device)
    onehot = torch.nn.functional.one_hot(code_t, len(classes)).double()
    count_t = torch.as_tensor(counts, dtype=torch.float64).to(device)
    out = []
    for start, stop in row_blocks(n, n):
        d2 = sq[start:stop, None] + sq[None, :] - 2.0 * (xt[start:stop] @ xt.T)
        d = torch.sqrt(torch.clamp(d2, min=0.0))
        rows = torch.arange(start, stop, device=device)
        d[rows - start, rows] = 0.0
        sums = d @ onehot  # (block, classes)
        own = code_t[start:stop]
        intra = sums.gather(1, own[:, None])[:, 0] / (count_t[own] - 1)
        mean_other = sums / count_t
        mean_other.scatter_(1, own[:, None], float("inf"))
        inter = mean_other.min(dim=1).values
        out.append((inter - intra) / torch.maximum(intra, inter))
    # a point alone in its cluster has intra 0/0: NaN, then 0
    return torch.nan_to_num(torch.cat(out)).cpu().numpy()


def silhouette_score(x, labels, device=None) -> float:
    return float(np.mean(silhouette_samples(x, labels, device)))


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """sklearn's adjusted Rand index from the pair confusion matrix, in
    exact integers."""
    labels_true, labels_pred = np.asarray(labels_true), np.asarray(labels_pred)
    n = len(labels_true)
    _, t = np.unique(labels_true, return_inverse=True)
    _, p = np.unique(labels_pred, return_inverse=True)
    table = np.zeros((t.max() + 1, p.max() + 1), np.int64)
    np.add.at(table, (t, p), 1)
    n_c, n_k = table.sum(axis=1), table.sum(axis=0)
    sum_squares = int((table ** 2).sum())
    tp = sum_squares - n
    fp = int((table @ n_k).sum()) - sum_squares
    fn = int((table.T @ n_c).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _sq_dists(x, sq, centers):
    return torch.clamp(sq[:, None] + (centers * centers).sum(1)[None, :]
                       - 2.0 * (x @ centers.T), min=0.0)


def _kmeans_plusplus(x, sq, n_clusters, generator):
    """sklearn's greedy k-means++: each new center the best of
    2 + ⌊ln k⌋ candidates drawn in proportion to the squared distance."""
    n = x.shape[0]
    trials = 2 + int(np.log(n_clusters))
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = [x[first[0]]]
    closest = _sq_dists(x, sq, x[first])[:, 0]
    potential = closest.sum()
    for _ in range(1, n_clusters):
        draws = torch.rand(trials, generator=generator, device=x.device,
                           dtype=torch.float64) * potential
        candidates = torch.clamp(torch.searchsorted(torch.cumsum(closest, 0), draws),
                                 max=n - 1)
        to_candidates = torch.minimum(closest[None, :],
                                      _sq_dists(x, sq, x[candidates]).T)
        potentials = to_candidates.sum(dim=1)
        best = int(torch.argmin(potentials))
        potential, closest = potentials[best], to_candidates[best]
        centers.append(x[candidates[best]])
    return torch.stack(centers)


def _lloyd(x, sq, centers, max_iter, tol):
    labels = None
    for _ in range(max_iter):
        dists = _sq_dists(x, sq, centers)
        new_labels = torch.argmin(dists, dim=1)
        if labels is not None and torch.equal(new_labels, labels):
            break  # strict convergence
        labels = new_labels
        onehot = torch.nn.functional.one_hot(labels, centers.shape[0]).double()
        counts = onehot.sum(dim=0)
        new_centers = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        empty = torch.nonzero(counts == 0)[:, 0]
        if len(empty):  # the points farthest from their centers
            far = torch.topk(dists.gather(1, labels[:, None])[:, 0], len(empty)).indices
            new_centers[empty] = x[far]
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        if shift <= tol:
            break
    dists = _sq_dists(x, sq, centers)
    labels = torch.argmin(dists, dim=1)
    return labels, float(dists.gather(1, labels[:, None]).sum())


def kmeans(x, n_clusters: int, n_init: int = 3, max_iter: int = 100,
           random_state: int = 42, device=None) -> np.ndarray:
    """Cluster labels of the best (lowest inertia) of ``n_init`` k-means
    runs, as sklearn's ``KMeans(...).fit_predict``."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64)).to(device)
    xt = xt - xt.mean(dim=0)
    sq = (xt * xt).sum(dim=1)
    tol = float(xt.var(dim=0, unbiased=False).mean()) * 1e-4
    generator = torch.Generator(device=device).manual_seed(int(random_state))
    best_labels, best_inertia = None, None
    for _ in range(n_init):
        centers = _kmeans_plusplus(xt, sq, n_clusters, generator)
        labels, inertia = _lloyd(xt, sq, centers, max_iter, tol)
        if best_inertia is None or inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels.cpu().numpy()


# --- the metrics --------------------------------------------------------------

def _class_centroid_stats(features, labels, rng_seed: int = 42):
    """Mean within-class distance to the centroid against the mean pairwise
    centroid distance (each class subsampled to ≤500 points for the intra
    term)."""
    rng = np.random.default_rng(rng_seed)
    centroids = []
    intra_per_class = []
    for label in np.unique(labels):
        members = features[labels == label]
        centroid = members.mean(axis=0)
        centroids.append(centroid)
        if len(members) < 2:
            continue
        if len(members) > 500:
            members = members[rng.choice(len(members), 500, replace=False)]
        intra_per_class.append(float(np.linalg.norm(members - centroid, axis=1).mean()))
    centroids = np.stack(centroids)
    sq = np.sum(centroids**2, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (centroids @ centroids.T)
    iu = np.triu_indices(len(centroids), k=1)
    inter = np.sqrt(np.maximum(d2[iu], 0.0))
    avg_intra = float(np.mean(intra_per_class)) if intra_per_class else 0.0
    avg_inter = float(inter.mean()) if inter.size else 0.0
    return avg_intra, avg_inter


def evaluate_feature_quality(features, labels, embedding, sample_size: int = 2000,
                             device=None) -> Dict:
    """Silhouette on the (stratified-sampled) features and on the 2D
    embedding, KMeans ARI on the sampled features, the centroid-based
    intra/inter distances and their ratio."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    logger.info("Evaluating features: %d samples, %d dimensions",
                features.shape[0], features.shape[1])
    sampled_f, sampled_y = stratified_subsample(features, labels, sample_size)
    n_classes = int(len(np.unique(labels)))
    kmeans_pred = kmeans(sampled_f, n_classes, n_init=3, max_iter=100, device=device)
    avg_intra, avg_inter = _class_centroid_stats(features, labels)
    return {
        "silhouette_features": silhouette_score(sampled_f, sampled_y, device),
        "silhouette_umap": silhouette_score(embedding, labels, device),
        "adjusted_rand_index": float(adjusted_rand_score(sampled_y, kmeans_pred)),
        "avg_intra_distance": avg_intra,
        "avg_inter_distance": avg_inter,
        "separation_ratio": avg_inter / avg_intra if avg_intra > 0 else 0.0,
        "n_samples": int(len(features)),
        "n_features": int(features.shape[1]),
        "n_classes": n_classes,
        "sampled_for_computation": len(features) > sample_size,
    }


# (metric key, aspect, [(min threshold, points)]): the JAX package's values
_RUBRIC: List[Tuple[str, str, List[Tuple[float, int]]]] = [
    ("silhouette_features", "cluster cohesion", [(0.7, 3), (0.5, 2), (0.2, 1)]),
    ("separation_ratio", "class separation", [(3.0, 3), (2.0, 2), (1.5, 1)]),
    ("adjusted_rand_index", "clustering agreement", [(0.8, 3), (0.6, 2), (0.4, 1)]),
]
_POINT_WORDS = {3: "Excellent", 2: "Good", 1: "Fair", 0: "Poor"}
_GRADES = [(7, "Excellent"), (5, "Good"), (3, "Fair"), (0, "Poor")]


def assess_quality(metrics: Dict) -> Tuple[str, list]:
    """Score each rubric aspect, sum to an overall grade."""
    total = 0
    feedback = []
    for key, aspect, levels in _RUBRIC:
        points = next((p for lo, p in levels if metrics[key] > lo), 0)
        total += points
        feedback.append(f"{_POINT_WORDS[points]} {aspect}")
    grade = next(g for lo, g in _GRADES if total >= lo)
    return grade, feedback


# --- figures (host files; matplotlib imported where they are drawn) ------------

def _panel_true_labels(plt, ax, embedding, labels, device):
    classes = np.unique(labels)
    cmap = plt.get_cmap("viridis", len(classes))
    for i, cls in enumerate(classes):
        pts = embedding[labels == cls]
        ax.scatter(pts[:, 0], pts[:, 1], color=cmap(i), s=10, alpha=0.6,
                   label=f"class {cls}")
        centroid = pts.mean(axis=0)
        ax.scatter(*centroid, color=cmap(i), marker="X", s=120,
                   edgecolors="black", linewidths=1.0)
    ax.legend(fontsize=7, ncol=2, loc="best")
    return "True classes (X = centroid)"


def _panel_kmeans(plt, ax, embedding, labels, device):
    pred = kmeans(embedding, len(np.unique(labels)), n_init=10, max_iter=300,
                  device=device)
    ax.scatter(embedding[:, 0], embedding[:, 1], c=pred, cmap="viridis", s=10,
               alpha=0.6)
    return "K-means clusters in embedding space"


def _panel_density(plt, ax, embedding, labels, device):
    h = ax.hist2d(embedding[:, 0], embedding[:, 1], bins=40, cmap="magma")
    plt.colorbar(h[3], ax=ax)
    return "Point density"


def _panel_silhouette_bars(plt, ax, embedding, labels, device):
    sil = silhouette_samples(embedding, labels, device)
    classes = np.unique(labels)
    means = [float(sil[labels == cls].mean()) for cls in classes]
    ax.bar([str(c) for c in classes], means, color="tab:blue")
    ax.axhline(float(sil.mean()), color="tab:red", linestyle="--",
               label=f"overall {sil.mean():.3f}")
    ax.set_xlabel("class")
    ax.legend(fontsize=8)
    return "Per-class silhouette (embedding)"


_PANELS: Sequence[Callable] = (_panel_true_labels, _panel_kmeans, _panel_density,
                               _panel_silhouette_bars)


def create_plots(embedding, labels, output_dir, device=None) -> None:
    """``umap_visualization.png`` and ``comprehensive_umap_analysis.png``
    (on a host without matplotlib, one warning naming both)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib is not installed: skipped the figures %s in %s",
                       ", ".join(FIGURES), output_dir)
        return
    labels = np.asarray(labels)
    name = projector_name()
    plt.figure(figsize=(10, 8))
    plt.scatter(embedding[:, 0], embedding[:, 1], c=labels, cmap="Spectral", s=5)
    plt.colorbar()
    plt.title(f"{name} projection of learned features")
    plt.xlabel(f"{name} 1")
    plt.ylabel(f"{name} 2")
    paths = [os.path.join(output_dir, f) for f in FIGURES]
    plt.savefig(paths[0], dpi=150, bbox_inches="tight")
    plt.close()

    cols = 2
    rows = (len(_PANELS) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(7 * cols, 5.5 * rows))
    for ax, panel in zip(np.ravel(axes), _PANELS):
        ax.set_title(panel(plt, ax, embedding, labels, device))
    for ax in np.ravel(axes)[len(_PANELS):]:
        ax.axis("off")
    fig.suptitle(f"Embedding-space analysis ({name} projection)", fontsize=14)
    fig.tight_layout()
    fig.savefig(paths[1], dpi=150, bbox_inches="tight")
    plt.close(fig)


# --- reports --------------------------------------------------------------------

# metric key -> (display label, reading direction)
_METRIC_INFO = {
    "silhouette_features": ("Silhouette Score (Features)", "higher is better, max 1.0"),
    "silhouette_umap": ("Silhouette Score (projection)", "higher is better, max 1.0"),
    "adjusted_rand_index": ("Adjusted Rand Index", "higher is better, max 1.0"),
    "avg_intra_distance": ("Average Intra-class Distance", "lower is better"),
    "avg_inter_distance": ("Average Inter-class Distance", "higher is better"),
    "separation_ratio": ("Separation Ratio", "inter/intra, higher is better"),
    "n_samples": ("Number of Samples", "points analyzed"),
    "n_features": ("Number of Features", "feature dimensionality"),
    "n_classes": ("Number of Classes", "unique labels"),
}


def _fmt(value) -> str:
    return f"{value:.4f}" if isinstance(value, float) else str(value)


def write_csv(path: str, header: Sequence[str], rows) -> None:
    """A CSV as ``pandas.DataFrame.to_csv(index=False)`` writes it: minimal
    quoting, ``\\n`` line ends, an absent value empty."""
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def save_results(metrics, quality, feedback, output_dir):
    """The CSV and plain-text quality reports, from ``_METRIC_INFO``."""
    records = [("Overall Quality", quality,
                "rubric grade over cohesion/separation/agreement")]
    for key, (label, direction) in _METRIC_INFO.items():
        if key in metrics:
            records.append((label, _fmt(metrics[key]), direction))
    for i, note in enumerate(feedback, start=1):
        records.append((f"Quality Indicator {i}", "✓", note))
    if metrics.get("sampled_for_computation"):
        records.append(("Computation Method", "stratified sample",
                        "silhouette/ARI computed on ≤2000 points"))
    write_csv(os.path.join(output_dir, "umap_feature_quality_results.csv"),
              ("Metric", "Value", "Interpretation"), records)

    lines = [
        "UMAP Feature Quality Analysis Report",
        "=" * 40,
        "",
        f"Projector: {projector_name()} (from-scratch implementation of "
        "arXiv:1802.03426 — vit_ssl_tpu_torch/evaluators/umap_native.py)",
        f"Overall Assessment: {quality}",
        "",
        "Detailed Metrics:",
        "-" * 20,
    ]
    for key, (label, direction) in _METRIC_INFO.items():
        if key in metrics:
            lines.append(f"{label}: {_fmt(metrics[key])}  ({direction})")
    lines += ["", "Quality Indicators:", "-" * 20]
    lines += [f"* {note}" for note in feedback]
    with open(os.path.join(output_dir, "umap_feature_quality_report.txt"), "w",
              encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def run_umap_analysis(features, labels, output_dir, umap_params: Optional[Dict] = None,
                      device=None):
    """2D projection, metrics, figures and reports: (embedding, metrics,
    quality, feedback)."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    features = np.asarray(features)
    labels = np.asarray(labels)
    logger.info("Starting projection on %d samples with %d dimensions",
                features.shape[0], features.shape[1])
    embedding = _project(features, 2, umap_params, device)
    metrics = evaluate_feature_quality(features, labels, embedding, sample_size=2000,
                                       device=device)
    quality, feedback = assess_quality(metrics)
    create_plots(embedding, labels, output_dir, device)
    save_results(metrics, quality, feedback, output_dir)
    logger.info("Analysis complete! Quality: %s", quality)
    return embedding, metrics, quality, feedback


def create_3d_umap_animation(features, labels, output_dir, umap_params=None,
                             step_degrees: int = 4, device=None):
    """The 3D projection of ``features`` (returned), and where matplotlib
    and PIL are installed a rotating scatter of it, ``umap_3d_rotation.gif``
    in ``output_dir``: 360 / ``step_degrees`` frames at elevation 20, 10
    frames a second (matplotlib's ``FuncAnimation`` and ``PillowWriter``)."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    embedding = _project(np.asarray(features), 3, umap_params, device)
    gif_path = os.path.join(output_dir, ANIMATION)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import PIL  # noqa: F401  (PillowWriter's)
        from matplotlib import animation
    except ImportError:
        logger.warning("matplotlib or PIL is not installed: skipped the animation %s",
                       gif_path)
        return embedding
    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(embedding[:, 0], embedding[:, 1], embedding[:, 2],
               c=np.asarray(labels), cmap="Spectral", s=5, alpha=0.7)
    name = projector_name()
    ax.set_xlabel(f"{name} 1")
    ax.set_ylabel(f"{name} 2")
    ax.set_zlabel(f"{name} 3")

    def spin(frame_idx):
        angle = frame_idx * step_degrees
        ax.view_init(elev=20, azim=angle)
        ax.set_title(f"3D {name} embedding — azimuth {angle}°")
        return ()

    anim = animation.FuncAnimation(fig, spin, frames=360 // step_degrees, interval=100,
                                   blit=False)
    anim.save(gif_path, writer=animation.PillowWriter(fps=10))
    plt.close(fig)
    logger.info("3D animation saved to: %s", gif_path)
    return embedding
