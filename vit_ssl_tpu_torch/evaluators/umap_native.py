"""Native UMAP (after ``vit_ssl_tpu/evaluators/umap_native.py``): the
paper's algorithm (McInnes, Healy & Melville, arXiv:1802.03426), the
neighbour graph and the layout on the evaluation's device.

1. exact kNN graph on the device, self excluded, sorted ascending, in row
   blocks (no n × n tensor);
2. per-point smooth-kNN calibration (``rho``, ``sigma`` by the paper's
   binary search), numpy;
3. the fuzzy simplicial set ``W + Wᵀ - W ∘ Wᵀ`` (``scipy.sparse``), both
   directed copies of every edge kept;
4. ``a, b`` of ``1 / (1 + a d^(2b))`` fitted to ``min_dist``/``spread``
   (``scipy.optimize.curve_fit``);
5. a PCA initialisation (numpy SVD, sklearn's ``svd_flip`` sign rule,
   scaled to ±10), then batch-synchronous SGD on the device: each epoch an
   edge takes part with probability ``w / w_max``, attraction along the
   active edges, ``negative_sample_rate`` repulsions from each active
   edge's head, gradients clipped to ±4, the learning rate decaying
   linearly.

Steps 1–4 and the PCA are deterministic and match the JAX package's. The
layout draws from a ``torch.Generator`` seeded with ``random_state`` (not
``jax.random``'s stream), and the card's scatter-adds sum in no fixed
order, so a layout is held to the JAX package's by its statistics.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)

# rows of a distance block: block × n float64 entries stay under 256 MB
_BLOCK_ELEMENTS = 1 << 25


def row_blocks(n: int, cols: int):
    """Row ranges of an (n, cols) computation of at most ``_BLOCK_ELEMENTS``."""
    step = max(1, _BLOCK_ELEMENTS // max(cols, 1))
    return [(start, min(start + step, n)) for start in range(0, n, step)]


def _knn(x: np.ndarray, k: int, metric: str, device=None):
    """Exact kNN (indices, distances) in float64, self excluded, each row
    sorted ascending."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64)).to(device)
    n = xt.shape[0]
    if metric == "cosine":
        xt = xt / torch.clamp(torch.linalg.vector_norm(xt, dim=1, keepdim=True),
                              min=1e-12)
    else:
        sq = (xt * xt).sum(dim=1)
    idx_blocks, dist_blocks = [], []
    for start, stop in row_blocks(n, n):
        if metric == "cosine":
            d = torch.clamp(1.0 - xt[start:stop] @ xt.T, min=0.0)
        else:  # euclidean
            d2 = sq[start:stop, None] + sq[None, :] - 2.0 * (xt[start:stop] @ xt.T)
            d = torch.sqrt(torch.clamp(d2, min=0.0))
        rows = torch.arange(start, stop, device=device)
        d[rows - start, rows] = float("inf")
        dist, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        idx_blocks.append(idx)
        dist_blocks.append(dist)
    return torch.cat(idx_blocks).cpu().numpy(), torch.cat(dist_blocks).cpu().numpy()


def _smooth_knn_calibration(knn_dists: np.ndarray, k: int,
                            n_iter: int = 64, bandwidth: float = 1.0):
    """Per-point (rho, sigma): Algorithm 3's binary search, vectorised."""
    rho = knn_dists[:, 0].copy()
    target = np.log2(k) * bandwidth
    lo = np.zeros(len(knn_dists))
    hi = np.full(len(knn_dists), np.inf)
    sigma = np.ones(len(knn_dists))
    d = np.maximum(knn_dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-d / sigma[:, None]).sum(axis=1)
        too_big = psum > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(
            too_big, (lo + sigma) / 2.0,
            np.where(np.isinf(hi), sigma * 2.0, (sigma + hi) / 2.0),
        )
    # floored at a fraction of the mean distance, as umap-learn does
    mean_d = np.mean(knn_dists)
    sigma = np.maximum(sigma, 1e-3 * mean_d)
    return rho, sigma


def _fuzzy_simplicial_set(knn_idx: np.ndarray, knn_dists: np.ndarray,
                          rho: np.ndarray, sigma: np.ndarray):
    """Symmetrised membership matrix as COO arrays (heads, tails, weights),
    both directed copies of every edge."""
    from scipy.sparse import coo_matrix

    n, k = knn_idx.shape
    w = np.exp(-np.maximum(knn_dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), k)
    cols = knn_idx.ravel()
    vals = w.ravel()
    m = coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    mt = m.T.tocsr()
    sym = (m + mt - m.multiply(mt)).tocoo()  # probabilistic t-conorm
    return sym.row, sym.col, np.asarray(sym.data)


def _fit_ab(min_dist: float, spread: float):
    """Least-squares fit of 1/(1+a d^(2b)) to the min_dist/spread curve."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv <= min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def _pca_init(x: np.ndarray, n_components: int):
    """The first ``n_components`` principal components of ``x`` (numpy SVD of
    the centred data; each component's sign makes its largest loading
    positive, sklearn's ``svd_flip`` on Vt), scaled to the ±10 box."""
    centred = x - x.mean(axis=0)
    u, s, vt = np.linalg.svd(centred, full_matrices=False)
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    u = u * signs
    emb = u[:, :n_components] * s[:n_components]
    emb = 10.0 * emb / max(np.abs(emb).max(), 1e-12)
    return emb.astype(np.float32)


def _optimize_layout(embedding: np.ndarray, heads: np.ndarray,
                     tails: np.ndarray, weights: np.ndarray,
                     n_epochs: int, a: float, b: float,
                     learning_rate: float, negative_sample_rate: int,
                     random_state: int, device=None) -> np.ndarray:
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(random_state))
    n = embedding.shape[0]
    heads_t = torch.as_tensor(np.asarray(heads, np.int64)).to(device)
    tails_t = torch.as_tensor(np.asarray(tails, np.int64)).to(device)
    prob = torch.as_tensor(weights / weights.max(), dtype=torch.float32).to(device)
    e = len(heads)
    nsr = int(negative_sample_rate)
    emb = torch.as_tensor(embedding, dtype=torch.float32).to(device).clone()
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        active = (torch.rand(e, generator=generator, device=device) < prob).float()

        diff = emb[heads_t] - emb[tails_t]
        d2 = (diff * diff).sum(dim=1, keepdim=True)
        attr = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0)
        attr = torch.where(d2 > 0.0, attr, torch.zeros_like(attr))
        g = torch.clamp(attr * diff, -4.0, 4.0) * active[:, None] * alpha
        emb.index_add_(0, heads_t, g)
        emb.index_add_(0, tails_t, -g)

        # negative sampling: repulse each active edge's head from random
        # points; a sample equal to the head itself is masked out, so the
        # 4.0 kick of coincident points only reaches distinct points
        negs = torch.randint(0, n, (e, nsr), generator=generator, device=device)
        diff_n = emb[heads_t][:, None, :] - emb[negs]
        d2n = (diff_n * diff_n).sum(dim=-1, keepdim=True)
        rep = (2.0 * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0))
        gn = torch.where(d2n > 0.0, torch.clamp(rep * diff_n, -4.0, 4.0),
                         torch.full_like(diff_n, 4.0))
        not_self = (negs != heads_t[:, None])[..., None].float()
        gn = gn * not_self * active[:, None, None] * alpha
        emb.index_add_(0, heads_t, gn.sum(dim=1))
    return emb.cpu().numpy()


class NativeUMAP:
    """The ``umap.UMAP`` interface's ``fit_transform``, with the JAX
    package's defaults."""

    def __init__(self, n_components: int = 2, n_neighbors: int = 15,
                 min_dist: float = 0.1, spread: float = 1.0,
                 metric: str = "euclidean", n_epochs: Optional[int] = None,
                 learning_rate: float = 1.0, negative_sample_rate: int = 5,
                 random_state: int = 42, device=None):
        self.n_components = int(n_components)
        self.n_neighbors = int(n_neighbors)
        self.min_dist = float(min_dist)
        self.spread = float(spread)
        self.metric = str(metric)
        self.n_epochs = n_epochs
        self.learning_rate = float(learning_rate)
        self.negative_sample_rate = int(negative_sample_rate)
        self.random_state = int(random_state)
        self.device = resolve_device(device)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if n <= self.n_components + 1:
            return np.zeros((n, self.n_components), np.float32)
        k = min(self.n_neighbors, n - 1)
        n_epochs = self.n_epochs or (500 if n <= 10_000 else 200)

        knn_idx, knn_dists = _knn(x, k, self.metric, self.device)
        rho, sigma = _smooth_knn_calibration(knn_dists, k)
        heads, tails, weights = _fuzzy_simplicial_set(knn_idx, knn_dists, rho, sigma)
        a, b = _fit_ab(self.min_dist, self.spread)
        init = _pca_init(x, self.n_components)
        logger.info("NativeUMAP: n=%d k=%d edges=%d epochs=%d (a=%.3f b=%.3f)",
                    n, k, len(heads), n_epochs, a, b)
        return _optimize_layout(
            init, heads, tails, weights, n_epochs, a, b, self.learning_rate,
            self.negative_sample_rate, self.random_state, self.device)
