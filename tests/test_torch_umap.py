"""The port's native UMAP (``vit_ssl_tpu_torch.evaluators.umap_native``)
against the JAX package's, on the CPU.

- The deterministic stages on seeded clusters: the exact kNN graph
  (euclidean and cosine: indices equal, distances within 1e-6), the
  smooth-kNN calibration, the fuzzy simplicial set (edges equal, weights
  within 1e-6), ``a, b`` and the PCA initialisation (columns equal up to
  sign, within 1e-5 in the ±10 box: a float32 ulp there is 1e-6).
- The layout on 3 separated clusters: its silhouette within 0.05 of the
  JAX layout's at 100 epochs (the two draw from different random streams).
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import silhouette_score

from vit_ssl_tpu.evaluators import umap_native as jax_umap
from vit_ssl_tpu_torch.evaluators import umap_native as umap

K = 15


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _clusters(n_per=100, dim=32, seed=1):
    rng = np.random.default_rng(seed)
    centers = 6.0 * rng.normal(size=(3, dim))
    labels = np.repeat(np.arange(3), n_per)
    return (centers[labels] + rng.normal(size=(3 * n_per, dim))), labels


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_graph_calibration_and_fuzzy_set_match_jax(metric):
    x, _ = _clusters()
    want_idx, want_d = jax_umap._knn(x, K, metric)
    got_idx, got_d = umap._knn(x, K, metric, "cpu")
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_d, want_d, atol=1e-6, rtol=0)

    want_rho, want_sigma = jax_umap._smooth_knn_calibration(want_d, K)
    got_rho, got_sigma = umap._smooth_knn_calibration(got_d, K)
    np.testing.assert_allclose(got_rho, want_rho, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_sigma, want_sigma, atol=1e-6, rtol=0)

    want = jax_umap._fuzzy_simplicial_set(want_idx, want_d, want_rho, want_sigma)
    got = umap._fuzzy_simplicial_set(got_idx, got_d, got_rho, got_sigma)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("min_dist,spread", [(0.1, 1.0), (0.5, 2.0)])
def test_ab_fit_matches_jax(min_dist, spread):
    assert umap._fit_ab(min_dist, spread) == jax_umap._fit_ab(min_dist, spread)


@pytest.mark.parametrize("components", [2, 3])
def test_pca_init_matches_sklearn_up_to_sign(components):
    x, _ = _clusters(seed=2)
    want = jax_umap._pca_init(x, components, 42)
    got = umap._pca_init(x, components)
    assert got.dtype == np.float32 and np.abs(got).max() == pytest.approx(10.0)
    for j in range(components):
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(sign * got[:, j], want[:, j], atol=1e-5, rtol=0)


def test_layout_separates_clusters_as_jax_does():
    x, labels = _clusters(seed=3)
    want = jax_umap.NativeUMAP(n_epochs=100).fit_transform(x)
    got = umap.NativeUMAP(n_epochs=100, device="cpu").fit_transform(x)
    assert got.shape == (300, 2) and np.isfinite(got).all()
    assert abs(silhouette_score(got, labels) - silhouette_score(want, labels)) <= 0.05


def test_tiny_input_is_degenerate():
    out = umap.NativeUMAP(device="cpu").fit_transform(np.ones((3, 4)))
    np.testing.assert_array_equal(out, np.zeros((3, 2), np.float32))
