"""The port's evaluators (``vit_ssl_tpu_torch.evaluators``) against the JAX
package's, on the CPU, on numpy inputs drawn from a seed.

- KNN: the same predictions as ``run_knn_evaluation`` (600 × 64 train and
  200 val rows, 10 classes).
- Linear probe: the default backend (sklearn's lbfgs fit, rebuilt) agrees
  with JAX's sklearn backend on ≥ 99% of the val rows, accuracy within
  0.01, on overlapping Gaussian classes (accuracy below 1); the Adam
  backend's predictions equal JAX's optax backend's.
- Quality metrics: silhouette within 1e-6 of JAX's (sklearn's), the
  adjusted Rand index equal, the stratified subsample's indices equal,
  KMeans' ARI on separable blobs within 0.02 of JAX's, the rubric's grades
  equal.
- Summary files: ``evaluation_summary.{csv,txt}``, ``predictions.csv`` and
  the UMAP quality CSV byte-equal to the JAX package's renderings of the
  same results.
- ``extract_features``: DINO's teacher, SimMIM and the ViT at a tiny
  width, weights carried across by the ``*_state_dict_from_flax`` bridges:
  features within 1e-5 of JAX's, the padded rows of the last batch dropped.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.evaluators import embedding_analysis as jax_ea
from vit_ssl_tpu.evaluators import evaluator_utils as jax_utils
from vit_ssl_tpu.evaluators import knn as jax_knn
from vit_ssl_tpu.evaluators import linear_probe as jax_probe
from vit_ssl_tpu.evaluators import supervised_evaluator as jax_sup
from vit_ssl_tpu.evaluators import unsupervised_evaluator as jax_unsup
from vit_ssl_tpu.models.builder import build_model as jax_build_model
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.evaluators import embedding_analysis as ea
from vit_ssl_tpu_torch.evaluators import knn, linear_probe
from vit_ssl_tpu_torch.evaluators import supervised_evaluator as sup
from vit_ssl_tpu_torch.evaluators import unsupervised_evaluator as unsup
from vit_ssl_tpu_torch.evaluators.evaluator_utils import extract_features
from vit_ssl_tpu_torch.models.builder import build_model
from vit_ssl_tpu_torch.utils.checkpoint import (dino_state_dict_from_flax,
                                                simmim_state_dict_from_flax,
                                                vit_state_dict_from_flax)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CLASSES = 10


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _gaussians(n, dim, noise, seed, classes=CLASSES):
    """Class-centred Gaussian features (float32) and their labels."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).normal(size=(classes, dim))
    labels = rng.integers(0, classes, n)
    return (centers[labels] + noise * rng.normal(size=(n, dim))).astype(np.float32), labels


def test_knn_matches_jax():
    xtr, ytr = _gaussians(600, 64, 2.5, 0)
    xva, yva = _gaussians(200, 64, 2.5, 1)
    theirs = jax_knn.run_knn_evaluation(xtr, ytr, xva, yva, CLASSES)
    ours = knn.run_knn_evaluation(xtr, ytr, xva, yva, CLASSES, device="cpu")
    assert ours["method"] == "knn" and ours["num_neighbors"] == theirs["num_neighbors"]
    np.testing.assert_array_equal(ours["predictions"], theirs["predictions"])
    assert ours["accuracy"] == theirs["accuracy"] < 1.0


def test_linear_probe_matches_sklearn_backend():
    xtr, ytr = _gaussians(600, 64, 3.0, 2)
    xva, yva = _gaussians(300, 64, 3.0, 3)
    theirs = jax_probe.run_linear_evaluation(xtr, ytr, xva, yva)
    ours = linear_probe.run_linear_evaluation(xtr, ytr, xva, yva, device="cpu")
    assert theirs["accuracy"] < 1.0
    assert np.mean(ours["predictions"] == theirs["predictions"]) >= 0.99
    assert abs(ours["accuracy"] - theirs["accuracy"]) <= 0.01


def test_linear_probe_adam_backend_matches_optax():
    xtr, ytr = _gaussians(600, 64, 3.0, 4)
    xva, yva = _gaussians(300, 64, 3.0, 5)
    theirs = jax_probe.run_linear_evaluation(xtr, ytr, xva, yva, backend="optax")
    ours = linear_probe.run_linear_evaluation(xtr, ytr, xva, yva, backend="optax",
                                              device="cpu")
    np.testing.assert_array_equal(ours["predictions"], theirs["predictions"])
    assert ours["accuracy"] == theirs["accuracy"]


@pytest.mark.parametrize("n,cap", [(900, 300), (2600, 2000)])
def test_stratified_subsample_is_sklearns(n, cap):
    features, labels = _gaussians(n, 16, 1.0, 6)
    want_f, want_y = jax_ea._stratified_subsample(features, labels, cap)
    got_f, got_y = ea.stratified_subsample(features, labels, cap)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_y, want_y)


@pytest.mark.parametrize("dim", [2, 64])
def test_silhouette_matches_sklearn(dim):
    from sklearn.metrics import silhouette_samples, silhouette_score

    x, y = _gaussians(700, dim, 1.5, 7)
    y[:1] = CLASSES  # a class of one point: its silhouette is 0
    assert abs(ea.silhouette_score(x, y, "cpu") - silhouette_score(x, y)) <= 1e-6
    np.testing.assert_allclose(ea.silhouette_samples(x, y, "cpu"),
                               silhouette_samples(x, y), atol=1e-6)


def test_adjusted_rand_index_equals_sklearns():
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(8)
    truth = rng.integers(0, CLASSES, 1000)
    for pred in (rng.integers(0, 7, 1000), truth, (truth + rng.integers(0, 2, 1000)) % 4):
        assert ea.adjusted_rand_score(truth, pred) == adjusted_rand_score(truth, pred)


def test_kmeans_ari_on_blobs_matches_sklearn():
    from sklearn.cluster import KMeans
    from sklearn.metrics import adjusted_rand_score

    x, y = _gaussians(2000, 32, 0.3, 9)
    want = adjusted_rand_score(
        y, KMeans(n_clusters=CLASSES, random_state=42, n_init=3, max_iter=100)
        .fit_predict(x))
    got = ea.adjusted_rand_score(y, ea.kmeans(x, CLASSES, device="cpu"))
    assert abs(got - want) <= 0.02


def test_feature_quality_and_rubric_match_jax():
    features, labels = _gaussians(2400, 32, 0.6, 10)
    embedding = np.random.default_rng(11).normal(size=(2400, 2)).astype(np.float32)
    embedding += 4 * labels[:, None]
    theirs = jax_ea.evaluate_feature_quality(features, labels, embedding)
    ours = ea.evaluate_feature_quality(features, labels, embedding, device="cpu")
    assert set(ours) == set(theirs)
    for key in ("silhouette_features", "silhouette_umap"):
        assert abs(ours[key] - theirs[key]) <= 1e-6, key
    assert abs(ours["adjusted_rand_index"] - theirs["adjusted_rand_index"]) <= 0.02
    for key in ("avg_intra_distance", "avg_inter_distance", "separation_ratio",
                "n_samples", "n_features", "n_classes", "sampled_for_computation"):
        assert ours[key] == theirs[key], key
    assert ea.assess_quality(ours) == jax_ea.assess_quality(theirs)
    for metrics in ({"silhouette_features": 0.75, "separation_ratio": 2.5,
                     "adjusted_rand_index": 0.3},
                    {"silhouette_features": 0.1, "separation_ratio": 3.5,
                     "adjusted_rand_index": 0.65}):
        assert ea.assess_quality(metrics) == jax_ea.assess_quality(metrics)


def _outcomes(module, bank_outcomes):
    """The same outcomes as ``module``'s EvalOutcome records, a UMAP one
    appended."""
    umap = dict(mode="eval_umap", method="UMAP", headline="Quality: Good",
                notes=["Silhouette: 0.412", "Good cluster cohesion"])
    return [module.EvalOutcome(mode=o.mode, method=o.method, headline=o.headline,
                               notes=list(o.notes)) for o in bank_outcomes] + [
        module.EvalOutcome(**umap)]


def test_summary_files_are_byte_equal(tmp_path):
    xtr, ytr = _gaussians(200, 16, 2.0, 12)
    xva, yva = _gaussians(80, 16, 2.0, 13)
    config = {"eval": {"mode": ["eval_knn", "eval_linear"], "num_classes": CLASSES}}
    theirs = jax_unsup.run_modes(config, jax_unsup.FeatureBank(xtr, ytr, xva, yva),
                                 str(tmp_path))
    ours = unsup.run_modes(config, unsup.FeatureBank(xtr, ytr, xva, yva), str(tmp_path),
                           "cpu")
    assert [o.headline for o in ours] == [o.headline for o in theirs]
    for name, module, outs in (("jax", jax_unsup, theirs), ("port", unsup, ours)):
        module.render_summary(_outcomes(module, outs), str(tmp_path / name))
    for name in ("evaluation_summary.csv", "evaluation_summary.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name

    preds, labels = np.array([3, 1, 4, 1, 5]), np.array([3, 1, 4, 2, 5])
    for name, module in (("jax", jax_sup), ("port", sup)):
        module.save_results(False, 0.8, preds, labels, str(tmp_path / name))
    assert (tmp_path / "port" / "predictions.csv").read_bytes() == \
        (tmp_path / "jax" / "predictions.csv").read_bytes()

    metrics = jax_ea.evaluate_feature_quality(xtr, ytr, xtr[:, :2], sample_size=100)
    quality, feedback = jax_ea.assess_quality(metrics)
    for name, module in (("jax", jax_ea), ("port", ea)):
        module.save_results(metrics, quality, feedback, str(tmp_path / name))
    name = "umap_feature_quality_results.csv"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


TINY = {
    "dino": ["data.img_size=16", "data.local_img_size=8", "model.output_dim=16"],
    "simmim": ["data.img_size=16", "model.patch_size=4"],
    "supervised": ["data.img_size=16", "model.num_classes=5"],
}
COMMON = ["model.embed_dim=32", "model.num_heads=2", "model.num_blocks=2",
          "model.mlp_dim=64", "model.dropout=0.0", "model.compute_dtype=float32",
          "eval.interval=0"]


def _jiggled(tree, seed):
    """``tree`` with every leaf moved by seeded noise (a teacher that is not
    the student)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(x) + 0.05 * rng.normal(size=np.shape(x)).astype(np.float32)
        for x in leaves])


@pytest.mark.parametrize("mode", ["dino", "simmim", "supervised"])
def test_extract_features_matches_jax(mode):
    overrides = TINY[mode] + COMMON + (["model.patch_size=8"] if mode != "simmim" else [])
    jax_config = jax_compose(CONFIGS, mode, overrides)
    bundle = jax_build_model(jax_config)
    trees = jax.jit(bundle.init_fn)(jax.random.PRNGKey(3))
    network = build_model(compose(CONFIGS, mode, overrides), "cpu")
    if mode == "dino":
        teacher = _jiggled(trees["teacher_params"], 14)
        state = jax_unsup.EvalState(params=trees["params"], teacher_params=teacher)
        sd = dino_state_dict_from_flax(trees["params"], teacher, trees["center"])
        network.load_state_dict({k[len("teacher_"):]: v for k, v in sd.items()
                                 if k.startswith("teacher_") and "center" not in k})
    else:
        state = jax_unsup.EvalState(params=trees["params"])
        bridge = simmim_state_dict_from_flax if mode == "simmim" else vit_state_dict_from_flax
        network.load_state_dict(bridge(jax.device_get(trees["params"])))

    rng = np.random.default_rng(15)
    weights = [np.ones(4, np.float32), np.array([1, 1, 0, 0], np.float32)]
    batches = [{"image": rng.random((4, 16, 16, 3), dtype=np.float32),
                "label": rng.integers(0, 5, 4).astype(np.int32), "weight": w}
               for w in weights]
    want_f, want_y = jax_utils.extract_features(bundle, state, batches)
    network.train()
    got_f, got_y = extract_features(network, batches, "cpu")
    assert got_f.shape == want_f.shape == (6, want_f.shape[1]) and got_f.dtype == np.float32
    np.testing.assert_allclose(got_f, want_f, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_y, want_y)
    assert all(m.training for m in network.modules())  # flags given back
