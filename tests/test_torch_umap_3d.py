"""The port's rotating 3D embedding
(``evaluators.embedding_analysis.create_3d_umap_animation`` and ``python -m
vit_ssl_tpu_torch.scripts.umap_3d_visualizer``) on the CPU.

- The 3D embedding against the JAX package's native projection
  (``vit_ssl_tpu.evaluators.embedding_analysis._project`` with umap-learn
  absent) on three separated clusters: shape (n, 3), finite, and the
  silhouette of the labels within 0.05 of JAX's, the bar
  ``tests/test_torch_umap.py`` holds the 2D layout to (the two optimise
  from their own random streams).
- With matplotlib and PIL: ``umap_3d_rotation.gif`` of 90 frames, and the
  same embedding as without them (drawing moves nothing).
- Without matplotlib: one warning naming matplotlib, PIL and the GIF.
- The CLI over a tiny port run directory (a DINO ``best_model`` and its
  ``.hydra`` config) and ``tests/make_synthetic_data.py``'s PNGs.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from make_synthetic_data import make
from vit_ssl_tpu.evaluators import embedding_analysis as jax_ea
from vit_ssl_tpu_torch.config import compose, to_container
from vit_ssl_tpu_torch.evaluators import create_3d_umap_animation
from vit_ssl_tpu_torch.evaluators.embedding_analysis import silhouette_score
from vit_ssl_tpu_torch.models.builder import build_dino_network
from vit_ssl_tpu_torch.scripts import umap_3d_visualizer
from vit_ssl_tpu_torch.train.__main__ import save_run_config
from vit_ssl_tpu_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parent.parent
PARAMS = {"n_epochs": 100}
SILHOUETTE_TOL = 0.05  # tests/test_torch_umap.py's bar for the 2D layout
TINY = ["data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.output_dim=32", "training.batch_size=8", "data.num_workers=0"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _clusters(n_per, seed):
    rng = np.random.default_rng(seed)
    centers = 6.0 * rng.normal(size=(3, 32))
    labels = np.repeat(np.arange(3), n_per)
    return centers[labels] + rng.normal(size=(3 * n_per, 32)), labels


def _without_matplotlib(monkeypatch, caplog, fn):
    """``fn()`` with matplotlib blocked: (its result, the warnings logged)."""
    caplog.clear()
    with monkeypatch.context() as m, caplog.at_level(logging.WARNING):
        m.setitem(sys.modules, "matplotlib", None)
        out = fn()
    return out, [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]


def test_3d_embedding_matches_jax_native_projection(tmp_path, monkeypatch, caplog):
    x, labels = _clusters(100, seed=3)
    assert not jax_ea._HAVE_UMAP
    want = jax_ea._project(x, 3, PARAMS)
    got, warnings = _without_matplotlib(monkeypatch, caplog, lambda: create_3d_umap_animation(
        x, labels, str(tmp_path), PARAMS, device="cpu"))
    assert got.shape == want.shape == (300, 3) and np.isfinite(got).all()
    assert (abs(silhouette_score(got, labels, "cpu") - silhouette_score(want, labels, "cpu"))
            <= SILHOUETTE_TOL)
    gif = str(tmp_path / "umap_3d_rotation.gif")
    assert len(warnings) == 1
    assert all(word in warnings[0] for word in ("matplotlib", "PIL", gif))
    assert not Path(gif).exists()


def test_gif_of_90_frames(tmp_path, monkeypatch, caplog):
    pytest.importorskip("matplotlib")
    image = pytest.importorskip("PIL.Image")
    x, labels = _clusters(40, seed=4)
    bare, _ = _without_matplotlib(monkeypatch, caplog, lambda: create_3d_umap_animation(
        x, labels, str(tmp_path / "bare"), PARAMS, device="cpu"))
    drawn = create_3d_umap_animation(x, labels, str(tmp_path), PARAMS, device="cpu")
    np.testing.assert_array_equal(drawn, bare)
    with image.open(tmp_path / "umap_3d_rotation.gif") as gif:
        assert gif.n_frames == 90 and gif.size == (1200, 900)


def test_cli_on_a_port_run_directory(tmp_path, monkeypatch, caplog):
    data = tmp_path / "data"
    make(str(data), n=24, size=16)
    run = tmp_path / "run"
    overrides = TINY + [f"hydra.run.dir={run}"]
    config = compose(REPO / "configs", "dino", overrides)
    save_run_config(config, overrides, str(run))
    network = build_dino_network(config, "cpu")
    save_checkpoint(str(run / "best_model"), {"teacher": network.state_dict()},
                    {"config": to_container(config), "epoch": 1, "mode": "dino"})
    argv = ["--config-path", str(REPO / "configs"), "--device", "cpu",
            f"eval.experiment_path={run}", f"eval.data_dir={data}/train_images",
            f"eval.data_csv={data}/train_labels.json"]
    embedding, warnings = _without_matplotlib(monkeypatch, caplog,
                                              lambda: umap_3d_visualizer.main(argv))
    assert embedding.shape == (24, 3) and np.isfinite(embedding).all()
    assert len(warnings) == 1 and str(run / "umap_3d_rotation.gif") in warnings[0]
