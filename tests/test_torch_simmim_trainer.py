"""The port's SimMIM trainer (``SimMIMTrainer``) against the JAX package's,
and ``python -m vit_ssl_tpu_torch.train --config-name simmim``, on the CPU.

- Both trainers at a tiny width (2 blocks, embed 32, image 16, patch 4,
  fp32, dropout 0, host images, no augmentation) from the same weights
  (JAX's initial state carried across with ``simmim_state_dict_from_flax``),
  fed one in-test loader of numpy images with a padded row: ``fit(2)`` with
  2 train batches and 1 val batch an epoch. Both packages' masks come from
  one numpy table at ``mask_ratio`` 0.5 (``make_random_mask`` monkeypatched
  in both model modules). Epoch metrics (Loss, PSNR, SSIM) at rtol 1e-4;
  every tensor at the end at rtol 1e-4 with an absolute floor of 1e-5, as
  the DINO and supervised trainer tests hold them; the best epoch and
  ``best_val_score`` equal.
- Resume is bit-exact: ``fit(2)`` then a resumed ``fit(1)`` equals
  ``fit(3)``, with the port's own masks; val masks repeat across epochs.
- ``eval.interval=1`` (``configs/simmim/eval.yaml``'s) evaluates after the
  epoch into ``epoch_1/`` and leaves ``fit(1)``'s state bit for bit.
- The CLI trains on ``tests/make_synthetic_data.py``'s PNGs through the
  host pipeline of ``configs/simmim/train_transforms.yaml``, and again with
  ``data.device_augment=true``, ``training.grad_accum_steps=2`` and
  ``model.fast_dropout=false``, writing ``best_model`` and ``last_model``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vit_ssl_tpu.models.simmim as jax_simmim_mod
from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.models.builder import build_model as jax_build_model
from vit_ssl_tpu.train.trainers import base as jax_trainer_base
from vit_ssl_tpu.train.trainers.simmim import SimMIMTrainer as JaxSimMIMTrainer
from vit_ssl_tpu.utils.checkpoint import simmim_params_to_torch
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.data.builder import eval_pipeline, make_loaders
from vit_ssl_tpu_torch.models import simmim as port_simmim_mod
from vit_ssl_tpu_torch.models.builder import build_model
from vit_ssl_tpu_torch.train.__main__ import check_mode, get_trainer
from vit_ssl_tpu_torch.train.trainers import SimMIMTrainer
from vit_ssl_tpu_torch.train.trainers import base as trainer_base
from vit_ssl_tpu_torch.utils.checkpoint import simmim_state_dict_from_flax

from make_synthetic_data import make

REPO = Path(__file__).resolve().parent.parent
B, IMG, PATCH = 4, 16, 4
N = (IMG // PATCH) ** 2
TINY = [f"data.img_size={IMG}", "model.embed_dim=32", "model.num_heads=2",
        "model.num_blocks=2", "model.mlp_dim=64", f"model.patch_size={PATCH}",
        "model.dropout=0.0", "model.compute_dtype=float32",
        f"training.batch_size={B}", "training.num_epochs=2", "training.warmup_epochs=1",
        "training.warmup_final_learning_rate=1e-2", "training.plain_logging=true",
        "eval.interval=0", "data.device_augment=false"]
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5


class HostImages:
    """``n`` batches of float images in [0, 1] and weights, drawn with numpy
    from (seed, epoch)."""

    def __init__(self, n, seed, weights):
        self.n, self.seed, self.weights, self.epoch = n, seed, weights, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for i in range(self.n):
            yield {"image": rng.random((B, IMG, IMG, 3), np.float32),
                   "weight": np.asarray(self.weights[i], np.float32)}


def _loaders():
    return (HostImages(2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]]),
            HostImages(1, 8, [[1, 1, 1, 0]]))


@pytest.fixture
def quiet(monkeypatch):
    """No metric plots (compared nowhere here); two CPU threads."""
    from vit_ssl_tpu.utils.history import TrainingHistory as JaxHistory
    from vit_ssl_tpu_torch.utils.history import TrainingHistory

    for cls in (JaxHistory, TrainingHistory):
        monkeypatch.setattr(cls, "vizualize", lambda self, num_epochs=None: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed_masks(monkeypatch):
    """Both packages draw their masks from one table: exactly N/2 of each row."""
    rng = np.random.default_rng(13)
    table = np.zeros((B, N), bool)
    for row in table:
        row[rng.permutation(N)[:N // 2]] = True
    monkeypatch.setattr(jax_simmim_mod, "make_random_mask",
                        lambda rng, b, n, ratio: jax.numpy.asarray(table[:b]))
    monkeypatch.setattr(port_simmim_mod, "make_random_mask",
                        lambda gen, b, n, ratio: torch.from_numpy(table[:b]).to(gen.device))


def _port_trainer(tmp, extra=()):
    config = compose("configs", "simmim", TINY + list(extra))
    train, val = _loaders()
    return SimMIMTrainer(build_model(config, "cpu"), str(tmp), config, train, val, "cpu")


def _meta(path, name):
    with open(os.path.join(path, name, "metadata.json")) as f:
        return json.load(f)


def test_trainer_matches_jax(tmp_path, quiet, fixed_masks, monkeypatch):
    config = jax_compose("configs", "simmim", TINY)
    bundle = jax_build_model(config)
    bundle.init_fn = jax.jit(bundle.init_fn)
    train, val = _loaders()
    theirs = JaxSimMIMTrainer(bundle, str(tmp_path / "jax"), config, train, val, None)
    start = jax.device_get(theirs.state.params)
    written = {}
    monkeypatch.setattr(jax_trainer_base, "save_checkpoint",
                        lambda path, tree, metadata: written.__setitem__(
                            os.path.basename(path), metadata))
    theirs.fit(2)

    ours = _port_trainer(tmp_path / "port")
    ours.state.model.load_state_dict(simmim_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, start)))
    ours.fit(2)

    assert set(ours.history.history) == set(theirs.history.history) == {
        f"{split}_{m}" for split in ("train", "val") for m in ("Loss", "PSNR", "SSIM")}
    for key, want in theirs.history.history.items():
        np.testing.assert_allclose(ours.history.history[key], want, rtol=METRIC_RTOL,
                                   err_msg=key)
    got_sd = ours.state.model.state_dict()
    for key, want in simmim_params_to_torch(theirs.state.params).items():
        got = got_sd[key].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                                   rtol=METRIC_RTOL, atol=PARAM_ATOL, err_msg=key)
    assert ours.state.step == int(theirs.state.step) == 4
    for name in ("best_model", "last_model"):
        mine, want = _meta(tmp_path / "port", name), written[name]
        assert mine["epoch"] == want["epoch"]
        assert mine["mode"] == want["mode"] == "simmim"
        assert mine["config"]["model"] == want["config"]["model"]
    best = _meta(tmp_path / "port", "best_model")["best_val_score"]
    assert best == pytest.approx(written["best_model"]["best_val_score"], rel=1e-5)
    assert _meta(tmp_path / "port", "last_model")["best_val_score"] == best


def _equal(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_resume_is_bit_exact_and_val_masks_repeat(tmp_path, quiet):
    extra = ["training.num_epochs=3", "model.dropout=0.1"]
    straight = _port_trainer(tmp_path / "a", extra)
    masks = []
    step = straight.eval_step
    straight.eval_step = lambda state, batch, gen: (
        masks.append(gen.get_state()), step(state, batch, gen))[1]
    straight.fit(3)
    assert all(torch.equal(m, masks[0]) for m in masks) and len(masks) == 3

    first = _port_trainer(tmp_path / "b", extra)
    first.fit(2)
    resumed = _port_trainer(tmp_path / "b", extra)
    resumed.resume_from(str(tmp_path / "b" / "last_model"))
    assert resumed.start_epoch == 2
    resumed.fit(1)
    assert resumed.state.step == straight.state.step == 6
    _equal(trainer_base.to_host(resumed.state.state_dict()),
           trainer_base.to_host(straight.state.state_dict()))
    assert resumed.history.history["train_Loss"] == straight.history.history["train_Loss"][2:]


def test_mode_and_trainer_are_taken(tmp_path, quiet):
    check_mode("simmim")
    config = compose("configs", "simmim", TINY)
    train, val = _loaders()
    trainer = get_trainer("simmim", build_model(config, "cpu"), str(tmp_path), config,
                          train, val, "cpu")
    assert isinstance(trainer, SimMIMTrainer)
    assert trainer.state.model.mask_ratio == 0.5
    # configs/simmim/eval.yaml evaluates every epoch (ported since): the
    # unmasked forward's features, into epoch_1/, training unmoved
    evaluated = _port_trainer(tmp_path / "eval", ["eval.interval=1"])
    assert evaluated.eval_interval == 1 and len(evaluated.eval_mode) == 3
    evaluated.eval_loaders = make_loaders(evaluated.config, _Labeled(40))
    evaluated.fit(1)
    plain = _port_trainer(tmp_path / "plain")
    plain.fit(1)
    _equal(trainer_base.to_host(evaluated.state.state_dict()),
           trainer_base.to_host(plain.state.state_dict()))
    assert (tmp_path / "eval" / "epoch_1" / "evaluation_summary.csv").exists()
    assert (tmp_path / "eval" / "epoch_1" / "umap_feature_quality_report.txt").exists()


class _Labeled:
    """n seeded images through the evaluators' host pipeline, 4 classes."""

    def __init__(self, n):
        self.images = np.random.default_rng(22).integers(0, 256, (n, IMG, IMG, 3),
                                                         dtype=np.uint8)
        self.pipeline = eval_pipeline(IMG)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.pipeline(self.images[idx]), idx % 4


def _cli(args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", "vit_ssl_tpu_torch.train",
                             "--config-name", "simmim", "--device", "cpu", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_cli_trains_simmim(tmp_path):
    data = make(str(tmp_path / "synth"), n=24, size=20, num_classes=2)
    common = [f"data.data_dir={data}/unlabeled_images", f"data.img_size={IMG}",
              "model.embed_dim=32", "model.num_heads=2", "model.num_blocks=2",
              "model.mlp_dim=64", f"model.patch_size={PATCH}", "training.batch_size=8",
              "training.num_epochs=2", "training.warmup_epochs=1", "eval.interval=0",
              "data.num_workers=0", "training.plain_logging=true"]
    runs = {"host": [], "device": ["data.device_augment=true",
                                   "+training.grad_accum_steps=2",
                                   "model.fast_dropout=false"]}
    procs = {name: _cli(common + extra + [f"hydra.run.dir={tmp_path / name}"])
             for name, extra in runs.items()}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=150)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        run = tmp_path / name
        for path in ("best_model/state.pt", "last_model/state.pt", ".hydra/config.yaml"):
            assert (run / path).exists(), path
        assert "[epoch 2] val:" in out and "PSNR=" in out and "SSIM=" in out
        assert "best_val_score" in _meta(run, "best_model")
        assert _meta(run, "last_model")["mode"] == "simmim"
    assert "Device-side train augmentation enabled" in err
