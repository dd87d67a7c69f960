"""The port's supervised and finetune trainer (``SupervisedTrainer``) against
the JAX package's, on the CPU.

- Both trainers at a tiny width (2 blocks, embed 32, image 16, patch 8,
  fp32, dropout 0, host images, no augmentation) from the same weights
  (JAX's initial state carried across with ``vit_state_dict_from_flax``),
  fed one in-test loader of numpy images and labels with a padded row:
  ``fit(2)`` with 2 train batches and 1 val batch an epoch. Supervised with
  the four metrics of ``configs/supervised/metrics.yaml``; finetune from a
  DINO ``.pth`` with ``training.extended_transfer``,
  ``training.freeze_backbone`` and an unfreeze at epoch 2 (the optimizer
  rebuilt, its moments dropped and its schedule restarted, as JAX does).
  Epoch metrics at rtol 1e-4; every tensor at the end at rtol 1e-4 with an
  absolute floor of 1e-5, as the DINO trainer's test holds them; the best
  epoch and the metadata equal.
- Resume is bit-exact across the unfreeze: ``fit(3)`` equals ``fit(1)``
  then a resumed ``fit(2)`` (which unfreezes), and ``fit(2)`` then a
  resumed ``fit(1)`` (which starts unfrozen); the frozen tensors are the
  checkpoint's bit for bit through epoch 1.
- The criterion is checked per mode, as JAX's ``make_criterion`` does.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.models.builder import build_model as jax_build_model
from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.train.steps import make_criterion as jax_make_criterion
from vit_ssl_tpu.train.trainers import base as jax_trainer_base
from vit_ssl_tpu.train.trainers.supervised import SupervisedTrainer as JaxSupervisedTrainer
from vit_ssl_tpu.utils.checkpoint import (dino_params_to_torch, save_torch_checkpoint,
                                          vit_params_to_torch)
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.models.builder import build_model, freeze_backbone_mask
from vit_ssl_tpu_torch.train.steps import make_criterion
from vit_ssl_tpu_torch.train.trainers import SupervisedTrainer
from vit_ssl_tpu_torch.train.trainers import base as trainer_base
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

B = 4
TINY = ["data.img_size=16", "model.embed_dim=32", "model.num_heads=2",
        "model.num_blocks=2", "model.mlp_dim=64", "model.patch_size=8",
        "model.num_classes=3", "model.dropout=0.0", "model.compute_dtype=float32",
        f"training.batch_size={B}", "training.num_epochs=2", "training.warmup_epochs=1",
        "training.warmup_final_learning_rate=1e-2", "training.plain_logging=true",
        "eval.interval=0", "data.device_augment=false"]
FINETUNE = ["training.extended_transfer=true", "training.freeze_backbone=true",
            "+freeze_backbone_epochs=2"]
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5


class HostImages:
    """``n`` batches of float images in [0, 1], labels and weights, drawn
    with numpy from (seed, epoch)."""

    def __init__(self, n, seed, weights):
        self.n, self.seed, self.weights, self.epoch = n, seed, weights, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for i in range(self.n):
            yield {"image": rng.random((B, 16, 16, 3), np.float32),
                   "label": rng.integers(0, 3, B).astype(np.int32),
                   "weight": np.asarray(self.weights[i], np.float32)}


def _loaders():
    return (HostImages(2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]]),
            HostImages(1, 8, [[1, 1, 1, 0]]))


@pytest.fixture(scope="module")
def dino_pth(tmp_path_factory):
    """A DINO checkpoint at the trainers' width, as a reference ``.pth``."""
    net = JaxDINONetwork(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32,
                         patch_size=8, num_heads=2, mlp_dim=64, output_dim=16)
    rng = np.random.default_rng(3)
    trees = [jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32),
        net.init(jax.random.PRNGKey(seed), np.zeros((1, 16, 16, 3)))["params"])
        for seed in (1, 2)]
    path = str(tmp_path_factory.mktemp("pre") / "dino.pth")
    save_torch_checkpoint(path, dino_params_to_torch(*trees, np.zeros((1, 16), np.float32)))
    return path


def _overrides(mode, pth):
    return TINY + (FINETUNE + [f"training.pretrained_path={pth}"] if mode == "finetune"
                   else [])


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


def _jax_fit(tmp, mode, pth, monkeypatch):
    config = jax_compose("configs", mode, _overrides(mode, pth))
    bundle = jax_build_model(config)
    bundle.init_fn = jax.jit(bundle.init_fn)
    train, val = _loaders()
    trainer = JaxSupervisedTrainer(bundle, str(tmp), config, train, val, None)
    start = jax.device_get(trainer.state.params)
    written = {}
    monkeypatch.setattr(jax_trainer_base, "save_checkpoint",
                        lambda path, tree, metadata: written.__setitem__(
                            os.path.basename(path), metadata))
    trainer.fit(2)
    return trainer, start, written


def _port_trainer(tmp, mode="finetune", pth=None, extra=()):
    config = compose("configs", mode, _overrides(mode, pth) + list(extra))
    train, val = _loaders()
    return SupervisedTrainer(build_model(config, "cpu"), str(tmp), config, train, val,
                             "cpu")


def _meta(path, name):
    with open(os.path.join(path, name, "metadata.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["supervised", "finetune"])
def test_trainer_matches_jax(tmp_path, mode, dino_pth, quiet, monkeypatch):
    theirs, start, jax_meta = _jax_fit(tmp_path / "jax", mode, dino_pth, monkeypatch)
    ours = _port_trainer(tmp_path / "port", mode, dino_pth)
    if mode == "finetune":  # the port's own surgery gave JAX's backbone
        got = ours.network.state_dict()
        for key, value in vit_params_to_torch(start).items():
            if key.startswith(("encoder_blocks.", "patch_embedding.")):
                np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
        assert ours.loaded == {"matched": 28, "mismatched": 0}
    ours.state.model.load_state_dict(vit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, start)))
    ours.fit(2)

    assert set(ours.history.history) == set(theirs.history.history)
    for key, want in theirs.history.history.items():
        np.testing.assert_allclose(ours.history.history[key], want, rtol=METRIC_RTOL,
                                   err_msg=key)
    got_sd = ours.state.model.state_dict()
    for key, want in vit_params_to_torch(theirs.state.params).items():
        got = got_sd[key].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                                   rtol=METRIC_RTOL, atol=PARAM_ATOL, err_msg=key)
    assert ours.state.step == int(theirs.state.step) == 4
    for name in ("best_model", "last_model"):
        mine, want = _meta(tmp_path / "port", name), jax_meta[name]
        assert mine["epoch"] == want["epoch"]
        assert mine["mode"] == want["mode"] == mode
        assert mine["config"]["model"] == want["config"]["model"]
    best = _meta(tmp_path / "port", "best_model")["best_val_acc"]
    assert best == pytest.approx(jax_meta["best_model"]["best_val_acc"])
    assert _meta(tmp_path / "port", "last_model")["best_val_acc"] == best


def _state(trainer):
    return trainer_base.to_host(trainer.state.state_dict())


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


def test_resume_is_bit_exact_across_the_unfreeze(tmp_path, dino_pth, quiet):
    """Three epochs with the unfreeze at epoch 2, straight and resumed at
    each epoch boundary; the lr schedule restarts at the unfreeze."""
    straight = _port_trainer(tmp_path / "a", pth=dino_pth, extra=["training.num_epochs=3"])
    pretrained = {k: v.clone() for k, v in straight.network.state_dict().items()}
    frozen = [k for k, t in freeze_backbone_mask(straight.network).items() if not t]
    seen = []
    train_epoch = straight.train_epoch

    def recorded(epoch):
        metrics = train_epoch(epoch)
        sd = straight.network.state_dict()
        seen.append((epoch, straight.state.step, straight.state.opt_state.count,
                     all(torch.equal(sd[k], pretrained[k]) for k in frozen)))
        return metrics

    straight.train_epoch = recorded
    straight.fit(3)
    # (epoch, step, optimizer count, frozen tensors unchanged): the count
    # restarts with the rebuilt optimizer at the unfreeze
    assert len(frozen) == 27
    assert seen == [(1, 2, 2, True), (2, 4, 2, False), (3, 6, 4, False)]
    want = _state(straight)

    for first in (1, 2):
        run = tmp_path / f"r{first}"
        before = _port_trainer(run, pth=dino_pth, extra=["training.num_epochs=3"])
        before.fit(first)
        resumed = _port_trainer(run, pth=dino_pth, extra=["training.num_epochs=3"])
        resumed.resume_from(str(run / "last_model"))
        assert resumed.start_epoch == first
        assert resumed.best_score == before.best_score
        resumed.fit(3 - first)
        _equal(_state(resumed), want, f"resumed after epoch {first}")


def test_criterion_is_checked_per_mode():
    for mode in ("supervised", "finetune"):
        config = compose("configs", mode, ["training.criterion.name=MSELoss"])
        jax_config = jax_compose("configs", mode, ["training.criterion.name=MSELoss"])
        with pytest.raises(ValueError, match="not supported by the"):
            make_criterion(config)
        with pytest.raises(ValueError, match="not supported by the"):
            jax_make_criterion(jax_config)
        assert make_criterion(compose("configs", mode)) == "ce"
    config = compose("configs", "supervised", ["training.criterion.name=HingeLoss"])
    with pytest.raises(ValueError, match="Unknown criterion"):
        make_criterion(config)
    assert make_criterion(compose("configs", "supervised",
                                  ["training.criterion.name=L1Loss"]), "simmim") == "l1"
