"""The port's trainers and loaders take the JAX package's checkpoint
directories (orbax trees, read by the port's own reader), on the CPU.

- Resume: the port's ``DINOTrainer``, ``SupervisedTrainer`` (finetune inside
  ``freeze_backbone`` and after the unfreeze; supervised with
  ``model.scan_layers``, SGD with momentum, from a ``preempt_model``) and
  ``SimMIMTrainer`` resume from the committed fixtures that the JAX trainers
  wrote (``tests/torch_orbax_fixtures``). The state equals orbax's restore
  bridged into the port's layout, exactly; the weights also equal the JAX
  package's own ``.pth`` bridge, and each optimizer moment its parameter's
  layout; ``start_epoch``, the best score and the mid-epoch offset are the
  metadata's.
- One DINO step from the resumed state (dropout 0, the same views) matches
  JAX's step from the same checkpoint at ``tests/test_torch_train.py``'s
  bars: the loss at rtol 1e-5, the center at atol 1e-6, every parameter
  within 2·lr + 1e-5 and 99.5 % of each tensor's entries within
  1e-5 + 1e-4·|p|.
- ``train_state_to_flax`` and ``write_tree`` of the port's state resumed
  from the JAX DINO checkpoint give back the JAX trainer's own tree, bit
  for bit, as orbax restores it (the full-width tree ``chip_smoke.py``
  writes on the card is made so).
- ``load_pretrained`` of a JAX DINO checkpoint equals the flat dict of its
  ``scripts/export_torch.py`` export; the evaluator's ``load_model_state``,
  the visualizers' ``load_model_from_checkpoint`` and the server take a JAX
  directory and answer as from the export.

The fixtures' DINO head is 32 features wide (the JAX package's is fixed at
2048): both packages' heads are narrowed the same way here.
"""

import importlib.util
import json
import math
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vit_ssl_tpu.train.trainers import base as jax_trainer_base
from vit_ssl_tpu.utils.checkpoint import (dino_params_to_torch, simmim_params_to_torch,
                                          vit_params_to_torch)
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.models.builder import build_dino_network, build_model, load_pretrained
from vit_ssl_tpu_torch.train.trainers import DINOTrainer, SimMIMTrainer, SupervisedTrainer
from vit_ssl_tpu_torch.train.state import buffers_in_order
from vit_ssl_tpu_torch.train.trainers import base as trainer_base
from vit_ssl_tpu_torch.utils.checkpoint import train_state_from_flax

ocp = pytest.importorskip("orbax.checkpoint")
REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_orbax_fixtures"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SPEC = _load("torch_orbax_fixture_spec", FIXTURES / "fixture_spec.py")
MF = _load("torch_orbax_make_fixtures", FIXTURES / "make_fixtures.py")
TRAINERS = {"dino": DINOTrainer, "simmim": SimMIMTrainer}
# fixture -> (config name, overrides, trainer, loader kind)
CASES = {name: (config, overrides, TRAINERS.get(config, SupervisedTrainer), kind)
         for name, (config, overrides, kind) in SPEC.RESUMES.items()}


@pytest.fixture
def narrow_heads(monkeypatch):
    """Both packages' DINO heads at the fixtures' hidden width; no metric
    plots; two CPU threads."""
    from vit_ssl_tpu.models import dino as jax_dino
    from vit_ssl_tpu.utils.history import TrainingHistory as JaxHistory
    from vit_ssl_tpu_torch.models import dino as port_dino
    from vit_ssl_tpu_torch.utils.history import TrainingHistory

    class NarrowJaxHead(jax_dino.DINOHead):
        hidden_dim: int = SPEC.HEAD_HIDDEN

    class NarrowHead(port_dino.DINOHead):
        def __init__(self, embed_dim, output_dim, hidden_dim=None, **kwargs):
            super().__init__(embed_dim, output_dim, SPEC.HEAD_HIDDEN, **kwargs)

    monkeypatch.setattr(jax_dino, "DINOHead", NarrowJaxHead)
    monkeypatch.setattr(port_dino, "DINOHead", NarrowHead)
    for cls in (JaxHistory, TrainingHistory):
        monkeypatch.setattr(cls, "vizualize", lambda self, num_epochs=None: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _port_trainer(name, tmp):
    config_name, overrides, cls, kind = CASES[name]
    config = compose(str(REPO / "configs"), config_name, overrides)
    network = (build_dino_network if cls is DINOTrainer else build_model)(config, "cpu")
    return cls(network, str(tmp), config, *SPEC.loaders(kind), "cpu")


def _restored(name):
    tree = ocp.PyTreeCheckpointer().restore(str(FIXTURES / name / "tree"))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    meta = json.loads((FIXTURES / name / "metadata.json").read_text())
    return tree, meta


def _trees_equal(a, b, where="state"):
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b.reshape(a.shape)) and a.shape == b.shape, where
    elif isinstance(b, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b))[:4])
        for k in b:
            _trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainers_resume_from_jax_checkpoints(name, tmp_path, narrow_heads):
    trainer = _port_trainer(name, tmp_path)
    trainer.resume_from(str(FIXTURES / name))
    tree, meta = _restored(name)
    trained = trainer.optimizer.select([n for n, _ in trainer.network.named_parameters()])
    want = train_state_from_flax(tree, meta)
    want["opt_state"] = buffers_in_order(want["opt_state"], trained)
    got = trainer_base.to_host(trainer.state.state_dict())
    _trees_equal(got, want)

    # the weights against the JAX package's own bridge
    if "student" in got:
        reference = dino_params_to_torch(tree["params"], tree["teacher_params"],
                                         tree["center"])
        weights = {f"{who}_{k}": v for who in ("student", "teacher")
                   for k, v in got[who].items()}
        weights["center"] = got["center"]
    elif "classification_head.linear.weight" in got["model"]:
        reference, weights = vit_params_to_torch(tree["params"]), got["model"]
        if "encoder_scan.block.layer_norm1.weight" in weights:
            weights = {k: v for k, v in weights.items() if "encoder_scan" not in k}
            reference = {k: v for k, v in reference.items() if "encoder_blocks" not in k}
    else:
        reference, weights = simmim_params_to_torch(tree["params"]), got["model"]
    assert set(weights) == set(reference)
    for k, v in reference.items():
        np.testing.assert_array_equal(weights[k].numpy(), np.asarray(v).reshape(
            weights[k].shape), err_msg=k)

    # each moment in its parameter's layout: a Dense kernel's transposed
    chain = tree["opt_state"]
    if isinstance(chain, dict):
        chain = chain["inner_states"]["train"]["inner_state"]
    field = "mu" if "mu" in got["opt_state"] else "trace"
    moments = chain[0][field]
    if "student" in got:
        kernel, name_ = moments["head"]["mlp_0"]["kernel"], "head.mlp.0.weight"
    elif "simmim_head" in moments:
        kernel, name_ = moments["simmim_head"]["kernel"], "simmim_head.weight"
    else:
        kernel = moments["classification_head"]["linear"]["kernel"]
        name_ = "classification_head.linear.weight"
    index = trained.index(name_)
    np.testing.assert_array_equal(got["opt_state"][field][index].numpy(), kernel.T)
    counts = {int(s["count"]) for s in chain if s is not None and "count" in s}
    assert counts == {got["opt_state"]["count"]}

    assert trainer.start_epoch == meta["epoch"]
    best = meta.get(trainer.best_key)
    assert trainer.best_score == (best if best is not None else -math.inf)
    if "preempt_epoch" in meta:
        assert trainer._mid_epoch_skip == (meta["preempt_epoch"], meta["preempt_batches_done"])


def test_dino_step_from_jax_checkpoint_matches_jax(tmp_path, narrow_heads, monkeypatch):
    fixture = str(FIXTURES / "dino_step1")
    monkeypatch.setattr(jax_trainer_base, "save_checkpoint", lambda *a, **k: None)
    theirs = MF.jax_trainer("dino", SPEC.DINO, "dino", tmp_path / "jax")
    theirs.train_loader.n = 1
    theirs.resume_from(fixture)
    theirs.fit(1)
    ours = _port_trainer("dino_step1", tmp_path / "port")
    ours.train_loader.n = 1
    ours.resume_from(fixture)
    lr = float(ours.optimizer.lr_schedule(ours.state.opt_state.count))
    ours.fit(1)
    assert ours.state.step == int(theirs.state.step) == 2
    np.testing.assert_allclose(ours.history.history["train_Loss"],
                               theirs.history.history["train_Loss"], rtol=1e-5)
    want = {k: np.asarray(v, np.float32) for k, v in dino_params_to_torch(
        theirs.state.params, theirs.state.teacher_params, theirs.state.center).items()}
    got = {k: v.detach().numpy() for k, v in ours.state.model_state_dict().items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["center"], want["center"].reshape(1, -1), atol=1e-6, rtol=0)
    bound = 2 * lr + 1e-5
    for key in sorted(set(want) - {"center"}):
        diff = np.abs(got[key] - want[key].reshape(got[key].shape))
        assert diff.max() <= bound, (key, diff.max(), bound)
        close = diff <= 1e-5 + 1e-4 * np.abs(want[key].reshape(diff.shape))
        assert close.mean() >= 0.995, (key, close.mean())


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The JAX package's ``.pth`` export of the DINO and the finetune
    fixtures (``scripts/export_torch.py``)."""
    export = _load("export_torch_script", REPO / "scripts" / "export_torch.py")
    out = tmp_path_factory.mktemp("exports")
    for name in ("dino_step1", "finetune_unfrozen"):
        export.main([str(FIXTURES / name), str(out / f"{name}.pth")])
    return out


def test_load_pretrained_matches_the_export(exports):
    got = load_pretrained(str(FIXTURES / "dino_step1"))
    want = load_pretrained(str(exports / "dino_step1.pth"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.reshape(got[k].shape)), k


def test_evaluator_visualizer_and_server_take_a_jax_directory(exports, tmp_path,
                                                               narrow_heads):
    from vit_ssl_tpu_torch.evaluators.unsupervised_evaluator import load_model_state
    from vit_ssl_tpu_torch.scripts.attention_visualizer import load_model_from_checkpoint
    from vit_ssl_tpu_torch.serve import Server

    run = tmp_path / "run"
    run.mkdir()
    os.symlink(FIXTURES / "dino_step1", run / "best_model")
    config = compose(str(REPO / "configs"), "dino",
                     SPEC.DINO + [f"+eval.experiment_path={run}"])
    network = load_model_state(config, "cpu")
    teacher = train_state_from_flax(*_restored("dino_step1"))["teacher"]
    for k, v in network.state_dict().items():
        assert torch.equal(v, teacher[k]), k

    model, _ = load_model_from_checkpoint(str(FIXTURES / "finetune_unfrozen"), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((2, 16, 16, 3), np.float32))
    exported = Server(str(exports / "finetune_unfrozen.pth"), 2, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(), exported.forward_batch(x.numpy()))

    for name in ("dino_step1", "finetune_unfrozen"):
        direct = Server(str(FIXTURES / name), 2, device="cpu")
        via_pth = Server(str(exports / f"{name}.pth"), 2, device="cpu")
        np.testing.assert_array_equal(direct.forward_batch(x.numpy()),
                                      via_pth.forward_batch(x.numpy()))


def _with_optimizer(meta, name, **params):
    config = json.loads(json.dumps(meta["config"]))
    config["training"]["optimizer"] = {"name": name, "params": params}
    return dict(meta, config=config)


def test_optax_chains_and_their_refusals():
    """Each optimizer's chain maps to the port's buffers; a chain that is
    not the config's, or counts that disagree, are refused naming both."""
    tree, meta = _restored("simmim")
    params = tree["params"]
    ones = jax.tree_util.tree_map(lambda p: np.ones_like(p), params)
    count = np.asarray(2, np.int32)
    sgd = dict(tree, opt_state=[{"trace": ones}, {"count": count}])
    state = train_state_from_flax(sgd, _with_optimizer(meta, "SGD"))
    assert set(state["opt_state"]) == {"count"}  # momentum 0: the trace is unused
    names = list(state["model"])
    state = train_state_from_flax(sgd, _with_optimizer(meta, "SGD", momentum=0.9))
    traces = buffers_in_order(state["opt_state"], names)["trace"]
    assert [float(t.sum()) for t in traces] == [float(p.numel())
                                                for p in state["model"].values()]
    rms = dict(tree, opt_state=[{"nu": ones}, {"count": count}, {"trace": ones}])
    state = train_state_from_flax(rms, _with_optimizer(meta, "RMSprop", momentum=0.5))
    assert set(state["opt_state"]) == {"count", "nu", "trace"}
    with pytest.raises(ValueError, match=r"config names Adam \(chain"):
        train_state_from_flax(tree, _with_optimizer(meta, "Adam"))
    with pytest.raises(ValueError, match="config names optimizer 'Lion'"):
        train_state_from_flax(tree, _with_optimizer(meta, "Lion"))
    skewed = dict(tree, opt_state=[tree["opt_state"][0], None, {"count": np.asarray(9)}])
    with pytest.raises(ValueError, match=r"optax's counts disagree.*9"):
        train_state_from_flax(skewed, meta)
    with pytest.raises(ValueError, match=r"saved for 2 parameters, 1 are trained here"):
        buffers_in_order({"count": 1, "mu": {"a": 0, "b": 0}}, ["a"])


def test_writer_gives_back_the_jax_dino_checkpoint(tmp_path):
    """``train_state_to_flax`` and ``write_tree`` (what ``chip_smoke.py``
    writes on the card) of the port's state resumed from the JAX DINO
    checkpoint: orbax restores the JAX trainer's own tree, bit for bit.
    Other models and optimizers are refused by name."""
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint, train_state_to_flax
    from vit_ssl_tpu_torch.utils.orbax_tree import write_tree

    state, meta = load_checkpoint(str(FIXTURES / "dino_step1"))
    state["opt_state"] = buffers_in_order(state["opt_state"], list(state["student"]))
    write_tree(str(tmp_path / "tree"), train_state_to_flax(state, meta))
    got = jax.tree_util.tree_map(np.asarray, ocp.PyTreeCheckpointer().restore(
        str(tmp_path / "tree")))
    want, _ = _restored("dino_step1")
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    with pytest.raises(ValueError, match="AdamW's optax state only; the config names 'SGD'"):
        train_state_to_flax(state, _with_optimizer(meta, "SGD"))
    simmim = train_state_from_flax(*_restored("simmim"))
    with pytest.raises(ValueError, match="DINO train states only"):
        train_state_to_flax(simmim, _restored("simmim")[1])
