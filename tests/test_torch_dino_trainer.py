"""The port's DINO trainer and loader against the JAX package's, on the CPU.

- ``DataLoader``: the same per-epoch index order, padding and weights as
  the JAX loader for a seed, with and without a process shard.
- ``DINOTrainer``: both trainers at a tiny width (2 blocks, embed 32, patch
  8, 16 px globals and 8 px packed locals, fp32, dropout 0) from the same
  weights (bridged with ``dino_state_dict_from_flax``), fed one in-test
  loader of host views made with numpy: ``fit(2)`` with 2 train batches and
  1 val batch an epoch, with epoch- and step-granular schedules. Attention
  takes each package's default route at these shapes (JAX's XLA path, the
  port's plain version on the CPU).
- Resume: ``fit(1)``, save, resume, ``fit(1)`` equals ``fit(2)`` bit for
  bit, and the epoch-1 snapshot written while epoch 2 trains holds epoch
  1's state.
- Each refusal names its ``ROADMAP.md`` queue-A item; the options ported
  since (preemption's ``training.auto_resume`` and
  ``training.fault_inject_preempt_step``, ``parallel.remat``, the
  automatic evaluation, the supervised and
  finetune modes, the evaluators' datasets, the Adam, SGD and RMSprop
  optimizers, the Accuracy metric) run instead.
"""

import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.data.loader import DataLoader as JaxDataLoader
from vit_ssl_tpu.models.builder import build_model as jax_build_model
from vit_ssl_tpu.train.trainers import base as jax_trainer_base
from vit_ssl_tpu.train.trainers.dino import DINOTrainer as JaxDINOTrainer
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.data.builder import eval_pipeline, make_loaders, prepare_dataloaders
from vit_ssl_tpu_torch.data.datasets import Dataset, STL10UnsupervisedDataset
from vit_ssl_tpu_torch.data.loader import DataLoader
from vit_ssl_tpu_torch.models.builder import build_dino_network
from vit_ssl_tpu_torch.train.__main__ import check_mode
from vit_ssl_tpu_torch.train.state import make_optimizer
from vit_ssl_tpu_torch.train.trainers import DINOTrainer
from vit_ssl_tpu_torch.train.trainers import base as trainer_base
from vit_ssl_tpu_torch.utils.checkpoint import dino_state_dict_from_flax, load_checkpoint
from vit_ssl_tpu_torch.utils.metrics import MetricHandler

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
B = 4
TINY = ["data.img_size=16", "data.local_img_size=8", "data.device_augment=false",
        "model.embed_dim=32", "model.num_heads=2", "model.num_blocks=2",
        "model.mlp_dim=64", "model.patch_size=8", "model.output_dim=16",
        "model.dropout=0.0", "model.compute_dtype=float32",
        f"training.batch_size={B}", "training.num_epochs=2",
        "training.warmup_epochs=1", "training.plain_logging=true",
        "eval.interval=0"]
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5


class _Items(Dataset):
    """n integers, so a loader's batches show its index order."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        return np.full((2, 2, 3), idx, np.uint8)


@pytest.mark.parametrize("shard", [None, (1, 2)], ids=["one_process", "shard_1_of_2"])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_matches_jax(shard, workers):
    """Per epoch: the same shuffled index order, the last short batch
    padded with copies of its first sample at weight 0."""
    ours = DataLoader(_Items(11), 4, shuffle=True, num_workers=workers, seed=5,
                      process_shard=shard)
    theirs = JaxDataLoader(_Items(11), 4, shuffle=True, num_workers=workers,
                           seed=5, process_shard=shard)
    assert len(ours) == len(theirs) == 3
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"image", "weight"}
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["weight"], b["weight"])
        assert got[-1]["weight"].sum() < len(got[-1]["weight"])
    ours.set_epoch(1)
    orders = [b["image"][:, 0, 0, 0].tolist() for b in ours]
    ours.set_epoch(2)
    assert orders != [b["image"][:, 0, 0, 0].tolist() for b in ours]


class HostViews:
    """``n`` batches of host views (2 globals of 16 px, 4 locals of 8 px)
    and weights, drawn with numpy from (seed, epoch)."""

    def __init__(self, n, seed, weights):
        self.n, self.seed, self.weights, self.epoch = n, seed, weights, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for i in range(self.n):
            views = ([rng.random((B, 16, 16, 3), np.float32) for _ in range(2)]
                     + [rng.random((B, 8, 8, 3), np.float32) for _ in range(4)])
            yield {"views": views, "weight": np.asarray(self.weights[i], np.float32)}


def _loaders():
    return (HostViews(2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]]),
            HostViews(1, 8, [[1, 1, 0, 0]]))


def _overrides(granular):
    return TINY + [f"training.step_granular_schedules={str(granular).lower()}"]


@pytest.fixture(scope="module")
def jax_compiled():
    """What both granularities' JAX trainers share (the architecture, the
    seed and the step programs; the schedules only change the step's
    arguments): the initial trees, drawn once by one jitted program rather
    than op by op, and the first trainer's compiled train and eval steps."""
    return {}


def _jax_fit(tmp, granular, monkeypatch, cache):
    """The JAX trainer's fit(2), its starting state, and the metadata of each
    checkpoint it wrote (its orbax writes are skipped: only the metadata is
    compared)."""
    config = jax_compose(CONFIGS, "dino", _overrides(granular))
    train, val = _loaders()
    bundle = jax_build_model(config)
    own_init = bundle.init_fn

    def init_fn(rng):
        if "trees" not in cache:
            cache["trees"] = jax.jit(own_init)(rng)
        return cache["trees"]

    bundle.init_fn = init_fn
    trainer = JaxDINOTrainer(bundle, str(tmp), config, train, val, None)
    if "steps" in cache:
        trainer.train_step, trainer.eval_step = cache["steps"]
    cache["steps"] = trainer.train_step, trainer.eval_step
    start = jax.device_get(trainer.state)
    written = {}
    monkeypatch.setattr(jax_trainer_base, "save_checkpoint",
                        lambda path, tree, metadata: written.__setitem__(
                            os.path.basename(path), metadata))
    trainer.fit(2)
    return trainer, start, written


def _port_trainer(tmp, granular=False, extra=()):
    config = compose(CONFIGS, "dino", _overrides(granular) + list(extra))
    train, val = _loaders()
    return DINOTrainer(build_dino_network(config, "cpu"), str(tmp), config, train,
                       val, "cpu")


def _meta(path, name):
    with open(os.path.join(path, name, "metadata.json")) as f:
        return json.load(f)


@pytest.fixture
def no_plots(monkeypatch):
    """The end-of-fit metric plots (matplotlib PNGs, compared nowhere
    here) are skipped on both sides; the CLI test draws them. The port's
    fits use two CPU threads (the suite runs beside other workers)."""
    from vit_ssl_tpu.utils.history import TrainingHistory as JaxHistory
    from vit_ssl_tpu_torch.utils.history import TrainingHistory

    for cls in (JaxHistory, TrainingHistory):
        monkeypatch.setattr(cls, "vizualize", lambda self, num_epochs=None: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("granular", [False, True], ids=["epoch", "step"])
def test_dino_trainer_matches_jax(tmp_path, granular, no_plots, monkeypatch,
                                  jax_compiled):
    """Per-epoch train and val metrics at rtol 1e-4; the center and every
    student and teacher tensor at the end at rtol 1e-4, with an absolute
    floor of 1e-5 (a tenth of the peak lr): Adam divides each gradient entry
    by its own RMS, so an entry whose gradient is float noise in both
    frameworks moves by a different fraction of lr in each (measured: 2 of
    the head's 4.2M entries off by 2.4e-6). The best epoch, the metadata
    epochs and the step count equal, best_val_score at rtol 1e-4."""
    theirs, start, jax_meta = _jax_fit(tmp_path / "jax", granular, monkeypatch,
                                       jax_compiled)
    ours = _port_trainer(tmp_path / "port", granular)
    ours.state.load_model_state_dict(dino_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, start.params),
        jax.tree_util.tree_map(np.asarray, start.teacher_params),
        np.asarray(start.center)))
    ours.fit(2)

    assert set(ours.history.history) == set(theirs.history.history)
    for key, want in theirs.history.history.items():
        np.testing.assert_allclose(ours.history.history[key], want,
                                   rtol=METRIC_RTOL, err_msg=key)
    want_sd = dino_params_to_torch(theirs.state.params, theirs.state.teacher_params,
                                   theirs.state.center)
    got_sd = ours.state.model_state_dict()
    assert set(got_sd) == set(want_sd)
    for key, want in want_sd.items():
        got = got_sd[key].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32).reshape(got.shape),
                                   rtol=METRIC_RTOL, atol=PARAM_ATOL, err_msg=key)
    assert ours.state.step == int(theirs.state.step) == 4
    for name in ("best_model", "last_model"):
        mine, want = _meta(tmp_path / "port", name), jax_meta[name]
        assert mine["epoch"] == want["epoch"]
        assert mine["mode"] == want["mode"] == "dino"
        assert mine["config"]["model"] == want["config"]["model"]
    assert _meta(tmp_path / "port", "last_model")["epoch"] == 2
    best = _meta(tmp_path / "port", "best_model")["best_val_score"]
    assert best == pytest.approx(jax_meta["best_model"]["best_val_score"],
                                 rel=METRIC_RTOL)
    assert ours.best_score == best


def _trees_equal(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _trees_close(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=METRIC_RTOL, atol=PARAM_ATOL, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _trees_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_close(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_resume_is_bit_exact_and_snapshots_are_complete(tmp_path, monkeypatch,
                                                        no_plots):
    """fit(1), save, resume and fit(1) give fit(2)'s state bit for bit on
    the CPU; and the epoch-1 ``last_model``, written while epoch 2 trains
    (its write held back here), holds epoch 1's state, not a later one.
    The fit(2) run also has ``training.profile`` on: a torch.profiler trace
    of its second epoch lands under ``<run>/profile``."""
    first = _port_trainer(tmp_path / "a")
    first.fit(1)
    after_one = trainer_base.to_host(first.state.state_dict())

    written = []
    save = trainer_base.save_checkpoint

    def slow_save(path, tree, metadata):
        if metadata["epoch"] == 1 and path.endswith("last_model"):
            time.sleep(0.2)  # epoch 2's steps run meanwhile
        written.append((os.path.basename(path), metadata["epoch"],
                        trainer_base.to_host(tree)))
        save(path, tree, metadata)

    monkeypatch.setattr(trainer_base, "save_checkpoint", slow_save)
    both = _port_trainer(tmp_path / "b", extra=["+training.profile=true"])
    both.fit(2)
    monkeypatch.setattr(trainer_base, "save_checkpoint", save)
    trace = tmp_path / "b" / "profile" / "trace_epoch_2.json"
    assert json.loads(trace.read_text())["traceEvents"]
    epoch_one = [tree for name, epoch, tree in written
                 if name == "last_model" and epoch == 1]
    assert len(epoch_one) == 1
    _trees_equal(epoch_one[0], after_one)

    resumed = _port_trainer(tmp_path / "c")
    resumed.resume_from(str(tmp_path / "a" / "last_model"))
    assert resumed.start_epoch == 1
    assert resumed.best_score == first.best_score
    _trees_equal(trainer_base.to_host(resumed.state.state_dict()), after_one)
    resumed.fit(1)
    _trees_equal(trainer_base.to_host(resumed.state.state_dict()),
                 trainer_base.to_host(both.state.state_dict()))
    tree, meta = load_checkpoint(str(tmp_path / "c" / "last_model"))
    assert meta["epoch"] == 2 and tree["step"] == 4
    assert resumed.history.history["train_Loss"] == both.history.history["train_Loss"][1:]


REFUSALS = [
    (["training.auto_resume=true"], None),  # ported: see below
    (["training.fault_inject_preempt_step=3"], None),  # ported: see below
    (["parallel.tp=2"], None),  # ported: see below
    (["parallel.pp=2"], None),  # ported: see below
    (["parallel.sp=2"], None),  # ported: see below
    (["parallel.ep=2", "model.moe_experts=2"], None),  # ported: see below
    (["parallel.fsdp=true"], None),  # ported: see below
    (["+parallel.multihost=true"], None),  # ported: see below
    (["eval.interval=1"], None),  # ported: see below
    (["parallel.remat=true"], None),  # ported: see below
    (["+training.grad_accum_steps=2"], None),  # ported: see below
]


@pytest.mark.parametrize("overrides,item", REFUSALS,
                         ids=[o[0].split("=")[0].lstrip("+") for o, _ in REFUSALS])
def test_trainer_refusals_name_their_item(tmp_path, overrides, item, no_plots):
    """Each refused option names its item; an option ported since (item
    None) trains: ``parallel.remat`` checkpoints the student's blocks and
    gives fit(1)'s state bit for bit; ``eval.interval=1`` evaluates the
    teacher after epoch 1 (all three of the config's modes, over in-memory
    labeled images) into ``epoch_1/`` and gives fit(1)'s state bit for bit,
    every module's train flag as it was; ``training.grad_accum_steps=2``
    accumulates over two microbatches and gives fit(1)'s state up to the
    order of fp32 sums (rtol 1e-4, floor 1e-5, as against JAX);
    ``training.auto_resume`` with no preempt_model fits the config's 2
    epochs through the CLI's flow, bit-equal to fit(2);
    ``training.fault_inject_preempt_step=3`` (2 train batches an epoch)
    stops fit(2) at epoch 2 after 1 batch, and a trainer auto-resumed from
    the preempt_model it saves ends bit-equal to fit(2) and removes it
    (every mode: ``tests/test_torch_preempt.py``); ``parallel.sp=2`` trains
    over two gloo processes, the globals at 24 px (N = 10) ringing over both,
    and ends as one process's fit(1) within the trainer's bars;
    ``parallel.fsdp`` (dp = 1 without a process group: nothing to shard, as
    in JAX) and ``parallel.multihost`` (read by the entry point only) give
    fit(1)'s state bit for bit (across processes:
    ``tests/test_torch_parallel_cli.py``); ``parallel.tp=2``,
    ``parallel.ep=2`` and ``parallel.pp=2`` pass the trainer's refusal, and
    in one process the mesh refuses a world of 1 that they do not divide, as
    JAX's does (their runs over processes:
    ``tests/test_torch_{tensor,expert}_parallel_cli.py``,
    ``tests/test_torch_pipeline{,_modes}_cli.py``)."""
    if overrides == ["parallel.sp=2"]:
        from torch_dist_worker import dino_fit, spawn

        grown = TINY + ["data.img_size=24"]
        spawn("dino_fit", 2, tmp_path / "sp", *grown, *overrides, timeout=180)
        got = torch.load(tmp_path / "sp" / "dino_fit.pt", weights_only=True)
        _trees_close(got, dino_fit(grown, tmp_path / "plain"))
        return
    if overrides[0].startswith(("parallel.tp", "parallel.ep", "parallel.pp")):
        config = compose(CONFIGS, "dino", _overrides(False) + overrides)
        trainer_base.refuse_unported_training(config)
        with pytest.raises(ValueError, match="to divide the 1 visible devices"):
            _port_trainer(tmp_path, extra=overrides)
        return
    if overrides[0].startswith(("training.auto_resume", "training.fault_inject")):
        from vit_ssl_tpu_torch.train.__main__ import fit_with_preemption
        from vit_ssl_tpu_torch.utils.preempt import PreemptionRequested, clear_preemption

        run = tmp_path / "on"
        trainer = _port_trainer(run, extra=overrides)
        if overrides[0].startswith("training.fault_inject"):
            with pytest.raises(PreemptionRequested) as exc:
                trainer.fit(2)
            clear_preemption()
            assert (exc.value.epoch, exc.value.batches_done) == (2, 1)
            trainer.save_preempt(exc.value)
            assert _meta(run, "preempt_model")["preempt_batches_done"] == 1
            trainer = _port_trainer(run, extra=["training.auto_resume=true"])
        fit_with_preemption(trainer, trainer.config, str(run))
        assert not (run / "preempt_model").exists()
        plain = _port_trainer(tmp_path / "off")
        plain.fit(2)
        _trees_equal(trainer_base.to_host(trainer.state.state_dict()),
                     trainer_base.to_host(plain.state.state_dict()))
        return
    if item is None:
        trainer = _port_trainer(tmp_path / "on", extra=overrides)
        if overrides == ["eval.interval=1"]:
            trainer.eval_loaders = _labeled_loaders(trainer.config)
            flags = [m.training for m in trainer.state.teacher.modules()]
        trainer.fit(1)
        plain = _port_trainer(tmp_path / "off")
        assert not plain.state.student.backbone.remat
        plain.fit(1)
        got = trainer_base.to_host(trainer.state.state_dict())
        want = trainer_base.to_host(plain.state.state_dict())
        if overrides == ["parallel.remat=true"]:
            assert trainer.state.student.backbone.remat
            _trees_equal(got, want)
        elif overrides in (["parallel.fsdp=true"], ["+parallel.multihost=true"]):
            _trees_equal(got, want)
        elif overrides == ["eval.interval=1"]:
            _trees_equal(got, want)
            assert [m.training for m in trainer.state.teacher.modules()] == flags
            for name in ("evaluation_summary.csv", "evaluation_summary.txt",
                         "umap_feature_quality_results.csv"):
                assert (tmp_path / "on" / "epoch_1" / name).exists(), name
            assert not (tmp_path / "off" / "epoch_1").exists()
        else:
            _trees_close(got, want)
        return
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md queue A item {item}\b"):
        _port_trainer(tmp_path, extra=overrides)


class _Labeled(Dataset):
    """n seeded 16-px images through the evaluators' host pipeline, with
    labels of 4 classes."""

    def __init__(self, n):
        rng = np.random.default_rng(21)
        self.images = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
        self.labels = np.arange(n) % 4
        self.pipeline = eval_pipeline(16)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.pipeline(self.images[idx]), int(self.labels[idx])


def _labeled_loaders(config):
    return make_loaders(config, _Labeled(40))


def test_eval_interval_that_never_fires_runs(tmp_path):
    """eval.interval=5 on a 2-epoch run never reaches an evaluation."""
    trainer = _port_trainer(tmp_path, extra=["eval.interval=5"])
    assert trainer.eval_interval == 5


@pytest.mark.parametrize("mode,item", [("supervised", None), ("finetune", None),
                                       ("simmim", None)])
def test_other_training_modes_name_their_item(mode, item, tmp_path):
    """Supervised, finetune and SimMIM (ported since, item None) are taken,
    and their loaders built: labeled batches, or SimMIM's unlabeled images
    through its host pipeline (``configs/simmim/train_transforms.yaml``)."""
    if item is None:
        from make_synthetic_data import make

        data = make(str(tmp_path), n=10, size=8, num_classes=2)
        check_mode(mode)
        if mode == "simmim":
            config = compose(CONFIGS, mode, [f"data.data_dir={data}/unlabeled_images",
                                             "data.img_size=8", "data.num_workers=0",
                                             "training.batch_size=4"])
            keys, image = {"image", "weight"}, (4, 8, 8, 3)
        else:
            config = compose(CONFIGS, mode, [f"data.data_dir={data}/train_images",
                                             f"data.data_csv={data}/train_labels.json",
                                             "data.num_workers=0", "training.batch_size=4"])
            keys, image = {"image", "label", "weight"}, None
        train, val = prepare_dataloaders(config, mode)
        batch = next(iter(train))
        assert set(batch) == keys
        assert (len(train.dataset), len(val.dataset)) == (8, 2)
        if image:
            assert batch["image"].shape == image and batch["image"].dtype == np.float32
        return
    with pytest.raises(NotImplementedError, match=rf"queue A item {item}\b"):
        check_mode(mode)
    config = compose(CONFIGS, mode)
    with pytest.raises(NotImplementedError, match=rf"queue A item {item}\b"):
        prepare_dataloaders(config, mode)


def test_host_data_refusals_name_their_item(tmp_path):
    """The host multi-crop and the native decoder name their item; the
    evaluators' datasets (ported since) load ``eval.*``'s labeled images,
    a list of modes by its first, through Resize and ToTensor."""
    from make_synthetic_data import make

    config = compose(CONFIGS, "dino", ["data.device_augment=false"])
    with pytest.raises(NotImplementedError, match=r"device_augment.*queue A item 11\b"):
        prepare_dataloaders(config, "dino")
    with pytest.raises(NotImplementedError, match=r"native_decode.*queue A item 11\b"):
        STL10UnsupervisedDataset(str(tmp_path), native_decode=True)
    data = make(str(tmp_path / "synth"), n=10, size=20, num_classes=2)
    config = compose(CONFIGS, "dino", [f"eval.data_dir={data}/train_images",
                                       f"eval.data_csv={data}/train_labels.json",
                                       "data.img_size=16", "data.num_workers=0",
                                       "training.batch_size=4"])
    train, val = prepare_dataloaders(config, ["eval_knn", "eval_umap"])
    batch = next(iter(train))
    assert set(batch) == {"image", "label", "weight"}
    assert batch["image"].shape == (4, 16, 16, 3) and batch["image"].dtype == np.float32
    assert float(batch["image"].max()) <= 1.0
    assert (len(train.dataset), len(val.dataset)) == (8, 2)


@pytest.mark.parametrize("name,item", [("Adam", None), ("SGD", None), ("RMSprop", None)])
def test_other_optimizers_name_their_item(name, item):
    """Ported since (item None): each name builds its optimizer
    (``tests/test_torch_optimizers.py`` holds them to optax); an unknown
    name still raises."""
    config = compose(CONFIGS, "dino", [f"training.optimizer.name={name}"])
    assert item is None
    optimizer = make_optimizer(config, lambda step: 1e-3)
    assert type(optimizer).__name__ == name
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer(compose(CONFIGS, "dino", ["training.optimizer.name=Lion"]),
                       lambda step: 1e-3)


@pytest.mark.parametrize("metric,item", [("Accuracy", None), ("PSNR", None)])
def test_other_metrics_name_their_item(metric, item):
    """Accuracy and PSNR (ported since, item None) compute; an unknown name
    still raises."""
    if item is None:
        handler = MetricHandler({"metrics": [metric]})
        got = handler.calculate_metrics(correct=3, total=4, psnr_sse=1.0,
                                        psnr_count=100.0)
        assert got == {metric: 0.75 if metric == "Accuracy" else pytest.approx(20.0)}
        with pytest.raises(ValueError, match="Unknown metric"):
            MetricHandler({"metrics": [metric + "x"]})
        return
    with pytest.raises(NotImplementedError, match=rf"queue A item {item}\b"):
        MetricHandler({"metrics": [metric]})


def test_make_loaders_splits_as_jax_builder():
    """The seeded split: val gets int(total · val_split) images, train the
    rest, both Subsets of a permutation from training.random_seed; the
    train loader shuffles, the val loader does not."""
    config = compose(CONFIGS, "dino", ["training.batch_size=8", "data.num_workers=0"])
    train, val = make_loaders(config, _Items(50))
    perm = np.random.default_rng(int(config.training.random_seed)).permutation(50)
    assert train.dataset.indices == list(perm[:40])
    assert val.dataset.indices == list(perm[40:])
    assert train.shuffle and not val.shuffle
    assert (len(train), len(val)) == (5, 2)
    train_only, none = make_loaders(compose(CONFIGS, "dino", ["data.val_split=0"]),
                                    _Items(50))
    assert none is None and len(train_only.dataset) == 50
