"""DINO's host multi-crop and the host data path around it, against the JAX
package, on ``tests/make_synthetic_data.py`` PNG folders:

- ``STL10DINODataset`` items, ``prepare_dataloaders(config, "dino")`` with
  ``data.device_augment=false`` (no workers and two) and ``"eval_dino"``
  (``eval.*`` over ``data.*``) against JAX's ``prepare_dataloaders(config,
  get_transforms(config), mode)``: every batch of two epochs, its views
  and weights, bit-equal (tolerance 0);
- ``data.native_decode=true``: ``native_batch`` taken (not refused) and
  its batches bit-equal to the per-sample path and to JAX's Python path;
  the gate (cache on, another pipeline, a file that fails) hands back to
  the per-sample path;
- one DINO step on the first batch of each package's loader, from the
  bridged weights (tiny width, fp32, dropout 0): loss at rtol 1e-5, the
  center at atol 1e-6, every parameter within 2·lr + 1e-5 and 99.5 % of
  its entries within 1e-5 + 1e-4·|w| (Adam divides by √v, so a few
  entries with tiny second moments move by up to lr on rounding alone);
- ``eval.mode`` ``eval_dino``: the JAX evaluator's pipelines fail on the
  multi-crop dataset with ``KeyError: 'globals'``; the port's evaluator
  refuses up front with that reason;
- the CLI ``python -m vit_ssl_tpu_torch.train --config-name dino
  data.device_augment=false`` at tiny width for one epoch, to its
  checkpoints, and ``data.native_decode=true`` with device augmentation;
- with ``cv2`` and ``PIL`` blocked: the decoder, every transform, the DINO
  host loader, ``native_batch`` and ``Server._decode`` of a PNG.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from make_synthetic_data import make
from vit_ssl_tpu.config import compose
from vit_ssl_tpu.data import prepare_dataloaders as jax_prepare_dataloaders
from vit_ssl_tpu.data.datasets import STL10DINODataset as JaxDINODataset
from vit_ssl_tpu.data.transforms import get_transforms as jax_get_transforms
from vit_ssl_tpu_torch.data import datasets
from vit_ssl_tpu_torch.data.builder import prepare_dataloaders
from vit_ssl_tpu_torch.data.transforms import get_transforms

REPO = Path(__file__).resolve().parent.parent
TINY = ["data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.output_dim=16", "training.batch_size=4", "training.warmup_epochs=1",
        "eval.interval=0", "data.num_workers=0", "model.dropout=0.0"]


def _start(args):
    """``python args...`` from the repo root, no card visible, two threads."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=150):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two folders: 22 unlabeled 24 px PNGs and 10 labeled 20 px ones."""
    root = tmp_path_factory.mktemp("multicrop")
    make(str(root / "a"), n=22, size=24, num_classes=2, seed=1)
    make(str(root / "b"), n=10, size=20, num_classes=2, seed=2)
    return root


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The subprocesses, started first so they run beside the other tests:
    the CLI on host views, the CLI with native_decode, the blocked run."""
    out = tmp_path_factory.mktemp("runs")
    common = ["-m", "vit_ssl_tpu_torch.train", "--config-name", "dino", "--device", "cpu",
              f"data.data_dir={data}/a/unlabeled_images", *TINY,
              "training.num_epochs=1", "training.plain_logging=true"]
    procs = {
        "host": _start(common + ["data.device_augment=false",
                                 f"hydra.run.dir={out / 'host'}"]),
        "native": _start(common + ["data.native_decode=true",
                                   f"hydra.run.dir={out / 'native'}"]),
        "blocked": _start(["-c", BLOCKED_RUN, str(data), str(out / "blocked")]),
    }
    yield out, procs
    for proc in procs.values():
        proc.kill()


def _config(data, *extra):
    return compose(str(REPO / "configs"), "dino", [
        f"data.data_dir={data}/a/unlabeled_images", "data.device_augment=false",
        *TINY, *extra])


def _assert_same_batches(port, jax_loader, epochs=(0, 1)):
    assert len(port) == len(jax_loader) > 0
    count = 0
    for epoch in epochs:
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        for got, want in zip(port, jax_loader):
            assert set(got) == set(want)
            for key in got:
                a, b = got[key], want[key]
                if isinstance(a, list):
                    assert len(a) == len(b)
                    for u, v in zip(a, b):
                        assert u.dtype == v.dtype and u.shape == v.shape
                        np.testing.assert_array_equal(u, v)
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            count += 1
    assert count == len(epochs) * len(port)
    return got


def test_dino_dataset_items_match_jax(data):
    config = _config(data)
    folder = f"{data}/a/unlabeled_images"
    port = datasets.STL10DINODataset(folder, get_transforms(config), 6, 2)
    ref = JaxDINODataset(folder, jax_get_transforms(config), 6, 2)
    assert port.files == ref.files and len(port) == 22 and port.num_global_views == 2
    for idx in (0, 5, 21):
        g_port, g_ref = np.random.default_rng((3, idx)), np.random.default_rng((3, idx))
        got, want = port.__getitem__(idx, g_port), ref.__getitem__(idx, g_ref)
        assert [v.shape for v in got] == [(16, 16, 3)] * 2 + [(8, 8, 3)] * 4
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)
        assert g_port.bit_generator.state == g_ref.bit_generator.state


@pytest.mark.parametrize("workers", [0, 2])
def test_dino_host_loaders_match_jax(data, workers):
    config = _config(data, f"data.num_workers={workers}")
    train, val = prepare_dataloaders(config, "dino")
    jax_train, jax_val = jax_prepare_dataloaders(config, jax_get_transforms(config), "dino")
    assert isinstance(train.dataset.dataset, datasets.STL10DINODataset)
    assert train.dataset.num_global_views == 2
    last = _assert_same_batches(train, jax_train)
    assert len(last["views"]) == 6 and last["views"][0].dtype == np.float32
    last = _assert_same_batches(val, jax_val)
    # 22 images at val_split 0.2: 4 val images, one full batch
    assert float(last["weight"].sum()) == 4.0


def test_eval_dino_loaders_match_jax(data):
    """``eval.data_dir`` wins over ``data.data_dir``; ``eval.dataset_name``
    and the transforms are the config's."""
    config = _config(data, f"eval.data_dir={data}/b/unlabeled_images",
                     "eval.dataset_name=stl10")
    train, val = prepare_dataloaders(config, "eval_dino")
    jax_train, jax_val = jax_prepare_dataloaders(config, jax_get_transforms(config),
                                                 "eval_dino")
    assert len(train.dataset) + len(val.dataset) == 10
    _assert_same_batches(train, jax_train)
    _assert_same_batches(val, jax_val)
    # a list of modes loads by its first, as JAX does
    train, _ = prepare_dataloaders(config, ["eval_dino", "eval_knn"])
    assert len(train.dataset) == 8


def _native_config(data, *extra):
    return _config(data, "data.device_augment=true", *extra)


def test_native_decode_batches_match_per_sample_and_jax(data, monkeypatch):
    calls = []
    native_batch = datasets.STL10UnsupervisedDataset.native_batch

    def counted(self, indices):
        out = native_batch(self, indices)
        calls.append((self.native_decode, out is not None))
        return out

    monkeypatch.setattr(datasets.STL10UnsupervisedDataset, "native_batch", counted)
    for workers in (0, 2):
        native = prepare_dataloaders(
            _native_config(data, "data.native_decode=true", f"data.num_workers={workers}"),
            "dino")
        per_sample = prepare_dataloaders(
            _native_config(data, f"data.num_workers={workers}"), "dino")
        config = _native_config(data, "data.native_decode=true",
                                f"data.num_workers={workers}")
        jax_loaders = jax_prepare_dataloaders(config, jax_get_transforms(config), "dino")
        for a, b, c in zip(native, per_sample, jax_loaders):
            calls.clear()
            last = _assert_same_batches(a, b)
            # the whole-batch path was taken, and only where it was asked for
            assert (True, True) in calls and all(asked == took for asked, took in calls)
            _assert_same_batches(a, c)
            assert last["image"].dtype == np.uint8 and last["image"].shape[1:] == (16, 16, 3)


def test_native_batch_gate(data, tmp_path):
    from vit_ssl_tpu_torch.data.transforms import Compose, Resize, ToTensor

    folder = f"{data}/a/unlabeled_images"
    resize = Compose([Resize([16, 16])])
    ok = datasets.STL10UnsupervisedDataset(folder, resize, native_decode=True)
    batch = ok.native_batch([3, 0, 7])
    assert [b.shape for b in batch] == [(16, 16, 3)] * 3
    for i, b in zip((3, 0, 7), batch):
        np.testing.assert_array_equal(b, ok[i])
    sub = datasets.Subset(ok, [5, 9, 2])
    np.testing.assert_array_equal(sub.native_batch([1])[0], ok[9])
    for gated in (datasets.STL10UnsupervisedDataset(folder, resize),
                  datasets.STL10UnsupervisedDataset(folder, resize, cache=True,
                                                    native_decode=True),
                  datasets.STL10UnsupervisedDataset(
                      folder, Compose([Resize([16, 16]), ToTensor()]), native_decode=True),
                  datasets.STL10UnsupervisedDataset(folder, Compose([Resize(16)]),
                                                    native_decode=True)):
        assert gated.native_batch([0, 1]) is None
    broken = tmp_path / "broken"
    broken.mkdir()
    for name in ("a.png", "b.png"):
        (broken / name).write_bytes((Path(folder) / sorted(os.listdir(folder))[0])
                                    .read_bytes()[:60])
    bad = datasets.STL10UnsupervisedDataset(str(broken), resize, native_decode=True)
    assert bad.native_batch([0, 1]) is None
    with pytest.raises(ValueError):
        bad[0]


def _jax_dino_step(batch, pack):
    from vit_ssl_tpu.models.dino import DINONetwork
    from vit_ssl_tpu.train.state import create_train_state
    from vit_ssl_tpu.train.steps import make_dino_steps
    from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch

    net = DINONetwork(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
                      num_heads=2, mlp_dim=64, dropout=0.0, output_dim=16)
    student = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(2)
    teacher = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32), student)
    center = rng.standard_normal((1, 16)).astype(np.float32)
    tx = optax.adamw(1e-3, weight_decay=1e-3)
    state = create_train_state(student, tx, jax.random.PRNGKey(1), teacher_params=teacher,
                               center=jnp.asarray(center))
    before = {k: np.asarray(v, np.float32) for k, v in dino_params_to_torch(
        state.params, state.teacher_params, state.center).items()}
    step, _ = make_dino_steps(net, tx, num_global_views=2, num_all_views=6,
                              student_temp=0.1, center_momentum=0.9, donate=False,
                              teacher_dropout=False, pack_locals=pack)
    state, out = step(state, {"views": [jnp.asarray(v) for v in batch["views"]],
                              "weight": jnp.asarray(batch["weight"])},
                      jnp.float32(0.04), jnp.float32(0.996))
    after = {k: np.asarray(v, np.float32) for k, v in dino_params_to_torch(
        state.params, state.teacher_params, state.center).items()}
    return before, after, float(out["loss"])


def test_dino_step_on_host_batches_matches_jax(data):
    from vit_ssl_tpu_torch.models import DINONetwork
    from vit_ssl_tpu_torch.train import AdamW, TrainState, make_dino_steps

    config = _config(data)
    port_batch = next(iter(prepare_dataloaders(config, "dino")[0]))
    jax_batch = next(iter(jax_prepare_dataloaders(config, jax_get_transforms(config),
                                                  "dino")[0]))
    before, after, jax_loss = _jax_dino_step(jax_batch, pack=True)
    net = DINONetwork(2, (3, 16, 16), 32, 8, 2, 64, dropout=0.0, output_dim=16)
    optimizer = AdamW(lambda count: 1e-3, weight_decay=1e-3)
    state = TrainState(net, optimizer, seed=0)
    state.load_model_state_dict({k: torch.from_numpy(v.copy()) for k, v in before.items()})
    step, _ = make_dino_steps(optimizer, 2, 6, student_temp=0.1, center_momentum=0.9,
                              teacher_dropout=False, pack_locals=True)
    out = step(state, {"views": [torch.from_numpy(v) for v in port_batch["views"]],
                       "weight": torch.from_numpy(port_batch["weight"])}, 0.04, 0.996)
    np.testing.assert_allclose(float(out["loss"]), jax_loss, rtol=1e-5)
    got = {k: v.detach().numpy() for k, v in state.model_state_dict().items()}
    assert set(got) == set(after)
    np.testing.assert_allclose(got["center"], after["center"].reshape(1, -1), atol=1e-6,
                               rtol=0)
    for key in sorted(set(after) - {"center"}):
        want = after[key].reshape(got[key].shape)
        diff = np.abs(got[key] - want)
        assert diff.max() <= 2e-3 + 1e-5, (key, diff.max())
        assert (diff <= 1e-5 + 1e-4 * np.abs(want)).mean() >= 0.995, key
    moved = [k for k in got if k.startswith("student_")
             and not np.array_equal(got[k], before[k].reshape(got[k].shape))]
    assert moved


def test_eval_dino_evaluation_fails_as_in_jax(data, tmp_path):
    """JAX's evaluator hands the multi-crop dataset its train/val pipelines:
    the first batch raises KeyError 'globals'. The port refuses before it
    loads a model, with that reason."""
    from vit_ssl_tpu.data.transforms import Compose, Resize, ToTensor
    from vit_ssl_tpu_torch.evaluators.unsupervised_evaluator import run_evaluation

    config = _config(data, "eval.mode=eval_dino", f"eval.data_dir={data}/b/unlabeled_images",
                     "eval.dataset_name=stl10")
    pipeline = Compose([Resize([16, 16]), ToTensor()])
    train, _ = jax_prepare_dataloaders(config, {"train": pipeline, "val": pipeline},
                                       "eval_dino")
    with pytest.raises(KeyError, match="globals"):
        next(iter(train))
    with pytest.raises(ValueError, match=r"eval_dino.*'globals'.*KeyError: 'globals'"):
        run_evaluation(config, save_path=str(tmp_path / "eval"), device="cpu")


def _meta(run, name):
    with open(os.path.join(run, name, "metadata.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("run", ["host", "native"])
def test_cli_trains_one_epoch(runs, run):
    out_dir, procs = runs
    out = _finish(procs[run])
    assert out.returncode == 0, out.stderr[-3000:]
    path = str(out_dir / run)
    for name in ("best_model/state.pt", "last_model/state.pt", ".hydra/config.yaml"):
        assert os.path.exists(os.path.join(path, name)), name
    meta = _meta(path, "last_model")
    assert meta["epoch"] == 1 and meta["mode"] == "dino"
    assert meta["config"]["data"]["device_augment"] is (run == "native")
    assert meta["config"]["data"].get("native_decode", False) is (run == "native")
    assert "[epoch 1] val:" in out.stdout
    if run == "host":
        assert "Device-side multi-crop" not in out.stderr


BLOCKED_RUN = """
import sys
for name in ("cv2", "PIL"):
    sys.modules[name] = None
import numpy as np
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.data import png, transforms
from vit_ssl_tpu_torch.data.builder import prepare_dataloaders
from vit_ssl_tpu_torch.data.datasets import STL10UnsupervisedDataset, _load_image
from vit_ssl_tpu_torch.serve import Server, make_pipeline

data, out = sys.argv[1], sys.argv[2]
folder = data + "/a/unlabeled_images"
config = compose("configs", "dino", ["data.data_dir=" + folder,
                                     "data.device_augment=false", "data.img_size=16",
                                     "data.local_img_size=8", "training.batch_size=4",
                                     "data.num_workers=2"])
dataset = STL10UnsupervisedDataset(folder)
image = png.decode(dataset.files[0])
specs = [("Resize", {"size": [10, 30]}), ("CenterCrop", {"size": 8}),
         ("RandomCrop", {"size": 8, "padding": 2}), ("RandomResizedCrop", {"size": 12}),
         ("RandomHorizontalFlip", {"p": 1.0}), ("ColorJitter", {"hue": 0.3}),
         ("RandomGrayscale", {"p": 1.0}), ("GaussianBlur", {"kernel_size": 5}),
         ("ToTensor", {}), ("Normalize", {"mean": [0.5] * 3, "std": [0.2] * 3})]
assert sorted(n for n, _ in specs) == sorted(transforms.TRANSFORM_REGISTRY)
for name, params in specs:
    transforms.build_transform(name, params)(image, np.random.default_rng(0))
train, val = prepare_dataloaders(config, "dino")
batch = next(iter(train))
assert len(batch["views"]) == 6 and batch["views"][2].shape == (4, 8, 8, 3)
native = STL10UnsupervisedDataset(folder, transforms.Compose([transforms.Resize([16, 16])]),
                                  native_decode=True)
assert len(native.native_batch([0, 1, 2])) == 3
server = Server.__new__(Server)
server.pipeline = make_pipeline(16)
assert server._decode(dataset.files[1]).shape == (16, 16, 3)
np.testing.assert_array_equal(_load_image(dataset.files[1]), png.decode(dataset.files[1]))
loaded = sorted(m for m in ("cv2", "PIL") if sys.modules.get(m) is not None)
print("OK", loaded)
"""


def test_host_path_runs_without_cv2_and_pil(runs):
    _, procs = runs
    out = _finish(procs["blocked"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK []"
