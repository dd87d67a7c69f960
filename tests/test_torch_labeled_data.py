"""The port's labeled datasets, host transforms and supervised data builder
against the JAX package's, on the CPU, over the files
``tests/make_synthetic_data.py`` writes.

- ``STL10Dataset`` (JSON index), ``CIFAR10Dataset`` (CSV index) and
  ``ImageFolderDataset``: the same classes, the same items (image and
  label) bit for bit, with a host pipeline and without.
- ``RandomResizedCrop`` and ``RandomHorizontalFlip`` from the same numpy
  generator, alone and through ``build_pipeline``: the same pixels.
- ``prepare_dataloaders`` for supervised and finetune, with and without
  ``data.device_augment``: the same split, batches and weights.
- The label-range check and the refusals that stay.
"""

import os
import shutil

import numpy as np
import pytest

from make_synthetic_data import make
from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.data import datasets as jax_datasets
from vit_ssl_tpu.data import transforms as jax_transforms
from vit_ssl_tpu.data.builder import prepare_dataloaders as jax_prepare_dataloaders
from vit_ssl_tpu_torch.config import ConfigValidationError, compose
from vit_ssl_tpu_torch.data import datasets, transforms
from vit_ssl_tpu_torch.data.builder import prepare_dataloaders

TRAIN = [{"name": "RandomResizedCrop", "params": {"size": 16, "scale": [0.5, 1.0]}},
         {"name": "RandomHorizontalFlip", "params": {}},
         {"name": "ToTensor"}]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = make(str(tmp_path_factory.mktemp("synth")), n=12, size=24, num_classes=3)
    folder = os.path.join(path, "folder")
    for i, name in enumerate(sorted(os.listdir(os.path.join(path, "train_images")))):
        cls = os.path.join(folder, f"class_{i % 3}")
        os.makedirs(cls, exist_ok=True)
        shutil.copy(os.path.join(path, "train_images", name), cls)
    return path


def _assert_items_equal(ours, theirs, n_seeds=2):
    assert len(ours) == len(theirs)
    assert list(ours.classes) == list(theirs.classes)
    for idx in range(len(ours)):
        for seed in range(n_seeds):
            a = ours.__getitem__(idx, np.random.default_rng((seed, idx)))
            b = theirs.__getitem__(idx, np.random.default_rng((seed, idx)))
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])


def _datasets(root, pipeline):
    ours = transforms.build_pipeline(pipeline) if pipeline else None
    theirs = jax_transforms.build_pipeline(pipeline) if pipeline else None
    return {
        "stl10": (datasets.STL10Dataset(f"{root}/train_labels.json",
                                        f"{root}/train_images", ours),
                  jax_datasets.STL10Dataset(f"{root}/train_labels.json",
                                            f"{root}/train_images", theirs)),
        "cifar10": (datasets.CIFAR10Dataset(f"{root}/cifar_labels.csv",
                                            f"{root}/cifar_images", ours),
                    jax_datasets.CIFAR10Dataset(f"{root}/cifar_labels.csv",
                                                f"{root}/cifar_images", theirs)),
        "imagefolder": (datasets.ImageFolderDataset(f"{root}/folder", ours),
                        jax_datasets.ImageFolderDataset(f"{root}/folder", theirs)),
    }


@pytest.mark.parametrize("pipeline", [None, TRAIN], ids=["decoded", "train_pipeline"])
@pytest.mark.parametrize("name", ["stl10", "cifar10", "imagefolder"])
def test_dataset_matches_jax(root, name, pipeline):
    ours, theirs = _datasets(root, pipeline)[name]
    _assert_items_equal(ours, theirs)


def test_csv_index_types_columns_as_pandas(tmp_path):
    """A CSV column of integers holds ints (file stems and classes), as
    pandas reads it; a mixed column stays text."""
    path = tmp_path / "labels.csv"
    path.write_text("id,label\n7,3\n12,1\n5,3\n")
    rows = datasets._read_csv_rows(str(path))
    assert rows == [(7, 3), (12, 1), (5, 3)]
    ds = datasets.CIFAR10Dataset(str(path), str(tmp_path))
    assert ds.classes == [1, 3] and ds._path(7).endswith("7.png")
    path.write_text("id,label\na7,x\n12,y\n")
    assert datasets._read_csv_rows(str(path)) == [("a7", "x"), ("12", "y")]


@pytest.mark.parametrize("op", [TRAIN[0], TRAIN[1],
                                {"name": "RandomResizedCrop",
                                 "params": {"size": [12, 20], "scale": [0.08, 0.2]}}])
def test_random_transforms_match_jax(op):
    img = np.random.default_rng(3).integers(0, 256, (24, 30, 3), dtype=np.uint8)
    for seed in range(20):
        ours = transforms.build_transform(op["name"], op["params"])(
            img, np.random.default_rng(seed))
        theirs = jax_transforms.build_transform(op["name"], op["params"])(
            img, np.random.default_rng(seed))
        np.testing.assert_array_equal(ours, theirs)


def _overrides(root, device_augment, mode):
    return [f"data.data_dir={root}/train_images", f"data.data_csv={root}/train_labels.json",
            "data.img_size=16", "data.num_workers=0", "training.batch_size=4",
            "model.num_classes=3", f"data.device_augment={str(device_augment).lower()}",
            f"training.type={mode}"]


@pytest.mark.parametrize("device_augment", [False, True], ids=["host", "device_augment"])
@pytest.mark.parametrize("mode", ["supervised", "finetune"])
def test_prepare_dataloaders_matches_jax(root, mode, device_augment):
    overrides = _overrides(root, device_augment, mode)
    config = compose("configs", mode, overrides)
    jax_config = jax_compose("configs", mode, overrides)
    ours = prepare_dataloaders(config, mode)
    theirs = jax_prepare_dataloaders(jax_config,
                                     jax_transforms.get_transforms(jax_config), mode)
    for a, b in zip(ours, theirs):
        assert a.dataset.indices == b.dataset.indices
        assert a.shuffle == b.shuffle
        a.set_epoch(1)
        b.set_epoch(1)
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            assert set(x) == set(y) == {"image", "label", "weight"}
            for key in x:
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key])
    dtype = np.uint8 if device_augment else np.float32
    assert got[0]["image"].dtype == dtype


def test_label_range_and_remaining_refusals(root):
    config = compose("configs", "supervised",
                     _overrides(root, True, "supervised") + ["model.num_classes=2"])
    with pytest.raises(ConfigValidationError, match="3 classes"):
        prepare_dataloaders(config, "supervised")
    jitter = transforms.build_transform("ColorJitter", {"brightness": 0.4, "hue": 0.1})
    ref = jax_transforms.build_transform("ColorJitter", {"brightness": 0.4, "hue": 0.1})
    image = np.random.default_rng(0).integers(0, 256, (12, 14, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jitter(image, np.random.default_rng(1)),
                                  ref(image, np.random.default_rng(1)))
    with pytest.raises(ValueError, match="Unknown transform"):
        transforms.build_transform("Solarize", {})
    config = compose("configs", "supervised",
                     _overrides(root, True, "supervised") + ["data.dataset_name=mnist"])
    with pytest.raises(ValueError, match="Unknown supervised/labeled dataset"):
        prepare_dataloaders(config, "supervised")
