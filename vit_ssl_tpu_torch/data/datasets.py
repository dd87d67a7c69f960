"""Datasets (from ``vit_ssl_tpu/data/datasets.py``): the base ``Dataset``, the
decoder and its cache, the labeled datasets (``CIFAR10Dataset``,
``STL10Dataset``, ``ImageFolderDataset``), the unlabeled STL-10 folder and
``Subset``.

Datasets return numpy arrays (uint8 HWC after the device-augment pipeline's
decode and resize, float32 after a host ``ToTensor``) and, when labeled,
int labels; the loader stacks them into NHWC batches. OpenCV is imported
inside :func:`_load_image`, so a dataset held in memory needs none.

The labeled indexes are read as the JAX package's pandas reads them, with
``csv`` and ``json``: the first column is the file, the second the class;
the classes are the sorted distinct values of the second column (numbers
when every value of a CSV column is an integer, as pandas infers them), and
a label is its class's index.

Not ported yet: the host multi-crop ``STL10DINODataset`` and the native
batch decoder (``csrc/fastloader``, which links OpenCV): ``ROADMAP.md``
queue A item 11.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


def _load_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC with OpenCV; PIL for what OpenCV cannot
    read."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:  # pragma: no cover - corrupt/unsupported file
        from PIL import Image

        with Image.open(path) as pil:
            return np.asarray(pil.convert("RGB"))
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class _DecodeCache:
    """Optional in-memory decoded-sample cache (``data.cache_decoded``).

    When the dataset's pipeline is deterministic (the device-augment
    contract: decode and resize), the post-transform sample is cached, so
    later epochs pay neither decode nor resize; a random pipeline caches
    the raw decode."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._store: Dict[str, np.ndarray] = {}

    def load(self, path: str) -> np.ndarray:
        if not self.enabled:
            return _load_image(path)
        hit = self._store.get(path)
        if hit is None:
            hit = _load_image(path)
            self._store[path] = hit
        return hit

    def load_transformed(self, path: str, transform, rng):
        """Decode + transform with the sample cached at the latest
        deterministic stage."""
        if not self.enabled:
            image = _load_image(path)
            return transform(image, rng) if transform else image
        from .transforms import is_deterministic

        if transform is None or not is_deterministic(transform):
            image = self.load(path)
            return transform(image, rng) if transform else image
        hit = self._store.get(path)
        if hit is None:
            hit = transform(_load_image(path), rng)
            self._store[path] = hit
        return hit


def _csv_value(text: str):
    """A CSV cell as pandas would type it in a column of integers."""
    try:
        return int(text)
    except ValueError:
        return text


def _read_csv_rows(path: str) -> List[Tuple]:
    """The rows under the header of a CSV file; a column whose every value
    is an integer holds ints (pandas' inference), other columns strings."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f)][1:]
    rows = [row for row in rows if row]
    columns = list(zip(*rows)) if rows else []
    typed = []
    for col in columns:
        values = [_csv_value(v) for v in col]
        typed.append(values if all(isinstance(v, int) for v in values) else list(col))
    return list(zip(*typed))


def _read_json_rows(path: str) -> List[Tuple]:
    """The records of a JSON index: a list of [file, class] lists, or of
    objects whose first two values are those (pandas' ``read_json``)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON list of records")
    return [tuple(rec.values()) if isinstance(rec, dict) else tuple(rec)
            for rec in data]


class _IndexedDataset(Dataset):
    """A folder of images indexed by (file, class) rows."""

    def __init__(self, rows: Sequence[Tuple], root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        self.rows = list(rows)
        self.root_dir = root_dir
        self.transform = transform
        self._cache = _DecodeCache(cache)
        self.classes = sorted({row[1] for row in self.rows})
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def __len__(self):
        return len(self.rows)

    def _path(self, name) -> str:
        raise NotImplementedError

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        name, cls = self.rows[idx][0], self.rows[idx][1]
        image = self._cache.load_transformed(self._path(name), self.transform, rng)
        return image, self.class_to_idx[cls]


class CIFAR10Dataset(_IndexedDataset):
    """CSV-indexed PNG folder: column 0 is the file stem, column 1 the class
    name."""

    def __init__(self, csv_file: str, root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        super().__init__(_read_csv_rows(csv_file), root_dir, transform, cache)

    def _path(self, name) -> str:
        return os.path.join(self.root_dir, f"{name}.png")


class STL10Dataset(_IndexedDataset):
    """JSON-indexed labeled folder: each record's file (its last path
    component under ``root_dir``) and class."""

    def __init__(self, json_file: str, root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        super().__init__(_read_json_rows(json_file), root_dir, transform, cache)

    def _path(self, name) -> str:
        return os.path.join(self.root_dir, str(name).split("/")[-1])


class ImageFolderDataset(Dataset):
    """Class-per-subdirectory layout (ImageNet-style), labeled:
    ``<root>/<class_name>/*.{png,jpg,jpeg,bmp,webp}``."""

    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, root_dir: str, transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.transform = transform
        self.classes = sorted(d for d in os.listdir(root_dir)
                              if os.path.isdir(os.path.join(root_dir, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cls_dir = os.path.join(root_dir, cls)
            for name in sorted(os.listdir(cls_dir)):
                if name.lower().endswith(self.EXTENSIONS):
                    self.samples.append((os.path.join(cls_dir, name),
                                         self.class_to_idx[cls]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        path, label = self.samples[idx]
        image = _load_image(path)
        if self.transform:
            image = self.transform(image, rng)
        return image, label


class STL10UnsupervisedDataset(Dataset):
    """Sorted glob of ``*.png``, image-only."""

    def __init__(self, root_dir: str, transform: Optional[Callable] = None,
                 cache: bool = False, native_decode: bool = False):
        if native_decode:
            raise NotImplementedError(
                "data.native_decode=true binds csrc/libfastloader.so, which "
                "links OpenCV; the port does not take it yet (ROADMAP.md "
                "queue A item 11)")
        self.root_dir = root_dir
        self.transform = transform
        self.files = sorted(glob.glob(f"{root_dir}/*.png"))
        self._cache = _DecodeCache(cache)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        return self._cache.load_transformed(self.files[idx], self.transform, rng)


class Subset(Dataset):
    """Index-restricted view of a dataset (the seeded train/val split)."""

    def __init__(self, dataset: Dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)
        if hasattr(dataset, "num_global_views"):
            self.num_global_views = dataset.num_global_views
        if hasattr(dataset, "classes"):
            self.classes = dataset.classes

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        return self.dataset.__getitem__(self.indices[idx], rng)
