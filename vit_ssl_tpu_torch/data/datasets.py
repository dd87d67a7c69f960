"""Datasets (from ``vit_ssl_tpu/data/datasets.py``): the base ``Dataset``, the
decoder and its cache, the unlabeled STL-10 folder and ``Subset``.

Datasets return numpy arrays (uint8 HWC after the device-augment pipeline's
decode and resize) and the loader stacks them into NHWC batches. OpenCV is
imported inside :func:`_load_image`, so a dataset held in memory needs none.

Not ported yet: the labeled datasets (CIFAR-10 CSV, STL-10 JSON, image
folder; they read their indexes with pandas), the host multi-crop
``STL10DINODataset`` and the native batch decoder (``csrc/fastloader``,
which links OpenCV): ``ROADMAP.md`` queue A items 4 and 11.
"""

from __future__ import annotations

import glob
from typing import Callable, Dict, Optional

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

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        return self.dataset.__getitem__(self.indices[idx], rng)
