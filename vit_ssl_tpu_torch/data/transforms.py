"""Host pipelines: a copy of ``Compose``, ``Resize``, ``ToTensor`` and
``is_deterministic`` from ``vit_ssl_tpu/data/transforms.py``, with the same
semantics (serving's clean pipeline; the trainer's decode-and-resize).

- pipelines consume PIL Images or uint8 HWC numpy arrays;
- ``ToTensor`` converts to float32 HWC in [0, 1] (the NHWC layout the
  models take), unlike torchvision's CHW;
- cv2 does the resize, with the same interpolation rule as the JAX package.

cv2 and PIL are imported inside the functions that use them, so the device
path (and a machine without them) never needs them; a resize to the size
an image already has needs no cv2.
"""

from __future__ import annotations

import numbers
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np


def _to_numpy(img: Any) -> np.ndarray:
    if hasattr(img, "convert") and hasattr(img, "getbands"):  # a PIL image
        return np.asarray(img.convert("RGB"))
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def _pair(size: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    if len(size) == 1:
        return int(size[0]), int(size[0])
    return int(size[0]), int(size[1])


class Transform:
    def __call__(self, img: Any, rng: Optional[np.random.Generator] = None) -> Any:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: List[Transform]):
        self.transforms = transforms

    def __call__(self, img, rng: Optional[np.random.Generator] = None):
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            img = t(img, rng)
        return img

    def __repr__(self):
        return f"Compose({self.transforms!r})"


class Resize(Transform):
    """torchvision.Resize semantics: int → shorter side, [h, w] → exact."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, rng=None):
        arr = _to_numpy(img)
        h, w = arr.shape[:2]
        if isinstance(self.size, numbers.Number):
            short = int(self.size)
            if h <= w:
                nh, nw = short, max(1, int(round(w * short / h)))
            else:
                nh, nw = max(1, int(round(h * short / w))), short
        else:
            nh, nw = _pair(self.size)
        if (nh, nw) == (h, w):
            return arr
        import cv2

        interp = cv2.INTER_AREA if (nh < h or nw < w) else cv2.INTER_LINEAR
        return cv2.resize(arr, (nw, nh), interpolation=interp)


class ToTensor(Transform):
    """uint8 HWC → float32 HWC in [0, 1] (NHWC framework layout)."""

    def __call__(self, img, rng=None):
        arr = _to_numpy(img)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return np.clip(arr.astype(np.float32), 0.0, 1.0)


_DETERMINISTIC = (Resize, ToTensor)


def is_deterministic(transform) -> bool:
    """True when a pipeline uses no randomness: its output per image is the
    same every epoch, so the loader may cache post-transform samples."""
    if transform is None:
        return True
    if isinstance(transform, Compose):
        return all(is_deterministic(t) for t in transform.transforms)
    return isinstance(transform, _DETERMINISTIC)
