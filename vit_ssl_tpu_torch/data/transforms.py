"""Host pipelines: a copy of ``Compose``, ``Resize``, ``RandomResizedCrop``,
``RandomHorizontalFlip``, ``ToTensor``, ``is_deterministic``,
``build_pipeline`` and ``get_transforms`` from
``vit_ssl_tpu/data/transforms.py``, with the same semantics (serving's
clean pipeline; the trainer's decode-and-resize; the supervised and
finetune train and val pipelines when ``data.device_augment`` is off).

- pipelines consume PIL Images or uint8 HWC numpy arrays;
- ``ToTensor`` converts to float32 HWC in [0, 1] (the NHWC layout the
  models take), unlike torchvision's CHW;
- cv2 does the resize, with the same interpolation rule as the JAX package.

cv2 and PIL are imported inside the functions that use them, so the device
path (and a machine without them) never needs them; a resize to the size
an image already has needs no cv2. The other host transforms of the JAX
package (CenterCrop, RandomCrop, ColorJitter, RandomGrayscale,
GaussianBlur, Normalize: DINO's host multi-crop) are refused by name
(``ROADMAP.md`` queue A item 11).
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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


class RandomResizedCrop(Transform):
    """torchvision semantics: sample area ∈ scale·A, log-uniform aspect in
    ratio, 10 attempts then center-crop fallback."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = _pair(size)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        h, w = arr.shape[:2]
        area = h * w
        log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                crop = arr[top:top + ch, left:left + cw]
                break
        else:  # fallback: center crop at clamped aspect
            in_ratio = w / h
            if in_ratio < self.ratio[0]:
                cw, ch = w, int(round(w / self.ratio[0]))
            elif in_ratio > self.ratio[1]:
                ch, cw = h, int(round(h * self.ratio[1]))
            else:
                cw, ch = w, h
            top, left = (h - ch) // 2, (w - cw) // 2
            crop = arr[top:top + ch, left:left + cw]
        import cv2

        th, tw = self.size
        interp = cv2.INTER_AREA if th < crop.shape[0] else cv2.INTER_LINEAR
        return cv2.resize(crop, (tw, th), interpolation=interp)


class RandomHorizontalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        if rng.uniform() < self.p:
            return arr[:, ::-1]
        return arr


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


TRANSFORM_REGISTRY: Dict[str, type] = {
    "Resize": Resize,
    "RandomResizedCrop": RandomResizedCrop,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "ToTensor": ToTensor,
}
# the JAX package's other host transforms, with the queue-A item that ports
# them
_NOT_PORTED = ("CenterCrop", "RandomCrop", "ColorJitter", "RandomGrayscale",
               "GaussianBlur", "Normalize")


def build_transform(name: str, params: Optional[Dict[str, Any]] = None) -> Transform:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the host transform '{name}' is not ported yet; see ROADMAP.md "
            "queue A item 11")
    if name not in TRANSFORM_REGISTRY:
        raise ValueError(f"Unknown transform '{name}'")
    return TRANSFORM_REGISTRY[name](**(params or {}))


def build_pipeline(sequence) -> Compose:
    """A Compose from a config list of {name, params} entries."""
    return Compose([build_transform(entry["name"], dict(entry.get("params") or {}))
                    for entry in sequence])


def get_transforms(config) -> Dict[str, Compose]:
    """Every pipeline under the config's ``transforms``, by key."""
    return {key: build_pipeline(seq) for key, seq in config["transforms"].items()}
