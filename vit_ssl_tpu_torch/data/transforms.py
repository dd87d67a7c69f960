"""Host pipelines: a copy of ``vit_ssl_tpu/data/transforms.py`` (Compose,
Resize, CenterCrop, RandomCrop, RandomResizedCrop, RandomHorizontalFlip,
ColorJitter, RandomGrayscale, GaussianBlur, ToTensor, Normalize, the
registry, ``is_deterministic``, ``build_pipeline`` and ``get_transforms``)
with the same semantics: serving's and the evaluators' clean pipeline, the
trainer's decode-and-resize, the supervised and finetune train and val
pipelines and DINO's host multi-crop when ``data.device_augment`` is off.

- pipelines consume PIL Images or uint8 HWC numpy arrays;
- ``ToTensor`` converts to float32 HWC in [0, 1] (the NHWC layout the
  models take), unlike torchvision's CHW;
- randomness comes from the ``numpy.random.Generator`` threaded through
  ``Compose``: the same draws in the same order as the JAX package's;
- the numpy arithmetic is the JAX package's, line for line; where that
  calls OpenCV (the resizes, the hue jitter's colour conversions, the
  blur), :mod:`.image_ops` computes the same uint8 results in the port's
  host C++ (float images in numpy), so no pipeline needs OpenCV or PIL.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import image_ops


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
        interp = "area" if (nh < h or nw < w) else "linear"
        return image_ops.resize(arr, nh, nw, interp)


class CenterCrop(Transform):
    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, img, rng=None):
        arr = _to_numpy(img)
        th, tw = self.size
        h, w = arr.shape[:2]
        if h < th or w < tw:
            pad_h, pad_w = max(0, th - h), max(0, tw - w)
            arr = np.pad(
                arr,
                ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
            )
            h, w = arr.shape[:2]
        top, left = (h - th) // 2, (w - tw) // 2
        return arr[top:top + th, left:left + tw]


class RandomCrop(Transform):
    def __init__(self, size, padding: int = 0):
        self.size = _pair(size)
        self.padding = padding

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        if self.padding:
            arr = np.pad(arr, ((self.padding,) * 2, (self.padding,) * 2, (0, 0)))
        th, tw = self.size
        h, w = arr.shape[:2]
        top = int(rng.integers(0, h - th + 1))
        left = int(rng.integers(0, w - tw + 1))
        return arr[top:top + th, left:left + tw]


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
        th, tw = self.size
        # the JAX package picks INTER_AREA by the height alone
        interp = "area" if th < crop.shape[0] else "linear"
        return image_ops.resize(crop, th, tw, interp)


class RandomHorizontalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        if rng.uniform() < self.p:
            return arr[:, ::-1]
        return arr


def _blend(a: np.ndarray, b: Union[np.ndarray, float], factor: float) -> np.ndarray:
    return factor * a + (1.0 - factor) * b


def _grayscale(arr: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma, what torchvision's rgb_to_grayscale uses
    return arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114


class ColorJitter(Transform):
    """torchvision ColorJitter: random factors, random op order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = (-float(hue), float(hue)) if isinstance(hue, numbers.Number) else tuple(hue)

    @staticmethod
    def _range(v):
        if isinstance(v, numbers.Number):
            return (max(0.0, 1.0 - float(v)), 1.0 + float(v))
        return tuple(v)

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img).astype(np.float32)
        if arr.max() > 1.5:  # uint8-range input
            scale = 255.0
        else:
            scale = 1.0

        ops = list(rng.permutation(4))
        for op in ops:
            if op == 0 and self.brightness != (1.0, 1.0):
                f = rng.uniform(*self.brightness)
                arr = arr * f
            elif op == 1 and self.contrast != (1.0, 1.0):
                f = rng.uniform(*self.contrast)
                mean = _grayscale(arr).mean()
                arr = _blend(arr, mean, f)
            elif op == 2 and self.saturation != (1.0, 1.0):
                f = rng.uniform(*self.saturation)
                gray = _grayscale(arr)[..., None]
                arr = _blend(arr, gray, f)
            elif op == 3 and self.hue != (0.0, 0.0):
                f = rng.uniform(*self.hue)
                u8 = np.clip(arr, 0, scale)
                u8 = (u8 * (255.0 / scale)).astype(np.uint8)
                hsv = image_ops.rgb_to_hsv(u8)
                # OpenCV hue is [0, 180); torchvision hue factor is in turns
                shift = int(round(f * 180.0))
                hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 180
                arr = image_ops.hsv_to_rgb(hsv).astype(np.float32)
                arr = arr * (scale / 255.0)
        return np.clip(arr, 0, scale).astype(np.float32) if scale == 1.0 else np.clip(
            arr, 0, 255
        ).astype(np.uint8)


class RandomGrayscale(Transform):
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        if rng.uniform() < self.p:
            gray = _grayscale(arr.astype(np.float32))
            arr = np.stack([gray] * 3, axis=-1)
            if arr.max() > 1.5:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr


class GaussianBlur(Transform):
    def __init__(self, kernel_size, sigma=(0.1, 2.0)):
        ks = _pair(kernel_size)
        self.kernel_size = (ks[0] | 1, ks[1] | 1)  # OpenCV's kernels are odd
        self.sigma = (float(sigma), float(sigma)) if isinstance(sigma, numbers.Number) else tuple(sigma)

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        arr = _to_numpy(img)
        s = rng.uniform(*self.sigma)
        return image_ops.gaussian_blur(arr, self.kernel_size, s, s)


class ToTensor(Transform):
    """uint8 HWC → float32 HWC in [0, 1] (NHWC framework layout)."""

    def __call__(self, img, rng=None):
        arr = _to_numpy(img)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return np.clip(arr.astype(np.float32), 0.0, 1.0)


class Normalize(Transform):
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, img, rng=None):
        arr = np.asarray(img, dtype=np.float32)
        return (arr - self.mean) / self.std


TRANSFORM_REGISTRY: Dict[str, type] = {
    "Resize": Resize,
    "CenterCrop": CenterCrop,
    "RandomCrop": RandomCrop,
    "RandomResizedCrop": RandomResizedCrop,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "ColorJitter": ColorJitter,
    "RandomGrayscale": RandomGrayscale,
    "GaussianBlur": GaussianBlur,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
}


_DETERMINISTIC = (Resize, CenterCrop, ToTensor, Normalize)


def is_deterministic(transform) -> bool:
    """True when a pipeline uses no randomness: its output per image is the
    same every epoch, so the loader may cache post-transform samples."""
    if transform is None:
        return True
    if isinstance(transform, Compose):
        return all(is_deterministic(t) for t in transform.transforms)
    return isinstance(transform, _DETERMINISTIC)


def build_transform(name: str, params: Optional[Dict[str, Any]] = None) -> Transform:
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
