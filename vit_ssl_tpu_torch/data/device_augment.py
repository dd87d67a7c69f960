"""Multi-crop augmentation on the device (port of ``vit_ssl_tpu/data/device_augment.py``).

The host ships one uint8 (B, H, W, C) batch; random resized crops, flips,
colour jitter, grayscale and Gaussian blur run as batched tensor code on
the device, each sample with its own parameters. Every op is split in two,
so that a test can hand JAX's draws to the port:

- ``draw(generator, b, h, w)``: the parameters of b samples, as (b,)
  tensors, all from the one ``torch.Generator`` (whose streams differ from
  ``jax.random``'s by design);
- ``apply(images, params)``: the op on (b, h, w, c) fp32 images in [0, 1]
  with those parameters.

Semantics follow the JAX package, with its two documented divergences from
torchvision: the crop box is clamped into the image instead of resampled,
and colour jitter runs brightness → contrast → saturation → hue in that
fixed order (through the HSV round trip). Crop-and-resize is
``jax.image.scale_and_translate(..., "linear")`` with its default
antialias: per-sample triangle-kernel weight matrices
(:func:`..ops.resample.weight_matrix`) applied as two batched products.
The blur is separable, ``kernel_size | 1`` taps, with zero padding as
JAX's ``"SAME"`` convolution, applied as banded matrix products.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..ops.resample import resize_hw, weight_matrix

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# colour-space helpers (tf.image-style HSV round trip)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    one = torch.ones_like(maxc)
    delta = maxc - minc
    safe_delta = torch.where(delta > 0, delta, one)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, one),
                    torch.zeros_like(maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):  # jnp.select over i == 0 .. 5
        out = torch.zeros_like(v)
        for k in reversed(range(6)):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def grayscale(img: torch.Tensor) -> torch.Tensor:
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _uniform(generator, b, low, high):
    u = torch.rand(b, generator=generator, device=generator.device)
    return u * (high - low) + low


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    """(b,) parameters broadcast against (b, h, w, c) images."""
    return x.reshape(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# ops


class RandomResizedCrop:
    """A box of U(scale) of the area and log-U(ratio) aspect, clamped into
    the image, resized to size × size with antialiased linear weights."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = int(size)
        self.scale = tuple(float(s) for s in scale)
        self.ratio = tuple(float(r) for r in ratio)

    def draw(self, generator, b, h, w) -> Params:
        area = h * w * _uniform(generator, b, *self.scale)
        log_r = _uniform(generator, b, math.log(self.ratio[0]),
                         math.log(self.ratio[1]))
        aspect = torch.exp(log_r)
        cw = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, w)
        ch = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, h)
        top = torch.rand(b, generator=generator, device=generator.device) * (h - ch)
        left = torch.rand(b, generator=generator, device=generator.device) * (w - cw)
        return {"top": top, "left": left, "height": ch, "width": cw}

    def apply(self, img, p: Params):
        _, h, w, _ = img.shape
        out = self.size
        sy, sx = p["height"] / out, p["width"] / out
        wy = weight_matrix(h, out, 1.0 / sy, -p["top"] / sy, "linear")
        wx = weight_matrix(w, out, 1.0 / sx, -p["left"] / sx, "linear")
        img = torch.einsum("bhwc,bhy->bywc", img, wy)
        img = torch.einsum("bywc,bwx->byxc", img, wx)
        return torch.clamp(img, 0.0, 1.0)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def draw(self, generator, b, h, w) -> Params:
        u = torch.rand(b, generator=generator, device=generator.device)
        return {"flip": u < self.p}

    def apply(self, img, p: Params):
        return torch.where(_per_sample(p["flip"]), img.flip(2), img)


class ColorJitter:
    """Brightness, then contrast, then saturation, then hue."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness, self.contrast = float(brightness), float(contrast)
        self.saturation, self.hue = float(saturation), float(hue)

    def draw(self, generator, b, h, w) -> Params:
        params = {}
        for name in ("brightness", "contrast", "saturation"):
            x = getattr(self, name)
            if x:
                params[name] = _uniform(generator, b, max(0.0, 1 - x), 1 + x)
        if self.hue:
            params["hue"] = _uniform(generator, b, -self.hue, self.hue)
        return params

    def apply(self, img, p: Params):
        if "brightness" in p:
            img = img * _per_sample(p["brightness"])
        if "contrast" in p:
            f = _per_sample(p["contrast"])
            mean = grayscale(torch.clamp(img, 0, 1)).mean(dim=(1, 2))
            img = f * img + (1.0 - f) * _per_sample(mean)
        if "saturation" in p:
            f = _per_sample(p["saturation"])
            gray = grayscale(torch.clamp(img, 0, 1))[..., None]
            img = f * img + (1.0 - f) * gray
        if "hue" in p:
            hsv = rgb_to_hsv(torch.clamp(img, 0, 1))
            hue = torch.remainder(hsv[..., 0] + p["hue"].reshape(-1, 1, 1), 1.0)
            img = hsv_to_rgb(torch.cat([hue[..., None], hsv[..., 1:]], dim=-1))
        return torch.clamp(img, 0.0, 1.0)


class RandomGrayscale:
    def __init__(self, p: float = 0.1):
        self.p = float(p)

    def draw(self, generator, b, h, w) -> Params:
        u = torch.rand(b, generator=generator, device=generator.device)
        return {"gray": u < self.p}

    def apply(self, img, p: Params):
        gray = grayscale(img)[..., None].expand_as(img)
        return torch.where(_per_sample(p["gray"]), gray, img)


class GaussianBlur:
    """Separable Gaussian of U(sigma) over ``kernel_size | 1`` taps, zero
    padding."""

    def __init__(self, kernel_size: int = 7, sigma=(0.1, 2.0)):
        self.k = int(kernel_size) | 1
        self.sigma = tuple(float(s) for s in sigma)

    def draw(self, generator, b, h, w) -> Params:
        return {"sigma": _uniform(generator, b, *self.sigma)}

    def _band(self, g, size):
        """(b, size, size) matrices: out[y] = Σₜ g[t]·in[y + t − half]."""
        half = (self.k - 1) // 2
        idx = torch.arange(size, device=g.device)
        tap = idx[None, :] - idx[:, None] + half  # [y, i] -> tap index
        valid = (tap >= 0) & (tap < self.k)
        return torch.where(valid, g[:, tap.clamp(0, self.k - 1)], torch.zeros((), device=g.device))

    def apply(self, img, p: Params):
        b, h, w, c = img.shape
        coords = torch.arange(self.k, dtype=torch.float32, device=img.device) - (self.k - 1) / 2.0
        s = p["sigma"].reshape(-1, 1)
        g = torch.exp(-(coords ** 2) / (2.0 * s ** 2))
        g = g / g.sum(dim=1, keepdim=True)
        img = torch.matmul(self._band(g, h), img.reshape(b, h, w * c)).reshape(b, h, w, c)
        img = torch.matmul(self._band(g, w), img.transpose(1, 2).reshape(b, w, h * c))
        return img.reshape(b, w, h, c).transpose(1, 2)


class Resize:
    def __init__(self, size: int):
        self.size = int(size)

    def draw(self, generator, b, h, w) -> Params:
        return {}

    def apply(self, img, p: Params):
        return resize_hw(img, self.size, self.size, "linear")


class Normalize:
    def __init__(self, mean, std):
        self.mean = torch.tensor(mean, dtype=torch.float32)
        self.std = torch.tensor(std, dtype=torch.float32)

    def draw(self, generator, b, h, w) -> Params:
        return {}

    def apply(self, img, p: Params):
        return (img - self.mean.to(img.device)) / self.std.to(img.device)


# ---------------------------------------------------------------------------
# pipelines from config transform lists


def _op(entry: Dict):
    name = entry["name"]
    params = dict(entry.get("params") or {})
    if name == "RandomResizedCrop":
        return RandomResizedCrop(params["size"], params.get("scale", (0.08, 1.0)),
                                 params.get("ratio", (3 / 4, 4 / 3)))
    if name == "RandomHorizontalFlip":
        return RandomHorizontalFlip(params.get("p", 0.5))
    if name == "ColorJitter":
        return ColorJitter(params.get("brightness", 0.0), params.get("contrast", 0.0),
                           params.get("saturation", 0.0), params.get("hue", 0.0))
    if name == "RandomGrayscale":
        return RandomGrayscale(params.get("p", 0.1))
    if name == "GaussianBlur":
        ks = params.get("kernel_size", 7)
        ks = int(ks[0]) if isinstance(ks, (list, tuple)) else int(ks)
        sg = params.get("sigma", (0.1, 2.0))
        sg = tuple(sg) if isinstance(sg, (list, tuple)) else (float(sg), float(sg))
        return GaussianBlur(ks, sg)
    if name == "Resize":
        size = params.get("size")
        return Resize(size[0] if isinstance(size, (list, tuple)) else size)
    if name == "Normalize":
        return Normalize(params["mean"], params["std"])
    if name == "ToTensor":  # inputs arrive as float [0, 1]
        return None
    raise ValueError(f"Unsupported device transform '{name}'")


_SUPPORTED = {"RandomResizedCrop", "RandomHorizontalFlip", "ColorJitter",
              "RandomGrayscale", "GaussianBlur", "Resize", "Normalize", "ToTensor"}


def supports_pipeline(sequence) -> bool:
    """Whether every transform of a config list has a device version."""
    return all(entry["name"] in _SUPPORTED for entry in sequence)


def build_device_pipeline(sequence: Sequence[Dict]) -> Callable:
    """``fn(generator, images) -> images`` over a batch of fp32 (B, H, W, C)
    images in [0, 1]; each op draws its B samples' parameters, then runs."""
    ops = [op for op in map(_op, sequence) if op is not None]

    def fn(generator, imgs):
        for op in ops:
            b, h, w, _ = imgs.shape
            imgs = op.apply(imgs, op.draw(generator, b, h, w))
        return imgs

    return fn


def to_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 → fp32 /255; any other dtype → fp32 as it is."""
    imgs = images.float()
    return imgs / 255.0 if images.dtype == torch.uint8 else imgs


def make_multicrop_fn(globals_seq: Sequence[Dict], locals_seq: Sequence[Dict],
                      num_global_views: int, num_all_views: int) -> Callable:
    """``fn(generator, images) -> tuple`` of ``num_all_views`` view batches
    (globals first) from (B, H, W, C) uint8 or float images, on the
    images' device; the generator must live there too."""
    g_fn = build_device_pipeline(globals_seq)
    l_fn = build_device_pipeline(locals_seq)

    def fn(generator, images) -> Tuple[torch.Tensor, ...]:
        imgs = to_unit_float(images)
        views: List[torch.Tensor] = []
        for v in range(num_all_views):
            views.append((g_fn if v < num_global_views else l_fn)(generator, imgs))
        return tuple(views)

    return fn


def make_batch_augment_fn(sequence: Sequence[Dict]) -> Callable:
    """``fn(generator, images) -> images``: one augmented view of each of a
    (B, H, W, C) uint8 or float batch, on the images' device (port of
    ``make_batch_augment_fn``, the supervised step's train-time pipeline);
    the generator must live there too."""
    pipeline = build_device_pipeline(sequence)

    def fn(generator, images) -> torch.Tensor:
        return pipeline(generator, to_unit_float(images))

    return fn
