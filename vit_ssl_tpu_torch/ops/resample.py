"""Separable resampling weights (a jax-free copy of
``jax/_src/image/scale.py::compute_weight_mat`` and its kernels).

``jax.image.resize`` and ``jax.image.scale_and_translate`` resample each
spatial axis by one (input, output) weight matrix: output sample j sits at
``(j + 0.5 − translation)/scale − 0.5`` in input coordinates, each input
pixel i weighs ``kernel(|sample − i| / kernel_scale)``, with
``kernel_scale = max(1/scale, 1)`` when antialiasing a downsample, columns
normalised to sum 1, and samples outside the input zeroed. The JAX package
uses the Keys cubic (a = −0.5) to resize the positional embedding
(``DynamicPatchEmbed``) and the triangle to crop and resize images
(``device_augment.random_resized_crop``); ``torch.nn.functional.interpolate``
matches neither (a = −0.75, no antialias), hence these weights, applied as
small batched products.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = −0.5, for x ≥ 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    """The linear-interpolation (tent) kernel."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


KERNELS = {"cubic": keys_cubic_kernel, "linear": triangle_kernel}


def weight_matrix(input_size: int, output_size: int, scale, translation,
                  kernel: str, antialias: bool = True,
                  device=None) -> torch.Tensor:
    """fp32 resampling weights (..., input_size, output_size).

    ``scale`` and ``translation`` are floats or tensors of one shape (a batch
    of per-sample transforms); the result has that shape in front."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=scale.device)
    scale, translation = torch.broadcast_tensors(scale, translation)
    inv_scale = (1.0 / scale)[..., None, None]
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones_like(inv_scale))
    out = torch.arange(output_size, dtype=torch.float32, device=scale.device)
    sample = ((out + 0.5) * inv_scale - translation[..., None, None] * inv_scale
              - 0.5)  # (..., 1, output_size)
    pixels = torch.arange(input_size, dtype=torch.float32,
                          device=scale.device)[:, None]
    w = KERNELS[kernel]((sample - pixels).abs() / kernel_scale)
    total = w.sum(dim=-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= input_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def resize_hw(x: torch.Tensor, out_h: int, out_w: int,
              kernel: str) -> torch.Tensor:
    """``jax.image.resize`` (antialiased) over the two spatial axes of an
    NHWC tensor, in fp32; an axis whose size does not change is left as
    it is."""
    _, h, w, _ = x.shape
    x = x.float()
    if out_h != h:
        wy = weight_matrix(h, out_h, out_h / h, 0.0, kernel, device=x.device)
        x = torch.einsum("nhwc,hy->nywc", x, wy)
    if out_w != w:
        wx = weight_matrix(w, out_w, out_w / w, 0.0, kernel, device=x.device)
        x = torch.einsum("nywc,wx->nyxc", x, wx)
    return x
