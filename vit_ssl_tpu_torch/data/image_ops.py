"""OpenCV's arithmetic that the host transforms use: resize
(``INTER_AREA``, ``INTER_LINEAR`` and, on float images, ``INTER_CUBIC``),
RGB↔HSV on OpenCV's [0, 180) hue and the Gaussian blur, each equal bit for
bit to ``cv2.resize``,
``cv2.cvtColor`` and ``cv2.GaussianBlur`` on uint8 images (OpenCV 5.0 on
x86-64, the dispatched SIMD paths; ``tests/test_torch_host_transforms.py``
holds each against ``cv2``, the colour conversions over every input).

- resize, ``INTER_LINEAR``: source coordinate ``(d + 0.5)·scale - 0.5`` in
  float32, 11-bit weights (``round(w·2048)``, each of the pair rounded on
  its own, so a pair need not sum to 2048), a horizontal pass summed in
  integers, then the vertical pass as OpenCV's vector code computes it:
  ``((r0 >> 4)·b0 >> 16) + ((r1 >> 4)·b1 >> 16)``, rounded by
  ``(s + 2) >> 2``. A shrink by exactly 2 on both axes is the 2×2 box
  average, as OpenCV switches it to ``INTER_AREA``.
- resize, ``INTER_AREA``: when both axes shrink, an integer factor on both
  is a box average (``(sum + 2) >> 2`` for 2×2, else ``round(sum·(1/area))``
  in float32) and any other factor sums each destination pixel's covered
  source pixels with float32 coverage weights, rows then columns in
  OpenCV's order, rounded half to even. When an axis grows, it is the
  linear path with the area variant of the coordinates.
- resize, ``INTER_CUBIC`` (float images only; the attention visualizer's
  upsampling of a heat map): the same source coordinate in float32, Keys'
  cubic with A = -0.75 as OpenCV's ``interpolateCubic`` computes its four
  float32 weights (the last one minus the other three), taps past the edge
  replicated, a horizontal pass summed tap by tap, then the vertical one.
  Within a few units in the last place of OpenCV's C++ path; OpenCV's IPP
  path, which it takes for a float shrink, sums in another form (about
  2e-6 of the largest value apart).
- RGB→HSV: OpenCV's 12-bit division tables, all integer.
- HSV→RGB: float32, the sector formulas with their products fused
  (``v·fma(-s, h, 1)``), times 255; OpenCV converts each row in blocks of
  32 pixels, which truncate to uint8, and rounds the row's remaining
  (width mod 32) pixels half to even.
- Gaussian blur: the kernel of ``getGaussianKernel`` in float64, made an
  8-bit fixed-point kernel by error diffusion (its sum exactly 256), one
  separable pass in integers with reflect-101 borders and a single
  rounding, ``(sum + 2^15) >> 16``.

A float image (float32 or float64) resizes and blurs in its own precision
with OpenCV's float coordinates, weights and kernel: within a few units in
the last place of OpenCV, whose sums run in another order.

Dispatch is by dtype: :func:`resize`, :func:`rgb_to_hsv`,
:func:`hsv_to_rgb` and :func:`gaussian_blur` send a uint8 image to the
port's host C++ ``csrc/image_ops.cpp`` (in the image library
:data:`vit_ssl_tpu_torch.kernels.HOST_IMAGE`, built with the host compiler at
first use by :func:`vit_ssl_tpu_torch.kernels.load_host`, called through
``ctypes``, which releases the GIL; output arrays allocated here), and a
float image (the visualizer's cubic resize, a float pipeline) to the numpy
versions. The numpy versions of the uint8 forms stay as the plain versions
the library is held against bit for bit (:func:`resize_plain`,
:func:`rgb_to_hsv_plain`, :func:`hsv_to_rgb_plain`,
:func:`gaussian_blur_plain`); a library that does not build raises, it does
not hand the image to them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np

from .. import kernels

LIBRARY = kernels.HOST_IMAGE
_INTERPOLATION = {"area": 0, "linear": 1}

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE: 11-bit resize weights
_HSV_SHIFT = 12
# pixels one vector step of OpenCV's HSV→RGB converts (its x86-64 SIMD
# dispatch); a row's remainder goes through its scalar tail
_HSV_BLOCK = 32
_DBL_EPSILON = np.finfo(np.float64).eps


def _check_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"the colour conversions take uint8 images, not {img.dtype}")
    return img


def _check_image(img: np.ndarray) -> np.ndarray:
    """uint8, or float32/float64 (computed in their own precision)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 and img.dtype not in (np.float32, np.float64):
        raise TypeError(f"the host image ops take uint8 or float images, not {img.dtype}")
    return img


# -- resize ---------------------------------------------------------------------

def _linear_coords(dsize: int, ssize: int, scale: float, inv_scale: float,
                   area_mode: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Each destination index's first source index and float32 fraction."""
    d = np.arange(dsize)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _weights(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    one = np.float32(1)
    w0 = np.rint((one - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return w0, w1


def _resize_linear(src: np.ndarray, dh: int, dw: int, area_mode: bool) -> np.ndarray:
    sh, sw, cn = src.shape
    inv_x, inv_y = dw / sw, dh / sh
    sx, fx = _linear_coords(dw, sw, 1.0 / inv_x, inv_x, area_mode)
    sy, fy = _linear_coords(dh, sh, 1.0 / inv_y, inv_y, area_mode)
    left = sx < 0
    fx, sx = np.where(left, np.float32(0), fx), np.where(left, 0, sx)
    edge = sx >= sw - 1  # the last column and past it: one source pixel
    fx, sx = np.where(edge, np.float32(0), fx), np.where(edge, sw - 1, sx)
    if src.dtype != np.uint8:  # float: the float weights, no fixed point
        one, t = np.float32(1), src.dtype.type
        a0, a1 = (one - fx).astype(t), fx.astype(t)
        b0, b1 = (one - fy).astype(t), fy.astype(t)
        x1 = np.minimum(sx + 1, sw - 1)
        rows = src[:, sx] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        rows = np.where(edge[None, :, None], src[:, sx], rows)
        return (rows[np.clip(sy, 0, sh - 1)] * b0[:, None, None]
                + rows[np.clip(sy + 1, 0, sh - 1)] * b1[:, None, None])
    a0, a1 = _weights(fx)
    b0, b1 = _weights(fy)
    s = src.astype(np.int32)
    rows = s[:, sx] * a0[None, :, None] + s[:, np.minimum(sx + 1, sw - 1)] * a1[None, :, None]
    rows = np.where(edge[None, :, None], s[:, sx] * _COEF_SCALE, rows)
    r0 = rows[np.clip(sy, 0, sh - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, sh - 1)] >> 4
    out = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """(n, 4) float32 weights of the taps at s - 1 .. s + 2 for fractions
    ``f``: OpenCV's ``interpolateCubic`` (A = -0.75) in float32."""
    a, one = np.float32(-0.75), np.float32(1)
    x1, y = f + one, one - f
    w0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    w1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    w2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    return np.stack([w0, w1, w2, one - w0 - w1 - w2], axis=-1).astype(np.float32)


def _resize_cubic(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw, _ = src.shape
    t = src.dtype.type
    inv_x, inv_y = dw / sw, dh / sh
    sx, fx = _linear_coords(dw, sw, 1.0 / inv_x, inv_x, False)
    sy, fy = _linear_coords(dh, sh, 1.0 / inv_y, inv_y, False)
    alpha, beta = _cubic_weights(fx).astype(t), _cubic_weights(fy).astype(t)
    rows = np.zeros((sh, dw, src.shape[2]), t)
    for j in range(4):
        rows = rows + src[:, np.clip(sx + j - 1, 0, sw - 1)] * alpha[None, :, j, None]
    out = rows[np.clip(sy - 1, 0, sh - 1)] * beta[:, 0, None, None]
    for k in range(1, 4):
        out = out + rows[np.clip(sy + k - 1, 0, sh - 1)] * beta[:, k, None, None]
    return out


def _area_table(ssize: int, dsize: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` as (dsize, K) source indices and
    float32 weights in its order, padded with weight-0 entries."""
    entries = [[] for _ in range(dsize)]
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            entries[dx].append((sx1 - 1, (sx1 - fsx1) / cell))
        entries[dx].extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            entries[dx].append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    k = max(len(e) for e in entries)
    index = np.zeros((dsize, k), np.int64)
    alpha = np.zeros((dsize, k), np.float32)
    for dx, e in enumerate(entries):
        for j, (si, a) in enumerate(e):
            index[dx, j], alpha[dx, j] = si, np.float32(a)
    return index, alpha


def _resize_area(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw, cn = src.shape
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    is_float = src.dtype != np.uint8
    if abs(scale_x - ix) < _DBL_EPSILON and abs(scale_y - iy) < _DBL_EPSILON:
        if is_float:
            box = src[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix, cn)
            return box.sum(axis=(1, 3)) * src.dtype.type(1.0 / (ix * iy))
        box = src[:dh * iy, :dw * ix].astype(np.int32).reshape(dh, iy, dw, ix, cn)
        total = box.sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        mean = total.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    x_index, x_alpha = _area_table(sw, dw, scale_x)
    y_index, y_alpha = _area_table(sh, dh, scale_y)
    dtype = src.dtype if is_float else np.float32
    f = src.astype(dtype)
    x_alpha, y_alpha = x_alpha.astype(dtype), y_alpha.astype(dtype)
    cols = np.zeros((sh, dw, cn), dtype)
    for j in range(x_index.shape[1]):
        cols = cols + f[:, x_index[:, j]] * x_alpha[None, :, j, None]
    out = np.zeros((dh, dw, cn), dtype)
    for j in range(y_index.shape[1]):
        out = out + cols[y_index[:, j]] * y_alpha[:, j, None, None]
    return out if is_float else np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_plain(img: np.ndarray, height: int, width: int, interpolation: str) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA,
    INTER_LINEAR or INTER_CUBIC)`` of an (H, W) or (H, W, C) image in numpy;
    ``interpolation`` is ``"area"``, ``"linear"`` or ``"cubic"`` (float
    images only). uint8 is bit-equal to OpenCV; a float image takes the
    same coordinates and weights in its own precision (OpenCV's float
    paths, up to the order of their sums)."""
    img = _check_image(img)
    if interpolation not in ("area", "linear", "cubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if interpolation == "cubic" and img.dtype == np.uint8:
        raise TypeError("the cubic resize takes float32 or float64 images, not uint8")
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    sh, sw = src.shape[:2]
    height, width = int(height), int(width)
    if height <= 0 or width <= 0:
        raise ValueError(f"resize to an empty size ({height}, {width})")
    if (height, width) == (sh, sw):
        out = src.copy()
    elif interpolation == "cubic":
        out = _resize_cubic(src, height, width)
    else:
        scale_x, scale_y = 1.0 / (width / sw), 1.0 / (height / sh)
        if (interpolation == "linear" and abs(scale_x - 2) < _DBL_EPSILON
                and abs(scale_y - 2) < _DBL_EPSILON):
            interpolation = "area"
        if interpolation == "area" and scale_x >= 1 and scale_y >= 1:
            out = _resize_area(src, height, width)
        else:
            out = _resize_linear(src, height, width, interpolation == "area")
    return out[:, :, 0] if squeeze else out


# -- colour ---------------------------------------------------------------------

def _division_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _division_tables()


def rgb_to_hsv_plain(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` of uint8 (..., 3) in numpy:
    hue in [0, 180), saturation and value in [0, 255]."""
    rgb = _check_uint8(rgb)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# each sector's (b, g, r) entries of (v, p, q, t)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 a·b + c rounded once: the float32 product is exact in
    float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def hsv_to_rgb_plain(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of uint8 (..., 3) with hue
    in [0, 180), in numpy."""
    hsv = _check_uint8(hsv)
    one, inv = np.float32(1), np.float32(1.0 / 255.0)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * inv
    v = hsv[..., 2].astype(np.float32) * inv
    h = np.fmod(h, np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0), h)
    table = np.stack([v, v * (one - s), v * _fma(-s, h, 1.0),
                      v * _fma(-s, one - h, 1.0)], axis=-1)
    bgr = np.take_along_axis(table, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * np.float32(255)
    # OpenCV converts each row in blocks of _HSV_BLOCK pixels, which
    # truncate, and rounds the row's last (width mod _HSV_BLOCK) pixels
    width = hsv.shape[-2] if hsv.ndim >= 2 else 1
    body = np.arange(width) < width - width % _HSV_BLOCK
    out = np.where(body[:, None], np.trunc(bgr), np.rint(bgr)) if hsv.ndim >= 2 \
        else np.rint(bgr)
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


# -- Gaussian blur ---------------------------------------------------------------

def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(size, sigma)`` (odd size, sigma > 0) in
    float64: exp(-x²/2σ²) normalised to sum 1."""
    if size % 2 != 1 or sigma <= 0:
        raise ValueError(f"Gaussian kernel needs an odd size and sigma > 0, got "
                         f"{size}, {sigma}")
    scale = -0.125 / (sigma * sigma)
    values = [math.exp(float(x * x) * scale) for x in range(1 - size, 0, 2)]
    mul = 1.0 / (2.0 * sum(values) + 1.0)
    side = [v * mul for v in values]
    return np.array(side + [mul] + side[::-1], np.float64)


def gaussian_kernel_fixed(size: int, sigma: float, bits: int = 8) -> np.ndarray:
    """The ``bits``-bit fixed-point kernel OpenCV filters uint8 images with:
    :func:`gaussian_kernel` scaled by 2^bits and rounded by error diffusion
    from the outside in, the centre taking what makes the sum exactly
    2^bits."""
    kernel = gaussian_kernel(size, sigma)
    half = size // 2
    out = np.zeros(size, np.int64)
    err = 0.0
    for i in range(half):
        adjusted = kernel[i] * float(1 << bits) + err
        value = round(adjusted)  # half to even, as cvRound
        err = adjusted - value
        out[i] = out[size - 1 - i] = value
    out[half] = (1 << bits) - 2 * int(out[:half].sum())
    return out


def gaussian_blur_plain(img: np.ndarray, ksize: Tuple[int, int], sigma_x: float,
                        sigma_y: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigmaX, sigmaY)`` of an (H, W, C)
    image in numpy; ``ksize`` is (width, height), both odd, as OpenCV takes it.
    uint8 is bit-equal to OpenCV; a float image is filtered with the float
    kernel in its own precision (OpenCV's float path, up to the order of
    its sums)."""
    img = _check_image(img)
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    h, w = src.shape[:2]
    if src.dtype != np.uint8:
        t = src.dtype.type
        kx = gaussian_kernel(int(ksize[0]), float(sigma_x)).astype(np.float32).astype(t)
        ky = gaussian_kernel(int(ksize[1]), float(sigma_y)).astype(np.float32).astype(t)
        rx, ry = len(kx) // 2, len(ky) // 2
        padded = np.pad(src, ((ry, ry), (rx, rx), (0, 0)), mode="reflect")
        rows = sum(kx[j] * padded[:, j:j + w] for j in range(len(kx)))
        out = sum(ky[i] * rows[i:i + h] for i in range(len(ky)))
        return out[:, :, 0] if squeeze else out
    kx = gaussian_kernel_fixed(int(ksize[0]), float(sigma_x))
    ky = gaussian_kernel_fixed(int(ksize[1]), float(sigma_y))
    rx, ry = len(kx) // 2, len(ky) // 2
    padded = np.pad(src.astype(np.int32), ((ry, ry), (rx, rx), (0, 0)), mode="reflect")
    rows = sum(int(kx[j]) * padded[:, j:j + w] for j in range(len(kx)))
    out = sum(int(ky[i]) * rows[i:i + h] for i in range(len(ky)))
    out = np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


# -- the host library (uint8) -----------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_image_ops_typed", False):
        u8p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.image_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64, u8p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.image_resize.restype = ctypes.c_int
        lib.image_rgb_to_hsv.argtypes = [u8p, u8p, i64]
        lib.image_rgb_to_hsv.restype = None
        lib.image_hsv_to_rgb.argtypes = [u8p, u8p, i64, ctypes.c_int]
        lib.image_hsv_to_rgb.restype = None
        lib.image_gaussian_blur.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64,
                                            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                            ctypes.c_double]
        lib.image_gaussian_blur.restype = ctypes.c_int
        lib.image_gaussian_kernel_fixed.argtypes = [ctypes.c_int, ctypes.c_double, u8p]
        lib.image_gaussian_kernel_fixed.restype = None
        lib._image_ops_typed = True
    return lib


def _hwc_rows(img: np.ndarray) -> Tuple[np.ndarray, int]:
    """``img`` as (H, W, C) uint8 whose pixels are packed within each row,
    and its row stride in bytes: a crop of a contiguous image is taken as
    it lies, anything else copied."""
    src = img[:, :, None] if img.ndim == 2 else img
    c = src.shape[2]
    if not (src.strides[2] == 1 and src.strides[1] == c and src.strides[0] >= src.shape[1] * c):
        src = np.ascontiguousarray(src)
    return src, src.strides[0]


def _same_shape(img: np.ndarray, out: np.ndarray) -> np.ndarray:
    return out[:, :, 0] if img.ndim == 2 else out


def resize(img: np.ndarray, height: int, width: int, interpolation: str) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA,
    INTER_LINEAR or INTER_CUBIC)`` of an (H, W) or (H, W, C) image;
    ``interpolation`` is ``"area"``, ``"linear"`` or ``"cubic"`` (float
    images only). uint8 runs in the host library, bit-equal to OpenCV and
    to :func:`resize_plain`; a float image runs in :func:`resize_plain`."""
    img = _check_image(img)
    if img.dtype != np.uint8 or interpolation not in _INTERPOLATION or img.ndim not in (2, 3):
        return resize_plain(img, height, width, interpolation)
    height, width = int(height), int(width)
    if height <= 0 or width <= 0:
        raise ValueError(f"resize to an empty size ({height}, {width})")
    src, stride = _hwc_rows(img)
    sh, sw, cn = src.shape
    out = np.empty((height, width, cn), np.uint8)
    lib = _library()
    kernels.count_host_call("image_resize")
    if lib.image_resize(src.ctypes.data, sh, sw, cn, stride, out.ctypes.data, height, width,
                        _INTERPOLATION[interpolation]):
        raise ValueError(f"image_resize refused ({sh}, {sw}, {cn}) -> ({height}, {width})")
    return _same_shape(img, out)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` of uint8 (..., 3): hue in
    [0, 180), saturation and value in [0, 255]; in the host library."""
    rgb = _check_uint8(rgb)
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"the colour conversions take (..., 3) images, not {rgb.shape}")
    src = np.ascontiguousarray(rgb)
    out = np.empty(src.shape, np.uint8)
    lib = _library()
    kernels.count_host_call("image_rgb_to_hsv")
    lib.image_rgb_to_hsv(src.ctypes.data, out.ctypes.data, src.size // 3)
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of uint8 (..., 3) with hue
    in [0, 180); in the host library."""
    hsv = _check_uint8(hsv)
    if hsv.shape[-1:] != (3,):
        raise ValueError(f"the colour conversions take (..., 3) images, not {hsv.shape}")
    src = np.ascontiguousarray(hsv)
    out = np.empty(src.shape, np.uint8)
    # a row of OpenCV's conversion is the last axis but the channels (one
    # pixel: a row of one)
    width = src.shape[-2] if src.ndim >= 2 else 1
    lib = _library()
    kernels.count_host_call("image_hsv_to_rgb")
    if width:
        lib.image_hsv_to_rgb(src.ctypes.data, out.ctypes.data, src.size // (3 * width), width)
    return out


def gaussian_kernel_fixed_library(size: int, sigma: float) -> np.ndarray:
    """:func:`gaussian_kernel_fixed` (8 bits) as the host library computes
    it."""
    if size % 2 != 1 or sigma <= 0:
        raise ValueError(f"Gaussian kernel needs an odd size and sigma > 0, got "
                         f"{size}, {sigma}")
    out = np.empty(size, np.int32)
    _library().image_gaussian_kernel_fixed(int(size), float(sigma), out.ctypes.data)
    return out.astype(np.int64)


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int], sigma_x: float,
                  sigma_y: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigmaX, sigmaY)`` of an (H, W, C)
    image; ``ksize`` is (width, height), both odd, as OpenCV takes it.
    uint8 runs in the host library, bit-equal to OpenCV and to
    :func:`gaussian_blur_plain`; a float image runs in
    :func:`gaussian_blur_plain`."""
    img = _check_image(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        return gaussian_blur_plain(img, ksize, sigma_x, sigma_y)
    kx, ky = int(ksize[0]), int(ksize[1])
    for size, sigma in ((kx, float(sigma_x)), (ky, float(sigma_y))):
        if size % 2 != 1 or sigma <= 0:
            raise ValueError(f"Gaussian kernel needs an odd size and sigma > 0, got "
                             f"{size}, {sigma}")
    src, stride = _hwc_rows(img)
    h, w, cn = src.shape
    out = np.empty((h, w, cn), np.uint8)
    lib = _library()
    kernels.count_host_call("image_gaussian_blur")
    if lib.image_gaussian_blur(src.ctypes.data, h, w, cn, stride, out.ctypes.data, kx, ky,
                               float(sigma_x), float(sigma_y)):
        raise ValueError(f"image_gaussian_blur refused ({h}, {w}, {cn}) at {ksize}")
    return _same_shape(img, out)
