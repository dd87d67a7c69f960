"""JPEG decoding on the port's own host C++ (``csrc/jpeg_decode.cpp``, in the
image library :data:`vit_ssl_tpu_torch.kernels.HOST_IMAGE`):
the host's JPEG reader where neither OpenCV nor PIL is installed.

:func:`decode_bytes` returns RGB uint8 (H, W, 3), bit-equal to libjpeg-turbo
as OpenCV and PIL run it: the islow inverse DCT, fancy upsampling and the
fixed-point YCbCr tables. It takes baseline, extended sequential and
progressive Huffman files at 8 bits, with 1, 3 or 4 components, sampling
factors 1 and 2 and restart intervals. Grey is replicated into three
channels. Adobe's RGB (APP14 transform 0) is passed through, its CMYK and
YCCK converted as the caller's reference does:

- ``cmyk="cv2"`` with ``exif_orientation=True`` is the datasets' reference,
  ``cv2.imread(path, cv2.IMREAD_COLOR)`` then BGR→RGB (the JAX package's
  ``_load_image``): the EXIF orientation applied, OpenCV's CMYK→BGR;
- ``cmyk="pil"`` with ``exif_orientation=False`` is the server's,
  ``Image.open(path).convert("RGB")``: no rotation, PIL's CMYK→RGB.

Arithmetic coding, lossless and hierarchical frames, 12-bit samples,
sampling factors above 2 and progressive files left unrefined are refused
by name with :class:`UnsupportedJPEG`, so a caller with another decoder may
hand them on. A damaged file raises ``ValueError``: where libjpeg would warn
and recover (data cut short, a missing EOI, a bad Huffman code, a missing
or misplaced restart marker), this decoder names the byte offset instead.

The library is compiled with the host's C++ compiler at first use
(:func:`vit_ssl_tpu_torch.kernels.load_host`); its entry is called through
``ctypes``, which releases the GIL, so a loader's threads decode at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import kernels

LIBRARY = kernels.HOST_IMAGE
SOI = b"\xff\xd8\xff"
_CMYK = {"cv2": 0, "pil": 2}
_UNSUPPORTED, _INVALID = 1, 2
_MESSAGE = 512


class UnsupportedJPEG(ValueError):
    """A valid JPEG this decoder does not take (arithmetic coding, lossless,
    hierarchical, 12-bit, sampling factors above 2, ...)."""


def is_jpeg(data: bytes) -> bool:
    return data[:3] == SOI


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_jpeg_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.c_int]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_free.argtypes = [u8p]
        lib.jpeg_free.restype = None
        lib._jpeg_typed = True
    return lib


def decode_bytes(data: bytes, *, exif_orientation: bool = True,
                 cmyk: str = "cv2") -> np.ndarray:
    """The JPEG ``data`` as RGB uint8 (H, W, 3); see the module docstring
    for ``exif_orientation`` and ``cmyk`` ("cv2" or "pil")."""
    if cmyk not in _CMYK:
        raise ValueError(f"cmyk must be one of {sorted(_CMYK)}, not {cmyk!r}")
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MESSAGE)
    data = bytes(data)
    flags = int(exif_orientation) | _CMYK[cmyk]
    kernels.count_host_call("jpeg_decode")
    status = lib.jpeg_decode(data, len(data), flags, ctypes.byref(out), ctypes.byref(h),
                             ctypes.byref(w), msg, _MESSAGE)
    if status:
        text = f"JPEG: {msg.value.decode(errors='replace')}"
        raise (UnsupportedJPEG if status == _UNSUPPORTED else ValueError)(text)
    try:
        shape = (h.value, w.value, 3)
        return np.ctypeslib.as_array(out, shape=shape).copy()
    finally:
        lib.jpeg_free(out)


def decode(path: str, **kwargs) -> np.ndarray:
    """The JPEG file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
