"""WebP decoding on the port's own host C++ (``csrc/webp_decode.cpp``, in
the image library :data:`vit_ssl_tpu_torch.kernels.HOST_IMAGE`): the host's
WebP reader where neither OpenCV nor PIL is installed.

:func:`decode_bytes` returns RGB uint8 (H, W, 3), bit-equal to libwebp as
OpenCV (``cv2.imread(path, cv2.IMREAD_COLOR)``, ``WebPDecodeBGRInto``) and
PIL (``Image.open(path).convert("RGB")``) run it. The C entry reads the
container too (the whole-batch decode calls the same entry): a simple lossy
(``VP8 ``) or lossless (``VP8L``) file, or an extended one (``VP8X``) whose
``ALPH`` chunk is dropped, as both references drop alpha. The ``EXIF``
chunk's orientation is applied when ``exif_orientation`` (OpenCV's reader
applies it; PIL's ``convert`` does not). Animated files are refused by name
with :class:`UnsupportedWebP`; a damaged file raises ``ValueError`` naming
the byte offset.

The library is compiled with the host's C++ compiler at first use
(:func:`vit_ssl_tpu_torch.kernels.load_host`); its entry is called through
``ctypes``, which releases the GIL, so a loader's threads decode at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import kernels

LIBRARY = kernels.HOST_IMAGE
_MESSAGE = 512
_UNSUPPORTED = 1


class UnsupportedWebP(ValueError):
    """A valid WebP this decoder does not take (an animation)."""


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_webp_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.webp_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.c_int]
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_free.argtypes = [u8p]
        lib.webp_free.restype = None
        lib._webp_typed = True
    return lib


def decode_bytes(data: bytes, *, exif_orientation: bool = True) -> np.ndarray:
    """The WebP ``data`` as RGB uint8 (H, W, 3); the EXIF orientation is
    applied when ``exif_orientation`` (OpenCV's reader) and not otherwise
    (PIL's)."""
    data = bytes(data)
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MESSAGE)
    kernels.count_host_call("webp_decode")
    status = lib.webp_decode(data, len(data), int(exif_orientation), ctypes.byref(out),
                             ctypes.byref(h), ctypes.byref(w), msg, _MESSAGE)
    if status:
        text = msg.value.decode(errors="replace")
        raise (UnsupportedWebP if status == _UNSUPPORTED else ValueError)(text)
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.webp_free(out)


def decode(path: str, **kwargs) -> np.ndarray:
    """The WebP file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
