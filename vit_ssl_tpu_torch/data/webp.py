"""WebP decoding on the port's own host library (``csrc/webp_decode.cpp``):
the host's WebP reader where neither OpenCV nor PIL is installed.

:func:`decode_bytes` returns RGB uint8 (H, W, 3), bit-equal to libwebp as
OpenCV (``cv2.imread(path, cv2.IMREAD_COLOR)``, ``WebPDecodeBGRInto``) and
PIL (``Image.open(path).convert("RGB")``) run it. The container is read
here: a simple lossy (``VP8 ``) or lossless (``VP8L``) file, or an extended
one (``VP8X``) whose ``ALPH`` chunk is dropped, as both references drop
alpha. The ``EXIF`` chunk's orientation is applied when ``exif_orientation``
(OpenCV's reader applies it; PIL's ``convert`` does not). Animated files are
refused by name with :class:`UnsupportedWebP`; a damaged file raises
``ValueError`` naming the byte offset.

The library is compiled with the host's C++ compiler at first use
(:func:`vit_ssl_tpu_torch.kernels.load_host`); its entry is called through
``ctypes``, which releases the GIL, so a loader's threads decode at once.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import kernels
from . import exif

LIBRARY = "webp_decode"
_MESSAGE = 512
_ANIMATION = 0x02


class UnsupportedWebP(ValueError):
    """A valid WebP this decoder does not take (an animation)."""


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.webp_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.c_int]
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_free.argtypes = [u8p]
        lib.webp_free.restype = None
        lib._typed = True
    return lib


def _chunks(data: bytes):
    """(FourCC, payload offset, payload size) of each chunk of the RIFF
    file."""
    if len(data) < 20 or not is_webp(data):
        raise ValueError("not a WebP file (no RIFF/WEBP header)")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff + 8 > len(data):
        raise ValueError(f"WebP RIFF size {riff} runs past the end of the file ({len(data)} "
                         "bytes)")
    end, at, out = riff + 8, 12, []
    while at + 8 <= end:
        kind = bytes(data[at:at + 4])
        (size,) = struct.unpack_from("<I", data, at + 4)
        if at + 8 + size > end:
            raise ValueError(f"WebP chunk {kind!r} at byte {at} runs past the end of the file")
        out.append((kind, at + 8, size))
        at += 8 + size + (size & 1)
    return out


def _payload(data: bytes):
    """(kind 0 lossy or 1 lossless, offset, size, canvas size or None, EXIF
    bytes or None)."""
    chunks = _chunks(data)
    if not chunks:
        raise ValueError("WebP file holds no chunk")
    canvas, exif_body = None, None
    if chunks[0][0] == b"VP8X":
        _, at, size = chunks[0]
        if size < 10:
            raise ValueError(f"WebP VP8X chunk at byte {at - 8} is truncated")
        flags = data[at]
        if flags & _ANIMATION or any(kind in (b"ANIM", b"ANMF") for kind, _, _ in chunks):
            raise UnsupportedWebP("animated WebP is not supported by this decoder")
        w = int.from_bytes(data[at + 4:at + 7], "little") + 1
        h = int.from_bytes(data[at + 7:at + 10], "little") + 1
        canvas = (h, w)
        body = next(((at, size) for kind, at, size in chunks if kind == b"EXIF"), None)
        if body is not None:
            exif_body = bytes(data[body[0]:body[0] + body[1]])
    frame = next(((kind, at, size) for kind, at, size in chunks if kind in (b"VP8 ", b"VP8L")),
                 None)
    if frame is None:
        raise ValueError("WebP file holds no VP8 or VP8L chunk")
    kind, at, size = frame
    return int(kind == b"VP8L"), at, size, canvas, exif_body


def decode_bytes(data: bytes, *, exif_orientation: bool = True) -> np.ndarray:
    """The WebP ``data`` as RGB uint8 (H, W, 3); the EXIF orientation is
    applied when ``exif_orientation`` (OpenCV's reader) and not otherwise
    (PIL's)."""
    data = bytes(data)
    kind, at, size, canvas, exif_body = _payload(data)
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MESSAGE)
    status = lib.webp_decode(data[at:at + size], size, kind, ctypes.byref(out), ctypes.byref(h),
                             ctypes.byref(w), msg, _MESSAGE)
    if status:
        raise ValueError(f"WebP {'VP8L' if kind else 'VP8'} data at byte {at}: "
                         f"{msg.value.decode(errors='replace')}")
    try:
        image = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.webp_free(out)
    if canvas is not None and canvas != image.shape[:2]:
        raise ValueError(f"WebP canvas {canvas[1]}x{canvas[0]} differs from its image "
                         f"{image.shape[1]}x{image.shape[0]}")
    if exif_orientation and exif_body is not None:
        image = exif.apply_orientation(image, exif.orientation(exif_body))
    return image


def decode(path: str, **kwargs) -> np.ndarray:
    """The WebP file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
