"""The EXIF orientation, as OpenCV's reader applies it: the tag is read from
IFD0 of a TIFF stream (a PNG ``eXIf`` chunk, in the PNG decoder's plain
version), the same rule as the host C++'s (``csrc/host_image.h``,
``exif_orientation``, which the JPEG, PNG and WebP decoders and the
whole-batch decode share), and applied as OpenCV's ``ApplyExifOrientation``
does (also to a TIFF, by its own orientation tag)."""

from __future__ import annotations

import struct

import numpy as np


def orientation(tiff: bytes) -> int:
    """IFD0's orientation tag (0x0112) of the TIFF stream ``tiff``; 1 when
    the stream, its IFD or the tag is absent or out of range."""
    order = {b"II": "<", b"MM": ">"}.get(bytes(tiff[:2]))
    if order is None or len(tiff) < 8 or struct.unpack_from(order + "H", tiff, 2)[0] != 42:
        return 1
    (ifd,) = struct.unpack_from(order + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (entries,) = struct.unpack_from(order + "H", tiff, ifd)
    for i in range(entries):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 1
        tag, kind = struct.unpack_from(order + "HH", tiff, at)
        if tag == 0x0112:
            value = (struct.unpack_from(order + "H", tiff, at + 8)[0] if kind == 3 else
                     struct.unpack_from(order + "I", tiff, at + 8)[0] if kind == 4 else 0)
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(image: np.ndarray, value: int) -> np.ndarray:
    """``image`` (H, W, C) turned upright for orientation ``value`` 1 to 8."""
    turned = {
        2: lambda a: a[:, ::-1],
        3: lambda a: a[::-1, ::-1],
        4: lambda a: a[::-1],
        5: lambda a: a.transpose(1, 0, 2),
        6: lambda a: a[::-1].transpose(1, 0, 2),
        7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
        8: lambda a: a[:, ::-1].transpose(1, 0, 2),
    }.get(value)
    return image if turned is None else np.ascontiguousarray(turned(image))
