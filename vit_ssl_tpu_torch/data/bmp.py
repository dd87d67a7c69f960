"""A BMP decoder in numpy: the host's BMP reader where neither OpenCV nor
PIL is installed.

:func:`decode_bytes` returns RGB uint8 (H, W, 3), bit-equal to
``cv2.imread(path, cv2.IMREAD_COLOR)`` followed by BGR→RGB. It takes
uncompressed files with a BITMAPINFOHEADER or a later header (40 to 124
bytes): 1-, 4- and 8-bit palette images (an index past the palette reads
black), 24-bit BGR, and 32-bit BGRA stored as BI_RGB or as BI_BITFIELDS
with the standard masks (red 0x00FF0000, green 0x0000FF00, blue 0x000000FF),
bottom-up or top-down. Alpha is dropped without compositing, as
``IMREAD_COLOR`` drops it.

Run-length (RLE4, RLE8) and embedded JPEG or PNG data, 16-bit pixels, other
bit-field masks and the OS/2 core header are refused by name with
:class:`UnsupportedBMP`, so that a caller with another decoder may hand them
on; a damaged file raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

# compression codes of the info header
_COMPRESSION = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG",
                5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}
_BGRA_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)


class UnsupportedBMP(ValueError):
    """A valid BMP this decoder does not take (RLE, 16-bit, other masks, ...)."""


def is_bmp(data: bytes) -> bool:
    return data[:2] == b"BM"


def decode_bytes(data: bytes) -> np.ndarray:
    """The BMP ``data`` as RGB uint8 (H, W, 3)."""
    if not is_bmp(data) or len(data) < 30:
        raise ValueError("not a BMP file (no BM signature)")
    (offset,) = struct.unpack_from("<I", data, 10)
    (header,) = struct.unpack_from("<I", data, 14)
    if header == 12:
        raise UnsupportedBMP("BMP with an OS/2 BITMAPCOREHEADER is not supported by "
                             "this decoder")
    if header < 40 or header > 124 or len(data) < 14 + header:
        raise ValueError(f"BMP info header of {header} bytes is invalid or truncated")
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    (colors,) = struct.unpack_from("<I", data, 46)
    name = _COMPRESSION.get(compression, f"compression {compression}")
    if compression in (1, 2, 4, 5) or compression not in _COMPRESSION:
        raise UnsupportedBMP(f"BMP with {name} data is not supported by this decoder")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP with {bpp} bits a pixel is invalid")
    if bpp == 16:
        raise UnsupportedBMP("16-bit BMP images are not supported by this decoder")
    if compression in (3, 6):
        if bpp != 32:
            raise ValueError(f"BMP {name} at {bpp} bits a pixel is invalid")
        masks = struct.unpack_from("<III", data, 54) if len(data) >= 66 else None
        if masks != _BGRA_MASKS:
            got = "missing" if masks is None else ", ".join(f"0x{m:08X}" for m in masks)
            raise UnsupportedBMP(f"BMP {name} masks {got} are not supported by this "
                                 "decoder (it takes red 0x00FF0000, green 0x0000FF00, "
                                 "blue 0x000000FF)")
    if width <= 0 or height == 0:
        raise ValueError(f"BMP size {width}x{height} is invalid")
    top_down, height = height < 0, abs(height)
    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * height > len(data):
        raise ValueError(f"BMP pixel data ({stride * height} bytes at offset {offset}) "
                         f"runs past the end of the file ({len(data)} bytes)")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        count = colors or 1 << bpp
        if count > 1 << bpp:
            raise ValueError(f"BMP palette of {count} colours at {bpp} bits a pixel")
        start = 14 + header
        if start + 4 * count > len(data):
            raise ValueError("BMP palette runs past the end of the file")
        palette = np.zeros((256, 3), np.uint8)
        palette[:count] = np.frombuffer(data, np.uint8, 4 * count, start).reshape(
            count, 4)[:, 2::-1]
        bits = np.unpackbits(rows, axis=1) if bpp < 8 else rows
        if bpp == 4:
            bits = bits.reshape(height, -1, 4)
            index = (bits[..., 0] << 3 | bits[..., 1] << 2 | bits[..., 2] << 1
                     | bits[..., 3])
        else:
            index = bits
        return palette[index[:, :width]]
    channels = bpp // 8
    return np.ascontiguousarray(
        rows[:, :width * channels].reshape(height, width, channels)[..., 2::-1])
