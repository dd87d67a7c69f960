"""A BMP decoder in numpy: the host's BMP reader where neither OpenCV nor
PIL is installed.

:func:`decode_bytes` returns RGB uint8 (H, W, 3), bit-equal to the caller's
reference:

- ``reference="cv2"`` is the JAX package's dataset reader,
  ``cv2.imread(path, cv2.IMREAD_COLOR)`` then BGR→RGB, and PIL where OpenCV
  refuses the file;
- ``reference="pil"`` is the server's ``Image.open(path).convert("RGB")``.

It takes the OS/2 core header (12 bytes) and BITMAPINFOHEADER to
BITMAPV5HEADER (40 to 124 bytes), bottom-up or top-down: 1-, 4- and 8-bit
palette images (an index past the palette reads black), RLE8 and RLE4 (each
reference's own reading of the escapes, deltas and skipped pixels), 16-bit
pixels as 5-5-5 (BI_RGB) or with 5-5-5 or 5-6-5 bit-field masks (OpenCV
shifts each field up, PIL scales it to 255), 24-bit BGR, and 32-bit pixels
(OpenCV reads BGRx bytes, or a V3 or later header's masks scaled to 255;
PIL takes the masks it knows). Alpha is
dropped without compositing, as ``IMREAD_COLOR`` and ``convert("RGB")`` drop
it.

Embedded JPEG or PNG data, 16-bit pixels with other masks, and 32-bit masks
PIL does not know (under ``"pil"``) are refused by name with
:class:`UnsupportedBMP`, so that a caller with another decoder may hand them
on; a damaged file raises ``ValueError`` with the byte offset.
"""

from __future__ import annotations

import struct

import numpy as np

# compression codes of the info header
_COMPRESSION = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG",
                5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}
_MASKS555 = (0x7C00, 0x03E0, 0x001F)
_MASKS565 = (0xF800, 0x07E0, 0x001F)
# the (red, green, blue, alpha) masks PIL reads 32-bit pixels with
_PIL_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0),
}
REFERENCES = ("cv2", "pil")


class UnsupportedBMP(ValueError):
    """A valid BMP this decoder does not take (embedded JPEG or PNG, other
    16-bit masks, ...)."""


class _OpenCVRefuses(Exception):
    """OpenCV's reader fails on this file; the JAX package then reads it
    with PIL."""


def is_bmp(data: bytes) -> bool:
    return data[:2] == b"BM"


def _fill_rle_cv2(data: bytes, offset: int, width: int, height: int,
                  rle4: bool) -> np.ndarray:
    """The palette indices (height * width, rows in stored order) that
    OpenCV's BMP reader fills from RLE8 or RLE4 data: skipped pixels, a
    line's rest at an end of line and the image's rest at the end of the
    bitmap take index 0 (RLE4: the end of the bitmap fills only the line's
    rest and reading goes on); a delta skips dx + dy * width pixels in
    reading order (RLE4: dx). A run past its line's end is damage; data that ends before the
    end-of-bitmap escape makes OpenCV fail."""
    out = np.zeros(height * width, np.uint8)
    n = len(data)
    state = {"pos": 0, "y": 0, "end": width}

    def fill(count: int, value) -> None:  # OpenCV's FillUniColor
        while True:
            pos = state["pos"]
            stop = min(pos + count, state["end"])
            count -= stop - pos
            out[pos:stop] = value
            state["pos"] = stop
            if stop >= state["end"]:
                state["end"] += width
                state["y"] += 1
                if state["y"] >= height:
                    return
            if count <= 0:
                return

    def need(p: int, k: int) -> None:
        if p + k > n:
            raise _OpenCVRefuses(f"BMP RLE data ends at byte {n}")

    p, wrapped = offset, 0
    while True:
        need(p, 2)
        count, code = data[p], data[p + 1]
        at, p = p, p + 2
        pos = state["pos"]
        if count:  # a run of one index (RLE8) or of two alternating (RLE4)
            if pos + count > state["end"]:
                raise ValueError(f"BMP RLE run at byte {at} runs past its line's end")
            if rle4:
                out[pos:pos + count] = np.resize(np.array([code >> 4, code & 15], np.uint8),
                                                 count)
                state["pos"] = pos + count
            else:
                y0 = state["y"]
                fill(count, code)
                wrapped = state["y"] - y0
                if state["y"] >= height:
                    break
        elif code > 2:  # absolute: `code` indices, padded to 16 bits
            if pos + code > state["end"]:
                raise ValueError(f"BMP RLE literal at byte {at} runs past its line's end")
            size = (((code + 1) >> 1) + 1) & ~1 if rle4 else (code + 1) & ~1
            need(p, size)
            raw = np.frombuffer(data, np.uint8, size, p)
            if rle4:
                raw = np.stack([raw >> 4, raw & 15], 1).ravel()
            out[pos:pos + code] = raw[:code]
            state["pos"], p, wrapped = pos + code, p + size, 0
        else:  # 0 end of line, 1 end of bitmap, 2 delta
            skip, lines = state["end"] - pos, height - state["y"]
            if rle4 or code or not wrapped or skip < width:
                if code == 2:
                    need(p, 2)
                    skip, lines = data[p], data[p + 1]
                    p += 2
                if code and not rle4:  # OpenCV's RLE4 skips only dx or the line's rest
                    skip += lines * width
                if state["y"] >= height:
                    break
                fill(skip, 0)
            wrapped = 0
            if state["y"] >= height:
                break
    return out


def _fill_rle_pil(data: bytes, offset: int, width: int, height: int,
                  rle4: bool) -> np.ndarray:
    """The palette indices (height * width, rows in stored order) that
    PIL's ``BmpRleDecoder`` reads from RLE8 or RLE4 data: runs cut at the
    line's end, index 0 to the line's end at an end of line and for a
    delta's right + up * width pixels (a delta's two bytes are read after
    two more), an odd RLE4 literal's last pixel dropped, literals padded to
    an even file offset. Raises where the data gives fewer pixels than the
    image holds."""
    out, x, n, p = bytearray(), 0, len(data), offset
    total = width * height
    while len(out) < total:
        if p + 2 > n:
            break
        count, code = data[p], data[p + 1]
        p += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                out += bytes([code >> 4, code & 15]) * (count // 2)
                out += bytes([code >> 4]) * (count % 2)
            else:
                out += bytes([code]) * count
            x += count
        elif code == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif code == 1:
            break
        elif code == 2:
            if p + 4 > n:
                raise ValueError(f"BMP RLE delta at byte {p - 2} is truncated")
            right, up = data[p + 2], data[p + 3]
            p += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            size = code // 2 if rle4 else code
            chunk = data[p:p + size]
            p += len(chunk)
            if rle4:
                nibbles = np.frombuffer(chunk, np.uint8)
                chunk = np.stack([nibbles >> 4, nibbles & 15], 1).tobytes()
            out += chunk
            if len(chunk) < (2 * size if rle4 else size):
                break
            x += code
            p += p % 2
    if len(out) < total:
        raise ValueError(f"BMP RLE data ends at byte {min(p, n)} with {len(out)} of "
                         f"{total} pixels")
    return np.frombuffer(bytes(out[:total]), np.uint8)


def _header(data: bytes):
    """(header size, width, height, bits a pixel, compression, palette
    colours, palette entry bytes) of the file's info header."""
    if not is_bmp(data) or len(data) < 30:
        raise ValueError("not a BMP file (no BM signature)")
    (header,) = struct.unpack_from("<I", data, 14)
    if header == 12:  # OS/2 BITMAPCOREHEADER: 16-bit sizes, 3-byte palette entries
        if len(data) < 26:
            raise ValueError("BMP core header is truncated")
        width, height, _, bpp = struct.unpack_from("<HHHH", data, 18)
        if bpp not in (1, 4, 8, 24, 32):
            raise ValueError(f"BMP core header with {bpp} bits a pixel is invalid")
        return header, width, height, bpp, 0, 0, 3
    if header < 40 or header > 124 or len(data) < 14 + header:
        raise ValueError(f"BMP info header of {header} bytes is invalid or truncated")
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    (colors,) = struct.unpack_from("<I", data, 46)
    return header, width, height, bpp, compression, colors, 4


def _masks(data: bytes, at: int, count: int):
    if at + 4 * count > len(data):
        return None
    return struct.unpack_from(f"<{count}I", data, at)


def _sixteen(rows: np.ndarray, width: int, masks, scale: bool) -> np.ndarray:
    """16-bit pixels with 5-5-5 or 5-6-5 ``masks`` (red, green, blue) as RGB:
    each field shifted to the top of its byte (OpenCV) or scaled to 255
    (``scale``, PIL)."""
    v = rows[:, :2 * width].view("<u2").astype(np.int32)
    out = []
    for mask in masks:
        shift = (mask & -mask).bit_length() - 1
        top = (mask >> shift).bit_length()
        field = (v & mask) >> shift
        out.append(field * 255 // ((1 << top) - 1) if scale else field << (8 - top))
    return np.stack(out, 2).astype(np.uint8)


def _thirty_two(rows: np.ndarray, width: int, masks) -> np.ndarray:
    """32-bit pixels read with contiguous (red, green, blue) masks, each field
    scaled to 255 (v * 255 // its largest value, exact for byte-wide
    fields); a zero mask reads 0."""
    v = rows[:, :4 * width].view("<u4").astype(np.uint64)
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1 if m else 0
        top = m >> shift
        out.append(((v & m) >> shift) * 255 // top if top else np.zeros_like(v))
    return np.stack(out, 2).astype(np.uint8)


def decode_bytes(data: bytes, reference: str = "cv2") -> np.ndarray:
    """The BMP ``data`` as RGB uint8 (H, W, 3), as ``reference`` ("cv2" or
    "pil") reads it; see the module docstring."""
    if reference not in REFERENCES:
        raise ValueError(f"reference must be one of {REFERENCES}, not {reference!r}")
    header, width, height, bpp, compression, colors, entry = _header(data)
    (offset,) = struct.unpack_from("<I", data, 10)
    name = _COMPRESSION.get(compression, f"compression {compression}")
    if compression in (4, 5, 6) or compression not in _COMPRESSION:
        raise UnsupportedBMP(f"BMP with {name} data is not supported by this decoder")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP with {bpp} bits a pixel is invalid")
    rle = compression in (1, 2)
    if rle and bpp != (8 if compression == 1 else 4):
        raise ValueError(f"BMP {name} at {bpp} bits a pixel is invalid")
    if compression == 3 and bpp not in (16, 32):
        raise UnsupportedBMP(f"BMP {name} at {bpp} bits a pixel is not supported by this "
                             "decoder")
    if width <= 0 or height == 0:
        raise ValueError(f"BMP size {width}x{height} is invalid")
    top_down, height = height < 0, abs(height)
    pil = reference == "pil"

    masks16 = masks32 = None
    if bpp == 16:
        if compression == 0:
            masks16, scale = _MASKS555, pil
        else:
            # OpenCV reads the masks after the info header, whatever its
            # size, and fails on any but these two; PIL, and the JAX
            # package after OpenCV fails, read them where the header says
            after = _masks(data, 14 + header, 3)
            after = after and tuple(after[::-1])
            inside = _masks(data, 54, 3)
            if not pil and after in ((0x1F, 0x3E0, 0x7C00), (0x1F, 0x7E0, 0xF800)):
                masks16, scale = after[::-1], False
            elif inside in (_MASKS555, _MASKS565):
                masks16, scale = inside, True
            else:
                got = "missing" if inside is None else ", ".join(f"0x{m:04X}" for m in inside)
                raise UnsupportedBMP(f"BMP 16-bit {name} masks {got} are not supported "
                                     "(5-5-5 and 5-6-5 are)")
    elif bpp == 32 and pil and compression == 3:
        alpha = _masks(data, 66, 1) if header >= 56 else (0,)
        rgba = (_masks(data, 54, 3) or ()) + (alpha or ())
        if rgba not in _PIL_MASKS32:
            raise UnsupportedBMP(f"BMP 32-bit {name} masks "
                                 f"{', '.join(f'0x{m:08X}' for m in rgba)} are not "
                                 "supported under the PIL reference")
        masks32 = rgba[:3] if any(rgba) else (0xFF0000, 0xFF00, 0xFF)
    elif bpp == 32 and compression == 3 and header >= 56 and any(_masks(data, 54, 3)):
        masks32 = _masks(data, 54, 3)  # OpenCV reads a V3+ header's masks
        for m in masks32:
            low = m >> ((m & -m).bit_length() - 1) if m else 0
            if low & (low + 1):
                raise UnsupportedBMP(f"BMP 32-bit {name} mask 0x{m:08X} is not contiguous, "
                                     "which is not supported under the OpenCV reference")

    palette = None
    if bpp <= 8:
        count = colors or 1 << bpp
        if count > 1 << bpp:
            raise ValueError(f"BMP palette of {count} colours at {bpp} bits a pixel")
        start = 14 + header
        if start + entry * count > len(data):
            raise ValueError(f"BMP palette at byte {start} runs past the end of the file")
        palette = np.zeros((256, 3), np.uint8)
        palette[:count] = np.frombuffer(data, np.uint8, entry * count, start).reshape(
            count, entry)[:, 2::-1]

    if rle:
        if offset >= len(data):
            raise ValueError(f"BMP RLE data offset {offset} is past the end of the file")
        fill = _fill_rle_pil if pil else _fill_rle_cv2
        try:
            index = fill(data, offset, width, height, compression == 2)
        except _OpenCVRefuses:
            index = _fill_rle_pil(data, offset, width, height, compression == 2)
        index = index.reshape(height, width)
        return palette[index if top_down else index[::-1]]

    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * height > len(data):
        raise ValueError(f"BMP pixel data ({stride * height} bytes at offset {offset}) "
                         f"runs past the end of the file ({len(data)} bytes)")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        bits = np.unpackbits(rows, axis=1) if bpp < 8 else rows
        if bpp == 4:
            bits = bits.reshape(height, -1, 4)
            index = (bits[..., 0] << 3 | bits[..., 1] << 2 | bits[..., 2] << 1
                     | bits[..., 3])
        else:
            index = bits
        return palette[index[:, :width]]
    if bpp == 16:
        return _sixteen(np.ascontiguousarray(rows), width, masks16, scale)
    if masks32 is not None:
        return _thirty_two(np.ascontiguousarray(rows), width, masks32)
    channels = bpp // 8
    return np.ascontiguousarray(
        rows[:, :width * channels].reshape(height, width, channels)[..., 2::-1])


def decode(path: str, **kwargs) -> np.ndarray:
    """The BMP file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
