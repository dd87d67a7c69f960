"""Encoders for the image formats the port decodes beside JPEG: PNG (any
colour type and depth, Adam7, an ``eXIf`` chunk), baseline TIFF (strips or
tiles, every compression, predictor, planar configuration and depth the
port takes) and run-length BMP. Numpy, ``zlib`` and ``struct`` only, so the
tests, ``make_fixtures.py`` and ``chip_smoke.py`` (on a machine without
OpenCV or PIL) write the same files.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def exif_orientation(value: int, order: str = "<") -> bytes:
    """A TIFF stream whose IFD0 holds only the orientation tag."""
    magic = b"II*\x00" if order == "<" else b"MM\x00*"
    return (magic + struct.pack(order + "IH", 8, 1)
            + struct.pack(order + "HHI", 0x0112, 3, 1) + struct.pack(order + "HH", value, 0)
            + bytes(4))


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    row, prev = row.astype(np.int16), prev.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int16), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) >> 1
    else:
        pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
        pc = np.abs(left + prev - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((row - pred) & 255).astype(np.uint8)


def _png_rows(samples: np.ndarray, depth: int):
    """(rows of bytes, bytes a pixel) of (h, w, c) samples at ``depth``."""
    h = samples.shape[0]
    if depth < 8:
        bits = np.unpackbits(samples[:, :, 0].astype(np.uint8)[:, :, None], axis=2)
        return np.packbits(bits[:, :, 8 - depth:].reshape(h, -1), axis=1), 1
    if depth == 16:
        be = np.ascontiguousarray(samples, dtype=">u2")
        return be.reshape(h, -1).view(np.uint8).reshape(h, -1), 2 * samples.shape[2]
    return samples.astype(np.uint8).reshape(h, -1), samples.shape[2]


def png(samples: np.ndarray, ctype: int, depth: int = 8, *, interlace: bool = False,
        filters: Sequence[int] = (0, 1, 2, 3, 4), palette: Optional[np.ndarray] = None,
        exif: Optional[bytes] = None) -> bytes:
    """A PNG of ``samples`` ((h, w) or (h, w, c) integers at ``depth`` bits),
    the rows filtered with ``filters`` in turn, Adam7 when ``interlace``,
    with a PLTE of ``palette`` ((n, 3) uint8) and an ``eXIf`` chunk of
    ``exif``."""
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    assert c == _PNG_CHANNELS[ctype]
    passes = [samples[y0::dy, x0::dx] for y0, x0, dy, dx in ADAM7] if interlace else [samples]
    raw, k = [], 0
    for sub in passes:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows, bpp = _png_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            kind = filters[k % len(filters)]
            k += 1
            raw.append(bytes([kind]) + _filter_row(kind, row, prev, bpp).tobytes())
            prev = row
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                         0, int(interlace)))
    if exif is not None:
        out += png_chunk(b"eXIf", exif)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + png_chunk(b"IDAT", zlib.compress(b"".join(raw), 6)) + png_chunk(b"IEND", b"")


# --------------------------------------------------------------------- TIFF

def lzw(data: bytes) -> bytes:
    """TIFF's LZW (MSB-first codes, 9 to 12 bits, the width raised one code
    early), starting with a clear code and ending with end-of-information."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    table = {}  # (prefix code << 8 | byte) -> code
    nxt = 258
    put(256)
    cur = -1
    for b in data:
        if cur < 0:
            cur = b
            continue
        key = cur << 8 | b
        code = table.get(key)
        if code is not None:
            cur = code
            continue
        put(cur)
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table = {}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        cur = b
    if cur >= 0:
        put(cur)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_TYPES = {"H": 3, "I": 4}


def _pack_rows(samples: np.ndarray, bits: int, order: str, predictor: int) -> bytes:
    """(h, w, c) samples as TIFF rows: predictor 2 differences along each
    row, sub-byte samples packed MSB first, each row padded to a byte."""
    h, w, c = samples.shape
    s = samples.astype(np.int64)
    if predictor == 2:
        s = s.copy()
        s[:, 1:] = (s[:, 1:] - s[:, :-1]) % (1 << bits)
    if bits == 16:
        return s.astype(order + "u2").tobytes()
    if bits == 8:
        return s.astype(np.uint8).tobytes()
    flat = s.reshape(h, w * c).astype(np.uint8)
    rowbits = np.unpackbits(flat[:, :, None], axis=2)[:, :, 8 - bits:].reshape(h, -1)
    return np.packbits(rowbits, axis=1).tobytes()


def tiff(samples: np.ndarray, *, photometric: int, bits: int = 8, compression: int = 1,
         predictor: int = 1, planar: int = 1, order: str = "<",
         rows_per_strip: Optional[int] = None, tile: Optional[int] = None,
         colormap: Optional[np.ndarray] = None, extra: Optional[int] = None,
         orientation: Optional[int] = None, extra_tags: Optional[dict] = None) -> bytes:
    """A one-image TIFF of ``samples`` ((h, w) or (h, w, c) integers at
    ``bits`` bits) in byte order ``order`` ("<" or ">"), in strips of
    ``rows_per_strip`` rows or ``tile`` x ``tile`` tiles, compressed with
    ``compression`` (1, 5 LZW, 8 or 32946 Deflate, 32773 PackBits); an
    ``extra`` value writes ExtraSamples for the channels past the colour
    ones, ``colormap`` ((2**bits, 3) uint16) a palette image; ``extra_tags``
    (tag -> SHORT values) adds or overrides IFD entries."""
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    compress = {1: lambda b: b, 5: lzw, 8: lambda b: zlib.compress(b, 6),
                32946: lambda b: zlib.compress(b, 6), 32773: packbits}[compression]
    planes = [samples[:, :, i:i + 1] for i in range(c)] if planar == 2 else [samples]
    blocks, sizes = [], {}
    if tile is None:
        rows_per_strip = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rows_per_strip):
                blocks.append(compress(_pack_rows(plane[y:y + rows_per_strip], bits, order,
                                                  predictor)))
    else:
        for plane in planes:
            for y in range(0, h, tile):
                for x in range(0, w, tile):
                    block = np.zeros((tile, tile, plane.shape[2]), plane.dtype)
                    part = plane[y:y + tile, x:x + tile]
                    block[:part.shape[0], :part.shape[1]] = part
                    blocks.append(compress(_pack_rows(block, bits, order, predictor)))
    tags = [(256, "I", [w]), (257, "I", [h]), (258, "H", [bits] * c), (259, "H", [compression]),
            (262, "H", [photometric]), (277, "H", [c]), (284, "H", [planar])]
    if orientation is not None:
        tags.append((274, "H", [orientation]))
    if predictor != 1:
        tags.append((317, "H", [predictor]))
    if colormap is not None:
        tags.append((320, "H", list(np.asarray(colormap, np.uint16).T.ravel())))
    if extra is not None:
        tags.append((338, "H", [extra] * (c - (1 if photometric in (0, 1, 3) else 3))))
    offsets_tag = 324 if tile is not None else 273
    counts_tag = 325 if tile is not None else 279
    if tile is not None:
        tags += [(322, "I", [tile]), (323, "I", [tile])]
    else:
        tags.append((278, "I", [rows_per_strip]))
    tags += [(offsets_tag, "I", [0] * len(blocks)), (counts_tag, "I", [len(b) for b in blocks])]
    tags = sorted({**{t[0]: t for t in tags},
                   **{tag: (tag, "H", list(v)) for tag, v in (extra_tags or {}).items()}}.values())
    # layout: header, the image data, the IFD, then the values that do not fit
    data_at = 8
    positions, at = [], data_at
    for b in blocks:
        positions.append(at)
        at += len(b) + (len(b) & 1)
    ifd_at = at
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, values = bytearray(struct.pack(order + "H", len(tags))), bytearray()
    for tag, kind, vals in tags:
        if tag == offsets_tag:
            vals = positions
        payload = struct.pack(order + kind * len(vals), *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", extra_at + len(values))
            values += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(order + "HHI", tag, _TYPES[kind], len(vals)) + field
    ifd += bytes(4)
    magic = b"II*\x00" if order == "<" else b"MM\x00*"
    body = b"".join(b + b"\0" * (len(b) & 1) for b in blocks)
    return magic + struct.pack(order + "I", ifd_at) + body + bytes(ifd) + bytes(values)


# ---------------------------------------------------------------------- BMP

def _rle_line(row: np.ndarray, rle4: bool) -> bytes:
    """One line of RLE8 or RLE4: runs of equal indices (two alternating
    for RLE4), literals where the indices change, then an end of line."""
    out, x, w = bytearray(), 0, len(row)
    step = 2 if rle4 else 1
    while x < w:
        n = 1
        while x + n < w and n < 255 and row[x + n] == row[x + n - step] and (
                rle4 or row[x + n] == row[x]):
            n += 1
        if n >= 3 or w - x < 3:
            out += bytes([n, (row[x] << 4 | (row[x + 1] if n > 1 else 0)) if rle4 else row[x]])
            x += n
            continue
        n = 3
        while x + n < w and n < 255 and not (x + n + 2 < w and row[x + n] == row[x + n + 1]
                                             == row[x + n + 2]):
            n += 1
        lit = row[x:x + n]
        if rle4:
            padded = np.concatenate([lit, np.zeros(n & 1, lit.dtype)])
            body = (padded[0::2] << 4 | padded[1::2]).astype(np.uint8).tobytes()
        else:
            body = lit.astype(np.uint8).tobytes()
        out += bytes([0, n]) + body + b"\0" * (len(body) & 1)
        x += n
    return bytes(out) + b"\0\0"


def bmp_rle(index: np.ndarray, palette: np.ndarray, rle4: bool = False,
            delta_at: Optional[tuple] = None) -> bytes:
    """A bottom-up RLE8 (or RLE4) BMP of ``index`` ((h, w) palette indices)
    with ``palette`` ((n, 3) RGB); ``delta_at`` (line, dx) stops that
    stored line halfway with a delta of dx pixels and an end of line, so
    the pixels it skips read index 0 (OpenCV; PIL reads a delta's two bytes
    after two more)."""
    h, w = index.shape
    lines = []
    for i, row in enumerate(index[::-1]):
        if delta_at is not None and i == delta_at[0]:
            half = _rle_line(row[:w // 2], rle4)[:-2]
            lines.append(half + bytes([0, 2, delta_at[1], 0, 0, 0]))
            continue
        lines.append(_rle_line(row, rle4))
    body = b"".join(lines)[:-2] + b"\0\1"
    pal = np.c_[np.asarray(palette)[:, ::-1], np.zeros(len(palette), np.uint8)]
    pal = pal.astype(np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 4 if rle4 else 8, 2 if rle4 else 1,
                       len(body), 2835, 2835, len(palette), 0)
    offset = 14 + 40 + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + body
