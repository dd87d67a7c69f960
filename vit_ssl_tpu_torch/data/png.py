"""A PNG decoder: the host's image reader where neither OpenCV nor PIL is
installed. :func:`decode_bytes`, :func:`decode_many` and :func:`decode` run
the port's host C++ ``csrc/png_decode.cpp`` (over ``csrc/inflate.cpp``, in the
image library :data:`vit_ssl_tpu_torch.kernels.HOST_IMAGE`,
built with the host compiler at first use by
:func:`vit_ssl_tpu_torch.kernels.load_host`; its entry is called through
``ctypes``, which releases the GIL, so a loader's threads decode at once).
:func:`decode_bytes_plain` and :func:`decode_many_plain` are the same
decoder on ``zlib`` and numpy, the plain versions the library is held
against bit for bit. A library that does not build raises: nothing falls
back to the plain versions.

Each returns RGB uint8 (H, W, 3), bit-equal to the caller's
reference: ``reference="cv2"`` is ``cv2.imread(path, cv2.IMREAD_COLOR)``
followed by BGR→RGB (the JAX package's dataset reader), ``reference="pil"``
is ``Image.open(path).convert("RGB")`` (its server's). Under both, grey is
replicated, a palette is expanded (an index past the palette reads black,
as libpng's expansion gives), an alpha channel is dropped without
compositing, and no gamma or colour-space chunk is applied. They differ in
two places:

- 16-bit samples: OpenCV keeps the high byte; PIL does too, except for
  16-bit grey, which it clips to 255;
- the ``eXIf`` chunk's orientation (1 to 8, a TIFF stream starting ``II``
  or ``MM``): OpenCV applies it, PIL does not.

It takes every colour type and bit depth PNG defines: colour types 0
(grey), 2 (RGB), 3 (palette), 4 (grey with alpha) and 6 (RGBA) at 8 and 16
bits, and grey and palette images at 1, 2 and 4 bits, interlaced (Adam7)
or not. :class:`UnsupportedPNG` is kept for a caller that hands refused
files on; no valid PNG is refused.

The plain versions' unfiltering: None and Up rows need only the row above
and Sub rows a running sum, but Average and Paeth rows depend on the pixel
to the left as well as on the row above. The rows are therefore unfiltered along
anti-diagonals (pixel (y, x) on diagonal y + x): every pixel of one
diagonal depends only on the two diagonals before it, so each diagonal is
one set of numpy operations over all of its pixels, H + W - 1 steps for
any mix of filters. The image is held skewed (column y + x of row y holds
pixel (y, x)), so that each diagonal is one column and its neighbours are
slices of the two columns before it. An interlaced image is seven such
sweeps, one a pass, whose pixels are then scattered to their places.
:func:`decode_many_plain` sweeps the diagonals of many non-interlaced
images of one size together, so the per-step cost of numpy's dispatch is
shared by the whole batch. The library unfilters row by row in place.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import kernels
from . import exif

LIBRARY = kernels.HOST_IMAGE
_MESSAGE = 512

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels a pixel holds, by colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths each colour type may have
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


# Adam7's passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
REFERENCES = ("cv2", "pil")


class UnsupportedPNG(ValueError):
    """A valid PNG this decoder does not take (none is refused today)."""


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    """(type, payload) of every chunk up to IEND, each CRC checked."""
    if not is_png(data):
        raise ValueError("not a PNG file (bad signature)")
    out, pos = [], 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        out.append((kind, body))
        pos += 12 + length
        if kind == b"IEND":
            return out
    raise ValueError("PNG file ends before its IEND chunk")


def _header(chunks) -> Dict[str, int]:
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError("PNG file does not start with an IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is invalid")
    if width == 0 or height == 0 or comp != 0 or filt != 0 or interlace > 1:
        raise ValueError("PNG header holds an empty size or an unknown method")
    return {"width": width, "height": height, "depth": depth, "ctype": ctype,
            "interlace": interlace}


def _passes(hdr) -> List[Tuple[int, int, int, int, int, int]]:
    """(first row, first column, row step, column step, rows, columns) of
    each non-empty pass: Adam7's seven, or the whole image."""
    w, h = hdr["width"], hdr["height"]
    if not hdr["interlace"]:
        return [(0, 0, 1, 1, h, w)]
    out = []
    for y0, x0, dy, dx in _ADAM7:
        rows, cols = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if rows > 0 and cols > 0:
            out.append((y0, x0, dy, dx, rows, cols))
    return out


def _paeth(a, b, c):
    """The Paeth predictor of left ``a``, up ``b`` and upper-left ``c``
    (int16 arrays), ties broken as the PNG specification orders them."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of N images of one size at once: ``raw`` (N, H,
    row_bytes) uint8 filtered bytes, ``filters`` (N, H) each row's filter
    type, ``bpp`` the bytes a pixel (at least 1). Returns the (N, H,
    row_bytes) uint8 scanlines: one diagonal sweep for the whole stack."""
    n, h, row_bytes = raw.shape
    w = row_bytes // bpp  # whole pixels; sub-byte depths have bpp 1
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    # skewed: row y + 1 (row 0 is the zero row above the image), column
    # y + x + 2 (columns 0 and 1 are zero pixels left of every row's first)
    skew = np.zeros((n, h + 1, h + w + 2, bpp), np.int16)
    raw_skew = np.zeros((n, h, h + w, bpp), np.int16)
    raw_skew[:, ys, ys + xs] = raw.reshape(n, h, w, bpp)
    kind = filters.astype(np.intp)[:, :, None, None]
    zeros = np.zeros((n, min(h, w), bpp), np.int16)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = skew[:, y0 + 1:y1 + 1, d + 1]  # left: (y, x - 1)
        b = skew[:, y0:y1, d + 1]          # up: (y - 1, x)
        c = skew[:, y0:y1, d]              # upper left: (y - 1, x - 1)
        k = np.broadcast_to(kind[:, y0:y1, 0], a.shape)
        pred = np.choose(k, (zeros[:, :y1 - y0], a, b, (a + b) >> 1, _paeth(a, b, c)))
        skew[:, y0 + 1:y1 + 1, d + 2] = (raw_skew[:, y0:y1, d] + pred) & 255
    out = skew[:, 1:][:, ys, ys + xs + 2]
    return out.astype(np.uint8).reshape(n, h, row_bytes)


def _unfilter_rows(tables: np.ndarray, bpp: int) -> np.ndarray:
    """The scanlines of N same-size images, ``tables`` (N, H, 1 + row_bytes):
    each row's filter byte, then its filtered bytes."""
    filters, raw = tables[:, :, 0], tables[:, :, 1:]
    if np.any(filters > 4):
        raise ValueError(f"PNG row filter type {int(filters.max())} is invalid")
    if np.all(filters == 0):
        return raw.copy()
    if np.any((filters == 3) | (filters == 4)):
        return _unfilter_diagonals(raw, filters, bpp)
    # no row reads its left neighbour through a nonlinear predictor: None,
    # Sub (a running sum along the row) and Up (a sum down the rows), row by
    # row
    n, h, row_bytes = raw.shape
    w = row_bytes // bpp
    out = np.empty_like(raw)
    prev = np.zeros((n, row_bytes), np.uint8)
    for y in range(h):
        f = filters[:, y, None]
        row = raw[:, y]
        sub = np.cumsum(row.reshape(n, w, bpp), axis=1, dtype=np.uint8).reshape(n, -1)
        out[:, y] = np.where(f == 1, sub, np.where(f == 2, row + prev, row))
        prev = out[:, y]
    return out


def _inflate(data: bytes):
    """(header, chunks, the inflated image data as one (rows, 1 +
    row_bytes) uint8 table a pass, bytes a pixel) of an in-memory PNG
    file."""
    chunks = _chunks(data)
    hdr = _header(chunks)
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    if not idat:
        raise ValueError("PNG file holds no IDAT chunk")
    try:
        inflated = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    bits = _CHANNELS[hdr["ctype"]] * hdr["depth"]
    tables, at = [], 0
    for *_, rows, cols in _passes(hdr):
        row_bytes = (cols * bits + 7) // 8
        tables.append((at, rows, row_bytes + 1))
        at += rows * (row_bytes + 1)
    if len(inflated) < at:
        raise ValueError(f"PNG image data holds {len(inflated)} bytes, {at} needed")
    tables = [np.frombuffer(inflated, np.uint8, rows * size, start).reshape(rows, size)
              for start, rows, size in tables]
    return hdr, chunks, tables, max(1, bits // 8)


def _to_rgb(hdr, chunks, rows: np.ndarray, w: int, reference: str) -> np.ndarray:
    """The unfiltered scanlines (h, row_bytes) of ``w`` pixels as RGB uint8
    (h, w, 3)."""
    h, depth, ctype = rows.shape[0], hdr["depth"], hdr["ctype"]
    if depth == 16:
        pairs = rows.reshape(h, w, _CHANNELS[ctype], 2)
        pix = pairs[..., 0]  # the high byte, as OpenCV and PIL keep it
        if ctype == 0 and reference == "pil":  # PIL clips 16-bit grey to 255
            pix = np.where(pix > 0, 255, pairs[..., 1]).astype(np.uint8)
    elif depth < 8:
        # one sample per `depth` bits, most significant first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = samples.reshape(h, rows.shape[1] * per_byte)[:, :w]
        if ctype == 0:  # scaled to 8 bits, as libpng expands grey
            samples = samples * (255 // ((1 << depth) - 1))
        pix = samples.astype(np.uint8)[:, :, None]
    else:
        pix = rows[:, :w * _CHANNELS[ctype]].reshape(h, w, _CHANNELS[ctype])
    if ctype == 3:
        plte = next((body for kind, body in chunks if kind == b"PLTE"), None)
        if plte is None or len(plte) % 3 or not plte:
            raise ValueError("palette PNG without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        palette[:len(entries)] = entries
        return palette[pix[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


def _image(hdr, chunks, rows: List[np.ndarray], reference: str) -> np.ndarray:
    """Each pass's unfiltered scanlines as the RGB image, oriented as the
    reference orients it."""
    passes = _passes(hdr)
    if len(passes) == 1 and not hdr["interlace"]:
        image = _to_rgb(hdr, chunks, rows[0], hdr["width"], reference)
    else:
        image = np.empty((hdr["height"], hdr["width"], 3), np.uint8)
        for (y0, x0, dy, dx, _, cols), r in zip(passes, rows):
            image[y0::dy, x0::dx] = _to_rgb(hdr, chunks, r, cols, reference)
    if reference == "cv2":
        body = next((body for kind, body in chunks if kind == b"eXIf"), None)
        if body is not None:
            image = exif.apply_orientation(image, exif.orientation(body))
    return image


def _check(reference: str) -> None:
    if reference not in REFERENCES:
        raise ValueError(f"reference must be one of {REFERENCES}, not {reference!r}")


def decode_bytes_plain(data: bytes, reference: str = "cv2") -> np.ndarray:
    """An in-memory PNG file as RGB uint8 (H, W, 3), as ``reference``
    ("cv2" or "pil") reads it: the plain version, on zlib and numpy."""
    _check(reference)
    hdr, chunks, tables, bpp = _inflate(data)
    rows = [_unfilter_rows(t[None], bpp)[0] for t in tables]
    return _image(hdr, chunks, rows, reference)


def decode_many_plain(datas: Sequence[bytes], reference: str = "cv2") -> List[np.ndarray]:
    """In-memory PNG files as RGB uint8 arrays, equal to
    :func:`decode_bytes_plain` of each: the non-interlaced images of one
    size and pixel layout are unfiltered together, in one diagonal sweep for
    the whole group."""
    _check(reference)
    parsed = [_inflate(data) for data in datas]
    groups: Dict[Tuple[int, ...], List[int]] = {}
    out: List[np.ndarray] = [None] * len(parsed)
    for i, (hdr, chunks, tables, bpp) in enumerate(parsed):
        if hdr["interlace"]:
            rows = [_unfilter_rows(t[None], bpp)[0] for t in tables]
            out[i] = _image(hdr, chunks, rows, reference)
        else:
            groups.setdefault(tables[0].shape + (bpp,), []).append(i)
    for key, members in groups.items():
        rows = _unfilter_rows(np.stack([parsed[i][2][0] for i in members]), key[-1])
        for i, r in zip(members, rows):
            out[i] = _image(parsed[i][0], parsed[i][1], [r], reference)
    return out


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_png_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.c_int]
        lib.png_decode.restype = ctypes.c_int
        lib.png_free.argtypes = [u8p]
        lib.png_free.restype = None
        lib._png_typed = True
    return lib


def decode_bytes(data: bytes, reference: str = "cv2") -> np.ndarray:
    """An in-memory PNG file as RGB uint8 (H, W, 3), as ``reference``
    ("cv2" or "pil") reads it, by the host library; a damaged file raises
    ``ValueError`` with the plain version's message."""
    _check(reference)
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MESSAGE)
    data = bytes(data)
    kernels.count_host_call("png_decode")
    status = lib.png_decode(data, len(data), REFERENCES.index(reference), ctypes.byref(out),
                            ctypes.byref(h), ctypes.byref(w), msg, _MESSAGE)
    if status:
        raise ValueError(msg.value.decode(errors="replace"))
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.png_free(out)


def decode_many(datas: Sequence[bytes], reference: str = "cv2") -> List[np.ndarray]:
    """In-memory PNG files as RGB uint8 arrays, :func:`decode_bytes` of
    each."""
    _check(reference)
    return [decode_bytes(data, reference) for data in datas]


def decode(path: str, **kwargs) -> np.ndarray:
    """The PNG file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
