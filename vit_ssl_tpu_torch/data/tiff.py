"""A baseline TIFF decoder: the host's TIFF reader where neither OpenCV nor
PIL is installed. The IFD and the pixel arithmetic are numpy; LZW and
PackBits, which go a byte at a time, run in the port's host library
``csrc/tiff_decode.cpp`` (built at first use, bound with ``ctypes``);
Deflate is ``zlib``.

:func:`decode_bytes` returns RGB uint8 (H, W, 3) of the first image, bit-equal
to the caller's reference:

- ``reference="cv2"`` is the JAX package's dataset reader: ``cv2.imread(path,
  cv2.IMREAD_COLOR)``, which reads every TIFF through libtiff's RGBA
  interface, then BGR→RGB; where OpenCV fails (2 bits a sample, 4-bit grey,
  an orientation of 5 to 8 on a non-square image) the JAX package reads the file with PIL, and so
  does this decoder;
- ``reference="pil"`` is the server's ``Image.open(path).convert("RGB")``.

The two differ in how 16 bits become 8 (libtiff: grey keeps the high byte
through its grey map, RGB rounds v * 255 / 65535; PIL: RGB keeps the high
byte, grey clips the value to 255 and ignores min-is-white), in palettes
(libtiff reads a colour map whose entries are all below 256 as 8-bit; PIL
always keeps the high byte) and in alpha (libtiff premultiplies unassociated
alpha, PIL divides associated alpha out). Both apply the orientation tag.

It takes the first IFD in either byte order; strips and tiles; compression
none, LZW, Deflate (8 and 32946) and PackBits; the horizontal predictor at
8 and 16 bits (which libtiff applies only under LZW and Deflate); grey (both
polarities), RGB and palette images at 1, 2, 4, 8 and 16 bits a sample (as
far as each reference reads them); planar configurations 1 and 2; extra
samples, which are dropped. JPEG-in-TIFF, CCITT, YCbCr, CMYK, float and
signed samples, BigTIFF and the other forms are refused by name with
:class:`UnsupportedTIFF`; a damaged file raises ``ValueError`` with the byte
offset.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from .. import kernels
from . import exif

LIBRARY = "tiff_decode"
REFERENCES = ("cv2", "pil")
_UNSUPPORTED = 1
_MESSAGE = 256
# field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 16: ("Q", 8)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits",
                 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                 7: "JPEG", 34712: "JPEG 2000", 50000: "ZSTD", 34925: "LZMA", 50001: "WebP"}
_PHOTOMETRIC = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab"}


class UnsupportedTIFF(ValueError):
    """A valid TIFF this decoder does not take (JPEG or CCITT compression,
    YCbCr, CMYK, float samples, BigTIFF, ...)."""


class _OpenCVRefuses(Exception):
    """OpenCV fails on this file; the JAX package then reads it with PIL."""


def is_tiff(data: bytes) -> bool:
    return data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_typed", False):
        for name in ("tiff_lzw", "tiff_packbits"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _expand(kind: int, block: bytes, size: int, at: int) -> bytes:
    """The ``block`` (at byte ``at``) expanded with compression ``kind``
    to at most ``size`` bytes."""
    if kind == 1:
        return block[:size]
    if kind in (8, 32946):
        try:
            return zlib.decompressobj().decompress(block, size)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data at byte {at} does not inflate: {e}") from None
    out = np.empty(size, np.uint8)
    got = ctypes.c_size_t()
    msg = ctypes.create_string_buffer(_MESSAGE)
    entry = "tiff_lzw" if kind == 5 else "tiff_packbits"
    fn = getattr(_library(), entry)
    kernels.count_host_call(entry)
    status = fn(block, len(block), out.ctypes.data, size, ctypes.byref(got), msg, _MESSAGE)
    if status:
        text = f"TIFF {_COMPRESSIONS[kind]} data at byte {at}: {msg.value.decode()}"
        raise (UnsupportedTIFF if status == _UNSUPPORTED else ValueError)(text)
    return out[:got.value].tobytes()


def _ifd(data: bytes) -> Tuple[str, Dict[int, list]]:
    """(byte order, tag -> values) of the first IFD."""
    if len(data) < 8 or not is_tiff(data):
        raise ValueError("not a TIFF file (no II*/MM* header)")
    if data[2:4] in (b"+\x00", b"\x00+"):
        raise UnsupportedTIFF("BigTIFF files are not supported by this decoder")
    order = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(order + "I", data, 4)
    if at + 2 > len(data):
        raise ValueError(f"TIFF IFD offset {at} is past the end of the file")
    (count,) = struct.unpack_from(order + "H", data, at)
    if at + 2 + 12 * count > len(data):
        raise ValueError(f"TIFF IFD at byte {at} runs past the end of the file")
    tags = {}
    for i in range(count):
        entry = at + 2 + 12 * i
        tag, kind, n = struct.unpack_from(order + "HHI", data, entry)
        if kind not in _TYPES:
            continue  # rationals, floats and others: no tag this decoder reads
        code, size = _TYPES[kind]
        where = entry + 8
        if n * size > 4:
            (where,) = struct.unpack_from(order + "I", data, entry + 8)
        if where + n * size > len(data):
            raise ValueError(f"TIFF tag {tag} at byte {entry} points past the end of the file")
        tags[tag] = list(struct.unpack_from(order + code * n, data, where))
    return order, tags


def _one(tags, tag, default=None):
    values = tags.get(tag)
    if values is None:
        if default is None:
            raise ValueError(f"TIFF IFD lacks required tag {tag}")
        return default
    return values[0]


def _samples(data: bytes, order: str, tags) -> Tuple[np.ndarray, dict]:
    """The stored samples (H, W, samples a pixel) as uint16, and the
    image's description."""
    width, height = _one(tags, 256), _one(tags, 257)
    bits = tags.get(258, [1])
    spp = _one(tags, 277, 1)
    compression = _one(tags, 259, 1)
    photometric = _one(tags, 262, -1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    fmt = tags.get(339, [1])
    if compression not in (1, 5, 8, 32946, 32773):
        name = _COMPRESSIONS.get(compression, f"compression {compression}")
        raise UnsupportedTIFF(f"TIFF with {name} data is not supported by this decoder")
    if photometric not in (0, 1, 2, 3):
        name = _PHOTOMETRIC.get(photometric, f"photometric {photometric}")
        raise UnsupportedTIFF(f"TIFF {name} images are not supported by this decoder")
    if any(f == 3 for f in fmt):
        raise UnsupportedTIFF("TIFF float samples are not supported by this decoder")
    if any(f not in (1, 4) for f in fmt):  # 4 is "undefined", read as unsigned
        raise UnsupportedTIFF("TIFF signed samples are not supported by this decoder")
    if len(set(bits)) != 1 or bits[0] not in (1, 2, 4, 8, 16):
        raise UnsupportedTIFF(f"TIFF with {bits} bits a sample is not supported by this "
                              "decoder")
    bits = bits[0]
    if _one(tags, 266, 1) != 1:
        raise UnsupportedTIFF("TIFF fill order 2 (LSB first) is not supported by this decoder")
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar} is invalid")
    colour = 3 if photometric == 2 else 1
    if spp < colour or width <= 0 or height <= 0:
        raise ValueError(f"TIFF {width}x{height} with {spp} samples a pixel is invalid")
    if spp > colour + 1:
        raise UnsupportedTIFF(f"TIFF with {spp - colour} extra samples is not supported by "
                              "this decoder (one is)")
    if predictor not in (1, 2):
        raise UnsupportedTIFF(f"TIFF predictor {predictor} is not supported by this decoder")
    differenced = predictor == 2 and compression in (5, 8, 32946)
    if differenced and bits not in (8, 16):
        raise UnsupportedTIFF(f"TIFF horizontal predictor at {bits} bits is not supported")
    tiled = 322 in tags
    if tiled:
        bw, bh = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        bw, bh = width, min(_one(tags, 278, height), height) or height
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError("TIFF IFD lacks its strip or tile offsets and byte counts")
    planes = spp if planar == 2 else 1
    per = spp if planar == 1 else 1  # samples a stored pixel
    across, down = -(-width // bw), -(-height // bh)
    if len(offsets) < planes * across * down:
        raise ValueError(f"TIFF holds {len(offsets)} strips or tiles, "
                         f"{planes * across * down} needed")
    row_bytes = (bw * per * bits + 7) // 8
    dtype = np.dtype(order + "u2") if bits == 16 else np.uint8
    out = np.zeros((height, width, spp), np.uint16)
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = bh if tiled else min(bh, height - ty * bh)
                at, n = offsets[k], counts[k]
                k += 1
                if at + n > len(data):
                    raise ValueError(f"TIFF strip or tile at byte {at} runs past the end of "
                                     "the file")
                raw = _expand(compression, data[at:at + n], rows * row_bytes, at)
                if len(raw) < rows * row_bytes:
                    raise ValueError(f"TIFF strip or tile at byte {at} holds {len(raw)} "
                                     f"bytes, {rows * row_bytes} needed")
                block = np.frombuffer(raw, np.uint8).reshape(rows, row_bytes)
                if bits >= 8:
                    vals = block.view(dtype).reshape(rows, bw, per).astype(np.uint16)
                    if differenced:
                        mod = np.uint16 if bits == 16 else np.uint8
                        vals = np.cumsum(vals.astype(mod), axis=1, dtype=mod).astype(np.uint16)
                else:
                    unpacked = np.unpackbits(block, axis=1).reshape(rows, row_bytes * 8 // bits,
                                                                    bits)
                    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
                    vals = (unpacked * weights).sum(2, dtype=np.uint16)[:, :bw * per]
                    vals = vals.reshape(rows, bw, per)
                y0, x0 = ty * bh, tx * bw
                h, w = min(rows, height - y0), min(bw, width - x0)
                channels = slice(plane, plane + 1) if planar == 2 else slice(None)
                out[y0:y0 + h, x0:x0 + w, channels] = vals[:h, :w]
    info = {"bits": bits, "photometric": photometric, "spp": spp, "colour": colour,
            "extra": tags.get(338, []), "order": order, "colormap": tags.get(320),
            "compression": compression, "planar": planar, "tile": bw if tiled else None,
            "one_block": len(offsets) == 1}
    return out, info


def _colormap(info, pil: bool) -> np.ndarray:
    cmap = info["colormap"]
    n = 1 << info["bits"]
    if cmap is None or len(cmap) < 3 * n:
        raise ValueError("TIFF palette image without a full colour map")
    table = np.array(cmap[:3 * n], np.uint32).reshape(3, n).T
    if pil or table.max() >= 256:  # libtiff reads an all-8-bit map as 8-bit
        table >>= 8
    return table.astype(np.uint8)


def _to_rgb_cv2(s: np.ndarray, info) -> np.ndarray:
    """libtiff's RGBA interface (TIFFReadRGBA*), as OpenCV reads a TIFF."""
    bits, photometric, extra = info["bits"], info["photometric"], info["extra"]
    if bits == 2 or bits == 4 and photometric != 3:  # refused by OpenCV's header check
        raise _OpenCVRefuses
    if photometric in (0, 1):
        if bits == 16 and info["tile"] is not None:
            raise UnsupportedTIFF("tiled 16-bit grey TIFF is misread by OpenCV and not "
                                  "supported under its reference")
        if info["spp"] > 1 and (info["tile"] is not None and info["planar"] == 1
                                or info["planar"] == 2 and bits != 8):
            raise UnsupportedTIFF("tiled or 16-bit planar TIFF grey with an extra sample is "
                                  "misread by OpenCV and not supported under its reference")
        if bits == 16:
            grey = s[..., 0] >> 8
        elif bits == 1:
            grey = s[..., 0] * 255
        else:
            grey = s[..., 0]
        if photometric == 0:
            grey = 255 - grey
        if info["planar"] == 2 and info["extra"][:1] == [2]:  # premultiplied (UaToAa)
            grey = (grey.astype(np.uint32) * s[..., 1] + 127) // 255
        return np.repeat(grey.astype(np.uint8)[..., None], 3, 2)
    if photometric == 3:
        if info["spp"] != 1:
            raise UnsupportedTIFF("TIFF palette images with extra samples are not supported")
        return _colormap(info, False)[s[..., 0]]
    if bits not in (8, 16):
        raise UnsupportedTIFF(f"TIFF RGB at {bits} bits a sample is not supported")
    v = s.astype(np.uint32)
    if bits == 16:  # libtiff's Bitdepth16To8
        v = (v * 255 + 32767) // 65535
    rgb = v[..., :3]
    if extra and extra[0] == 2:  # unassociated alpha, premultiplied (UaToAa)
        rgb = (rgb * v[..., 3:4] + 127) // 255
    return rgb.astype(np.uint8)


def _to_rgb_pil(s: np.ndarray, info) -> np.ndarray:
    """PIL's TIFF modes (``TiffImagePlugin.OPEN_INFO``) and ``convert("RGB")``."""
    bits, photometric, spp, order = info["bits"], info["photometric"], info["spp"], info["order"]
    extra = tuple(info["extra"])
    if info["planar"] == 2 and spp > info["colour"] and extra in ((), (0,)):
        raise UnsupportedTIFF("planar TIFF with an unspecified extra sample is misread by PIL "
                              "and not supported under its reference")
    if photometric in (0, 1):
        if spp == 2 and not (bits == 8 and extra == (2,)) or spp > 2:
            raise UnsupportedTIFF(f"TIFF grey with extra samples {list(extra)} at {bits} bits "
                                  "is not supported under the PIL reference")
        if bits == 16:
            if photometric == 0 and order == ">":
                raise UnsupportedTIFF("big-endian 16-bit min-is-white TIFF is not supported "
                                      "under the PIL reference")
            grey = np.minimum(s[..., 0], 255)  # PIL's I;16 clipped, min-is-white ignored
        else:
            grey = s[..., 0] * (255 // ((1 << bits) - 1))
            if photometric == 0:
                grey = 255 - grey
        return np.repeat(grey.astype(np.uint8)[..., None], 3, 2)
    if photometric == 3:
        if spp != 1 or bits == 16:
            raise UnsupportedTIFF("TIFF palette images with extra samples or 16-bit indices "
                                  "are not supported")
        return _colormap(info, True)[s[..., 0]]
    if bits not in (8, 16) or (bits == 16 and spp > 4):
        raise UnsupportedTIFF(f"TIFF RGB at {bits} bits with {spp} samples is not supported "
                              "under the PIL reference")
    v = (s >> 8 if bits == 16 else s).astype(np.int32)
    rgb = v[..., :3]
    if spp > 3 and extra[:1] == (1,):  # associated alpha, divided out ("RGBa")
        a = v[..., 3:4]
        rgb = np.where(a == 0, 0, np.minimum(rgb * 255 // np.maximum(a, 1), 255))
    return rgb.astype(np.uint8)


def _pil_raw_layout(samples: np.ndarray, info, orientation: int) -> np.ndarray:
    """The samples as PIL's raw (uncompressed) path lays them out. An image
    in one strip whose PIL mode is its raw mode is memory-mapped at PIL's
    size, which an orientation of 5 to 8 has already transposed: the rows
    are then read (W, H) before the turn. PIL reads a 16-bit plane of a
    planar file as 8-bit, which is refused."""
    h, w, spp = samples.shape
    if info["planar"] == 2 and (info["bits"] == 16 or spp > info["colour"]):
        raise UnsupportedTIFF("uncompressed planar TIFF with 16-bit or extra samples is "
                              "misread by PIL and not supported under its reference")
    mapped = (info["bits"] == 8 and (
        (info["photometric"] in (1, 3) and spp == 1)
        or (info["photometric"] == 2 and (spp == 3 or (spp == 4 and tuple(info["extra"])
                                                       in ((), (2,))))))
        or (info["bits"] == 16 and info["photometric"] == 1 and spp == 1))
    if 5 <= orientation <= 8 and mapped and info["one_block"]:
        if info["tile"] is None:
            return samples.reshape(w, h, spp)
        # one tile: rows of the tile's width, read (W, H)
        tile = np.zeros((info["tile"], info["tile"], spp), samples.dtype)
        tile[:h, :w] = samples
        return np.ascontiguousarray(tile[:w, :h])
    return samples


def decode_bytes(data: bytes, reference: str = "cv2") -> np.ndarray:
    """The first image of the TIFF ``data`` as RGB uint8 (H, W, 3), as
    ``reference`` ("cv2" or "pil") reads it; see the module docstring."""
    if reference not in REFERENCES:
        raise ValueError(f"reference must be one of {REFERENCES}, not {reference!r}")
    order, tags = _ifd(data)
    samples, info = _samples(data, order, tags)
    orientation = _one(tags, 274, 1)
    h, w = samples.shape[:2]
    # OpenCV fails to turn a non-square image by 5 to 8 (it then goes to PIL)
    if reference == "cv2" and (orientation < 5 or h == w):
        try:
            rgb = _to_rgb_cv2(samples, info)
        except _OpenCVRefuses:
            pass
        else:
            if info["tile"] is not None and orientation in (2, 3, 6, 7):
                # libtiff's left-right flip turns each tile in its place
                rgb = rgb.copy()
                for x in range(0, w, info["tile"]):
                    rgb[:, x:x + info["tile"]] = rgb[:, x:x + info["tile"]][:, ::-1]
                rgb = rgb[:, ::-1]
            return exif.apply_orientation(rgb, orientation)
    if info["compression"] == 1:
        samples = _pil_raw_layout(samples, info, orientation)
    return exif.apply_orientation(_to_rgb_pil(samples, info), orientation)


def decode(path: str, **kwargs) -> np.ndarray:
    """The TIFF file at ``path``; the keywords of :func:`decode_bytes`."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kwargs)
