"""Zstandard decoding on the port's own host library (``csrc/zstd_decode.cpp``):
the reader of the zstd frames in the JAX package's orbax checkpoints, where
neither ``zstandard`` nor tensorstore is installed.

:func:`decompress` decodes every frame of a buffer (RFC 8878: frames with or
without the content size and the XXH64 checksum, skippable frames, Raw, RLE
and Compressed blocks, Huffman and treeless literals, FSE, RLE, predefined
and repeat sequence tables, the repeat offsets, any window). A frame that
needs a dictionary raises :class:`UnsupportedZstd`; damaged input raises
``ValueError`` naming the byte offset, and no partial output is returned.
:func:`decompress_into` decodes straight into a caller's buffer (a numpy
array's bytes) whose size the caller knows.

:func:`frame_raw` writes the other way, with no compression: one frame of
Raw blocks, which any zstd decoder reads. :func:`crc32c` is the checksum OCDBT
files end with; it lives in the same library.

The library is compiled with the host's C++ compiler at first use
(:func:`vit_ssl_tpu_torch.kernels.load_host`); its entries are called
through ``ctypes``, which releases the GIL.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import kernels

LIBRARY = "zstd_decode"
MAGIC = b"\x28\xb5\x2f\xfd"
_UNSUPPORTED, _TOO_SMALL = 1, 3
_MESSAGE = 512
_BLOCK_MAX = 128 * 1024


class UnsupportedZstd(ValueError):
    """A valid zstd frame this decoder does not take (a dictionary)."""


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        size_t = ctypes.c_size_t
        lib.zstd_decompress.argtypes = [ctypes.c_char_p, size_t, ctypes.POINTER(u8p),
                                        ctypes.POINTER(size_t), ctypes.c_char_p, ctypes.c_int]
        lib.zstd_decompress.restype = ctypes.c_int
        lib.zstd_decompress_into.argtypes = [ctypes.c_void_p, size_t, ctypes.c_void_p, size_t,
                                             ctypes.POINTER(size_t), ctypes.c_char_p,
                                             ctypes.c_int]
        lib.zstd_decompress_into.restype = ctypes.c_int
        lib.zstd_free.argtypes = [u8p]
        lib.zstd_free.restype = None
        lib.zstd_xxh64.argtypes = [ctypes.c_char_p, size_t, ctypes.c_uint64]
        lib.zstd_xxh64.restype = ctypes.c_uint64
        lib.ocdbt_crc32c.argtypes = [ctypes.c_void_p, size_t]
        lib.ocdbt_crc32c.restype = ctypes.c_uint32
        lib._typed = True
    return lib


def _raise(status: int, msg) -> None:
    text = f"zstd: {msg.value.decode(errors='replace')}"
    raise (UnsupportedZstd if status == _UNSUPPORTED else ValueError)(text)


def decompress(data: bytes) -> bytes:
    """Every frame of ``data``, decoded and joined."""
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    msg = ctypes.create_string_buffer(_MESSAGE)
    data = bytes(data)
    status = lib.zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(size),
                                 msg, _MESSAGE)
    if status:
        _raise(status, msg)
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.zstd_free(out)


def decompress_into(data, out: np.ndarray) -> None:
    """Decodes ``data`` (bytes or a uint8 array) into the C-contiguous
    array ``out``, whose bytes it must fill exactly."""
    if not out.flags.c_contiguous:
        raise ValueError("zstd: decompress_into needs a C-contiguous output array")
    lib = _library()
    src = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    size = ctypes.c_size_t()
    msg = ctypes.create_string_buffer(_MESSAGE)
    status = lib.zstd_decompress_into(src.ctypes.data, src.nbytes, out.ctypes.data, out.nbytes,
                                      ctypes.byref(size), msg, _MESSAGE)
    if status:
        _raise(status, msg)
    if size.value != out.nbytes:
        raise ValueError(f"zstd: data decodes to {size.value} bytes, {out.nbytes} expected")


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (a zstd frame's checksum is its low 32 bits)."""
    data = bytes(data)
    return int(_library().zstd_xxh64(data, len(data), seed))


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data`` (bytes, bytearray or a uint8 array)."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    return int(_library().ocdbt_crc32c(buf.ctypes.data, buf.nbytes))


def frame_raw(data) -> bytes:
    """``data`` as one zstd frame of Raw blocks (no compression, content size
    in the header, no checksum)."""
    view = memoryview(data).cast("B")
    n = len(view)
    # frame header: FCS of 8 bytes (flag 3), single segment, no checksum
    parts = [MAGIC, bytes([0xE0]), struct.pack("<Q", n)]
    if n == 0:
        parts.append(struct.pack("<I", 1)[:3])  # one empty last Raw block
    for start in range(0, n, _BLOCK_MAX):
        size = min(_BLOCK_MAX, n - start)
        last = start + size == n
        parts.append(struct.pack("<I", (size << 3) | int(last))[:3])
        parts.append(view[start:start + size])
    return b"".join(parts)
