"""The whole-batch image decode: the port's counterpart of the JAX package's
``vit_ssl_tpu/data/native.py`` over its ``csrc/fastloader.cpp``.

:func:`decode_batch` reads, decodes and resizes a whole batch of image files
into one uint8 NHWC array in a single call of ``csrc/batch_decode.cpp``'s
entry in the image library :data:`vit_ssl_tpu_torch.kernels.HOST_IMAGE`
(``vitssl_decode_batch``, the C signature and
contract of ``fastloader.cpp``): each file is read in C++ and decoded by its
magic bytes (PNG, JPEG, WebP: the port's C++ decoders, as the JAX package's
dataset reader, ``cv2.imread`` then BGR→RGB, gives them, the EXIF
orientation applied), resized with ``INTER_AREA`` where either axis
shrinks and ``INTER_LINEAR`` otherwise, and written into its slot, across a
``std::thread`` pool, with the GIL released for the whole batch. A file the
call does not decode (BMP, TIFF, another format, a refused or damaged file)
comes back zero-filled with ``ok`` false.

The library is built with the host compiler at first use
(:func:`vit_ssl_tpu_torch.kernels.load_host`). Unlike the JAX package's
binding, which returns None when its library was not built, this one builds
the library or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from .. import kernels

LIBRARY = kernels.HOST_IMAGE
ENTRY = "vitssl_decode_batch"


def _library() -> ctypes.CDLL:
    lib = kernels.load_host(LIBRARY)
    if not getattr(lib, "_native_typed", False):
        lib.vitssl_decode_batch.restype = ctypes.c_int
        lib.vitssl_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib._native_typed = True
    return lib


def decode_batch(paths: List[str], out_h: int, out_w: int,
                 num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize a batch of files: (uint8 (N, out_h, out_w, 3), ok
    (N,) bool). ``num_threads <= 0`` takes ``min(cpu_count, N)``."""
    n, out_h, out_w = len(paths), int(out_h), int(out_w)
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"decode_batch to an empty size ({out_h}, {out_w})")
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    if num_threads <= 0:
        num_threads = min(max(os.cpu_count() or 1, 1), n)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib = _library()
    kernels.count_host_call(ENTRY)
    lib.vitssl_decode_batch(c_paths, n, out_h, out_w, out.ctypes.data, ok.ctypes.data,
                            int(num_threads))
    return out, ok.astype(bool)
