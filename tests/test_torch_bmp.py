"""The port's BMP decoder (``vit_ssl_tpu_torch/data/bmp.py``) against the JAX
package's reader, ``vit_ssl_tpu.data.datasets._load_image``
(``cv2.imread(..., IMREAD_COLOR)``), bit for bit: every variant OpenCV and
PIL write (24-bit, 32-bit BI_BITFIELDS and BI_RGB, 8-bit grey and palette,
1-bit), 4-bit palettes built here (bottom-up and top-down, indices past the
palette), and the refusals by name, which the port's loader hands on to
OpenCV as the JAX package reads them.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import bmp
from vit_ssl_tpu_torch.data.datasets import _load_image

SIZES = [(5, 7), (1, 1), (13, 33)]


def _image(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8)


def _written(kind, image):
    if kind == "cv2_bgr":
        return cv2.imencode(".bmp", image)[1].tobytes()
    if kind == "cv2_bgra":
        return cv2.imencode(".bmp", np.dstack([image, image[:, :, :1]]))[1].tobytes()
    if kind == "cv2_gray":
        return cv2.imencode(".bmp", image[:, :, 0])[1].tobytes()
    out = io.BytesIO()
    Image.fromarray(image).convert(kind.split("_")[1]).save(out, "BMP")
    return out.getvalue()


def _handmade(width, height, bpp, rows, palette=None, top_down=False, compression=0,
              masks=b"", header=40):
    """A BMP of ``rows`` (bottom row first unless ``top_down``), each padded
    to 4 bytes, with a BGRx palette and optional bit-field masks."""
    stride = (width * bpp + 31) // 32 * 4
    pal = b"" if palette is None else bytes(
        np.c_[palette[:, ::-1], np.zeros(len(palette), np.uint8)].astype(np.uint8).ravel())
    body = b"".join(r.ljust(stride, b"\0") for r in rows)
    info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                       bpp, compression, len(body), 0, 0,
                       0 if palette is None else len(palette), 0).ljust(header, b"\0")
    offset = 14 + header + len(masks) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + masks
            + pal + body)


def _check(tmp_path, data, name="x.bmp"):
    path = tmp_path / name
    path.write_bytes(data)
    got = bmp.decode_bytes(data)
    np.testing.assert_array_equal(got, jax_load_image(str(path)))
    np.testing.assert_array_equal(_load_image(str(path)), got)
    return got


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["cv2_bgr", "cv2_bgra", "cv2_gray", "pil_1", "pil_L",
                                  "pil_P", "pil_RGB", "pil_RGBA"])
def test_written_by_cv2_and_pil(tmp_path, kind, size):
    image = _image(size)
    got = _check(tmp_path, _written(kind, image))
    assert got.shape == (*size, 3)
    if kind in ("cv2_bgr", "pil_RGB", "pil_RGBA"):
        np.testing.assert_array_equal(got, image[:, :, ::-1] if kind == "cv2_bgr" else image)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("top_down", [False, True])
def test_four_bit_palette(tmp_path, size, top_down):
    h, w = size
    rng = np.random.default_rng(h * w)
    index = rng.integers(0, 16, (h, w)).astype(np.uint8)
    palette = rng.integers(0, 256, (11, 3), dtype=np.uint8)  # indices 11-15 read black
    rows = [np.packbits(np.unpackbits(r[:, None], axis=1)[:, 4:].ravel()).tobytes()
            for r in (index if top_down else index[::-1])]
    got = _check(tmp_path, _handmade(w, h, 4, rows, palette, top_down))
    want = np.zeros((16, 3), np.uint8)
    want[:11] = palette
    np.testing.assert_array_equal(got, want[index])


def test_v5_header_with_standard_masks(tmp_path):
    """A 124-byte header, 32-bit BI_BITFIELDS, the standard masks inside."""
    pixels = np.random.default_rng(3).integers(0, 256, (3, 4, 4), dtype=np.uint8)
    masks = struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
    data = bytearray(_handmade(4, 3, 32, [r.tobytes() for r in pixels[::-1]],
                               compression=3, header=124))
    data[54:70] = masks
    got = _check(tmp_path, bytes(data))
    np.testing.assert_array_equal(got, pixels[:, :, 2::-1])


@pytest.mark.parametrize("case,named", [
    ("rle8", "BI_RLE8"), ("rle4", "BI_RLE4"), ("sixteen", "16-bit"),
    ("masks", "masks 0x000000FF"), ("core", "BITMAPCOREHEADER")])
def test_refusals_name_the_header(tmp_path, case, named):
    palette = np.arange(48, dtype=np.uint8).reshape(16, 3)
    data = {
        "rle8": _handmade(2, 2, 8, [b"\x02\x01", b"\x00\x01"], palette, compression=1),
        "rle4": _handmade(2, 2, 4, [b"\x02\x12", b"\x00\x01"], palette, compression=2),
        "sixteen": _handmade(3, 2, 16, [bytes(6)] * 2),
        "masks": _handmade(2, 2, 32, [bytes(range(8))] * 2, compression=3,
                           masks=struct.pack("<III", 0xFF, 0xFF00, 0xFF0000)),
        "core": b"BM" + struct.pack("<IHHI", 26 + 12, 0, 0, 26)
                + struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(12),
    }[case]
    with pytest.raises(bmp.UnsupportedBMP, match=named):
        bmp.decode_bytes(data)
    if case in ("rle8", "sixteen"):  # the loader hands it to OpenCV, as JAX reads it
        path = tmp_path / "refused.bmp"
        path.write_bytes(data)
        np.testing.assert_array_equal(_load_image(str(path)), jax_load_image(str(path)))


def test_damaged_files_raise():
    data = _written("cv2_bgr", _image((6, 5)))
    with pytest.raises(ValueError, match="runs past the end"):
        bmp.decode_bytes(data[:-7])
    with pytest.raises(ValueError, match="no BM signature"):
        bmp.decode_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    assert bmp.is_bmp(data) and not bmp.is_bmp(b"\xff\xd8\xff")
