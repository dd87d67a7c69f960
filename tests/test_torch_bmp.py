"""The port's BMP decoder (``vit_ssl_tpu_torch/data/bmp.py``) against the JAX
package's reader, ``vit_ssl_tpu.data.datasets._load_image``
(``cv2.imread(..., IMREAD_COLOR)``, then PIL where OpenCV fails), and under
``reference="pil"`` against its server's ``Image.open(path).convert("RGB")``,
bit for bit: every variant OpenCV and PIL write (24-bit, 32-bit BI_BITFIELDS
and BI_RGB, 8-bit grey and palette, 1-bit), 4-bit palettes built here
(bottom-up and top-down, indices past the palette), RLE8 and RLE4 (encoded
pictures, and random escape streams with deltas, early ends of line and of
bitmap, read as each reference reads them), 16-bit 5-5-5 and 5-6-5 (OpenCV
shifts, PIL scales), 32-bit with other masks, the OS/2 core header, and the
refusals by name.
"""

import io
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import bmp
from vit_ssl_tpu_torch.data.datasets import _load_image

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_image_fixtures"))
import encoders  # noqa: E402

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


def _pil(path):
    with Image.open(path) as pil:
        return np.asarray(pil.convert("RGB"))


def _both(tmp_path, data, name="x.bmp"):
    """The port under both references against both readers; a reader that
    fails (OSError, ValueError) must see the port refuse or raise too."""
    path = tmp_path / name
    path.write_bytes(data)
    out = {}
    for reference, oracle in (("cv2", jax_load_image), ("pil", _pil)):
        try:
            want = oracle(str(path))
        except (OSError, ValueError):
            with pytest.raises(ValueError):
                bmp.decode_bytes(data, reference)
            out[reference] = None
            continue
        got = bmp.decode_bytes(data, reference)
        assert got.shape == want.shape, reference
        np.testing.assert_array_equal(got, want, err_msg=reference)
        np.testing.assert_array_equal(_load_image(str(path), reference), want)
        out[reference] = got
    return out


@pytest.mark.parametrize("case,named", [
    ("rle8", None), ("rle4", None), ("sixteen", None), ("masks", None), ("core", None),
    ("masks444", "0x0F00"), ("jpeg", "BI_JPEG"), ("alphabitfields", "BI_ALPHABITFIELDS")])
def test_refusals_name_the_header(tmp_path, case, named):
    """RLE8, RLE4, 16-bit, 32-bit with other masks and the core header, once
    refused, now decode bit-equal under both references (PIL refuses the
    32-bit masks, and so does the port under its reference); 16-bit masks
    other than 5-5-5 and 5-6-5, embedded JPEG and BI_ALPHABITFIELDS, which
    neither reader takes, are still refused by name."""
    palette = np.arange(48, dtype=np.uint8).reshape(16, 3)
    data = {
        "rle8": _handmade(2, 2, 8, [b"\x02\x01", b"\x00\x01"], palette, compression=1),
        "rle4": _handmade(2, 2, 4, [b"\x02\x12", b"\x00\x01"], palette, compression=2),
        "sixteen": _handmade(3, 2, 16, [bytes(range(6)), bytes(range(10, 16))]),
        "masks": _handmade(2, 2, 32, [bytes(range(8))] * 2, compression=3,
                           masks=struct.pack("<III", 0xFF, 0xFF00, 0xFF0000)),
        "core": b"BM" + struct.pack("<IHHI", 26 + 16, 0, 0, 26)
                + struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(range(16)),
        "masks444": _handmade(2, 2, 16, [bytes(4)] * 2, compression=3,
                              masks=struct.pack("<III", 0xF00, 0xF0, 0xF)),
        "jpeg": _handmade(2, 2, 24, [bytes(6)] * 2, compression=4),
        "alphabitfields": _handmade(2, 2, 32, [bytes(8)] * 2, compression=6,
                                    masks=struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF,
                                                      0xFF000000)),
    }[case]
    if named is None:
        out = _both(tmp_path, data)
        assert out["cv2"] is not None
        if case == "masks":
            assert out["pil"] is None
            with pytest.raises(bmp.UnsupportedBMP, match="masks"):
                bmp.decode_bytes(data, "pil")
        return
    with pytest.raises(bmp.UnsupportedBMP, match=named):
        bmp.decode_bytes(data)


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (7, 11), (40, 63), (100, 150)])
def test_rle_encoded_pictures(tmp_path, rle4, size):
    h, w = size
    rng = np.random.default_rng(h * w + rle4)
    colours = 16 if rle4 else 256
    smooth = (np.add.outer(np.arange(h) // 3, np.arange(w) // 5) % colours).astype(np.uint8)
    noise = rng.integers(0, colours, (h, w)).astype(np.uint8)
    index = np.where(rng.random((h, w)) < 0.2, noise, smooth)
    palette = rng.integers(0, 256, (colours - 3, 3), dtype=np.uint8)  # the last 3 read black
    out = _both(tmp_path, encoders.bmp_rle(index, palette, rle4=rle4))
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette
    np.testing.assert_array_equal(out["cv2"], full[index])
    if h > 2 and w > 8:  # a delta: OpenCV skips to index 0, PIL reads its bytes late
        _both(tmp_path, encoders.bmp_rle(index, palette, rle4=rle4, delta_at=(1, 3)))


def _rle_stream(rng, w, h, rle4):
    """Random RLE escapes: runs, literals, ends of line, deltas, an early
    end of bitmap, or none at all."""
    out = b""
    for _ in range(int(rng.integers(1, 6 * h))):
        r = rng.random()
        if r < 0.45:
            out += bytes([int(rng.integers(1, w + 1)), int(rng.integers(0, 256))])
        elif r < 0.75 and w >= 3:
            n = int(rng.integers(3, w + 1))
            size = (((n + 1) >> 1) + 1) & ~1 if rle4 else (n + 1) & ~1
            out += bytes([0, n]) + rng.integers(0, 256, size).astype(np.uint8).tobytes()
        elif r < 0.9:
            out += b"\x00\x00"
        elif r < 0.97:
            out += bytes([0, 2, int(rng.integers(0, w)), int(rng.integers(0, 3))])
        else:
            out += b"\x00\x01"
    return out + (b"\x00\x01" if rng.random() < 0.8 else b"")


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_rle_streams_as_each_reader_reads_them(tmp_path, rle4, seed):
    """OpenCV and PIL read the same escapes differently (OpenCV fills a
    delta's and a line's skipped pixels with index 0 in reading order, PIL
    reads a delta's two bytes after two more and drops an odd RLE4
    literal's last pixel): the port reads each as its reference does, and
    raises where the reader fails or leaves pixels unwritten."""
    for trial in range(40):
        rng = np.random.default_rng(1000 * seed + trial)
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        palette = rng.integers(0, 256, (16 if rle4 else 256, 3), dtype=np.uint8)
        odd = trial % 3 == 0  # pixel data at an odd offset: PIL pads literals by it
        body = _rle_stream(rng, w, h, rle4)
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 4 if rle4 else 8, 2 if rle4 else 1,
                           len(body), 0, 0, len(palette), 0)
        pal = np.c_[palette[:, ::-1], np.zeros(len(palette), np.uint8)].tobytes()
        offset = 14 + 40 + len(pal) + odd
        data = (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal
                + bytes(odd) + body)
        path = tmp_path / "rle.bmp"
        path.write_bytes(data)
        for reference, oracle in (("cv2", jax_load_image), ("pil", _pil)):
            try:
                got = bmp.decode_bytes(data, reference)
            except ValueError:
                continue  # damage the reader also fails on, or leaves unwritten
            np.testing.assert_array_equal(got, oracle(str(path)),
                                          err_msg=f"{reference} trial {trial}")


@pytest.mark.parametrize("masks", ["555", "565", "555_bitfields", "565_v5"])
def test_sixteen_bit(tmp_path, masks):
    """OpenCV shifts each field to the top of its byte, PIL scales it to 255;
    with a V5 header OpenCV reads the masks after it, fails, and the JAX
    package's PIL reads them."""
    rng = np.random.default_rng(len(masks))
    h, w = 9, 7
    pixels = rng.integers(0, 65536, (h, w)).astype("<u2")
    rows = [r.tobytes() for r in pixels[::-1]]
    m555, m565 = struct.pack("<III", 0x7C00, 0x3E0, 0x1F), struct.pack("<III", 0xF800, 0x7E0,
                                                                        0x1F)
    if masks == "555":
        data = _handmade(w, h, 16, rows)
    elif masks == "555_bitfields":
        data = _handmade(w, h, 16, rows, compression=3, masks=m555)
    elif masks == "565":
        data = _handmade(w, h, 16, rows, compression=3, masks=m565)
    else:
        data = bytearray(_handmade(w, h, 16, rows, compression=3, header=124))
        data[54:66] = m565
        data = bytes(data)
    out = _both(tmp_path, data)
    v = pixels.astype(np.int32)
    if masks in ("555", "555_bitfields"):
        np.testing.assert_array_equal(out["cv2"][..., 0], ((v >> 10) & 31) << 3)
        np.testing.assert_array_equal(out["pil"][..., 0], ((v >> 10) & 31) * 255 // 31)
    if masks == "565_v5":
        np.testing.assert_array_equal(out["cv2"], out["pil"])


@pytest.mark.parametrize("header", [40, 108])
@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                   (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                                   (0x3FF00000, 0xFFC00, 0x3FF, 0), (0xF0F0, 0x0F0F0000, 0x0F, 0),
                                   (0, 0, 0, 0)])
def test_thirty_two_bit_masks(tmp_path, masks, header):
    """OpenCV reads a 40-byte header's pixels as BGRx bytes and a V3 or
    later header's masks, each field scaled to 255; PIL takes the masks it
    knows and refuses others."""
    rng = np.random.default_rng(sum(masks) % 1000 + header)
    pixels = rng.integers(0, 2 ** 32, (5, 6), dtype=np.uint64).astype("<u4")
    rows = [r.tobytes() for r in pixels[::-1]]
    if header == 40:
        data = _handmade(6, 5, 32, rows, compression=3, masks=struct.pack("<III", *masks[:3]))
    else:
        data = bytearray(_handmade(6, 5, 32, rows, compression=3, header=header))
        data[54:70] = struct.pack("<IIII", *masks)
        data = bytes(data)
    if header > 40 and masks[0] == 0xF0F0:
        with pytest.raises(bmp.UnsupportedBMP, match="not contiguous"):
            bmp.decode_bytes(data)
        return
    out = _both(tmp_path, data)
    if header == 40 or not any(masks):
        np.testing.assert_array_equal(out["cv2"],
                                      pixels.view(np.uint8).reshape(5, 6, 4)[..., 2::-1])


@pytest.mark.parametrize("bpp", [1, 4, 8, 24])
def test_core_header(tmp_path, bpp):
    rng = np.random.default_rng(bpp)
    h, w = 6, 11
    stride = (w * bpp + 31) // 32 * 4
    rows = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    palette = rng.integers(0, 256, (1 << bpp, 3), dtype=np.uint8)[:, ::-1] if bpp <= 8 else \
        np.zeros((0, 3), np.uint8)
    core = struct.pack("<IHHHH", 12, w, h, 1, bpp) + palette.tobytes()
    offset = 14 + len(core)
    body = rows.tobytes()
    _both(tmp_path, b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + core + body)


def test_damaged_files_raise(tmp_path):
    palette = np.arange(48, dtype=np.uint8).reshape(16, 3)
    overrun = _handmade(2, 2, 8, [b"\x05\x01", b"\x00\x01"], palette, compression=1)
    with pytest.raises(ValueError, match="RLE run at byte .* past its line's end"):
        bmp.decode_bytes(overrun)
    cut = _handmade(4, 2, 8, [b"\x04\x01"], palette, compression=1)  # no end of bitmap
    with pytest.raises(ValueError, match="RLE data ends at byte"):
        bmp.decode_bytes(cut)
    path = tmp_path / "cut.bmp"
    path.write_bytes(cut)
    with pytest.raises(ValueError, match="damaged BMP"):
        _load_image(str(path))
    data = _written("cv2_bgr", _image((6, 5)))
    with pytest.raises(ValueError, match="runs past the end"):
        bmp.decode_bytes(data[:-7])
    with pytest.raises(ValueError, match="no BM signature"):
        bmp.decode_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    assert bmp.is_bmp(data) and not bmp.is_bmp(b"\xff\xd8\xff")
