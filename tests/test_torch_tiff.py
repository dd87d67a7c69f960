"""The port's TIFF decoder (``vit_ssl_tpu_torch/data/tiff.py`` over the host
library ``csrc/tiff_decode.cpp``) against the JAX package's readers, bit for
bit: under ``reference="cv2"`` the dataset reader
``vit_ssl_tpu.data.datasets._load_image`` (OpenCV, then PIL where OpenCV
fails), under ``reference="pil"`` the server's
``Image.open(path).convert("RGB")``.

The files come from ``tests/torch_image_fixtures/encoders.py`` at test time,
from seeded numpy pictures: every compression (none, LZW, Deflate as 8 and
32946, PackBits), the horizontal predictor at 8 and 16 bits, both planar
configurations, strips and tiles, both byte orders, grey of both polarities,
RGB and palette at 1, 2, 4, 8 and 16 bits, an extra sample, and the
orientation tag. Beside them: the LZW and PackBits expanders against the
encoders over long inputs, the refusals by name, and damaged files, which
raise with a byte offset.
"""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import tiff
from vit_ssl_tpu_torch.data.datasets import _load_image

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_image_fixtures"))
import encoders  # noqa: E402


def _oracle(path, reference):
    if reference == "cv2":
        return jax_load_image(str(path))
    with Image.open(path) as pil:
        return np.asarray(pil.convert("RGB"))


def _check(tmp_path, data, reference, name="x.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    want = _oracle(path, reference)
    got = tiff.decode_bytes(data, reference)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_load_image(str(path), reference), want)
    return got


def _samples(rng, h, w, spp, bits):
    return rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16)


@pytest.mark.parametrize("reference", ["cv2", "pil"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("bits", [8, 16])
def test_rgb_every_compression_and_predictor(tmp_path, reference, compression, predictor,
                                             bits):
    rng = np.random.default_rng(compression + 7 * predictor + bits)
    for order in ("<", ">"):
        for h, w, layout in ((9, 13, {"rows_per_strip": 4}), (21, 35, {"tile": 16}),
                             (1, 1, {})):
            data = encoders.tiff(_samples(rng, h, w, 3, bits), photometric=2, bits=bits,
                                 compression=compression, predictor=predictor, order=order,
                                 **layout)
            _check(tmp_path, data, reference)


@pytest.mark.parametrize("reference", ["cv2", "pil"])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_grey_every_depth_and_polarity(tmp_path, reference, photometric, bits):
    rng = np.random.default_rng(bits * 3 + photometric)
    for compression in (1, 5, 8):
        s = _samples(rng, 11, 19, 1, bits)
        if bits == 16:
            s[0] = np.arange(19)[:, None]  # small values: PIL clips, OpenCV keeps the high byte
        for order in ("<", ">"):
            data = encoders.tiff(s, photometric=photometric, bits=bits,
                                 compression=compression, order=order, rows_per_strip=5)
            if reference == "pil" and bits == 16 and photometric == 0 and order == ">":
                with pytest.raises(tiff.UnsupportedTIFF, match="min-is-white"):
                    tiff.decode_bytes(data, reference)  # PIL has no mode for it
                continue
            _check(tmp_path, data, reference)


@pytest.mark.parametrize("reference", ["cv2", "pil"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_every_depth(tmp_path, reference, bits):
    rng = np.random.default_rng(40 + bits)
    for high in (65536, 256):  # OpenCV reads an all-8-bit colour map as 8-bit, PIL does not
        cmap = rng.integers(0, high, (1 << bits, 3)).astype(np.uint16)
        for layout in ({"rows_per_strip": 3}, {"tile": 16}):
            data = encoders.tiff(_samples(rng, 10, 17, 1, bits), photometric=3, bits=bits,
                                 colormap=cmap, compression=32773, **layout)
            _check(tmp_path, data, reference)


@pytest.mark.parametrize("reference", ["cv2", "pil"])
@pytest.mark.parametrize("planar", [1, 2])
def test_planar_configurations_and_extra_samples(tmp_path, reference, planar):
    rng = np.random.default_rng(planar)
    cases = [(3, None, 8, 5), (3, None, 16, 8), (4, 2, 8, 8), (4, 0, 8, 5), (4, 1, 8, 5),
             (4, 2, 16, 1)]
    for spp, extra, bits, compression in cases:
        data = encoders.tiff(_samples(rng, 13, 9, spp, bits), photometric=2, bits=bits,
                             planar=planar, extra=extra, compression=compression,
                             rows_per_strip=5)
        path = tmp_path / "planar.tif"
        path.write_bytes(data)
        try:
            want = _oracle(path, reference)
        except OSError:  # the reference cannot read it: neither does the port
            with pytest.raises(tiff.UnsupportedTIFF, match="misread"):
                tiff.decode_bytes(data, reference)
            continue
        try:
            got = tiff.decode_bytes(data, reference)
        except tiff.UnsupportedTIFF as e:
            # refused by name only where the reference misreads the layout
            assert "misread" in str(e) and planar == 2
            continue
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reference", ["cv2", "pil"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_tag(tmp_path, reference, orientation):
    """Both references turn the image: OpenCV itself for 1 to 4 (and for a
    square image), PIL where OpenCV fails; a tiled file's left-right flip
    is libtiff's, tile by tile."""
    rng = np.random.default_rng(orientation)
    for h, w, layout in ((7, 12, {"rows_per_strip": 3}), (8, 8, {}), (20, 37, {"tile": 16}),
                         (19, 5, {})):
        data = encoders.tiff(_samples(rng, h, w, 3, 8), photometric=2, compression=8,
                             orientation=orientation, **layout)
        _check(tmp_path, data, reference)
        grey = encoders.tiff(_samples(rng, h, w, 1, 8), photometric=1, compression=1,
                             orientation=orientation, **layout)
        _check(tmp_path, grey, reference)


def test_lzw_and_packbits_expand_long_inputs():
    """The host library against the encoders: past 4094 codes (a clear code
    mid-stream) and every PackBits run and literal length."""
    rng = np.random.default_rng(9)
    raw = np.concatenate([rng.integers(0, 256, 30000), np.repeat(rng.integers(0, 256, 300),
                                                                 rng.integers(1, 200, 300))])
    raw = raw.astype(np.uint8).tobytes()
    for kind, encode in ((5, encoders.lzw), (32773, encoders.packbits)):
        out = tiff._expand(kind, encode(raw), len(raw), 0)
        assert out == raw
        assert tiff._expand(kind, encode(raw), 1000, 0) == raw[:1000]  # stops at the cap


@pytest.mark.parametrize("case,named", [
    ("jpeg", "JPEG"), ("ccitt", "CCITT"), ("ycbcr", "YCbCr"), ("cmyk", "CMYK"),
    ("float", "float"), ("signed", "signed"), ("bigtiff", "BigTIFF"), ("old_lzw", "old-style"),
    ("fill_order", "fill order")])
def test_refusals_name_the_form(case, named):
    rgb = np.zeros((4, 4, 3), np.uint16)
    data = {
        "jpeg": lambda: encoders.tiff(rgb, photometric=2, extra_tags={259: [7]}),
        "ccitt": lambda: encoders.tiff(rgb[:, :, 0], photometric=0, bits=1,
                                       extra_tags={259: [3]}),
        "ycbcr": lambda: encoders.tiff(rgb, photometric=6),
        "cmyk": lambda: encoders.tiff(np.zeros((4, 4, 4), np.uint16), photometric=5),
        "float": lambda: encoders.tiff(rgb[:, :, 0], photometric=1, bits=16,
                                       extra_tags={339: [3]}),
        "signed": lambda: encoders.tiff(rgb[:, :, 0], photometric=1, bits=16,
                                        extra_tags={339: [2]}),
        "bigtiff": lambda: b"II+\x00\x08\x00\x00\x00" + bytes(16),
        # the first code's low bit set after a zero byte: LSB-first LZW
        "old_lzw": lambda: encoders.tiff(rgb, photometric=2, compression=5)[:8] + b"\x00\x01"
        + encoders.tiff(rgb, photometric=2, compression=5)[10:],
        "fill_order": lambda: encoders.tiff(rgb, photometric=2, extra_tags={266: [2]}),
    }[case]()
    with pytest.raises(tiff.UnsupportedTIFF, match=named):
        tiff.decode_bytes(data)


def test_damaged_files_raise(tmp_path):
    rng = np.random.default_rng(5)
    pixels = _samples(rng, 16, 16, 3, 8)
    good = encoders.tiff(pixels, photometric=2, compression=5, rows_per_strip=8)
    with pytest.raises(ValueError, match="not a TIFF"):
        tiff.decode_bytes(b"\x89PNG\r\n\x1a\n" + bytes(16))
    bad_ifd = bytearray(good)
    struct.pack_into("<I", bad_ifd, 4, len(good) + 100)
    with pytest.raises(ValueError, match="IFD offset .* past the end"):
        tiff.decode_bytes(bytes(bad_ifd))
    corrupt = bytearray(good)
    corrupt[10:15] = b"\xff\xff\xff\xff\xff"  # codes past the table in the first strip
    with pytest.raises(ValueError, match="LZW data at byte 8"):
        tiff.decode_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="past the end of the file"):
        tiff.decode_bytes(good[:12])  # the IFD is at the end: cut with it
    deflated = zlib.compress(bytes(100))  # a strip that inflates to 100 of 768 bytes
    short = encoders.tiff(pixels, photometric=2, compression=8, rows_per_strip=16)
    cut = bytearray(short)
    cut[8:8 + len(deflated)] = deflated
    with pytest.raises(ValueError, match="holds 100 bytes, 768 needed"):
        tiff.decode_bytes(bytes(cut))
    path = tmp_path / "cut.tif"
    path.write_bytes(bytes(cut))
    with pytest.raises(ValueError, match="damaged TIFF file"):
        _load_image(str(path))
