"""The port's C++ PNG decoder (``csrc/png_decode.cpp`` with ``csrc/inflate.cpp``,
through ``data/png.py``) against its plain numpy version
(``png.decode_bytes_plain``) and the readers both are held to, on the CPU:

- every colour type and bit depth (grey 1, 2, 4, 8, 16; RGB 8, 16; palette
  1, 2, 4, 8; grey with alpha and RGBA 8, 16), every row filter alone and
  mixed, Adam7 at sizes with empty passes, palettes shorter than their
  indices, ``eXIf`` orientations 1 to 8 in both byte orders: under
  ``reference="cv2"`` equal to ``cv2.imread`` then BGR→RGB (the JAX
  package's ``_load_image``) and under ``"pil"`` to PIL's
  ``convert("RGB")``, max |Δ| 0, and to the plain version;
- the inflate over every block kind: stored (level 0), fixed Huffman,
  dynamic at levels 1 to 9, Huffman-only and RLE strategies, windows of
  2^9 to 2^15 bytes, the stream split over many IDAT chunks;
- ``tests/torch_image_fixtures/``'s PNGs against ``digests.json``;
- damage: a bad CRC, a file that is not a PNG, truncated files, a missing
  IEND, IHDR or IDAT, a bad colour type, a missing PLTE, corrupt and
  truncated zlib streams (bad header, bad block type, bad stored lengths,
  a bad Adler-32, a cut stream), filter byte 5 and short image data: each
  raises ``ValueError`` with the plain version's message; fuzzed files
  raise where the plain version raises and decode equal where it decodes.
"""

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.data import datasets, png

FIXTURES = Path(__file__).resolve().parent / "torch_image_fixtures"
sys.path.insert(0, str(FIXTURES))
import encoders  # noqa: E402

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 2, 1, 0, 4, 4)]


def _samples(rng, h, w, ctype, depth):
    hi = 1 << depth
    samples = rng.integers(0, hi, (h, w, CHANNELS[ctype]))
    # a smooth band, so the predictors' small differences are taken too
    samples[: h // 2] = (np.add.outer(np.arange(h // 2), np.arange(w))[:, :, None] * 3) % hi
    return samples.astype(np.uint16 if depth == 16 else np.uint8)


def _references(tmp_path, data):
    path = tmp_path / "x.png"
    path.write_bytes(data)
    with Image.open(path) as pil:
        return {"cv2": jax_load_image(str(path)), "pil": np.asarray(pil.convert("RGB"))}


def _check(tmp_path, data, what):
    want = _references(tmp_path, data)
    for reference in ("cv2", "pil"):
        got = png.decode_bytes(data, reference)
        plain = png.decode_bytes_plain(data, reference)
        for other, name in ((want[reference], "reader"), (plain, "plain")):
            assert got.dtype == other.dtype == np.uint8 and got.shape == other.shape, \
                (what, reference, name)
            assert int(np.abs(got.astype(np.int32) - other).max()) == 0, (what, reference, name)


@pytest.mark.parametrize("ctype,depth", CASES)
def test_every_colour_type_depth_and_filter(tmp_path, ctype, depth):
    rng = np.random.default_rng(10 * ctype + depth)
    for filters in FILTERS:
        for h, w in ((13, 10), (1, 1), (29, 37)):
            samples = _samples(rng, h, w, ctype, depth)
            palette = rng.integers(0, 256, (min(1 << depth, 200), 3)) if ctype == 3 else None
            data = encoders.png(samples, ctype, depth, filters=filters, palette=palette)
            _check(tmp_path, data, (filters, h, w))


@pytest.mark.parametrize("ctype,depth", CASES)
def test_adam7_every_colour_type_and_depth(tmp_path, ctype, depth):
    rng = np.random.default_rng(100 + 10 * ctype + depth)
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 8), (33, 41)):
        samples = _samples(rng, h, w, ctype, depth)
        palette = rng.integers(0, 256, (min(1 << depth, 200), 3)) if ctype == 3 else None
        _check(tmp_path, encoders.png(samples, ctype, depth, interlace=True, palette=palette),
               (h, w))


@pytest.mark.parametrize("order", ["<", ">"])
def test_exif_orientations(tmp_path, order):
    picture = np.random.default_rng(8).integers(0, 256, (29, 37, 3), dtype=np.uint8)
    for value in range(1, 9):
        data = encoders.png(picture, 2, exif=encoders.exif_orientation(value, order))
        _check(tmp_path, data, value)
        assert png.decode_bytes(data, "cv2").shape == ((37, 29, 3) if value >= 5 else (29, 37, 3))


def _chunks(data):
    out, pos = [], 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]))
        pos += 12 + length
    return out


def _rebuild(chunks):
    return png.SIGNATURE + b"".join(encoders.png_chunk(kind, body) for kind, body in chunks)


def _with_idat(data, idat, pieces=1):
    """``data`` with its image data replaced by ``idat``, in ``pieces``
    IDAT chunks."""
    chunks = [c for c in _chunks(data) if c[0] != b"IDAT"]
    cut = np.linspace(0, len(idat), pieces + 1).astype(int)
    parts = [(b"IDAT", idat[a:b]) for a, b in zip(cut, cut[1:])]
    return _rebuild(chunks[:-1] + parts + chunks[-1:])


def _raw(data):
    return zlib.decompress(b"".join(body for kind, body in _chunks(data) if kind == b"IDAT"))


STREAMS = {
    "stored": dict(level=0),
    "fixed": dict(level=6, strategy=zlib.Z_FIXED),
    "level1": dict(level=1),
    "level9": dict(level=9),
    "huffman_only": dict(level=6, strategy=zlib.Z_HUFFMAN_ONLY),
    "rle": dict(level=6, strategy=zlib.Z_RLE),
    "window9": dict(level=9, wbits=9),
    "window12": dict(level=5, wbits=12, memLevel=1),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_inflate_every_block_kind(tmp_path, stream):
    rng = np.random.default_rng(3)
    kernels.host_calls.clear()
    for image in (_samples(rng, 70, 90, 2, 8), _samples(rng, 40, 33, 6, 16)):
        ctype, depth = (2, 8) if image.dtype == np.uint8 else (6, 16)
        data = encoders.png(image, ctype, depth)
        comp = zlib.compressobj(**STREAMS[stream])
        idat = comp.compress(_raw(data)) + comp.flush()
        for pieces in (1, 7):
            _check(tmp_path, _with_idat(data, idat, pieces), (stream, pieces))
    assert kernels.host_calls["png_decode"] == 8


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.png")))
def test_fixtures_equal_their_digests(name):
    digests = json.loads((FIXTURES / "digests.json").read_text())[name]
    data = (FIXTURES / name).read_bytes()
    for reference in ("cv2", "pil"):
        got = png.decode_bytes(data, reference)
        assert {"shape": list(got.shape), "sha256": hashlib.sha256(got.tobytes()).hexdigest()} \
            == digests[reference], reference
        np.testing.assert_array_equal(got, png.decode_bytes_plain(data, reference))


def _same_failure(data, reference="cv2"):
    """Both decoders raise ValueError with one message; returns it."""
    with pytest.raises(ValueError) as plain:
        png.decode_bytes_plain(data, reference)
    with pytest.raises(ValueError) as got:
        png.decode_bytes(data, reference)
    assert str(got.value) == str(plain.value)
    return str(got.value)


def test_damage_raises_the_plain_versions_message():
    picture = np.random.default_rng(4).integers(0, 256, (21, 30, 3), dtype=np.uint8)
    good = encoders.png(picture, 2)
    chunks = _chunks(good)
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    raw = _raw(good)

    bad_crc = bytearray(good)
    bad_crc[45] ^= 0xFF
    stream = bytearray(idat)
    stream[0] = 0x79  # not a multiple of 31 with its flag byte
    bad_adler = idat[:-1] + bytes([idat[-1] ^ 1])
    block3 = bytes([0x78, 0x01, 0x07])  # a last block of type 3
    stored = zlib.compress(raw, 0)
    bad_len = bytearray(stored)
    bad_len[5] ^= 0xFF  # LEN against NLEN
    filter5 = bytearray(raw)
    filter5[0] = 5
    grey = encoders.png(picture[:, :, 0], 0)
    palette = encoders.png(picture[:, :, :1], 3, palette=np.zeros((200, 3), np.uint8))
    cases = {
        "CRC": bytes(bad_crc),
        "bad signature": b"\xff\xd8\xff\xe0 a JPEG header",
        "is truncated": good[:-30],
        "before its IEND": _rebuild(chunks[:-1]),
        "IHDR": _rebuild(chunks[1:]),
        "no IDAT": _rebuild([c for c in chunks if c[0] != b"IDAT"]),
        "colour type": _rebuild([(b"IHDR", chunks[0][1][:8] + bytes([16, 3, 0, 0, 0]))]
                                + chunks[1:]),
        "empty size": _rebuild([(b"IHDR", bytes(4) + chunks[0][1][4:])] + chunks[1:]),
        "header check": _with_idat(good, bytes(stream)),
        "block type": _with_idat(good, block3),
        "stored block lengths": _with_idat(good, bytes(bad_len)),
        "data check": _with_idat(good, bad_adler),
        "truncated stream": _with_idat(good, idat[:len(idat) // 2]),
        "filter type 5": _with_idat(good, zlib.compress(bytes(filter5))),
        "bytes, ": _with_idat(good, zlib.compress(raw[:-40])),
        "PLTE": _rebuild([c for c in _chunks(palette) if c[0] != b"PLTE"]),
        "grey ok": grey,
    }
    for key, data in cases.items():
        if key == "grey ok":
            np.testing.assert_array_equal(png.decode_bytes(data), png.decode_bytes_plain(data))
            continue
        message = _same_failure(data)
        assert key in message, (key, message)


def test_fuzzed_files_fail_or_decode_as_the_plain_version():
    """Random bytes of the image data flipped (CRCs made good again), IDAT
    cut short and chunk lengths broken: where the plain version raises, the
    library raises ValueError too, and where it decodes, equally."""
    rng = np.random.default_rng(9)
    picture = _samples(rng, 24, 31, 2, 8)
    base = [encoders.png(picture, 2), encoders.png(picture, 2, interlace=True),
            encoders.png(picture[:, :, :1], 0, filters=(4,))]
    failed = decoded = 0
    for i in range(600):
        data = base[i % len(base)]
        chunks = _chunks(data)
        idat = bytearray(b"".join(body for kind, body in chunks if kind == b"IDAT"))
        for _ in range(1 + i % 3):
            idat[rng.integers(0, len(idat))] = rng.integers(0, 256)
        if i % 5 == 0:
            idat = idat[:rng.integers(1, len(idat))]
        damaged = _with_idat(data, bytes(idat))
        try:
            want = png.decode_bytes_plain(damaged)
        except ValueError:
            _same_failure(damaged)
            failed += 1
            continue
        np.testing.assert_array_equal(png.decode_bytes(damaged), want)
        decoded += 1
    assert failed > 100


def test_load_image_and_decode_many_go_through_the_library(tmp_path):
    picture = np.random.default_rng(2).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    files = [encoders.png(picture, 2), encoders.png(picture, 2, interlace=True),
             encoders.png(picture.astype(np.uint16) * 257, 2, 16)]
    kernels.host_calls.clear()
    for reference in ("cv2", "pil"):
        got = png.decode_many(files, reference)
        for image, want in zip(got, png.decode_many_plain(files, reference)):
            np.testing.assert_array_equal(image, want)
    path = tmp_path / "x.png"
    path.write_bytes(files[0])
    np.testing.assert_array_equal(datasets._load_image(str(path)), jax_load_image(str(path)))
    np.testing.assert_array_equal(png.decode(str(path)),
                                  cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    assert kernels.host_calls["png_decode"] == 8
    with pytest.raises(ValueError, match="reference"):
        png.decode_bytes(files[0], "tf")
