"""The port's PNG decoder (``vit_ssl_tpu_torch/data/png.py``) against
``cv2.imread(path, cv2.IMREAD_COLOR)`` followed by BGR→RGB, which the JAX
package decodes with (``vit_ssl_tpu/data/datasets.py``), and, under
``reference="pil"``, against its server's ``Image.open(path).convert("RGB")``:

- PNGs that OpenCV and PIL write (RGB, grey, palette at 8 and 4 bits,
  RGBA, grey with alpha, 1-bit), and PNGs from the encoder below for each
  colour type with every row filter (each alone, and all five cycling,
  which sends the decoder's diagonal sweep through every predictor),
  odd sizes and a palette shorter than its indices: bit-equal;
- 16-bit images of every colour type (OpenCV keeps the high byte, PIL
  clips 16-bit grey to 255), Adam7 interlaced images of every colour type
  and depth, and the ``eXIf`` chunk's orientations (OpenCV turns the image,
  PIL does not), each against both readers;
- damage by name: a bad CRC, a file that is not a PNG, a truncated file,
  an unknown row filter.
"""

import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import png
from vit_ssl_tpu_torch.data.datasets import _load_image

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_image_fixtures"))
import encoders  # noqa: E402


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(samples, ctype, filters, depth=8, palette=None):
    """A PNG file of ``samples`` ((H, W, C) uint8, or (H, W) indices or grey
    levels for ``depth`` < 8), row y filtered with ``filters[y % len]``."""
    h, w = samples.shape[:2]
    if depth < 8:
        packed = np.packbits(np.unpackbits(samples.astype(np.uint8)[:, :, None], axis=2)
                             [:, :, 8 - depth:].reshape(h, -1), axis=1)
        rows, bpp = packed, 1
    else:
        rows = samples.reshape(h, -1)
        bpp = samples.shape[2] if samples.ndim == 3 else 1
    raw, prev = b"", np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        kind = filters[y % len(filters)]
        raw += bytes([kind]) + encoders._filter_row(kind, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                      0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    idat = zlib.compress(raw, 6)
    # the image data split over two IDAT chunks, as encoders may write it
    half = len(idat) // 2
    return out + _chunk(b"IDAT", idat[:half]) + _chunk(b"IDAT", idat[half:]) \
        + _chunk(b"IEND", b"")


RNG = np.random.default_rng(0)
# a smooth image (small differences, each predictor's branches taken) and
# noise (every wrap-around)
SMOOTH = (np.add.outer(np.arange(29), 2 * np.arange(37))[:, :, None]
          * np.array([1, 3, 7])).astype(np.uint8)
NOISE = RNG.integers(0, 256, (29, 37, 3), dtype=np.uint8)
FILTER_SETS = [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 2, 1, 0, 4]]


@pytest.mark.parametrize("filters", FILTER_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("image", ["smooth", "noise"])
def test_encoder_filters_bit_equal(tmp_path, filters, image):
    """Every colour type at 8 bits, and grey and palette at 1, 2 and 4
    bits, bit-equal to the image and to cv2.imread."""
    rgb = SMOOTH if image == "smooth" else NOISE
    alpha = RNG.integers(0, 256, rgb.shape[:2] + (1,), dtype=np.uint8)
    grey = rgb[:, :, 1:2]
    palette = RNG.integers(0, 256, (200, 3), dtype=np.uint8)
    # indices past the 200-entry palette read black, as libpng expands them
    index = (rgb[:, :, 0].astype(np.int32) * 7 + rgb[:, :, 2]) % 256
    full = np.zeros((256, 3), np.uint8)
    full[:200] = palette
    cases = [
        ("rgb", encode(rgb, 2, filters), rgb),
        ("rgba", encode(np.concatenate([rgb, alpha], 2), 6, filters), rgb),
        ("grey", encode(grey, 0, filters), np.repeat(grey, 3, 2)),
        ("grey_alpha", encode(np.concatenate([grey, alpha], 2), 4, filters),
         np.repeat(grey, 3, 2)),
        ("palette", encode(index[:, :, None].astype(np.uint8), 3, filters,
                           palette=palette), full[index]),
    ]
    for depth in (1, 2, 4):
        levels = rgb[:, :, 0] >> (8 - depth)
        cases.append((f"grey{depth}", encode(levels, 0, filters, depth=depth),
                      np.repeat((levels * (255 // (2 ** depth - 1)))[:, :, None], 3, 2)
                      .astype(np.uint8)))
        cases.append((f"palette{depth}", encode(levels, 3, filters, depth=depth,
                                                palette=palette[:2 ** depth]),
                      palette[levels]))
    for name, data, want in cases:
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        got = png.decode(str(path))
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, _cv2_rgb(path), err_msg=name)


def _pil(arr, mode):
    img = Image.fromarray(arr)
    if mode == "P":
        return img.quantize(256)
    if mode == "P16":  # a 16-colour palette, which PIL writes at 4 bits
        return img.quantize(16)
    return img.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "P16", "RGBA", "LA", "1"])
def test_pil_written_bit_equal(tmp_path, mode):
    for name, arr in (("noise", NOISE), ("smooth", SMOOTH)):
        path = tmp_path / f"{name}_{mode}.png"
        _pil(arr, mode).save(path)
        np.testing.assert_array_equal(png.decode(str(path)), _cv2_rgb(path),
                                      err_msg=f"{name} {mode}")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_bit_equal(tmp_path, channels):
    for level in (0, 3, 9):  # cv2's compression levels pick other filters
        arr = RNG.integers(0, 256, (41, 23, channels), dtype=np.uint8)
        arr[:20, :, :min(channels, 3)] = SMOOTH[:20, :23, :min(channels, 3)]
        path = tmp_path / f"c{channels}_{level}.png"
        cv2.imwrite(str(path), arr if channels > 1 else arr[:, :, 0],
                    [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = png.decode(str(path))
        np.testing.assert_array_equal(got, _cv2_rgb(path))
        assert np.array_equal(_load_image(str(path)), got)


def test_refusals_name_their_reason(tmp_path):
    """16-bit and interlaced images, once refused, now decode bit-equal;
    damage is still named."""
    sixteen = tmp_path / "sixteen.png"
    cv2.imwrite(str(sixteen), RNG.integers(0, 65536, (8, 9, 3), dtype=np.uint16))
    np.testing.assert_array_equal(png.decode(str(sixteen)), _cv2_rgb(sixteen))
    np.testing.assert_array_equal(_load_image(str(sixteen)), _cv2_rgb(sixteen))

    interlaced = tmp_path / "adam7.png"
    interlaced.write_bytes(encoders.png(NOISE, 2, interlace=True))
    np.testing.assert_array_equal(png.decode(str(interlaced)), _cv2_rgb(interlaced))
    np.testing.assert_array_equal(png.decode(str(interlaced)), NOISE)

    data = bytearray(encode(NOISE, 2, [1]))
    data[40] ^= 0xFF  # a byte of the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        png.decode_bytes(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_bytes(b"\xff\xd8\xff\xe0 a JPEG header")
    truncated = encode(NOISE, 2, [4])[:-30]
    with pytest.raises(ValueError):
        png.decode_bytes(truncated)
    bad_filter = tmp_path / "filter5.png"
    raw = b"".join(bytes([5]) + bytes(3) for _ in range(2))
    bad_filter.write_bytes(png.SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", 1, 2, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type 5"):
        png.decode(str(bad_filter))


def test_decode_many_equals_one_by_one():
    """Images of several sizes and layouts in one call: those of one size
    and layout are unfiltered together, each equal to its own decode."""
    files = [encode(NOISE, 2, [0, 1, 2, 3, 4]), encode(SMOOTH, 2, [4, 3]),
             encode(NOISE[:, :, :1], 0, [3, 1]), encode(NOISE, 2, [1, 2]),
             encode(SMOOTH[:20, :11], 2, [4]), encode(NOISE, 2, [0])]
    got = png.decode_many(files)
    assert len(got) == len(files)
    for data, image in zip(files, got):
        np.testing.assert_array_equal(image, png.decode_bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_many(files[:2] + [b"GIF89a"])


def _both(tmp_path, data, name="x.png"):
    """The port under both references against the JAX package's dataset
    reader and PIL's ``convert("RGB")``."""
    path = tmp_path / name
    path.write_bytes(data)
    want_cv2 = jax_load_image(str(path))
    with Image.open(path) as pil:
        want_pil = np.asarray(pil.convert("RGB"))
    for reference, want in (("cv2", want_cv2), ("pil", want_pil)):
        got = png.decode_bytes(data, reference)
        assert got.shape == want.shape, reference
        np.testing.assert_array_equal(got, want, err_msg=reference)
        np.testing.assert_array_equal(_load_image(str(path), reference), want)
    return want_cv2, want_pil


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_sixteen_bit_every_colour_type(tmp_path, ctype):
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype)
    for interlace in (False, True):
        samples = rng.integers(0, 65536, (13, 10, channels)).astype(np.uint16)
        samples[0] = np.arange(10)[:, None] * 25  # below 256: PIL's grey clip shows
        want_cv2, want_pil = _both(tmp_path, encoders.png(samples, ctype, 16,
                                                          interlace=interlace))
        high = (samples >> 8).astype(np.uint8)
        np.testing.assert_array_equal(want_cv2[:, :, 0], high[:, :, 0])
        if ctype == 0:  # PIL clips 16-bit grey to 255 (up to 255 off OpenCV)
            np.testing.assert_array_equal(want_pil[:, :, 0], np.minimum(samples[:, :, 0], 255))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1),
                                         (3, 2), (3, 4), (3, 8), (4, 8), (6, 8)])
def test_adam7_every_colour_type_and_depth(tmp_path, ctype, depth):
    """Seven passes, each unfiltered on its own (every filter cycling), then
    scattered; sizes where passes are empty (1x1, 3x2) included."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(10 * ctype + depth)
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 8), (29, 37)):
        samples = rng.integers(0, 1 << depth, (h, w, channels)).astype(np.uint8)
        palette = rng.integers(0, 256, (min(1 << depth, 200), 3)) if ctype == 3 else None
        _both(tmp_path, encoders.png(samples, ctype, depth, interlace=True, palette=palette))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("order", ["<", ">"])
def test_exif_orientations(tmp_path, orientation, order):
    """OpenCV turns the image by the ``eXIf`` chunk, PIL does not; the chunk
    before or after the image data."""
    for where in ("before", "after"):
        data = encoders.png(NOISE, 2, exif=encoders.exif_orientation(orientation, order))
        if where == "after":  # move the chunk behind IDAT
            start = data.index(b"eXIf") - 4
            length = struct.unpack(">I", data[start:start + 4])[0] + 12
            chunk, rest = data[start:start + length], data[:start] + data[start + length:]
            end = rest.index(b"IEND") - 4
            data = rest[:end] + chunk + rest[end:]
        want_cv2, want_pil = _both(tmp_path, data)
        np.testing.assert_array_equal(want_pil, NOISE)
        assert want_cv2.shape == ((37, 29, 3) if orientation >= 5 else (29, 37, 3))


def test_exif_orientation6_equals_the_jax_reader(tmp_path):
    """A PNG whose ``eXIf`` chunk holds orientation 6 comes out turned, as
    ``cv2.imread`` gives it to the JAX package: (53, 37, 3), not (37, 53)."""
    picture = np.random.default_rng(6).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = tmp_path / "exif6.png"
    Image.fromarray(picture).save(path, exif=_exif6())
    want = jax_load_image(str(path))
    assert want.shape == (53, 37, 3)
    np.testing.assert_array_equal(_load_image(str(path)), want)
    np.testing.assert_array_equal(png.decode_many([path.read_bytes()])[0], want)


def _exif6():
    exif = Image.Exif()
    exif[0x0112] = 6
    return exif


def test_decode_many_with_interlaced_sixteen_bit_and_exif():
    files = [encoders.png(NOISE, 2, interlace=True), encode(NOISE, 2, [3, 4]),
             encoders.png(NOISE.astype(np.uint16) * 257, 2, 16),
             encoders.png(NOISE, 2, exif=encoders.exif_orientation(8)),
             encode(SMOOTH[:29, :37], 2, [4])]
    for reference in ("cv2", "pil"):
        got = png.decode_many(files, reference)
        for data, image in zip(files, got):
            np.testing.assert_array_equal(image, png.decode_bytes(data, reference))
    with pytest.raises(ValueError, match="reference"):
        png.decode_bytes(files[0], "tf")
