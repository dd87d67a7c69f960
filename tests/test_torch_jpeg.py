"""The port's JPEG decoder (``vit_ssl_tpu_torch/data/jpeg.py`` over
``csrc/jpeg_decode.cpp``, built here with the host compiler) against the JAX
package's readers, bit for bit:

- the datasets' reference, ``vit_ssl_tpu.data.datasets._load_image``
  (``cv2.imread(..., IMREAD_COLOR)``: EXIF orientation applied, OpenCV's
  CMYK), over sampling factors, qualities, progressive files, optimized
  tables, restart intervals, grayscale, sizes off the MCU grid, the eight
  EXIF orientations, Adobe CMYK and RGB, and hypothesis over sizes and
  qualities;
- the server's, PIL's ``convert("RGB")``, with ``exif_orientation=False,
  cmyk="pil"`` on the same files;
- the refusals by name (arithmetic, 12-bit, lossless), the damaged files
  (cut short, no EOI, flipped entropy bytes), the committed fixtures and
  their digests, the host build, and threads decoding at once.
"""

import hashlib
import importlib.util
import io
import json
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.data import jpeg

FIXTURES = Path(__file__).resolve().parent / "torch_jpeg_fixtures"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SERVER = {"exif_orientation": False, "cmyk": "pil"}


def picture(seed, h, w):
    """A smooth seeded picture with noise on it (edges and texture)."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3), dtype=np.uint8)
    smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    return np.clip(smooth + rng.integers(-24, 25, smooth.shape), 0, 255).astype(np.uint8)


def cv2_file(tmp_path, name, image, quality=75, sampling="420", *extra):
    ok, buf = cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                           SAMPLING[sampling], *extra])
    assert ok
    path = tmp_path / name
    path.write_bytes(buf.tobytes())
    return path


def pil_rgb(path):
    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))


def assert_both_references(path):
    """The port equals JAX's dataset reader and, with the server's options,
    PIL; returns the dataset decode."""
    got = jpeg.decode(str(path))
    np.testing.assert_array_equal(got, jax_load_image(str(path)))
    np.testing.assert_array_equal(jpeg.decode(str(path), **SERVER), pil_rgb(path))
    return got


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_sampling_and_quality(tmp_path, sampling, quality):
    path = cv2_file(tmp_path, "x.jpg", picture(quality, 45, 67), quality, sampling)
    assert assert_both_references(path).shape == (45, 67, 3)


@pytest.mark.parametrize("mode", ["progressive", "optimize", "restart1", "restart2",
                                  "restart7", "progressive_restart2"])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_progressive_optimized_and_restarts(tmp_path, mode, sampling):
    extra = []
    if "progressive" in mode:
        extra += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if mode == "optimize":
        extra += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if "restart" in mode:
        extra += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(mode[-1])]
    path = cv2_file(tmp_path, "x.jpg", picture(7, 53, 70), 85, sampling, *extra)
    assert_both_references(path)


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 9), (33, 31), (8, 16)])
def test_sizes_off_the_mcu_grid_and_grayscale(tmp_path, size):
    image = picture(3, *size)
    for sampling in ("420", "422", "440"):
        assert_both_references(cv2_file(tmp_path, f"{sampling}.jpg", image, 80, sampling))
    gray = cv2_file(tmp_path, "gray.jpg", image[:, :, 0], 80)
    got = assert_both_references(gray)
    assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = tmp_path / "exif.jpg"
    Image.fromarray(picture(orientation, 37, 53)).save(path, "JPEG", quality=90, exif=exif)
    got = assert_both_references(path)
    assert got.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))
    assert jpeg.decode(str(path), exif_orientation=False).shape == (37, 53, 3)


@pytest.mark.parametrize("quality", [40, 95])
def test_adobe_cmyk_and_rgb(tmp_path, quality):
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(picture(quality, 29, 34)).convert("CMYK").save(cmyk, quality=quality)
    inks = tmp_path / "inks.jpg"
    ink = np.random.default_rng(quality).integers(0, 256, (20, 30, 4), dtype=np.uint8)
    Image.fromarray(ink, "CMYK").save(inks, quality=quality)
    rgb = tmp_path / "rgb.jpg"
    Image.fromarray(picture(quality, 26, 31)).save(rgb, quality=quality, keep_rgb=True)
    for path in (cmyk, inks, rgb):
        assert_both_references(path)
    # the two CMYK conversions differ: each caller gets its own reference's
    assert not np.array_equal(jpeg.decode(str(inks)), jpeg.decode(str(inks), cmyk="pil"))


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from(sorted(SAMPLING)), progressive=st.booleans())
def test_hypothesis_sizes_and_qualities(tmp_path, h, w, quality, sampling, progressive):
    path = cv2_file(tmp_path, f"h{h}w{w}.jpg", picture(h * 41 + w, h, w), quality, sampling,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive))
    assert assert_both_references(path).shape == (h, w, 3)


def _frame(marker: int, precision: int = 8) -> bytes:
    """SOI, a DQT, and a frame header of ``marker`` (8x8, one component)."""
    dqt = b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + bytes([1] * 64)
    sof = bytes([0xFF, marker]) + struct.pack(">HBHHB", 11, precision, 8, 8, 1) + b"\x01\x11\x00"
    return b"\xff\xd8" + dqt + sof + b"\xff\xd9"


@pytest.mark.parametrize("marker,precision,named", [
    (0xC9, 8, "SOF9 (arithmetic coding"), (0xC1, 12, "12-bit precision (SOF1"),
    (0xC3, 8, "SOF3 (lossless)"), (0xC5, 8, "SOF5 (hierarchical"),
    (0xCA, 8, "SOF10 (arithmetic coding: progressive)")])
def test_refusals_name_the_marker(marker, precision, named):
    with pytest.raises(jpeg.UnsupportedJPEG, match=re.escape(named)):
        jpeg.decode_bytes(_frame(marker, precision))


def test_sampling_above_two_is_refused():
    data = bytearray(_frame(0xC0))
    data[data.index(b"\x01\x11\x00") + 1] = 0x31  # component 1 sampled 3x1
    with pytest.raises(jpeg.UnsupportedJPEG, match="sampling factors 3x1"):
        jpeg.decode_bytes(bytes(data))


@pytest.mark.parametrize("cut", ["half", "ninety", "no_eoi"])
def test_damaged_files_raise(tmp_path, cut):
    """A file cut at 50 % or 90 %, or lacking only its EOI, raises
    ``ValueError`` with the byte offset, as the JAX server's reader (PIL)
    raises ``OSError``. The JAX datasets' ``cv2.imread`` instead returns
    libjpeg's recovery (the missing MCUs grey) with a warning: a deliberate
    divergence (ROADMAP.md queue C)."""
    whole = cv2_file(tmp_path, "whole.jpg", picture(11, 60, 80), 90).read_bytes()
    keep = {"half": len(whole) // 2, "ninety": len(whole) * 9 // 10,
            "no_eoi": len(whole) - 2}[cut]
    path = tmp_path / "cut.jpg"
    path.write_bytes(whole[:keep])
    for options in ({}, SERVER):
        with pytest.raises(ValueError, match="byte offset"):
            jpeg.decode(str(path), **options)
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(path)
    assert jax_load_image(str(path)).shape == (60, 80, 3)  # libjpeg's recovery


@pytest.mark.parametrize("restart", [0, 3])
def test_flipped_entropy_bytes_equal_cv2_or_name_the_offset(tmp_path, restart):
    """40 flipped bytes in the entropy-coded data: libjpeg decodes with a
    warning; the port equals it or raises naming a byte offset (where
    libjpeg's recovery would take over: ROADMAP.md queue C)."""
    rng = np.random.default_rng(restart)
    whole = bytearray(cv2_file(tmp_path, "w.jpg", picture(5, 120, 160), 85, "420",
                               cv2.IMWRITE_JPEG_RST_INTERVAL, restart).read_bytes())
    sos = whole.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(whole[sos + 2:sos + 4], "big")
    outcomes = set()
    for trial in range(12):
        data = bytearray(whole)
        for p in rng.choice(np.arange(start, len(data) - 2), 40, replace=False):
            data[p] ^= int(rng.integers(1, 256))
        path = tmp_path / f"flip{trial}.jpg"
        path.write_bytes(bytes(data))
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        try:
            got = jpeg.decode(str(path))
        except ValueError as e:
            assert "byte offset" in str(e)
            outcomes.add("raised")
            continue
        assert want is not None
        np.testing.assert_array_equal(got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
        outcomes.add("equal")
    assert outcomes


def test_a_single_flip_in_the_padding_bits_still_decodes(tmp_path):
    """The fill bits after the last MCU are no code: flipping them changes
    nothing in libjpeg or here."""
    data = bytearray(cv2_file(tmp_path, "p.jpg", picture(2, 8, 8), 75, "444").read_bytes())
    assert data[-2:] == b"\xff\xd9"
    want = jpeg.decode_bytes(bytes(data))
    data.insert(len(data) - 2, 0x00)  # an extraneous byte before EOI: skipped
    np.testing.assert_array_equal(jpeg.decode_bytes(bytes(data)), want)


def _fixture_digests():
    return json.loads((FIXTURES / "digests.json").read_text())


def _sha(image):
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()


def test_fixture_digests_match_a_fresh_cv2_and_pil_decode():
    spec = importlib.util.spec_from_file_location("make_fixtures",
                                                  FIXTURES / "make_fixtures.py")
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    recorded = _fixture_digests()
    assert recorded == make.digests(FIXTURES)
    assert len(recorded) >= 10
    assert sum(p.stat().st_size for p in FIXTURES.glob("*.jpg")) < 80_000
    cases = " ".join(v["case"] for v in recorded.values())
    for case in ("progressive", "CMYK", "EXIF orientation 6", "restart", "grayscale",
                 "4:4:0", "4:2:2", "1x1", "Adobe RGB"):
        assert case in cases, case


@pytest.mark.parametrize("name", sorted(_fixture_digests()))
def test_fixtures_decode_to_their_digests(name):
    want = _fixture_digests()[name]
    for options, key in (({}, "cv2"), (SERVER, "pil")):
        got = jpeg.decode(str(FIXTURES / name), **options)
        assert [list(got.shape), _sha(got)] == [want[key]["shape"], want[key]["sha256"]]


def test_threads_decode_at_once(tmp_path):
    files = [cv2_file(tmp_path, f"{i}.jpg", picture(i, 50 + i, 70), 80).read_bytes()
             for i in range(16)]
    alone = [jpeg.decode_bytes(f) for f in files]
    with ThreadPoolExecutor(8) as pool:
        together = list(pool.map(jpeg.decode_bytes, files * 4))
    for i, image in enumerate(together):
        np.testing.assert_array_equal(image, alone[i % 16])


def test_not_a_jpeg_and_bad_options():
    assert jpeg.is_jpeg(b"\xff\xd8\xff\xe0") and not jpeg.is_jpeg(b"\x89PNG")
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="cmyk must be one of"):
        jpeg.decode_bytes(b"\xff\xd8", cmyk="lab")


def test_host_build_rebuilds_and_reports_failures(tmp_path, monkeypatch):
    """The host library builds at first use into the build folder, is
    rebuilt when its source is newer, and a failed build or a missing
    compiler raises with the reason; nothing falls back to cv2 or PIL."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    source = tmp_path / "probe.cpp"
    source.write_text('extern "C" int probe() { return 7; }\n')
    monkeypatch.setitem(kernels.HOST_SOURCES, "probe", str(source))
    assert kernels.build_host("probe") > 0
    assert kernels.load_host("probe").probe() == 7
    assert kernels.build_host("probe") == 0  # current: not rebuilt
    lib = kernels.library_path("probe")
    source.write_text('extern "C" int probe() { return 8 }\n')  # newer, and broken
    os.utime(source, (lib.stat().st_mtime + 5,) * 2)
    with pytest.raises(RuntimeError, match="host library build failed"):
        kernels.build_host("probe")
    assert "error" in kernels.log_path("probe").read_text()
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C.. compiler"):
        kernels.build_host("probe")
    assert "jpeg_decode" not in kernels.SOURCES  # no part of the nvcc build


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("sampling", ["420", "444"])
def test_chip_smokes_encoder_and_the_standard_tables(sampling):
    """``chip_smoke.encode_jpeg`` (the card's folder of JPEGs) writes files
    that OpenCV and the port decode alike, close to the picture; without
    its DHT segment (as Motion-JPEG frames come) both decode it with the
    standard tables of Annex K."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(int(sampling))
    for h, w in ((1, 1), (19, 45), (64, 48)):
        image = smoke.smooth_picture(rng, h, w)
        data = smoke.encode_jpeg(image, 85, sampling)
        got = jpeg.decode_bytes(data)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
        if h > 1:
            mse = np.mean((got.astype(np.float64) - image) ** 2)
            assert 10 * np.log10(255 ** 2 / mse) > 30
        dht = data.index(b"\xff\xc4")
        bare = data[:dht] + data[dht + 2 + int.from_bytes(data[dht + 2:dht + 4], "big"):]
        np.testing.assert_array_equal(jpeg.decode_bytes(bare), got)


@pytest.mark.parametrize("quality", [50, 95])
def test_adobe_ycck(tmp_path, quality):
    """Adobe's YCCK (APP14 transform 2): PIL's CMYK file with its transform
    byte set to 2 is a valid YCCK file, which libjpeg turns into CMYK
    through the YCbCr tables; both references then take their CMYK path."""
    out = io.BytesIO()
    Image.fromarray(picture(quality, 23, 35)).convert("CMYK").save(out, "JPEG",
                                                                   quality=quality)
    data = bytearray(out.getvalue())
    adobe = data.index(b"Adobe")
    assert data[adobe + 11] == 0  # the transform byte: 0 is CMYK
    data[adobe + 11] = 2
    path = tmp_path / "ycck.jpg"
    path.write_bytes(bytes(data))
    got = assert_both_references(path)
    assert not np.array_equal(got, jpeg.decode_bytes(out.getvalue()))
