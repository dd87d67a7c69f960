"""The port's WebP decoder (``vit_ssl_tpu_torch/data/webp.py`` over the host
library ``csrc/webp_decode.cpp``) against libwebp as the JAX package runs
it, bit for bit: ``cv2.imread(path, cv2.IMREAD_COLOR)`` (the dataset reader,
``vit_ssl_tpu.data.datasets._load_image``, EXIF orientation applied) and
``Image.open(path).convert("RGB")`` (the server's, no rotation).

Each case encodes seeded numpy pictures with PIL or OpenCV at test time:
lossy at qualities 0 to 100 and every method, odd sizes and one-pixel
images, lossless (every transform the encoder picks, colour indexing at 2,
4, 16 and 256 colours), lossy with an alpha channel, and EXIF orientations.
Beside them: animation refused by name, damaged files raising with a byte
offset, and threads decoding at once.
"""

import io
import struct
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import webp
from vit_ssl_tpu_torch.data.datasets import _load_image


def picture(rng, h, w):
    coarse = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3), dtype=np.uint8)
    smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    return np.clip(smooth + rng.integers(-24, 25, smooth.shape), 0, 255).astype(np.uint8)


def pil_webp(image, **options):
    out = io.BytesIO()
    Image.fromarray(image).save(out, "WEBP", **options)
    return out.getvalue()


def _check(tmp_path, data, name="x.webp"):
    """The port under both references against both readers."""
    path = tmp_path / name
    path.write_bytes(data)
    want_cv2 = jax_load_image(str(path))
    with Image.open(path) as pil:
        want_pil = np.asarray(pil.convert("RGB"))
    got = webp.decode_bytes(data)
    assert got.shape == want_cv2.shape
    np.testing.assert_array_equal(got, want_cv2)
    np.testing.assert_array_equal(webp.decode_bytes(data, exif_orientation=False), want_pil)
    np.testing.assert_array_equal(_load_image(str(path)), want_cv2)
    np.testing.assert_array_equal(_load_image(str(path), reference="pil"), want_pil)
    return got


@pytest.mark.parametrize("quality", [0, 10, 30, 50, 75, 90, 100])
def test_lossy_qualities_and_methods(tmp_path, quality):
    rng = np.random.default_rng(quality)
    for method in (0, 3, 6):
        for h, w in ((1, 1), (7, 5), (33, 47), (64, 64), (97, 130)):
            _check(tmp_path, pil_webp(picture(rng, h, w), quality=quality, method=method))


@pytest.mark.parametrize("quality", [5, 60, 95])
def test_lossy_written_by_cv2(tmp_path, quality):
    rng = np.random.default_rng(100 + quality)
    for h, w in ((50, 83), (128, 96), (375, 500)):
        image = picture(rng, h, w)
        data = cv2.imencode(".webp", image, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
        _check(tmp_path, data)


@pytest.mark.parametrize("quality", [0, 50, 100])
def test_lossless(tmp_path, quality):
    rng = np.random.default_rng(200 + quality)
    for h, w in ((1, 1), (9, 31), (80, 60), (160, 200)):
        image = picture(rng, h, w)
        image[: h // 3] = rng.integers(0, 256, image[: h // 3].shape)  # noise: literals
        _check(tmp_path, pil_webp(image, lossless=True, quality=quality))


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_lossless_colour_indexing(tmp_path, colours):
    """Few colours: the palette transform, with 8, 4, 2 or 1 pixels a
    packed pixel."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    for h, w in ((3, 17), (40, 77)):
        index = rng.integers(0, colours, (h, w))
        index[:, w // 2:] = index[:, :1]  # runs: backward references
        _check(tmp_path, pil_webp(palette[index], lossless=True))


@pytest.mark.parametrize("lossless", [False, True])
def test_alpha_is_dropped(tmp_path, lossless):
    rng = np.random.default_rng(7 + lossless)
    for h, w in ((20, 30), (101, 66)):
        rgba = np.concatenate([picture(rng, h, w), rng.integers(0, 256, (h, w, 1),
                                                                dtype=np.uint8)], 2)
        rgba[: h // 2, :, 3] = 0  # transparent rows keep their colour in the file
        _check(tmp_path, pil_webp(rgba, lossless=lossless, quality=80, exact=True))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations(tmp_path, orientation):
    rng = np.random.default_rng(orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    for lossless in (False, True):
        got = _check(tmp_path, pil_webp(picture(rng, 37, 53), exif=exif, lossless=lossless))
        assert got.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))


def test_animation_is_refused_by_name(tmp_path):
    rng = np.random.default_rng(3)
    frames = [Image.fromarray(picture(rng, 16, 16)) for _ in range(2)]
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    with pytest.raises(webp.UnsupportedWebP, match="animated"):
        webp.decode_bytes(out.getvalue())


@pytest.mark.parametrize("lossless", [False, True])
def test_damaged_files_raise(tmp_path, lossless):
    rng = np.random.default_rng(11)
    data = pil_webp(picture(rng, 64, 64), lossless=lossless, quality=80)
    with pytest.raises(ValueError, match="RIFF size .* runs past the end"):
        webp.decode_bytes(data[:-40])
    with pytest.raises(ValueError, match="not a WebP"):
        webp.decode_bytes(b"RIFF\x00\x00\x00\x00WAVE" + bytes(16))
    chunk = bytearray(data)
    struct.pack_into("<I", chunk, 16, len(data))  # the frame chunk's size past the file
    with pytest.raises(ValueError, match="chunk .* at byte 12 runs past the end"):
        webp.decode_bytes(bytes(chunk))
    # the frame cut short inside a well-formed container
    body = data[20:20 + 60]
    cut = b"RIFF" + struct.pack("<I", 4 + 8 + len(body)) + b"WEBP" + data[12:16] \
        + struct.pack("<I", len(body)) + body
    with pytest.raises(ValueError, match="at byte 20"):
        webp.decode_bytes(cut)
    path = tmp_path / "cut.webp"
    path.write_bytes(cut)
    with pytest.raises(ValueError, match="damaged WebP file"):
        _load_image(str(path))


def test_threads_decode_at_once():
    """ctypes releases the GIL: four threads each decode their own file and
    get the single-threaded answer."""
    rng = np.random.default_rng(13)
    files = [pil_webp(picture(rng, 120, 160), quality=70),
             pil_webp(picture(rng, 120, 160), lossless=True)] * 2
    want = [webp.decode_bytes(d) for d in files]
    got = [None] * len(files)

    def work(i):
        for _ in range(3):
            got[i] = webp.decode_bytes(files[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(files))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
