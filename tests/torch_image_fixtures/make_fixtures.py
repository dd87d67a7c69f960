"""Write the image fixtures beside this file, and ``digests.json``.

Each fixture is one case of the port's PNG, TIFF, WebP and BMP decoders:
the WebP files written by PIL and OpenCV (libwebp), the others by
``encoders.py`` (numpy and zlib, which ``chip_smoke.py`` also uses), all
from seeds. ``digests.json`` records each file's decoded shape and the
sha256 of its RGB bytes under both references: ``cv2`` is the JAX package's
``vit_ssl_tpu.data.datasets._load_image`` (``cv2.imread(path,
cv2.IMREAD_COLOR)`` then BGR→RGB, PIL where OpenCV fails), ``pil`` is
``Image.open(path).convert("RGB")`` (its server). ``chip_smoke.py`` holds the
port's decoders to these digests on the card's machine, which has no OpenCV;
``tests/test_torch_image_fixtures.py`` holds the digests to a fresh decode
here, so the files cannot go stale.

    python tests/torch_image_fixtures/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parents[1]))  # the repo, for the JAX package
import encoders  # noqa: E402


def picture(rng, h, w):
    """A smooth seeded RGB picture with some noise: real edges and texture."""
    coarse = rng.integers(0, 256, (h // 24 + 2, w // 24 + 2, 3), dtype=np.uint8)
    smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    return np.clip(smooth + rng.integers(-12, 13, smooth.shape), 0, 255).astype(np.uint8)


def pil_webp(image, **options):
    out = io.BytesIO()
    Image.fromarray(image).save(out, "WEBP", **options)
    return out.getvalue()


def libwebp_lossy(image, **config):
    """A lossy WebP from the libwebp that PIL bundles, through its advanced
    API, for the encoder settings PIL does not pass on (the simple loop
    filter, sharpness, token partitions, segments)."""
    import ctypes

    libs = Path(Image.__file__).resolve().parents[1] / "pillow.libs"
    for dep in sorted(libs.glob("libsharpyuv*.so*")):
        ctypes.CDLL(str(dep), mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(str(sorted(libs.glob("libwebp-*.so*"))[0]))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    names = ("lossless quality method image_hint target_size target_PSNR segments "
             "sns_strength filter_strength filter_sharpness filter_type autofilter "
             "alpha_compression alpha_filtering alpha_quality pass show_compressed "
             "preprocessing partitions partition_limit emulate_jpeg_size thread_level "
             "low_memory near_lossless exact use_delta_palette use_sharp_yuv qmin qmax").split()
    floats = {"quality", "target_PSNR"}

    class Config(ctypes.Structure):  # encode.h's WebPConfig
        _fields_ = [(n, ctypes.c_float if n in floats else i32) for n in names] + [
            ("pad", ctypes.c_uint32 * 2)]

    writer = ctypes.CFUNCTYPE(i32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ptr)

    class Picture(ctypes.Structure):  # encode.h's WebPPicture
        _fields_ = [("use_argb", i32), ("colorspace", i32), ("width", i32), ("height", i32),
                    ("y", ptr), ("u", ptr), ("v", ptr), ("y_stride", i32), ("uv_stride", i32),
                    ("a", ptr), ("a_stride", i32), ("pad1", ctypes.c_uint32 * 2),
                    ("argb", ptr), ("argb_stride", i32), ("pad2", ctypes.c_uint32 * 3),
                    ("writer", writer), ("custom_ptr", ptr), ("extra_info_type", i32),
                    ("extra_info", ptr), ("stats", ptr), ("error_code", i32),
                    ("progress_hook", ptr), ("user_data", ptr), ("pad3", ctypes.c_uint32 * 3),
                    ("pad4", ptr), ("pad5", ptr), ("pad6", ctypes.c_uint32 * 8),
                    ("memory_", ptr), ("memory_argb_", ptr), ("pad7", ptr * 2)]

    abi = 0x0210  # libwebp 1.5-1.6's WEBP_ENCODER_ABI_VERSION
    cfg, pic = Config(), Picture()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75), abi)
    for key, value in config.items():
        setattr(cfg, key, value)
    assert lib.WebPValidateConfig(ctypes.byref(cfg))
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    pic.height, pic.width = image.shape[:2]
    pixels = np.ascontiguousarray(image)
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), pixels.ctypes.data_as(ptr),
                                    3 * pic.width)
    out = bytearray()

    def write(data, size, _):
        out.extend(ctypes.string_at(data, size))
        return 1

    pic.writer = writer(write)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    lib.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    return bytes(out)


def fixtures():
    """name -> (case, the file's bytes)."""
    rng = np.random.default_rng(2027)
    exif = Image.Exif()
    exif[0x0112] = 6
    alpha = picture(rng, 333, 500)[:, :, :1]
    deep = picture(rng, 96, 128).astype(np.uint16) * 257 + rng.integers(0, 257, (96, 128, 3))
    index = (picture(rng, 375, 500)[:, :, 0] // 32).astype(np.uint8)
    palette = rng.integers(0, 256, (8, 3), dtype=np.uint8)
    quarter = (picture(rng, 100, 150)[:, :, 1] // 16).astype(np.uint8)
    return {
        "lossy_q75_500x375.webp": ("lossy WebP, quality 75, 500x375 (PIL)",
                                   pil_webp(picture(rng, 375, 500), quality=75)),
        "lossy_q90_375x500.webp": ("lossy WebP, quality 90, method 6, 375x500 (PIL)",
                                   pil_webp(picture(rng, 500, 375), quality=90, method=6)),
        "lossy_alpha_q80_500x333.webp": (
            "lossy WebP with an alpha channel, quality 80, 500x333 (PIL)",
            pil_webp(np.concatenate([picture(rng, 333, 500), alpha], 2), quality=80)),
        "lossy_exif6_334x500.webp": ("lossy WebP, EXIF orientation 6, 334x500 (PIL)",
                                     pil_webp(picture(rng, 500, 334), quality=85, exif=exif)),
        "lossy_q40_256.webp": ("lossy WebP, quality 40, 256x256 (OpenCV)",
                               cv2.imencode(".webp", picture(rng, 256, 256),
                                            [cv2.IMWRITE_WEBP_QUALITY, 40])[1].tobytes()),
        "lossy_simple_filter_200x150.webp": (
            "lossy WebP, simple loop filter, sharpness 4, 8 token partitions, 200x150 "
            "(libwebp's advanced API)",
            libwebp_lossy(picture(rng, 150, 200), quality=60, filter_type=0,
                          filter_strength=70, filter_sharpness=4, partitions=3, segments=4)),
        "lossy_strong_sharp7_150x200.webp": (
            "lossy WebP, normal loop filter at strength 100, sharpness 7, one segment, "
            "2 token partitions, 150x200 (libwebp's advanced API)",
            libwebp_lossy(picture(rng, 200, 150), quality=35, filter_type=1,
                          filter_strength=100, filter_sharpness=7, segments=1, sns_strength=0,
                          partitions=1)),
        "lossless_256.webp": ("lossless WebP, 256x256 (PIL)",
                              pil_webp(picture(rng, 256, 256), lossless=True)),
        "lossless_palette_120x90.webp": (
            "lossless WebP of 8 colours (colour indexing, packed pixels), 120x90 (PIL)",
            pil_webp(palette[index[:90, :120]], lossless=True)),
        "grey16_96x128.png": ("16-bit grey PNG, 128x96",
                              encoders.png(deep[:, :, 0], 0, 16)),
        "rgb16_adam7_96x128.png": ("16-bit RGB Adam7 PNG, 128x96",
                                   encoders.png(deep, 2, 16, interlace=True)),
        "adam7_101x67.png": ("8-bit RGB Adam7 PNG, 67x101",
                             encoders.png(picture(rng, 101, 67), 2, interlace=True)),
        "exif6_37x53.png": ("PNG with eXIf orientation 6, 53x37",
                            encoders.png(picture(rng, 37, 53), 2,
                                         exif=encoders.exif_orientation(6))),
        "grey16_deflate_96x128.tif": (
            "16-bit grey TIFF, Deflate with the horizontal predictor, 128x96",
            encoders.tiff(deep[:, :, 1], photometric=1, bits=16, compression=8, predictor=2,
                          rows_per_strip=16)),
        "rgb16_lzw_96x128.tif": ("16-bit RGB TIFF, LZW, big-endian, 128x96",
                                 encoders.tiff(deep, photometric=2, bits=16, compression=5,
                                               order=">", rows_per_strip=32)),
        "rgb_packbits_tiles_100x150.tif": (
            "8-bit RGB TIFF, PackBits in 64x64 tiles, planar, 150x100",
            encoders.tiff(picture(rng, 100, 150), photometric=2, compression=32773, tile=64,
                          planar=2)),
        "palette4_orient6_100x150.tif": (
            "4-bit palette TIFF, orientation 6, 150x100",
            encoders.tiff(quarter, photometric=3, bits=4, colormap=np.repeat(
                rng.integers(0, 256, (16, 1), dtype=np.uint16), 3, 1) * 257, orientation=6)),
        "rle8_500x375.bmp": ("RLE8 BMP of 8 colours, 500x375",
                             encoders.bmp_rle(index, palette)),
        "rle4_delta_150x100.bmp": ("RLE4 BMP with a delta, 150x100",
                                   encoders.bmp_rle(quarter, rng.integers(
                                       0, 256, (16, 3), dtype=np.uint8), rle4=True,
                                       delta_at=(5, 20))),
    }


def digest(image: np.ndarray) -> dict:
    return {"shape": list(image.shape), "sha256": hashlib.sha256(image.tobytes()).hexdigest()}


def references(path: Path) -> dict:
    from vit_ssl_tpu.data.datasets import _load_image

    with Image.open(path) as pil:
        return {"cv2": digest(_load_image(str(path))),
                "pil": digest(np.asarray(pil.convert("RGB")))}


def main():
    out = {}
    for name, (case, data) in sorted(fixtures().items()):
        path = HERE / name
        path.write_bytes(data)
        out[name] = {"case": case, **references(path)}
    (HERE / "digests.json").write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    total = sum((HERE / name).stat().st_size for name in out)
    print(f"wrote {len(out)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
