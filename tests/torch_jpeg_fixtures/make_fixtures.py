"""Write the JPEG fixtures beside this file, and ``digests.json``.

Each fixture is one case of the port's JPEG decoder, written from a seed with
OpenCV or PIL; ``digests.json`` records each file's decoded shape and the
sha256 of its RGB bytes under both references: ``cv2`` is
``cv2.imread(path, cv2.IMREAD_COLOR)`` then BGR→RGB (the JAX package's
``_load_image``), ``pil`` is ``Image.open(path).convert("RGB")`` (its
server). ``chip_smoke.py`` holds the port's decoder to these digests on the
card's machine, which has neither library; ``tests/test_torch_jpeg.py``
holds the digests to a fresh decode here, so the files cannot go stale.

    python tests/torch_jpeg_fixtures/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def picture(rng, h, w):
    """A smooth seeded RGB picture with some noise: real edges and texture."""
    coarse = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3), dtype=np.uint8)
    smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    return np.clip(smooth + rng.integers(-24, 25, smooth.shape), 0, 255).astype(np.uint8)


def cv2_jpeg(rgb, quality, sampling, *extra):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR) if rgb.ndim == 3 else rgb,
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling, *extra])
    assert ok
    return buf.tobytes()


def pil_jpeg(image, **options):
    out = io.BytesIO()
    image.save(out, "JPEG", **options)
    return out.getvalue()


def fixtures():
    """name -> (case, the file's bytes)."""
    rng = np.random.default_rng(2024)
    exif = Image.Exif()
    exif[0x0112] = 6
    return {
        "baseline_420_q75.jpg": ("baseline 4:2:0, quality 75, 61x47",
                                 cv2_jpeg(picture(rng, 47, 61), 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
        "baseline_444_q95.jpg": ("baseline 4:4:4, quality 95",
                                 cv2_jpeg(picture(rng, 40, 48), 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
        "baseline_422_q50.jpg": ("baseline 4:2:2, quality 50",
                                 cv2_jpeg(picture(rng, 33, 50), 50, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
        "baseline_440_q10.jpg": ("baseline 4:4:0, quality 10",
                                 cv2_jpeg(picture(rng, 45, 38), 10, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
        "progressive_420_q90.jpg": ("progressive 4:2:0, quality 90",
                                    cv2_jpeg(picture(rng, 57, 70), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                             cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        "optimized_restart7_q100.jpg": ("optimized tables, restart interval 7, quality 100",
                                        cv2_jpeg(picture(rng, 30, 44), 100,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                                 cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                 cv2.IMWRITE_JPEG_RST_INTERVAL, 7)),
        "gray_q85.jpg": ("grayscale, quality 85",
                         cv2_jpeg(picture(rng, 35, 41)[:, :, 0], 85,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
        "tiny_1x1_q1.jpg": ("1x1, quality 1",
                            cv2_jpeg(picture(rng, 1, 1), 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
        "exif_orientation6.jpg": ("EXIF orientation 6 (PIL), 53x37",
                                  pil_jpeg(Image.fromarray(picture(rng, 37, 53)), quality=90,
                                           exif=exif)),
        "adobe_cmyk.jpg": ("Adobe CMYK (PIL)",
                           pil_jpeg(Image.fromarray(picture(rng, 29, 34)).convert("CMYK"),
                                    quality=85)),
        "adobe_rgb.jpg": ("Adobe RGB, saved without conversion (PIL keep_rgb)",
                          pil_jpeg(Image.fromarray(picture(rng, 26, 31)), quality=80,
                                   keep_rgb=True)),
    }


def cv2_rgb(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def pil_rgb(path) -> np.ndarray:
    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))


def digest(image: np.ndarray) -> dict:
    image = np.ascontiguousarray(image, np.uint8)
    return {"shape": list(image.shape), "sha256": hashlib.sha256(image.tobytes()).hexdigest()}


def digests(folder: Path = HERE) -> dict:
    """name -> case and both references' digests, of the files in ``folder``."""
    cases = {name: case for name, (case, _) in fixtures().items()}
    return {name: {"case": cases[name], "cv2": digest(cv2_rgb(folder / name)),
                   "pil": digest(pil_rgb(folder / name))} for name in sorted(cases)}


def main() -> None:
    for name, (_, data) in fixtures().items():
        (HERE / name).write_bytes(data)
    (HERE / "digests.json").write_text(json.dumps(digests(), indent=1) + "\n")


if __name__ == "__main__":
    main()
