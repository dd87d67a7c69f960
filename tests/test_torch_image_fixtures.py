"""The committed image fixtures (``tests/torch_image_fixtures``) and the
port's readers without OpenCV or PIL:

- ``digests.json`` equals a fresh decode by the JAX package's dataset reader
  (``vit_ssl_tpu.data.datasets._load_image``) and by PIL's ``convert("RGB")``,
  so the files and their digests cannot drift apart;
- the port's ``_load_image`` decodes every fixture to its digest under both
  references, as ``chip_smoke.py`` checks on the card's machine;
- with ``cv2`` and ``PIL`` blocked in ``sys.modules``, ``_load_image`` still
  returns the references' arrays for every format this slice added: 16-bit,
  Adam7 and ``eXIf``-rotated PNG, every TIFF form, lossy, lossless and alpha
  WebP, and RLE, 16-bit, bit-field and core-header BMP;
- ``chip_smoke.py``'s image-formats phase rehearsed at a narrow width: its
  written pictures decode back exactly, and the CLI trains from its mixed
  folder in a process where cv2 and PIL cannot be imported;
- the port's server decodes every fixture as the JAX package's server does.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu_torch.data import datasets

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
sys.path.insert(0, str(FIXTURES))
import encoders  # noqa: E402


def _digest(image):
    return {"shape": list(image.shape), "sha256": hashlib.sha256(image.tobytes()).hexdigest()}


def _pil(path):
    with Image.open(path) as pil:
        return np.asarray(pil.convert("RGB"))


def test_fixture_digests_match_a_fresh_cv2_and_pil_decode():
    assert len(DIGESTS) >= 15
    size = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert size < 1_100_000, size
    for name, want in DIGESTS.items():
        path = FIXTURES / name
        assert _digest(jax_load_image(str(path))) == want["cv2"], name
        assert _digest(_pil(path)) == want["pil"], name


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_decode_to_their_digests(name):
    for reference in ("cv2", "pil"):
        got = datasets._load_image(str(FIXTURES / name), reference)
        assert _digest(got) == DIGESTS[name][reference], reference


def _cases(tmp_path):
    """Files of every new case, written here from seeds."""
    rng = np.random.default_rng(27)
    picture = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    picture[:, 10:] = picture[:, :1]
    deep = rng.integers(0, 65536, (23, 31, 4)).astype(np.uint16)
    deep[0] = 100  # below 256: PIL's 16-bit grey clip shows
    index = (np.add.outer(np.arange(23) // 4, np.arange(31) // 6) % 16).astype(np.uint8)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    files = {
        "grey16.png": encoders.png(deep[:, :, 0], 0, 16),
        "rgba16.png": encoders.png(deep, 6, 16),
        "adam7_grey2.png": encoders.png(index & 3, 0, 2, interlace=True),
        "adam7_rgb.png": encoders.png(picture, 2, interlace=True),
        "exif6.png": encoders.png(picture, 2, exif=encoders.exif_orientation(6)),
        "exif3.png": encoders.png(picture, 2, exif=encoders.exif_orientation(3, ">")),
        "rle8.bmp": encoders.bmp_rle(index, palette),
        "rle4_delta.bmp": encoders.bmp_rle(index, palette, rle4=True, delta_at=(2, 4)),
    }
    for compression in (1, 5, 8, 32773):
        files[f"rgb_{compression}.tif"] = encoders.tiff(picture, photometric=2,
                                                        compression=compression,
                                                        predictor=2 if compression in (5, 8)
                                                        else 1, rows_per_strip=7)
    files.update({
        "grey16.tif": encoders.tiff(deep[:, :, 0], photometric=1, bits=16, compression=8),
        "rgb16_planar.tif": encoders.tiff(deep[:, :, :3], photometric=2, bits=16,
                                          compression=5, planar=2, order=">"),
        "white4.tif": encoders.tiff(index, photometric=0, bits=4, tile=16),
        "palette8_orient6.tif": encoders.tiff(index, photometric=3, colormap=np.repeat(
            np.arange(256, dtype=np.uint16)[:, None] * 200, 3, 1), orientation=6),
        "rgba_unassociated.tif": encoders.tiff(deep[:, :, :4] >> 8, photometric=2, extra=2),
    })
    for name, masks in (("555.bmp", None), ("565.bmp", (0xF800, 0x7E0, 0x1F)),
                        ("bgra_masks.bmp", (0xFF, 0xFF00, 0xFF0000))):
        bits = 32 if name == "bgra_masks.bmp" else 16
        pixels = rng.integers(0, 1 << bits, (4, 5), dtype=np.uint64).astype(f"<u{bits // 8}")
        body = b"".join(r.tobytes().ljust((5 * bits + 31) // 32 * 4, b"\0")
                        for r in pixels[::-1])
        extra = b"" if masks is None else struct.pack("<III", *masks)
        info = struct.pack("<IiiHHIIiiII", 40, 5, 4, 1, bits, 0 if masks is None else 3,
                           len(body), 0, 0, 0, 0)
        offset = 54 + len(extra)
        files[name] = (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info
                       + extra + body)
    core = struct.pack("<IHHHH", 12, 5, 4, 1, 24)
    files["core.bmp"] = (b"BM" + struct.pack("<IHHI", 26 + 64, 0, 0, 26) + core
                         + rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    for kind, options in (("lossy", {"quality": 60}), ("lossless", {"lossless": True})):
        out = io.BytesIO()
        Image.fromarray(picture).save(out, "WEBP", **options)
        files[f"{kind}.webp"] = out.getvalue()
    out = io.BytesIO()
    Image.fromarray(np.concatenate([picture, picture[:, :, :1]], 2)).save(out, "WEBP",
                                                                        quality=90)
    files["alpha.webp"] = out.getvalue()
    exif = Image.Exif()
    exif[0x0112] = 8
    out = io.BytesIO()
    Image.fromarray(picture).save(out, "WEBP", exif=exif)
    files["exif8.webp"] = out.getvalue()
    paths = []
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        paths.append(path)
    return paths + [FIXTURES / name for name in sorted(DIGESTS)]


def _or_none(read, path):
    try:
        return read(path)
    except (OSError, ValueError):  # the reader fails on it
        return None


def test_load_image_without_cv2_and_pil_equals_the_references(tmp_path, monkeypatch):
    paths = _cases(tmp_path)
    want = {str(p): (jax_load_image(str(p)), _or_none(_pil, p)) for p in paths}
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    assert datasets._decode_with("cv2", str(paths[0])) is None
    assert datasets._decode_with("PIL", str(paths[0])) is None
    for path, (cv2_image, pil_image) in want.items():
        np.testing.assert_array_equal(datasets._load_image(path), cv2_image, err_msg=path)
        if pil_image is None:  # PIL fails on it, and so does the port
            with pytest.raises(ValueError):
                datasets._load_image(path, "pil")
            continue
        np.testing.assert_array_equal(datasets._load_image(path, "pil"), pil_image,
                                      err_msg=path)
    gif = tmp_path / "x.gif"
    gif.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="a GIF file; without OpenCV or PIL"):
        datasets._load_image(str(gif))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BLOCKED_CLI = """
import sys
for name in ("cv2", "PIL"):
    sys.modules[name] = None
from vit_ssl_tpu_torch.train.__main__ import main
main(sys.argv[1:])
loaded = sorted(m for m in ("cv2", "PIL") if sys.modules.get(m) is not None)
print("LOADED", loaded)
"""


def test_chip_smokes_mixed_folder_trains_without_cv2_and_pil(tmp_path, monkeypatch):
    """``chip_smoke.py``'s image-formats phase on the CPU at a narrow width:
    its written pictures decode back exactly and equal the JAX dataset
    reader's arrays, and the CLI trains from its ImageNet-layout folder
    (every file named .JPEG, WebP fixtures beside) with cv2 and PIL
    blocked."""
    smoke = _load_chip_smoke()
    monkeypatch.setattr(smoke, "JPEG_SIZES", [(37, 50), (50, 37), (40, 40)])
    written = smoke.format_sources(encoders, np.random.default_rng(43))
    assert sorted({kind for kind, _, _ in written.values()}) == sorted(smoke.FORMAT_KINDS)
    folder = tmp_path / "train"
    for j, (name, (kind, data, want)) in enumerate(sorted(written.items())):
        path = folder / f"n{j % 3:08d}" / f"{name}.JPEG"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        np.testing.assert_array_equal(datasets._load_image(str(path)), want, err_msg=name)
        np.testing.assert_array_equal(jax_load_image(str(path)), want, err_msg=name)
    for j, name in enumerate(n for n in sorted(DIGESTS) if n.endswith(".webp")):
        (folder / f"n{j % 3:08d}" / f"{name}.JPEG").write_bytes((FIXTURES / name).read_bytes())
    run = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    args = ["--device", "cpu", "--config-name", "vit_b_imagenet", f"data.data_dir={folder}",
            "data.img_size=32", "model.embed_dim=64", "model.num_heads=2",
            "model.num_blocks=2", "model.mlp_dim=128", "model.patch_size=8",
            "model.num_classes=3", "training.batch_size=8", "training.warmup_epochs=1",
            "eval.interval=0", "training.num_epochs=1", "data.num_workers=2",
            "data.val_split=0.25", "training.plain_logging=true", f"hydra.run.dir={run}"]
    out = subprocess.run([sys.executable, "-c", BLOCKED_CLI, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
    assert "[epoch 1] train:" in out.stdout + out.stderr
    assert (run / "last_model" / "state.pt").exists()


def test_server_decode_matches_jax_on_every_fixture():
    """The port's server decodes each fixture (WebP, TIFF, 16-bit and
    interlaced PNG, RLE BMP) as the JAX package's server does:
    ``Image.open(path).convert("RGB")`` then its pipeline."""
    from vit_ssl_tpu_torch.serve import Server, make_pipeline

    spec = importlib.util.spec_from_file_location("jax_serve", REPO / "scripts" / "serve.py")
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)
    theirs = jax_serve.Server.__new__(jax_serve.Server)
    theirs.pipeline = jax_serve.make_pipeline(32)
    ours = Server.__new__(Server)
    ours.pipeline = make_pipeline(32)
    for name in sorted(DIGESTS):
        path = str(FIXTURES / name)
        got = ours._decode(path)
        assert got.shape == (32, 32, 3) and got.dtype == np.float32, name
        np.testing.assert_array_equal(got, theirs._decode(path), err_msg=name)
