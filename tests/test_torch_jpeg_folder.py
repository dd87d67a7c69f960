"""JPEG folders through the port's data paths, against the JAX package's:

- ``ImageFolderDataset`` over a mixed JPEG, PNG and BMP folder (one file
  named ``.JPEG`` holds a PNG: the decoder is chosen by magic bytes), sample
  for sample equal to JAX's under ``configs/vit_b_imagenet.yaml``'s train and
  val pipelines and under its device-augment decode-and-resize, with the same
  generators; the evaluators' datasets and ``STL10Dataset`` over JPEGs;
- ``Server._decode`` against ``scripts/serve.py``'s on JPEGs with EXIF
  orientation 6 and in CMYK (PIL's reading: no rotation, PIL's CMYK);
- a ``--device cpu`` CLI run of a narrow supervised ViT (2 blocks, width 64)
  from a JPEG folder, in a process where ``cv2`` and ``PIL`` cannot be
  imported.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.data import datasets as jax_datasets
from vit_ssl_tpu.data import transforms as jax_transforms
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.data import datasets
from vit_ssl_tpu_torch.data.builder import eval_datasets, labeled_datasets
from vit_ssl_tpu_torch.serve import Server, make_pipeline

REPO = Path(__file__).resolve().parent.parent
IMG = 32
NARROW = [f"data.img_size={IMG}", "model.embed_dim=64", "model.num_heads=2",
          "model.num_blocks=2", "model.mlp_dim=128", "model.patch_size=8",
          "model.num_classes=3", "training.batch_size=8", "training.warmup_epochs=1",
          "eval.interval=0"]


def _picture(rng, h, w):
    coarse = rng.integers(0, 256, (h // 5 + 2, w // 5 + 2, 3), dtype=np.uint8)
    return cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)


def _jpeg(image, *params):
    ok, buf = cv2.imencode(".jpg", image, list(params))
    assert ok
    return buf.tobytes()


def _write_folder(root: Path, n: int, mixed: bool, seed: int = 0) -> Path:
    """``n`` images in 3 class folders: JPEGs of several sizes and kinds,
    and, when ``mixed``, PNGs, BMPs and a PNG named ``.JPEG``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = [(40, 52), (52, 40), (33, 47), (48, 48)][i % 4]
        image = _picture(rng, h, w)
        kind = i % 6 if mixed else i % 3
        folder = root / f"n0{i % 3:07d}"
        folder.mkdir(parents=True, exist_ok=True)
        if kind == 0:
            data, name = _jpeg(image, cv2.IMWRITE_JPEG_QUALITY, 90), f"{i}.JPEG"
        elif kind == 1:
            data, name = _jpeg(image, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), f"{i}.jpg"
        elif kind == 2:
            data, name = _jpeg(image, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), f"{i}.jpeg"
        elif kind == 3:
            data, name = cv2.imencode(".png", image)[1].tobytes(), f"{i}.png"
        elif kind == 4:
            data, name = cv2.imencode(".bmp", image)[1].tobytes(), f"{i}.bmp"
        else:  # ImageNet holds such files: a PNG under a JPEG name
            data, name = cv2.imencode(".png", image)[1].tobytes(), f"{i}.JPEG"
        (folder / name).write_bytes(data)
    return root


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("mixed"), 18, mixed=True)


def _assert_items_equal(ours, theirs, seeds=2):
    assert len(ours) == len(theirs) and list(ours.classes) == list(theirs.classes)
    for idx in range(len(ours)):
        for seed in range(seeds):
            a = ours.__getitem__(idx, np.random.default_rng((seed, idx)))
            b = theirs.__getitem__(idx, np.random.default_rng((seed, idx)))
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])


def test_the_folder_holds_a_png_named_jpeg(mixed):
    names = {p.name: p.read_bytes()[:4] for p in mixed.rglob("*") if p.is_file()}
    assert any(n.endswith(".JPEG") and head == b"\x89PNG" for n, head in names.items())
    assert {n.rsplit(".", 1)[1] for n in names} == {"JPEG", "jpg", "jpeg", "png", "bmp"}


@pytest.mark.parametrize("augment", ["host", "device"])
def test_image_folder_matches_jax_under_the_config_pipelines(mixed, augment):
    overrides = [f"data.data_dir={mixed}", f"data.img_size={IMG}",
                 f"data.device_augment={'true' if augment == 'device' else 'false'}"]
    config = compose(REPO / "configs", "vit_b_imagenet", overrides)
    train, val = labeled_datasets(config)
    if augment == "host":
        jax_config = jax_compose(str(REPO / "configs"), "vit_b_imagenet", overrides=overrides)
        pipes = jax_transforms.get_transforms(jax_config)
        theirs = (jax_datasets.ImageFolderDataset(str(mixed), pipes["train"]),
                  jax_datasets.ImageFolderDataset(str(mixed), pipes["val"]))
    else:
        resize = jax_transforms.Compose([jax_transforms.Resize([IMG, IMG])])
        theirs = (jax_datasets.ImageFolderDataset(str(mixed), resize),) * 2
    assert len(train) == 18
    for ours, jax_set in zip((train, val), theirs):
        _assert_items_equal(ours, jax_set)


def test_eval_and_stl10_datasets_read_jpegs(mixed, tmp_path):
    config = compose(REPO / "configs", "vit_b_imagenet",
                     [f"data.img_size={IMG}", "eval.dataset_name=imagefolder",
                      f"eval.data_dir={mixed}"])
    pipeline = jax_transforms.Compose([jax_transforms.Resize([IMG, IMG]),
                                       jax_transforms.ToTensor()])
    for ours in eval_datasets(config):
        _assert_items_equal(ours, jax_datasets.ImageFolderDataset(str(mixed), pipeline), 1)
    files = sorted(str(p) for p in mixed.rglob("*") if p.suffix.lower() in (".jpg", ".jpeg"))
    index = tmp_path / "labels.json"
    index.write_text(json.dumps([[f"x/{os.path.basename(f)}", i % 2]
                                 for i, f in enumerate(files)]))
    flat = tmp_path / "flat"
    flat.mkdir()
    for f in files:
        os.link(f, flat / os.path.basename(f))
    _assert_items_equal(datasets.STL10Dataset(str(index), str(flat)),
                        jax_datasets.STL10Dataset(str(index), str(flat)), 1)


def test_server_decode_matches_jax_on_exif_and_cmyk(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_serve", REPO / "scripts" / "serve.py")
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)
    theirs = jax_serve.Server.__new__(jax_serve.Server)
    theirs.pipeline = jax_serve.make_pipeline(IMG)
    ours = Server.__new__(Server)
    ours.pipeline = make_pipeline(IMG)
    rng = np.random.default_rng(4)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_picture(rng, 30, 50)).save(tmp_path / "exif6.jpg", quality=90,
                                                exif=exif)
    Image.fromarray(_picture(rng, 41, 29)).convert("CMYK").save(tmp_path / "cmyk.jpg",
                                                                quality=85)
    for name in ("exif6.jpg", "cmyk.jpg"):
        path = str(tmp_path / name)
        got = ours._decode(path)
        assert got.shape == (IMG, IMG, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, theirs._decode(path))
    # the datasets' reader rotates the EXIF-6 file (OpenCV), the server's does not
    assert datasets._load_image(str(tmp_path / "exif6.jpg")).shape == (50, 30, 3)
    assert datasets._load_image(str(tmp_path / "exif6.jpg"), reference="pil").shape == (
        30, 50, 3)


BLOCKED_CLI = """
import sys
for name in ("cv2", "PIL"):
    sys.modules[name] = None
from vit_ssl_tpu_torch.train.__main__ import main
main(sys.argv[1:])
loaded = sorted(m for m in ("cv2", "PIL") if sys.modules.get(m) is not None)
print("LOADED", loaded)
"""


def test_cli_trains_from_a_jpeg_folder_without_cv2_and_pil(tmp_path):
    folder = _write_folder(tmp_path / "train", 24, mixed=False, seed=1)
    run = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    args = ["--device", "cpu", "--config-name", "vit_b_imagenet", f"data.data_dir={folder}",
            *NARROW, "training.num_epochs=1", "data.num_workers=2", "data.val_split=0.25",
            "training.plain_logging=true", f"hydra.run.dir={run}"]
    out = subprocess.run([sys.executable, "-c", BLOCKED_CLI, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
    text = out.stdout + out.stderr
    assert "[epoch 1] train:" in text and "val:" in text
    for name in ("best_model", "last_model"):
        assert (run / name / "state.pt").exists(), name
