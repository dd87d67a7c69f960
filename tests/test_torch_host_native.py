"""The port's host C++ image path (``csrc/image_ops.cpp``, ``csrc/batch_decode.cpp``
through ``data/image_ops.py`` and ``data/native.py``), on the CPU:

- each C++ function against its plain numpy version and against ``cv2`` 5.0
  and the JAX package's own call, max |Δ| 0: ``resize`` (integer and
  fractional shrinks, the exact 2×, growth on one axis and on both, 1-pixel
  edges, 1 to 4 channels, crops taken in place) against
  ``vit_ssl_tpu.data.transforms.Resize`` and ``RandomResizedCrop``; the HSV
  pair over every uint8 input, and ``ColorJitter``'s hue with one generator;
  the blur at kernel sizes 3 to 9 with sigmas from the configs' range
  (0.1, 2.0) and JAX's ``GaussianBlur``; the fixed-point kernel over
  thousands of sigmas;
- dispatch by dtype: uint8 goes to the library (``kernels.host_calls``
  counts each C entry), float images to the numpy versions; more threads
  than cores decoding and resizing at once get the one-thread results, and
  the counter loses no call;
- ``native.decode_batch`` byte for byte against the JAX package's
  ``vit_ssl_tpu.data.native.decode_batch`` over ``csrc/fastloader.cpp``
  built against the system OpenCV (skipped where ``pkg-config opencv4`` is
  absent), and against the JAX package's per-sample reader and resize over
  PNG, JPEG and WebP files of mixed sizes, shrinks and growths; a BMP, TIFF
  or broken file yields ``ok`` false and ``native_batch`` None;
- the slice as a whole: a host-views DINO loader batch and a
  ``data.native_decode=true`` batch against the JAX package's loaders on
  one seeded PNG folder, with every C entry of each path counted;
- the build: one image library for the PNG, JPEG and WebP decoders, the
  image ops and the whole-batch decode, each source compiled once; a host
  library of one source or several through the same compile-then-link
  steps; the WebP container read by the one C entry both paths call.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from make_synthetic_data import make
from vit_ssl_tpu.config import compose
from vit_ssl_tpu.data import prepare_dataloaders as jax_prepare_dataloaders
from vit_ssl_tpu.data import transforms as jax_transforms
from vit_ssl_tpu.data.datasets import _load_image as jax_load_image
from vit_ssl_tpu.data.transforms import get_transforms as jax_get_transforms
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.data import datasets, image_ops, jpeg, native, png, transforms, webp
from vit_ssl_tpu_torch.data.builder import prepare_dataloaders
from vit_ssl_tpu_torch.data.transforms import get_transforms

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "torch_image_fixtures"))
import encoders  # noqa: E402

RNG = np.random.default_rng(28)
# (source h, w, destination h, w): integer and fractional shrinks, the exact
# 2x, growth on one axis and on both, 1-pixel edges
RESIZES = [(96, 96, 48, 48), (97, 64, 31, 32), (90, 120, 30, 40), (60, 90, 20, 30),
           (375, 500, 224, 224), (500, 333, 224, 224), (61, 30, 48, 48), (27, 70, 48, 48),
           (20, 30, 40, 45), (13, 17, 96, 96), (1, 1, 5, 7), (1, 40, 3, 12), (40, 1, 12, 3),
           (5, 7, 1, 1), (33, 47, 33, 46), (64, 64, 32, 31), (7, 5, 7, 5)]


def _equal(got, want, what):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert int(diff.max(initial=0)) == 0, (what, int(diff.max()))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_equals_plain_and_cv2(channels):
    for sh, sw, dh, dw in RESIZES:
        src = RNG.integers(0, 256, (sh, sw, channels), dtype=np.uint8)
        for name, flag in (("area", cv2.INTER_AREA), ("linear", cv2.INTER_LINEAR)):
            what = (name, sh, sw, dh, dw, channels)
            got = image_ops.resize(src, dh, dw, name)
            _equal(got, image_ops.resize_plain(src, dh, dw, name), what)
            want = cv2.resize(src, (dw, dh), interpolation=flag)
            _equal(got, want.reshape(got.shape), what)
    # an (H, W) image keeps its two axes
    grey = RNG.integers(0, 256, (37, 29), dtype=np.uint8)
    _equal(image_ops.resize(grey, 20, 50, "area"), image_ops.resize_plain(grey, 20, 50, "area"),
           "grey")


def test_resize_takes_crops_in_place_and_copies_the_rest():
    big = RNG.integers(0, 256, (120, 150, 3), dtype=np.uint8)
    for view in (big[10:97, 23:140], big[::2, ::3], big[:, ::-1], big[::-1],
                 np.asfortranarray(big[:50, :60])):
        for name in ("area", "linear"):
            for dh, dw in ((30, 41), (96, 96), (48, 200)):
                _equal(image_ops.resize(view, dh, dw, name),
                       image_ops.resize_plain(view, dh, dw, name), (view.strides, name))


def test_dispatch_by_dtype():
    """uint8 runs in the library and is counted; a float image runs in the
    numpy version, as the visualizer's cubic resize does."""
    kernels.host_calls.clear()
    img = RNG.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    image_ops.resize(img, 20, 20, "area")
    image_ops.gaussian_blur(img, (5, 5), 1.0, 1.0)
    image_ops.hsv_to_rgb(image_ops.rgb_to_hsv(img))
    assert {k: kernels.host_calls[k] for k in ("image_resize", "image_gaussian_blur",
                                               "image_rgb_to_hsv", "image_hsv_to_rgb")} == \
        {"image_resize": 1, "image_gaussian_blur": 1, "image_rgb_to_hsv": 1,
         "image_hsv_to_rgb": 1}
    kernels.host_calls.clear()
    floats = img.astype(np.float32) / 255
    for fn in (lambda x: image_ops.resize(x, 20, 20, "linear"),
               lambda x: image_ops.resize(x, 80, 90, "cubic"),
               lambda x: image_ops.gaussian_blur(x, (3, 3), 0.5, 0.5)):
        out = fn(floats)
        assert out.dtype == np.float32
    assert sum(kernels.host_calls.values()) == 0
    np.testing.assert_array_equal(image_ops.resize(floats, 20, 20, "linear"),
                                  image_ops.resize_plain(floats, 20, 20, "linear"))
    with pytest.raises(TypeError, match="cubic"):
        image_ops.resize(img, 80, 90, "cubic")
    with pytest.raises(ValueError, match="empty size"):
        image_ops.resize(img, 0, 5, "area")
    with pytest.raises(ValueError, match="odd size"):
        image_ops.gaussian_blur(img, (4, 5), 1.0, 1.0)


@pytest.mark.parametrize("spec", [("Resize", {"size": [224, 224]}), ("Resize", {"size": 96}),
                                  ("Resize", {"size": [300, 120]}),
                                  ("RandomResizedCrop", {"size": 224}),
                                  ("RandomResizedCrop", {"size": 96, "scale": [0.4, 1.0]}),
                                  ("RandomResizedCrop", {"size": 48, "scale": [0.05, 0.4]})],
                         ids=lambda s: f"{s[0]}-{s[1]}")
def test_resizing_transforms_equal_jax(spec):
    """The port's transform (through the library) and JAX's (through
    OpenCV) from equal generators on pictures of ImageNet's sizes."""
    name, params = spec
    port, ref = transforms.build_transform(name, params), jax_transforms.build_transform(
        name, params)
    kernels.host_calls.clear()
    for i, (h, w) in enumerate([(375, 500), (500, 333), (96, 96), (64, 300)] * 3):
        image = RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)
        g_port, g_ref = np.random.default_rng(i), np.random.default_rng(i)
        got, want = port(image, g_port), ref(image, g_ref)
        _equal(got, want, (name, h, w))
        assert g_port.bit_generator.state == g_ref.bit_generator.state
    assert kernels.host_calls["image_resize"] > 0


def test_rgb_to_hsv_every_colour_equals_plain_and_cv2():
    colours = np.arange(1 << 24, dtype=np.uint32)
    for part in np.array_split(colours, 16):  # 2^20 colours a call
        rgb = np.stack([(part >> 16) & 255, (part >> 8) & 255, part & 255],
                       axis=-1).astype(np.uint8).reshape(-1, 1024, 3)
        got = image_ops.rgb_to_hsv(rgb)
        _equal(got, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV), "cv2")
        _equal(got, image_ops.rgb_to_hsv_plain(rgb), "plain")


@pytest.mark.parametrize("row", [240, 1, 45])
def test_hsv_to_rgb_every_input_equals_plain_and_cv2(row):
    """Rows of 240 pixels (blocks of 32 and a tail), of one pixel (all tail)
    and of 45 (one block and a tail)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], axis=-1).astype(np.uint8).reshape(-1, 3)
    hsv = hsv[:len(hsv) // row * row].reshape(-1, row, 3)
    for part in np.array_split(hsv, 12):
        got = image_ops.hsv_to_rgb(part)
        _equal(got, cv2.cvtColor(part, cv2.COLOR_HSV2RGB), ("cv2", row))
        _equal(got, image_ops.hsv_to_rgb_plain(part), ("plain", row))
    one = np.array([17, 200, 99], np.uint8)  # a single pixel: a row of one
    _equal(image_ops.hsv_to_rgb(one), image_ops.hsv_to_rgb_plain(one), "pixel")


def test_color_jitter_hue_equals_jax():
    """``ColorJitter``'s hue (its only OpenCV calls) with one generator."""
    params = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.2, "hue": 0.1}
    port = transforms.build_transform("ColorJitter", params)
    ref = jax_transforms.build_transform("ColorJitter", params)
    kernels.host_calls.clear()
    for i in range(40):
        image = RNG.integers(0, 256, (33, 70, 3), dtype=np.uint8)
        g_port, g_ref = np.random.default_rng(i), np.random.default_rng(i)
        _equal(port(image, g_port), ref(image, g_ref), i)
        assert g_port.bit_generator.state == g_ref.bit_generator.state
    assert kernels.host_calls["image_rgb_to_hsv"] == kernels.host_calls["image_hsv_to_rgb"] > 0


def test_gaussian_kernel_fixed_equals_plain():
    """The fixed-point kernel (Python 3.12's compensated sum, error
    diffusion) at every odd size 1 to 9 and 3000 sigmas each."""
    sigmas = np.concatenate([RNG.uniform(0.1, 2.0, 2000), RNG.uniform(0.01, 8.0, 1000)])
    for size in (1, 3, 5, 7, 9):
        for sigma in sigmas:
            got = image_ops.gaussian_kernel_fixed_library(size, float(sigma))
            np.testing.assert_array_equal(got, image_ops.gaussian_kernel_fixed(size, sigma))


def test_gaussian_blur_equals_plain_cv2_and_jax():
    for kx in (3, 5, 7, 9):
        for ky in (3, 5, 7, 9):
            for _ in range(3):
                h, w = RNG.integers(1, 60, 2)
                sx, sy = RNG.uniform(0.1, 2.0, 2)
                src = RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)
                got = image_ops.gaussian_blur(src, (kx, ky), sx, sy)
                _equal(got, image_ops.gaussian_blur_plain(src, (kx, ky), sx, sy), (kx, ky))
                _equal(got, cv2.GaussianBlur(src, (kx, ky), sigmaX=sx, sigmaY=sy), (kx, ky))
    port = transforms.build_transform("GaussianBlur", {"kernel_size": 7})
    ref = jax_transforms.build_transform("GaussianBlur", {"kernel_size": 7})
    crop = RNG.integers(0, 256, (120, 130, 3), dtype=np.uint8)[5:101, 9:105]
    for i in range(20):
        g_port, g_ref = np.random.default_rng(i), np.random.default_rng(i)
        _equal(port(crop, g_port), ref(crop, g_ref), i)


# -- the whole-batch decode ------------------------------------------------------

def _webp_fixtures():
    folder = REPO / "tests" / "torch_image_fixtures"
    return sorted(str(p) for p in folder.glob("*.webp"))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """PNG (8 and 16 bits, Adam7, palette, eXIf 6), JPEG (4:2:0, 4:4:4, grey)
    and WebP files of mixed sizes; a BMP, a TIFF and broken files apart."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(5)
    paths = []

    def write(name, data):
        path = root / name
        path.write_bytes(data)
        paths.append(str(path))

    for i, (h, w) in enumerate([(40, 56), (96, 96), (17, 130), (120, 33), (8, 8)]):
        picture = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        write(f"{i}_rgb.png", encoders.png(picture, 2))
        write(f"{i}_adam7.png", encoders.png(picture, 2, interlace=True))
        write(f"{i}_16.png", encoders.png(picture.astype(np.uint16) * 257, 2, 16))
        write(f"{i}_exif6.png", encoders.png(picture, 2, exif=encoders.exif_orientation(6)))
        ok, jpg = cv2.imencode(".jpg", picture[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        write(f"{i}.jpg", jpg.tobytes())
        ok, grey = cv2.imencode(".jpg", picture[:, :, 0])
        write(f"{i}_grey.jpg", grey.tobytes())
    for path in _webp_fixtures():
        paths.append(path)
    bad = {}
    for name, data in (("x.bmp", cv2.imencode(".bmp", np.zeros((9, 9, 3), np.uint8))[1].tobytes()),
                       ("x.tiff", cv2.imencode(".tiff", np.zeros((9, 9, 3), np.uint8))[1]
                        .tobytes()),
                       ("cut.png", Path(paths[0]).read_bytes()[:70]),
                       ("cut.jpg", Path(paths[4]).read_bytes()[:200]),
                       ("text.png", b"not an image")):
        (root / name).write_bytes(data)
        bad[name] = str(root / name)
    return paths, bad


def _jax_sample(path, out_h, out_w):
    """The JAX package's per-sample path: its reader, then fastloader's
    resize rule with cv2."""
    image = jax_load_image(path)
    if image.shape[:2] == (out_h, out_w):
        return image
    flag = cv2.INTER_AREA if out_h < image.shape[0] or out_w < image.shape[1] \
        else cv2.INTER_LINEAR
    return cv2.resize(image, (out_w, out_h), interpolation=flag)


@pytest.mark.parametrize("size", [(48, 48), (96, 96), (150, 60), (224, 224)])
def test_decode_batch_equals_jax_per_sample(mixed, size):
    paths, _ = mixed
    kernels.host_calls.clear()
    out, ok = native.decode_batch(paths, *size, num_threads=3)
    assert kernels.host_calls[native.ENTRY] == 1
    assert ok.all() and out.shape == (len(paths), *size, 3)
    for path, image in zip(paths, out):
        _equal(image, _jax_sample(path, *size), path)


def test_decode_batch_refusals_and_threads(mixed):
    paths, bad = mixed
    batch = paths[:3] + list(bad.values()) + paths[3:6]
    one, ok_one = native.decode_batch(batch, 40, 40, num_threads=1)
    many, ok_many = native.decode_batch(batch, 40, 40)
    np.testing.assert_array_equal(one, many)
    np.testing.assert_array_equal(ok_one, ok_many)
    assert ok_one.tolist() == [True] * 3 + [False] * len(bad) + [True] * 3
    assert not one[3:3 + len(bad)].any()  # failed slots are zero-filled
    out, ok = native.decode_batch([], 8, 8)
    assert out.shape == (0, 8, 8, 3) and ok.shape == (0,)
    missing, ok = native.decode_batch([str(Path(paths[0]).parent / "absent.png")], 8, 8)
    assert not ok[0] and not missing.any()
    with pytest.raises(ValueError, match="empty size"):
        native.decode_batch(paths[:2], 0, 8)


def test_threads_share_the_libraries_and_the_counter(mixed):
    """More threads than cores decode, resize and count at once, the
    interpreter switching threads every microsecond: every result equals the
    one-thread result, and no count is lost."""
    import threading

    paths, _ = mixed
    pngs = [Path(p).read_bytes() for p in paths if p.endswith(".png")]
    want = [image_ops.resize(png.decode_bytes(d), 31, 45, "area") for d in pngs]
    threads, rounds, errors = 3 * (os.cpu_count() or 1), 5, []

    def work():
        try:
            for _ in range(rounds):
                for data, expected in zip(pngs, want):
                    got = image_ops.resize(png.decode_bytes(data), 31, 45, "area")
                    if not np.array_equal(got, expected):
                        errors.append("differs")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    kernels.host_calls.clear()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    calls = threads * rounds * len(pngs)
    assert (kernels.host_calls["png_decode"], kernels.host_calls["image_resize"]) == \
        (calls, calls)


@pytest.fixture(scope="module")
def fastloader(tmp_path_factory):
    """The JAX package's ``csrc/fastloader.cpp`` built against OpenCV into a
    temporary folder (the JAX package's files untouched)."""
    if shutil.which("pkg-config") is None or subprocess.run(
            ["pkg-config", "--exists", "opencv4"]).returncode != 0:
        pytest.skip("pkg-config opencv4 is absent: OpenCV's headers are needed to build "
                    "csrc/fastloader.cpp")
    lib = tmp_path_factory.mktemp("fastloader") / "libfastloader.so"
    flags = subprocess.run(["pkg-config", "--cflags", "opencv4"], capture_output=True,
                           text=True, check=True).stdout.split()
    subprocess.run([kernels.host_compiler(), "-O2", "-fPIC", "-std=c++17", *flags, "-shared",
                    "-o", str(lib), str(REPO / "csrc" / "fastloader.cpp"),
                    "-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core"], check=True)
    return lib


def test_decode_batch_equals_jax_fastloader(mixed, fastloader, monkeypatch):
    from vit_ssl_tpu.data import native as jax_native

    monkeypatch.setattr(jax_native, "_LIB_PATH", fastloader)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_checked", False)
    paths, bad = mixed
    # a system OpenCV before 5.0 (4.6, say) leaves a WebP's EXIF orientation
    # unapplied in its reader, where cv2 5.0, the JAX package's dataset
    # reader that the per-sample test above holds the batch to, applies it
    version = subprocess.run(["pkg-config", "--modversion", "opencv4"], capture_output=True,
                             text=True).stdout.strip()
    if int(version.split(".")[0]) < 5:
        paths = [p for p in paths if not (p.endswith(".webp") and "exif" in p)]
    batch = paths + [bad["cut.png"], bad["text.png"]]
    for size in ((48, 48), (96, 96), (150, 60)):
        got, ok = native.decode_batch(batch, *size, num_threads=4)
        want, want_ok = jax_native.decode_batch(batch, *size, num_threads=4)
        np.testing.assert_array_equal(ok, want_ok)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), size


def test_native_batch_hands_failures_to_the_per_sample_path(mixed, tmp_path):
    paths, bad = mixed
    folder = tmp_path / "folder"
    folder.mkdir()
    for i, path in enumerate(paths[:8]):
        os.link(path, folder / f"{i:02d}.png")  # any format, named .png
    resize = transforms.Compose([transforms.Resize([32, 32])])
    dataset = datasets.STL10UnsupervisedDataset(str(folder), resize, native_decode=True)
    batch = dataset.native_batch(range(8))
    for i, b in enumerate(batch):
        _equal(b, dataset[i], i)
    for name in ("x.bmp", "x.tiff", "cut.png"):
        os.link(bad[name], folder / f"99_{name}.png")
    dataset = datasets.STL10UnsupervisedDataset(str(folder), resize, native_decode=True)
    assert dataset.native_batch(range(len(dataset))) is None
    assert dataset.native_batch(range(8)) is not None
    names = [Path(f).name for f in dataset.files]
    for name in ("x.bmp", "x.tiff"):
        _equal(dataset[names.index(f"99_{name}.png")],
               _jax_sample(str(folder / f"99_{name}.png"), 32, 32), name)
    with pytest.raises(ValueError, match="damaged PNG"):
        dataset[names.index("99_cut.png.png")]


# -- the slice as a whole --------------------------------------------------------

TINY = ["data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.output_dim=16", "training.batch_size=4", "training.warmup_epochs=1",
        "eval.interval=0", "data.num_workers=2", "model.dropout=0.0"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    make(str(root), n=18, size=40, num_classes=2, seed=7)
    return root / "unlabeled_images"


def _same_batch(got, want):
    assert set(got) == set(want)
    for key in got:
        a, b = got[key], want[key]
        for u, v in zip(*((a, b) if isinstance(a, list) else ([a], [b]))):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("path", ["host_views", "native_decode"])
def test_slice_batches_equal_jax_through_the_library(folder, path):
    extra = (["data.device_augment=false"] if path == "host_views"
             else ["data.device_augment=true", "data.native_decode=true"])
    config = compose(str(REPO / "configs"), "dino", [f"data.data_dir={folder}", *TINY, *extra])
    kernels.host_calls.clear()
    train, _ = prepare_dataloaders(config, "dino")
    jax_train, _ = jax_prepare_dataloaders(config, jax_get_transforms(config), "dino")
    batches = 0
    for got, want in zip(train, jax_train):
        _same_batch(got, want)
        batches += 1
    assert batches == len(train) > 0
    if path == "host_views":
        # every view decoded by the C++ PNG decoder, cropped, hue-turned and
        # blurred in the C++ image ops
        entries = ("png_decode", "image_resize", "image_rgb_to_hsv", "image_hsv_to_rgb",
                   "image_gaussian_blur")
        assert kernels.host_calls[native.ENTRY] == 0
    else:
        entries = (native.ENTRY,)
        assert kernels.host_calls["png_decode"] == 0  # every batch in one call
    assert all(kernels.host_calls[e] > 0 for e in entries), dict(kernels.host_calls)


def test_slice_load_image_equals_jax(folder):
    kernels.host_calls.clear()
    for path in sorted(folder.glob("*.png"))[:6]:
        _equal(datasets._load_image(str(path)), jax_load_image(str(path)), path)
    assert kernels.host_calls["png_decode"] == 6
    pipes = get_transforms(compose(str(REPO / "configs"), "dino", [f"data.data_dir={folder}"]))
    assert set(pipes) >= {"globals", "locals"}


# -- the build -------------------------------------------------------------------

def test_one_image_library_compiles_each_source_once():
    modules = (png, jpeg, webp, image_ops, native)
    assert {m.LIBRARY for m in modules} == {kernels.HOST_IMAGE}
    lib = kernels.load_host(kernels.HOST_IMAGE)
    for entry in ("png_decode", "jpeg_decode", "webp_decode", "image_resize",
                  "image_gaussian_blur", native.ENTRY):
        assert hasattr(lib, entry), entry
    sources = kernels.host_sources(kernels.HOST_IMAGE)
    commands = [line for line in kernels.log_path(kernels.HOST_IMAGE).read_text().splitlines()
                if line.startswith("$ ")]
    compiled = sorted(line.split()[-1] for line in commands if " -c " in line)
    assert compiled == sorted(str(src) for src in sources)
    assert len(commands) == len(sources) + 1  # one compile a source, one link
    others = [s for name in kernels.HOST_SOURCES if name != kernels.HOST_IMAGE
              for s in kernels.host_sources(name)]
    assert not set(sources) & set(others)


def test_build_host_compiles_then_links_one_source_or_several(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    (tmp_path / "a.cpp").write_text('extern "C" int twice(int x) { return 2 * x; }\n')
    (tmp_path / "b.cpp").write_text('extern "C" int twice(int);\n'
                                    'extern "C" int four_times(int x) { return twice(twice(x)); }\n')
    (tmp_path / "c.cpp").write_text('extern "C" int twice(int x) { return x + x; }\n')
    monkeypatch.setitem(kernels.HOST_SOURCES, "pair", (str(tmp_path / "a.cpp"),
                                                       str(tmp_path / "b.cpp")))
    monkeypatch.setitem(kernels.HOST_SOURCES, "single", str(tmp_path / "a.cpp"))
    monkeypatch.setitem(kernels.HOST_SOURCES, "clash", (str(tmp_path / "a.cpp"),
                                                        str(tmp_path / "c.cpp")))
    assert kernels.load_host("pair").four_times(3) == 12
    assert kernels.load_host("single").twice(5) == 10
    for name, sources in (("pair", 2), ("single", 1)):
        log = kernels.log_path(name).read_text()
        assert log.count(" -c ") == sources and log.count("$ ") == sources + 1, log
    with pytest.raises(RuntimeError, match="host library build failed .* -shared"):
        kernels.build_host("clash")  # the same C entry twice: the link fails
    assert not kernels.library_path("clash").exists()
    assert not list((tmp_path / "build").glob("*.o"))  # objects removed either way


def test_webp_container_is_read_by_the_entry_both_paths_call(tmp_path):
    """An animated WebP is refused by name per sample and gets ok false in
    the batch; a WebP with EXIF orientation 6 turns alike on both paths."""
    from PIL import Image

    rng = np.random.default_rng(12)
    frames = [Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
              for _ in range(2)]
    animated = tmp_path / "animated.webp"
    frames[0].save(animated, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    with pytest.raises(webp.UnsupportedWebP, match="animated WebP"):
        webp.decode(str(animated))
    exif = Image.Exif()
    exif[0x0112] = 6
    turned = tmp_path / "turned.webp"
    frames[0].save(turned, "WEBP", lossless=True, exif=exif)
    kernels.host_calls.clear()
    want = webp.decode(str(turned))
    assert want.shape == (24, 16, 3) and kernels.host_calls["webp_decode"] == 1
    out, ok = native.decode_batch([str(animated), str(turned)], 24, 16, num_threads=2)
    assert ok.tolist() == [False, True] and not out[0].any()
    _equal(out[1], want, "turned.webp")
    _equal(out[1], jax_load_image(str(turned)), "turned.webp")
