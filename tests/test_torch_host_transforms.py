"""The port's host transforms (``vit_ssl_tpu_torch/data/transforms.py``) and
the OpenCV arithmetic under them (``data/image_ops.py``), on the CPU:

- every one of the ten transforms against the JAX package's
  (``vit_ssl_tpu/data/transforms.py``), on seeded uint8 and float inputs
  from equal generators, the generators' next draws equal afterwards: on
  uint8 every output is bit-equal; on float the numpy-only transforms are
  bit-equal and the resizes and the blur, where JAX calls OpenCV's float
  paths, are within 1e-5 (linear resize, measured max |Δ| 4.2e-6 on [0, 1]
  floats), 0 (area) and 1e-6 (blur, measured 2.4e-7);
- each OpenCV replacement against ``cv2`` 5.0 on uint8, measured max |Δ| 0
  and share of exact pixels 1.0 (the target, exact, met): RGB→HSV over all
  2^24 colours, HSV→RGB over all 180·256·256 inputs laid out as rows of
  240 pixels (blocks of 32 and a tail) and as rows of one pixel (all
  tail), ``INTER_LINEAR`` and ``INTER_AREA`` resizes between sizes from 1
  to 130 px (shrinks by integer factors, by 2 on both axes, growth on one
  axis), the Gaussian blur at kernel sizes 1 to 9 with independent
  widths and heights;
- DINO's whole ``globals`` and ``locals`` pipelines (``configs/dino.yaml``)
  on 96 px images: max and mean |Δ| 0 against JAX's.
"""

import cv2
import numpy as np
import pytest

from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu.data import transforms as jax_transforms
from vit_ssl_tpu_torch.data import image_ops
from vit_ssl_tpu_torch.data import transforms

# (name, params): every transform of the JAX registry, with its options
SPECS = [
    ("Resize", {"size": 20}),
    ("Resize", {"size": [24, 30]}),
    ("Resize", {"size": [10, 12]}),
    ("Resize", {"size": [37, 45]}),
    ("CenterCrop", {"size": 16}),
    ("CenterCrop", {"size": [20, 50]}),
    ("RandomCrop", {"size": 16}),
    ("RandomCrop", {"size": [20, 24], "padding": 4}),
    ("RandomResizedCrop", {"size": 24}),
    ("RandomResizedCrop", {"size": 96, "scale": [0.5, 1.0]}),
    ("RandomResizedCrop", {"size": 48, "scale": [0.08, 0.4]}),
    ("RandomResizedCrop", {"size": [20, 28], "scale": [0.9, 1.0], "ratio": [0.5, 0.6]}),
    ("RandomHorizontalFlip", {}),
    ("RandomHorizontalFlip", {"p": 1.0}),
    ("ColorJitter", {"brightness": 0.4, "contrast": 0.4, "saturation": 0.2, "hue": 0.1}),
    ("ColorJitter", {"brightness": 0.8}),
    ("ColorJitter", {"hue": 0.5}),
    ("ColorJitter", {"contrast": [0.2, 1.5], "saturation": [0.0, 2.0], "hue": [-0.2, 0.3]}),
    ("RandomGrayscale", {"p": 0.2}),
    ("RandomGrayscale", {"p": 1.0}),
    ("GaussianBlur", {"kernel_size": 7, "sigma": [0.1, 2.0]}),
    ("GaussianBlur", {"kernel_size": 4, "sigma": 1.3}),
    ("GaussianBlur", {"kernel_size": [3, 9], "sigma": [0.5, 3.0]}),
    ("ToTensor", {}),
    ("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
]
# the transforms where JAX calls OpenCV's float paths on a float input
FLOAT_BOUNDS = {"Resize": 1e-5, "RandomResizedCrop": 1e-5, "GaussianBlur": 1e-6}


def test_registry_and_deterministic_set_are_jax():
    assert list(transforms.TRANSFORM_REGISTRY) == list(jax_transforms.TRANSFORM_REGISTRY)
    assert {n for n, _ in SPECS} == set(transforms.TRANSFORM_REGISTRY)
    assert ([t.__name__ for t in transforms._DETERMINISTIC]
            == [t.__name__ for t in jax_transforms._DETERMINISTIC])
    assert not hasattr(transforms, "_NOT_PORTED")
    with pytest.raises(ValueError, match="Unknown transform"):
        transforms.build_transform("Solarize", {})


def _inputs(dtype):
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (37, 45, 3), dtype=np.uint8) for _ in range(6)]
    images.append(np.zeros((37, 45, 3), np.uint8))  # flat: saturation 0
    if dtype == "float":
        return [(im / 255.0).astype(np.float32) for im in images]
    return images


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("name,params", SPECS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SPECS)])
def test_transform_matches_jax(name, params, dtype):
    port = transforms.build_transform(name, params)
    ref = jax_transforms.build_transform(name, params)
    bound = FLOAT_BOUNDS.get(name, 0.0) if dtype == "float" else 0.0
    for i, image in enumerate(_inputs(dtype)):
        for seed in range(4):
            g_port, g_ref = np.random.default_rng((seed, i)), np.random.default_rng((seed, i))
            got, want = port(image, g_port), ref(image, g_ref)
            assert got.dtype == want.dtype and got.shape == want.shape
            err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
            assert err <= bound, (name, params, dtype, err)
            # the same draws were taken: the streams go on alike
            assert g_port.bit_generator.state == g_ref.bit_generator.state
            np.testing.assert_array_equal(g_port.random(3), g_ref.random(3))


def test_pil_input_converts():
    from PIL import Image

    image = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    pipe = transforms.build_pipeline([{"name": "Resize", "params": {"size": [10, 16]}},
                                      {"name": "ToTensor"}])
    np.testing.assert_array_equal(pipe(Image.fromarray(image).convert("L")),
                                  pipe(np.asarray(Image.fromarray(image).convert("L"))))


def _exact_share(got, want):
    """(max |Δ|, share of exact values)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), float((diff == 0).mean())


def test_rgb_to_hsv_every_colour():
    colours = np.arange(1 << 24, dtype=np.uint32)
    for part in np.array_split(colours, 8):  # 2^21 colours a call
        rgb = np.stack([(part >> 16) & 255, (part >> 8) & 255, part & 255],
                       axis=-1).astype(np.uint8).reshape(-1, 2048, 3)
        got = image_ops.rgb_to_hsv(rgb)
        assert _exact_share(got, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)) == (0, 1.0)


@pytest.mark.parametrize("row", [240, 1])
def test_hsv_to_rgb_every_input(row):
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], axis=-1).astype(np.uint8).reshape(-1, row, 3)
    for part in np.array_split(hsv, 6):
        got = image_ops.hsv_to_rgb(part)
        assert _exact_share(got, cv2.cvtColor(part, cv2.COLOR_HSV2RGB)) == (0, 1.0)


def test_resize_matches_cv2():
    rng = np.random.default_rng(3)
    sizes = [tuple(rng.integers(1, 131, 4)) for _ in range(150)]
    sizes += [(2 * a, 2 * b, a, b) for a, b in rng.integers(1, 60, (20, 2))]
    sizes += [(3 * a, 4 * b, a, b) for a, b in rng.integers(1, 30, (20, 2))]
    sizes += [(61, 30, 48, 48), (27, 70, 48, 48), (96, 96, 48, 48), (1, 1, 5, 7)]
    for sh, sw, dh, dw in sizes:
        src = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        for name, flag in (("area", cv2.INTER_AREA), ("linear", cv2.INTER_LINEAR)):
            got = image_ops.resize(src, dh, dw, name)
            want = cv2.resize(src, (int(dw), int(dh)), interpolation=flag)
            assert _exact_share(got, want) == (0, 1.0), (name, sh, sw, dh, dw)


def test_gaussian_blur_matches_cv2():
    rng = np.random.default_rng(4)
    for kx in (1, 3, 5, 7, 9):
        for ky in (1, 3, 7):
            for _ in range(6):
                h, w = rng.integers(8, 100, 2)
                sx, sy = rng.uniform(0.1, 3.0, 2)
                src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                got = image_ops.gaussian_blur(src, (kx, ky), sx, sy)
                want = cv2.GaussianBlur(src, (kx, ky), sigmaX=sx, sigmaY=sy)
                assert _exact_share(got, want) == (0, 1.0), (kx, ky, sx, sy)
    for size, sigma in ((7, 0.7), (5, 2.0), (9, 1.1)):
        np.testing.assert_allclose(image_ops.gaussian_kernel(size, sigma),
                                   cv2.getGaussianKernel(size, sigma)[:, 0], rtol=1e-12)


@pytest.mark.parametrize("key", ["globals", "locals"])
def test_dino_pipelines_match_jax(key):
    """``configs/dino.yaml``'s host pipelines on 96 px images, 64 views each:
    max and mean |Δ| against JAX's are both 0."""
    spec = to_container(compose("configs", "dino"))["transforms"][key]
    port, ref = transforms.build_pipeline(spec), jax_transforms.build_pipeline(spec)
    rng = np.random.default_rng(9)
    errs = []
    for i in range(64):
        image = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
        g_port, g_ref = np.random.default_rng(i), np.random.default_rng(i)
        got, want = port(image, g_port), ref(image, g_ref)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        errs.append(np.abs(got - want))
        assert g_port.bit_generator.state == g_ref.bit_generator.state
    errs = np.stack(errs)
    assert (float(errs.max()), float(errs.mean())) == (0.0, 0.0)
