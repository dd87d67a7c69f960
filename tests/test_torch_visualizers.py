"""The port's attention and SimMIM visualizers
(``vit_ssl_tpu_torch.scripts.{attention,simmim}_visualizer``) against the
repo's JAX scripts, and the cubic resize they use, on the CPU.

Random JAX weights (2 blocks, embed 64, 2 heads, 32 px, patch 8, perturbed
so that the attention is far from uniform) go to the port through its
bridge (``vit_state_dict_from_flax``, ``simmim_state_dict_from_flax``);
both scripts read the same PNG, written here with PIL. The JAX scripts'
arrays are captured where they reach ``Axes.imshow``.

- Attention map: the predicted class equal, the input image bit-equal (the
  port's decoder and resize against PIL and OpenCV), the heat map within
  1e-5 (it is scaled to [0, 1]; fp32 sums in another order).
- SimMIM: JAX's mask (the third output of its ``apply``) handed to the
  port; the original bit-equal, the masked and reconstruction images
  within 1e-5.
- Resize: ``image_ops.resize(..., "cubic")`` within 1e-6 of max |cv2| on
  float32 images.
- Without matplotlib each script logs one warning naming it and the
  output file, and still returns its arrays.
"""

import importlib.util
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import from_container as jax_from_container
from vit_ssl_tpu.models.builder import build_model as jax_build_model
from vit_ssl_tpu_torch.config import compose, from_container, to_container
from vit_ssl_tpu_torch.data import image_ops
from vit_ssl_tpu_torch.models.builder import build_model
from vit_ssl_tpu_torch.scripts import attention_visualizer, simmim_visualizer
from vit_ssl_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                simmim_state_dict_from_flax,
                                                vit_state_dict_from_flax)

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
from matplotlib.axes import Axes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
IMG, PATCH = 32, 8
MODEL = {"num_blocks": 2, "in_channels": 3, "embed_dim": 64, "patch_size": PATCH,
         "num_heads": 2, "mlp_dim": 128, "num_classes": 10, "dropout": 0.1,
         "compute_dtype": "float32", "mask_ratio": 0.5}
HEAT_TOL = 1e-5  # heat maps and images in [0, 1], fp32 both sides
RESIZE_REL_TOL = 1e-6  # of max |cv2|: the same weights, sums in another order


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config(mode):
    return {"training": {"type": mode}, "data": {"img_size": IMG}, "model": dict(MODEL)}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_weights(config, seed):
    """JAX init, perturbed by N(0, 0.1) so that attention rows differ."""
    bundle = jax_build_model(jax_from_container(config))
    params = bundle.init_fn(jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    return bundle, params


@pytest.fixture
def png(tmp_path):
    """A 40 x 48 RGB PNG (resized to 32 px by both scripts)."""
    rng = np.random.default_rng(3)
    path = tmp_path / "photo.png"
    PIL_Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.fixture
def shown(monkeypatch):
    """Every array handed to ``Axes.imshow``, in order."""
    arrays, imshow = [], Axes.imshow

    def capture(self, x, *args, **kwargs):
        arrays.append(np.array(x, copy=True))
        return imshow(self, x, *args, **kwargs)

    monkeypatch.setattr(Axes, "imshow", capture)
    return arrays


def _port_model(config, state):
    model = build_model(from_container(config), "cpu")
    model.load_state_dict(state)
    return model.eval()


def test_attention_map_matches_jax(png, tmp_path, shown):
    config = _config("supervised")
    bundle, params = _jax_weights(config, 0)
    want_class, want_heat = _jax_script("attention_visualizer").visualize(
        bundle, params, jax_from_container(config), png, str(tmp_path / "jax.png"))
    want_image = shown[0]
    shown.clear()

    model = _port_model(config, vit_state_dict_from_flax(params))
    got_class, got_heat = attention_visualizer.visualize(
        model, from_container(config), png, str(tmp_path / "port.png"))
    assert (tmp_path / "port.png").exists()
    assert got_class == want_class
    assert got_heat.shape == (IMG, IMG) and got_heat.dtype == np.float32
    np.testing.assert_allclose(got_heat, want_heat, atol=HEAT_TOL, rtol=0)
    np.testing.assert_array_equal(shown[0], want_image)
    np.testing.assert_array_equal(shown[2], got_heat)  # the overlay is the heat map


def test_attention_cli_reads_a_port_run_directory(png, tmp_path):
    config = _config("supervised")
    _, params = _jax_weights(config, 1)
    state = vit_state_dict_from_flax(params)
    ckpt = str(tmp_path / "run" / "best_model")
    save_checkpoint(ckpt, {"model": state}, {"config": to_container(from_container(config)),
                                             "epoch": 1})
    want = attention_visualizer.attention_arrays(
        _port_model(config, state), from_container(config), png)
    got_class, got_heat = attention_visualizer.main(
        ["--checkpoint", ckpt, "--image", png, "--output", str(tmp_path / "a.png"),
         "--device", "cpu"])
    assert got_class == want[1]
    np.testing.assert_array_equal(got_heat, want[2])


def test_simmim_reconstruction_matches_jax(png, tmp_path, shown):
    config = _config("simmim")
    bundle, params = _jax_weights(config, 2)
    outputs = []

    class Recording:
        """JAX's module, keeping what ``apply`` returns."""

        def apply(self, *args, **kwargs):
            outputs.append(bundle.module.apply(*args, **kwargs))
            return outputs[-1]

    recording = type("Bundle", (), {"module": Recording()})()
    _jax_script("simmim_visualizer").visualize_simmim_reconstruction(
        recording, params, jax_from_container(config), png, str(tmp_path / "jax.png"),
        seed=5)
    want = shown[:3]
    mask = torch.from_numpy(np.array(outputs[0][2]))
    assert mask.shape == (1, (IMG // PATCH) ** 2) and 0 < int(mask.sum()) < mask.numel()

    model = _port_model(config, simmim_state_dict_from_flax(params))
    got = simmim_visualizer.visualize_simmim_reconstruction(
        model, from_container(config), png, str(tmp_path / "port.png"), mask=mask)
    assert (tmp_path / "port.png").exists()
    np.testing.assert_array_equal(got[0], want[0])
    for image, ref in zip(got[1:], want[1:]):
        assert image.shape == (IMG, IMG, 3)
        np.testing.assert_allclose(np.clip(image, 0, 1), ref, atol=HEAT_TOL, rtol=0)
    # the masked patches: mid-grey in one image, the predictions in the other
    grey = np.isclose(got[1], 0.5).all(axis=-1)
    assert grey.mean() == pytest.approx(float(mask.float().mean()), abs=0.05)
    assert not np.allclose(got[2], got[0])


def test_simmim_mask_comes_from_the_seed(png, tmp_path):
    config = _config("simmim")
    _, params = _jax_weights(config, 3)
    model = _port_model(config, simmim_state_dict_from_flax(params))
    cfg = from_container(config)
    first = simmim_visualizer.reconstruction_arrays(model, cfg, png, seed=7)
    again = simmim_visualizer.reconstruction_arrays(model, cfg, png, seed=7)
    other = simmim_visualizer.reconstruction_arrays(model, cfg, png, seed=8)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[1], other[1])
    masked = np.isclose(first[1], 0.5).all(axis=-1).reshape(
        IMG // PATCH, PATCH, IMG // PATCH, PATCH).all(axis=(1, 3))
    assert int(masked.sum()) == int((IMG // PATCH) ** 2 * MODEL["mask_ratio"])


@pytest.mark.parametrize("src,dst", [((14, 14), (224, 224)), ((12, 12), (192, 192)),
                                     ((4, 4), (32, 32)), ((4, 6, 3), (32, 19))])
def test_cubic_resize_matches_cv2(src, dst):
    """The visualizers' upsampling, against cv2 as installed."""
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_CUBIC)
    got = image_ops.resize(x, *dst, "cubic")
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RESIZE_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("src,dst", [((30, 40), (13, 17)), ((7, 5, 3), (30, 11)),
                                     ((9, 9), (9, 20)), ((1, 6), (5, 3)), ((16, 16), (16, 16))])
def test_cubic_resize_matches_cv2_c_path(src, dst):
    """Shrinks and mixed axes against OpenCV's C++ path (IPP off; IPP's
    float cubic shrink sums in another form, about 2e-6 of max apart)."""
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(ipp)
    got = image_ops.resize(x, *dst, "cubic")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RESIZE_REL_TOL * np.abs(want).max()


def test_cubic_resize_refuses_uint8():
    with pytest.raises(TypeError, match="float32 or float64"):
        image_ops.resize(np.zeros((4, 4), np.uint8), 8, 8, "cubic")


def test_without_matplotlib_each_script_warns_once(png, tmp_path, monkeypatch, caplog):
    sup, sim = _config("supervised"), _config("simmim")
    vit = _port_model(sup, vit_state_dict_from_flax(_jax_weights(sup, 4)[1]))
    simmim = _port_model(sim, simmim_state_dict_from_flax(_jax_weights(sim, 5)[1]))
    want_attention = attention_visualizer.attention_arrays(vit, from_container(sup), png)
    want_simmim = simmim_visualizer.reconstruction_arrays(simmim, from_container(sim), png)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for script, call, want in (
            (attention_visualizer, lambda out: attention_visualizer.visualize(
                vit, from_container(sup), png, out), want_attention[1:]),
            (simmim_visualizer, lambda out: simmim_visualizer.visualize_simmim_reconstruction(
                simmim, from_container(sim), png, out), want_simmim)):
        caplog.clear()
        out = str(tmp_path / f"{script.__name__}.png")
        with caplog.at_level(logging.WARNING):
            got = call(out)
        warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
        assert len(warnings) == 1 and "matplotlib" in warnings[0] and out in warnings[0]
        assert not Path(out).exists()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_chip_smoke_batch1_shapes_are_the_configs():
    """The card's visualizer phase holds B1 at the batch-1 shapes that the
    composed configs give (CLS and 14² patches at ViT-B/16's 224 px; 12²
    patches at SimMIM's 192 px), in its kernel checks too."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for case, name, cls in ((smoke.VIT_B_B1_ONE, "vit_b_imagenet", 1),
                            (smoke.SIMMIM_B1_ONE, "simmim", 0)):
        config = to_container(compose(REPO / "configs", name))
        model, img = config["model"], config["data"]["img_size"]
        tokens = (img // model["patch_size"]) ** 2 + cls
        width = model["embed_dim"] // model["num_heads"]
        assert case == (1, tokens, model["num_heads"], width, model["compute_dtype"], 0)
        assert case in smoke.ATTENTION_CASES
