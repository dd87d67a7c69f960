"""The port's device augmentation against ``vit_ssl_tpu/data/device_augment.py``.

The two packages draw from different random streams by design, so each test
reproduces JAX's draws with ``jax.random`` from the op's own key, exactly as
the JAX op splits it, and hands them to the port's ``apply``; both then run
on the same numpy images. fp32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.data import device_augment as jax_aug
from vit_ssl_tpu_torch.data import device_augment as aug

TOL = dict(atol=1e-5, rtol=0)
B = 6


def _images(h=24, w=20, seed=0):
    return np.random.default_rng(seed).random((B, h, w, 3), np.float32)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _jax_batch(fn, keys, imgs, **kw):
    return np.asarray(jax.vmap(lambda k, x: fn(k, x, **kw))(keys, jnp.asarray(imgs)))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_hsv_round_trip_matches_jax():
    x = _images(seed=1)
    x[0, :4] = x[0, :4, :, :1]  # gray pixels: zero saturation, hue 0
    hsv = aug.rgb_to_hsv(torch.from_numpy(x))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax_aug.rgb_to_hsv(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(aug.hsv_to_rgb(hsv).numpy(),
                               np.asarray(jax_aug.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
                               **TOL)


@pytest.mark.parametrize("size,scale", [(12, (0.5, 1.0)), (8, (0.08, 0.4)), (30, (0.9, 1.0))],
                         ids=["global", "local", "upsample"])
def test_random_resized_crop_matches_jax(size, scale):
    imgs, keys = _images(seed=2), _keys(3)
    want = _jax_batch(jax_aug.random_resized_crop, keys, imgs, out_size=size,
                      scale=scale)
    h, w = imgs.shape[1:3]
    ratio = (3 / 4, 4 / 3)

    def box(key):  # JAX's draws, as random_resized_crop makes them
        k_area, k_ratio, k_top, k_left = jax.random.split(key, 4)
        area = h * w * jax.random.uniform(k_area, minval=scale[0], maxval=scale[1])
        aspect = jnp.exp(jax.random.uniform(k_ratio, minval=jnp.log(ratio[0]),
                                            maxval=jnp.log(ratio[1])))
        cw = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, w)
        ch = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, h)
        return (jax.random.uniform(k_top) * (h - ch),
                jax.random.uniform(k_left) * (w - cw), ch, cw)

    top, left, ch, cw = (_t(a) for a in jax.vmap(box)(keys))
    op = aug.RandomResizedCrop(size, scale, ratio)
    got = op.apply(torch.from_numpy(imgs),
                   {"top": top, "left": left, "height": ch, "width": cw})
    assert got.shape == (B, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_random_resized_crop_draws_a_clamped_box():
    op = aug.RandomResizedCrop(8, (0.08, 0.4))
    p = op.draw(torch.Generator().manual_seed(0), 1000, 24, 20)
    assert (p["height"] >= 1).all() and (p["height"] <= 24).all()
    assert (p["width"] >= 1).all() and (p["width"] <= 20).all()
    assert (p["top"] >= 0).all() and (p["top"] + p["height"] <= 24 + 1e-4).all()
    assert (p["left"] >= 0).all() and (p["left"] + p["width"] <= 20 + 1e-4).all()
    area = p["height"] * p["width"] / (24 * 20)
    assert 0.05 < float(area.mean()) < 0.4


def test_flip_matches_jax():
    imgs, keys = _images(seed=4), _keys(5)
    want = _jax_batch(jax_aug.random_hflip, keys, imgs)
    flip = jax.vmap(lambda k: jax.random.uniform(k) < 0.5)(keys)
    got = aug.RandomHorizontalFlip().apply(torch.from_numpy(imgs),
                                           {"flip": torch.from_numpy(np.array(flip))})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert 0 < int(np.asarray(flip).sum()) < B  # both branches ran


def test_color_jitter_matches_jax():
    imgs, keys = _images(seed=6), _keys(7)
    kw = dict(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1)
    want = _jax_batch(jax_aug.color_jitter, keys, imgs, **kw)

    def factors(key):
        kb, kc, ks, kh = jax.random.split(key, 4)
        return (jax.random.uniform(kb, minval=0.6, maxval=1.4),
                jax.random.uniform(kc, minval=0.6, maxval=1.4),
                jax.random.uniform(ks, minval=0.8, maxval=1.2),
                jax.random.uniform(kh, minval=-0.1, maxval=0.1))

    fb, fc, fs, fh = (_t(a) for a in jax.vmap(factors)(keys))
    got = aug.ColorJitter(**kw).apply(
        torch.from_numpy(imgs),
        {"brightness": fb, "contrast": fc, "saturation": fs, "hue": fh})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_grayscale_matches_jax():
    imgs, keys = _images(seed=8), _keys(9)
    want = _jax_batch(jax_aug.random_grayscale, keys, imgs, p=0.5)
    gray = jax.vmap(lambda k: jax.random.uniform(k) < 0.5)(keys)
    got = aug.RandomGrayscale(0.5).apply(torch.from_numpy(imgs),
                                         {"gray": torch.from_numpy(np.array(gray))})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gaussian_blur_matches_jax():
    imgs, keys = _images(seed=10), _keys(11)
    want = _jax_batch(jax_aug.gaussian_blur, keys, imgs, kernel_size=7,
                      sigma=(0.1, 2.0))
    sigma = jax.vmap(lambda k: jax.random.uniform(k, minval=0.1, maxval=2.0))(keys)
    got = aug.GaussianBlur(7, (0.1, 2.0)).apply(torch.from_numpy(imgs),
                                                 {"sigma": _t(sigma)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_resize_and_normalize_match_jax():
    imgs = _images(seed=12)
    want = np.asarray(jax.vmap(lambda x: jax_aug.resize(x, 10))(jnp.asarray(imgs)))
    got = aug.Resize(10).apply(torch.from_numpy(imgs), {})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    norm = aug.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3])
    np.testing.assert_allclose(
        norm.apply(torch.from_numpy(imgs), {}).numpy(),
        (imgs - np.array([0.5, 0.4, 0.3])) / np.array([0.2, 0.25, 0.3]), **TOL)


def test_multicrop_from_the_dino_config():
    from vit_ssl_tpu.config import compose, to_container

    cfg = to_container(compose("configs", "dino", overrides=[
        "data.img_size=16", "data.local_img_size=8"]))
    fn = aug.make_multicrop_fn(cfg["transforms"]["globals"],
                               cfg["transforms"]["locals"], 2, 6)
    images = torch.from_numpy(
        np.random.default_rng(13).integers(0, 256, (B, 24, 24, 3), dtype=np.uint8))
    views = fn(torch.Generator().manual_seed(0), images)
    assert [tuple(v.shape) for v in views] == [(B, 16, 16, 3)] * 2 + [(B, 8, 8, 3)] * 4
    assert all(v.dtype == torch.float32 and float(v.min()) >= 0.0
               and float(v.max()) <= 1.0 for v in views)
    again = fn(torch.Generator().manual_seed(0), images)
    assert all(torch.equal(a, b) for a, b in zip(views, again))
    other = fn(torch.Generator().manual_seed(1), images)
    assert not torch.equal(views[0], other[0])


def test_unsupported_transform_raises():
    with pytest.raises(ValueError, match="Unsupported"):
        aug.build_device_pipeline([{"name": "RandomRotation"}])
