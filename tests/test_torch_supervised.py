"""The port's supervised training step against the JAX package's, on the CPU.

``make_supervised_steps`` of both packages runs from the same ViT weights
(2 blocks, embed 64, image 32, patch 8; carried by the port's bridge) on
the same host float images, at dropout 0, so no random stream enters; a
padded row has weight 0. Once on each side's default route (B1 and JAX's
XLA path at this size), once with kernel B3 and once with kernel B2 forced
on both sides (JAX's in interpret mode, forward and custom-VJP backward;
the port's plain versions, which its CPU wrapper runs). Also here: the single-view device
augmentation against JAX's, ``eval_step`` and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_ssl_tpu.ops.attention as jax_attention_mod
from vit_ssl_tpu.data import device_augment as jax_aug
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.train import schedules as jax_schedules
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_supervised_steps as jax_make_supervised_steps
from vit_ssl_tpu.utils.checkpoint import vit_params_to_torch
from vit_ssl_tpu_torch.data.device_augment import make_batch_augment_fn
from vit_ssl_tpu_torch.data import device_augment as aug
from vit_ssl_tpu_torch.models import ViT
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.train import (
    AdamW,
    SupervisedTrainState,
    cross_entropy_loss,
    make_supervised_steps,
    reference_lr_schedule,
)
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

B = 4
WEIGHT = np.array([1, 1, 1, 0], np.float32)  # a padded row, as the loader pads
LR = dict(start_lr=1e-4, target_lr=1e-3, eta_min=1e-5, warmup_epochs=1,
          num_epochs=4, steps_per_epoch=2)
WEIGHT_DECAY = 1e-3
SMALL = dict(num_classes=10, num_blocks=2, input_shape=(3, 32, 32), embed_dim=64,
             patch_size=8, num_heads=4, mlp_dim=128, dropout=0.0)
# The supervised train pipeline (configs/supervised/train_transforms.yaml)
TRAIN_TRANSFORMS = [
    {"name": "RandomResizedCrop", "params": {"size": 16, "scale": [0.9, 1.0]}},
    {"name": "RandomHorizontalFlip", "params": {}},
    {"name": "ToTensor"},
]


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _batches():
    rng = np.random.default_rng(30)
    return [{"image": rng.random((B, 32, 32, 3), np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32),
             "weight": WEIGHT} for _ in range(3)]


def _weights():
    module = JaxViT(**SMALL)
    return _jiggle(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
                   ["params"], 1)


def _force(patch, route):
    """Send every block down kernel B3 or B2 on both sides (at N = 17 both
    packages pick B1/XLA on their own): JAX's predicates in its attention
    module; the port's B1 feasibility, and for B2 its length ceiling."""
    if route == "default":
        return
    patch.setattr(jax_attention_mod, "attention_nhd_profitable", lambda *a, **kw: False)
    patch.setattr(fa, "attention_nhd_feasible", lambda *a, **kw: False)
    if route == "b3":
        patch.setattr(jax_attention_mod, "fused_attention_profitable",
                      lambda *a, **kw: True)
    else:
        patch.setattr(jax_attention_mod, "flash_attention_available",
                      lambda *a, **kw: False)
        patch.setattr(fa, "MAX_SEQ", 16)


@pytest.fixture(scope="module", params=["default", "b3", "b2"],
                ids=["default", "b3", "b2"])
def jax_run(request):
    """JAX's losses, preds and parameters after each of 3 steps."""
    patch = pytest.MonkeyPatch()
    _force(patch, request.param)
    try:
        tx = optax.adamw(jax_schedules.reference_lr_schedule(**LR),
                         weight_decay=WEIGHT_DECAY)
        state = create_train_state(_weights(), tx, jax.random.PRNGKey(1))
        step, _ = jax_make_supervised_steps(JaxViT(**SMALL), tx, donate=False)
        runs = []
        for batch in _batches():
            state, out = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            runs.append((float(out["loss"]), np.asarray(out["preds"]),
                         {k: np.asarray(v, np.float32)
                          for k, v in vit_params_to_torch(state.params).items()}))
    finally:
        patch.undo()
    return request.param, runs


def _port_run(route, steps, monkeypatch):
    _force(monkeypatch, route)
    calls = []
    kernel = "blockwise_attention" if route == "b2" else "fused_attention"
    real = getattr(attention_mod, kernel)
    monkeypatch.setattr(attention_mod, kernel,
                        lambda *a: calls.append(a[0].shape) or real(*a))
    model = ViT(**SMALL)
    model.load_state_dict(vit_state_dict_from_flax(_weights()), strict=True)
    optimizer = AdamW(reference_lr_schedule(**LR), weight_decay=WEIGHT_DECAY)
    state = SupervisedTrainState(model, optimizer, seed=0)
    train_step, _ = make_supervised_steps(optimizer)
    outs = []
    for batch in _batches()[:steps]:
        outs.append(train_step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}))
    assert state.step == steps
    assert len(calls) == (0 if route == "default" else SMALL["num_blocks"] * steps)
    return state, outs


@pytest.mark.parametrize("steps", [1, 3])
def test_supervised_step_matches_jax(jax_run, steps, monkeypatch):
    """Loss at rtol 1e-5, preds equal, labels and weight passed through.
    Parameters as in tests/test_torch_train.py: Adam divides each gradient
    entry by its own RMS, so an entry whose fp32 sums land on opposite
    sides of zero may differ by up to 2·lr a step; every entry is held
    within 2·Σlr + 1e-5 and 99.5 % of them within 1e-5 + 1e-4·|p|."""
    route, runs = jax_run
    state, outs = _port_run(route, steps, monkeypatch)
    batches = _batches()
    for i, out in enumerate(outs):
        loss, preds, _ = runs[i]
        np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-5)
        np.testing.assert_array_equal(out["preds"].numpy(), preds)
        np.testing.assert_array_equal(out["labels"].numpy(), batches[i]["label"])
        assert float(out["weight_sum"]) == 3.0
    want = runs[steps - 1][2]
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    assert set(got) == set(want)
    schedule = reference_lr_schedule(**LR)
    bound = 2 * sum(schedule(i) for i in range(steps)) + 1e-5
    for key in sorted(want):
        diff = np.abs(got[key] - want[key].reshape(got[key].shape))
        assert diff.max() <= bound, (key, diff.max(), bound)
        close = diff <= 1e-5 + 1e-4 * np.abs(want[key].reshape(diff.shape))
        assert close.mean() >= 0.995, (key, close.mean())


def test_eval_step_matches_jax():
    """Eval mode, uint8 images scaled to [0, 1] on both sides: loss at rtol
    1e-5 and preds."""
    params = _weights()
    tx = optax.adamw(1e-3)
    _, jax_eval = jax_make_supervised_steps(JaxViT(**SMALL), tx, donate=False)
    rng = np.random.default_rng(31)
    batch = {"image": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, B).astype(np.int32), "weight": WEIGHT}
    want = jax_eval(create_train_state(params, tx, jax.random.PRNGKey(0)),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    model = ViT(**{**SMALL, "dropout": 0.1})  # eval runs without dropout
    model.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    optimizer = AdamW(lambda step: 1e-3)
    _, eval_step = make_supervised_steps(optimizer)
    got = eval_step(SupervisedTrainState(model, optimizer, 0),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))


def test_cross_entropy_loss_is_weighted():
    logits = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 3, 6, 2, 2])
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0])
    want = torch.nn.functional.cross_entropy(logits[w > 0], labels[w > 0])
    torch.testing.assert_close(cross_entropy_loss(logits, labels, w), want)
    assert float(cross_entropy_loss(logits, labels, torch.zeros(5))) == 0.0


def test_train_step_with_dropout_and_device_augmentation():
    """Dropout on, views from the device pipeline over uint8 images: finite
    loss, every parameter moves, the same step from the same state and
    seed repeats bit for bit, and the next step draws other masks."""
    def run():
        model = ViT(**{**SMALL, "dropout": 0.1}).reset_parameters(
            torch.Generator().manual_seed(0))
        optimizer = AdamW(lambda step: 1e-3, weight_decay=1e-3)
        state = SupervisedTrainState(model, optimizer, seed=5)
        train_step, _ = make_supervised_steps(
            optimizer, augment_fn=make_batch_augment_fn(
                [{**TRAIN_TRANSFORMS[0], "params": {"size": 32, "scale": [0.9, 1.0]}},
                 *TRAIN_TRANSFORMS[1:]]))
        images = torch.from_numpy(np.random.default_rng(32).integers(
            0, 256, (B, 40, 40, 3), dtype=np.uint8))
        batch = {"image": images, "label": torch.tensor([1, 2, 3, 4]),
                 "weight": torch.ones(B)}
        before = {k: v.clone() for k, v in model.state_dict().items()}
        out = train_step(state, batch, with_grads=True)
        return state, before, out, train_step, batch

    state, before, out, train_step, batch = run()
    assert torch.isfinite(out["loss"]) and set(out["grads"]) == set(before)
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    again = run()[2]
    assert torch.equal(again["loss"], out["loss"])
    assert not torch.equal(train_step(state, batch)["loss"], out["loss"])


def test_grad_accum_not_ported():
    """Ported since: ``grad_accum=2`` (two microbatches of the padded batch)
    gives the full batch's loss and gradients to rtol 1e-5 (a floor of 1e-6
    of each tensor's largest entry) and the same predictions; a batch it
    does not divide raises ``ValueError``."""
    rng = np.random.default_rng(40)
    batch = {"image": torch.from_numpy(rng.random((B, 32, 32, 3), np.float32)),
             "label": torch.tensor([1, 2, 3, 4]), "weight": torch.from_numpy(WEIGHT)}
    outs = {}
    for accum in (1, 2, 3):
        model = ViT(**SMALL).reset_parameters(torch.Generator().manual_seed(0))
        optimizer = AdamW(lambda step: 1e-3)
        train_step, _ = make_supervised_steps(optimizer, grad_accum=accum)
        state = SupervisedTrainState(model, optimizer, 0)
        if accum == 3:
            with pytest.raises(ValueError, match="must divide"):
                train_step(state, batch)
            continue
        outs[accum] = train_step(state, batch, with_grads=True)
    got, want = outs[2], outs[1]
    assert torch.equal(got["preds"], want["preds"])
    for g, w in [(got["loss"], want["loss"])] + [
            (g, want["grads"][name]) for name, g in got["grads"].items()]:
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# make_batch_augment_fn: the supervised train pipeline on the device


def test_batch_augment_matches_jax_with_its_draws():
    """JAX's ``make_batch_augment_fn`` on uint8 images against the port's
    ops given JAX's own draws (crop box and flip of each sample, split from
    its key exactly as JAX splits them): atol 1e-5."""
    b, h, w = 8, 24, 20
    images = np.random.default_rng(33).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    rng = jax.random.PRNGKey(34)
    want = np.asarray(jax_aug.make_batch_augment_fn(TRAIN_TRANSFORMS)(
        rng, jnp.asarray(images)))
    scale, ratio = (0.9, 1.0), (3 / 4, 4 / 3)

    def draws(key):  # the per-sample draws of random_resized_crop, random_hflip
        k_crop, k_flip = jax.random.split(key, 2)
        k_area, k_ratio, k_top, k_left = jax.random.split(k_crop, 4)
        area = h * w * jax.random.uniform(k_area, minval=scale[0], maxval=scale[1])
        aspect = jnp.exp(jax.random.uniform(k_ratio, minval=jnp.log(ratio[0]),
                                            maxval=jnp.log(ratio[1])))
        cw = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, w)
        ch = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, h)
        return (jax.random.uniform(k_top) * (h - ch), jax.random.uniform(k_left) * (w - cw),
                ch, cw, jax.random.uniform(k_flip) < 0.5)

    top, left, ch, cw, flip = (torch.from_numpy(np.array(a)) for a in
                               jax.vmap(draws)(jax.random.split(rng, b)))
    assert 0 < int(flip.sum()) < b  # both branches of the flip are held
    x = aug.to_unit_float(torch.from_numpy(images))
    x = aug.RandomResizedCrop(16, scale, ratio).apply(
        x, {"top": top.float(), "left": left.float(), "height": ch.float(),
            "width": cw.float()})
    got = aug.RandomHorizontalFlip().apply(x, {"flip": flip})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_batch_augment_shapes_range_and_generator():
    images = torch.from_numpy(np.random.default_rng(35).integers(
        0, 256, (64, 24, 20, 3), dtype=np.uint8))
    fn = make_batch_augment_fn(TRAIN_TRANSFORMS)
    out = fn(torch.Generator().manual_seed(0), images)
    assert out.shape == (64, 16, 16, 3) and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert torch.equal(out, fn(torch.Generator().manual_seed(0), images))
    assert not torch.equal(out, fn(torch.Generator().manual_seed(1), images))
    # the same draws through the ops by hand: crop, then flip
    g = torch.Generator().manual_seed(0)
    crop, flip = aug.RandomResizedCrop(16, (0.9, 1.0)), aug.RandomHorizontalFlip()
    x = aug.to_unit_float(images)
    x = crop.apply(x, crop.draw(g, 64, 24, 20))
    p = flip.draw(g, 64, 16, 16)
    assert 0 < int(p["flip"].sum()) < 64
    assert torch.equal(out, flip.apply(x, p))
