"""Gradient accumulation in the port's three steps, and Bernoulli dropout.

- Each step (supervised, SimMIM, DINO) at ``grad_accum`` 2 and 4 against the
  same port step at 1 from one cloned state, dropout 0 (SimMIM at
  ``mask_ratio`` 1, so the mask is every patch in both): loss, every
  gradient and the step's other outputs at rtol 1e-5 (an absolute floor of
  1e-6 of the tensor's largest entry: fp32 sums in another order).
- A padded row (weight 0) changes nothing, bit for bit, whatever its image.
- A batch that ``grad_accum`` does not divide raises ``ValueError``, as the
  JAX package's supervised and DINO steps do.
- The port's accumulated steps against the JAX package's accumulated steps
  at ``grad_accum`` 2 from the same weights (dropout 0, host images or
  views, SimMIM at ``mask_ratio`` 1; SGD at lr 1, so the updated parameters
  carry the gradient): rtol 1e-5, atol 1e-6 (SSIM's sum over patches of
  either sign: 1e-6 a patch).
- Bernoulli dropout (``fast_dropout=false``): the keep rate within 4σ of
  1 − rate, kept values scaled by 1/(1 − rate), the identity when
  deterministic; the fused FFN draws the same Bernoulli mask as the unfused
  one from one generator state.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.models.simmim import SimMIMViT as JaxSimMIMViT
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_dino_steps as jax_make_dino_steps
from vit_ssl_tpu.train.steps import make_simmim_steps as jax_make_simmim_steps
from vit_ssl_tpu.train.steps import make_supervised_steps as jax_make_supervised_steps
from vit_ssl_tpu.utils.checkpoint import (dino_params_to_torch, simmim_params_to_torch,
                                          vit_params_to_torch)
from vit_ssl_tpu_torch.models import DINONetwork, SimMIMViT, ViT
from vit_ssl_tpu_torch.ops import (Dropout, FeedForwardBlock, dropout_bernoulli,
                                   keep_mask_bernoulli)
from vit_ssl_tpu_torch.train import (SGD, SupervisedTrainState, TrainState,
                                     make_dino_steps, make_simmim_steps,
                                     make_supervised_steps)
from vit_ssl_tpu_torch.utils.checkpoint import (dino_state_dict_from_flax,
                                                simmim_state_dict_from_flax,
                                                vit_state_dict_from_flax)

B, IMG = 8, 16
NET = dict(num_blocks=2, input_shape=(3, IMG, IMG), embed_dim=32, patch_size=8,
           num_heads=2, mlp_dim=64, dropout=0.0)
WEIGHT = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)  # a padded row
RTOL, FLOOR = 1e-5, 1e-6
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
TEMPS = (0.04, 0.996)  # teacher temperature, teacher momentum


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32), params)


def _init(module, rngs):
    """The module's parameters, drawn by one jitted program."""
    return jax.jit(lambda r: module.init(r, jnp.zeros((1, IMG, IMG, 3)))["params"])(rngs)


def _close(got, want, what):
    """rtol RTOL with an absolute floor of FLOOR · max|want|."""
    want = want.detach().float()
    atol = FLOOR * float(want.abs().max().clamp_min(1e-30))
    torch.testing.assert_close(got.detach().float(), want, rtol=RTOL, atol=atol,
                               msg=lambda m: f"{what}: {m}")


# ---------------------------------------------------------------------------
# the three modes, each as (JAX module, port model, state, steps, batch)


def _images(seed, b=B):
    return np.random.default_rng(seed).random((b, IMG, IMG, 3), np.float32)


def _views(seed, b=B):
    rng = np.random.default_rng(seed)
    return ([rng.random((b, IMG, IMG, 3), np.float32) for _ in range(2)]
            + [rng.random((b, 8, 8, 3), np.float32) for _ in range(4)])


def _supervised():
    module = JaxViT(num_classes=5, **NET)
    params = _jiggle(_init(module, jax.random.PRNGKey(0)), 1)
    model = ViT(num_classes=5, **NET)
    model.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    batch = {"image": _images(2), "weight": WEIGHT,
             "label": np.random.default_rng(3).integers(0, 5, B).astype(np.int32)}
    return module, params, model, batch


def _simmim():
    module = JaxSimMIMViT(mask_ratio=1.0, **NET)
    params = _jiggle(_init(module, {"params": jax.random.PRNGKey(0),
                                    "mask": jax.random.PRNGKey(1)}), 1)
    model = SimMIMViT(mask_ratio=1.0, **NET)
    model.load_state_dict(simmim_state_dict_from_flax(params), strict=True)
    return module, params, model, {"image": _images(4), "weight": WEIGHT}


def _dino():
    module = JaxDINONetwork(output_dim=16, **NET)
    params = _jiggle(_init(module, jax.random.PRNGKey(0)), 1)
    teacher = _jiggle(params, 2)
    center = np.random.default_rng(3).standard_normal((1, 16)).astype(np.float32)
    return module, (params, teacher, center), None, {"views": _views(5),
                                                      "weight": WEIGHT}


def _port_state(mode, parts, optimizer):
    if mode == "dino":
        student, teacher, center = parts[1]
        sd = dino_state_dict_from_flax(student, teacher, center)
        net = DINONetwork(output_dim=16, **NET)
        state = TrainState(net, optimizer, seed=0, teacher=DINONetwork(output_dim=16, **NET),
                           center=torch.zeros(1, 16))
        state.load_model_state_dict(sd)
        return state
    return SupervisedTrainState(copy.deepcopy(parts[2]), optimizer, seed=0)


def _port_step(mode, optimizer, grad_accum):
    if mode == "supervised":
        step = make_supervised_steps(optimizer, grad_accum=grad_accum)[0]
        return lambda state, batch, **kw: step(state, batch, **kw)
    if mode == "simmim":
        step = make_simmim_steps(optimizer, 8, 3, "l1", grad_accum=grad_accum)[0]
        return lambda state, batch, **kw: step(state, batch, **kw)
    step = make_dino_steps(optimizer, 2, 6, 0.1, 0.9, teacher_dropout=False,
                           grad_accum=grad_accum, pack_locals=True)[0]
    return lambda state, batch, **kw: step(state, batch, *TEMPS, **kw)


def _torch_batch(batch):
    out = {}
    for key, value in batch.items():
        out[key] = ([torch.from_numpy(v) for v in value] if isinstance(value, list)
                    else torch.from_numpy(value))
    return out


BUILD = {"supervised": _supervised, "simmim": _simmim, "dino": _dino}
MODES = list(BUILD)


@pytest.fixture(scope="module")
def built():
    return {mode: BUILD[mode]() for mode in MODES}


def _run(mode, parts, grad_accum, batch=None):
    optimizer = SGD(lambda count: 1.0)
    state = _port_state(mode, parts, optimizer)
    out = _port_step(mode, optimizer, grad_accum)(
        state, _torch_batch(parts[3] if batch is None else batch), with_grads=True)
    return state, out


# ---------------------------------------------------------------------------
# accumulated against the full batch, in the port


@pytest.mark.parametrize("grad_accum", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_accumulated_step_equals_the_full_batch(built, mode, grad_accum):
    full_state, full = _run(mode, built[mode], 1)
    acc_state, acc = _run(mode, built[mode], grad_accum)
    _close(acc["loss"], full["loss"], "loss")
    assert set(acc["grads"]) == set(full["grads"])
    for name, g in acc["grads"].items():
        _close(g, full["grads"][name], name)
    if mode == "supervised":
        assert torch.equal(acc["preds"], full["preds"])
    if mode == "simmim":
        for key in ("psnr_sse", "psnr_count", "ssim_sum", "ssim_count"):
            _close(acc[key], full[key], key)
    if mode == "dino":
        _close(acc_state.center, full_state.center, "center")
        for key, value in acc["dino_stats"].items():
            _close(value, full["dino_stats"][key], key)
    assert acc_state.step == full_state.step == 1


@pytest.mark.parametrize("mode", MODES)
def test_padded_row_changes_nothing(built, mode):
    """The weight-0 row's image replaced: the same loss and gradients, bit for
    bit, at grad_accum 2."""
    batch = copy.deepcopy(built[mode][3])
    key = "views" if mode == "dino" else "image"
    for x in (batch[key] if mode == "dino" else [batch[key]]):
        x[-1] = np.random.default_rng(9).random(x[-1].shape, np.float32)
    _, want = _run(mode, built[mode], 2)
    _, got = _run(mode, built[mode], 2, batch)
    assert torch.equal(got["loss"], want["loss"])
    for name, g in got["grads"].items():
        assert torch.equal(g, want["grads"][name]), name


def test_indivisible_batch_raises_as_jax(built):
    optimizer = SGD(lambda count: 1.0)
    for mode in MODES:
        with pytest.raises(ValueError, match="must divide training.grad_accum_steps"):
            _run(mode, built[mode], 3)
    module, params = built["supervised"][:2]
    tx = optax.sgd(1.0)
    step = jax_make_supervised_steps(module, tx, donate=False, grad_accum=3)[0]
    with pytest.raises(ValueError, match="must divide training.grad_accum_steps"):
        step(create_train_state(params, tx, jax.random.PRNGKey(0)),
             {k: jnp.asarray(v) for k, v in built["supervised"][3].items()})
    module, (student, teacher, center) = built["dino"][:2]
    step = jax_make_dino_steps(module, tx, 2, 6, 0.1, 0.9, donate=False,
                               teacher_dropout=False, grad_accum=3, pack_locals=True)[0]
    batch = built["dino"][3]
    with pytest.raises(ValueError, match="must divide training.grad_accum_steps"):
        step(create_train_state(student, tx, jax.random.PRNGKey(0), teacher_params=teacher,
                                center=jnp.asarray(center)),
             {"views": [jnp.asarray(v) for v in batch["views"]],
              "weight": jnp.asarray(batch["weight"])}, *TEMPS)
    assert optimizer.lr_schedule(0) == 1.0


# ---------------------------------------------------------------------------
# accumulated against the JAX package's accumulated steps


@pytest.mark.parametrize("mode", MODES)
def test_accumulated_step_matches_jax(built, mode):
    module, params, _, batch = built[mode]
    tx = optax.sgd(1.0)
    if mode == "dino":
        student, teacher, center = params
        state = create_train_state(student, tx, jax.random.PRNGKey(0),
                                   teacher_params=teacher, center=jnp.asarray(center))
        step = jax_make_dino_steps(module, tx, 2, 6, 0.1, 0.9, donate=False,
                                   teacher_dropout=False, grad_accum=2,
                                   pack_locals=True)[0]
        new, want = step(state, {"views": [jnp.asarray(v) for v in batch["views"]],
                                 "weight": jnp.asarray(batch["weight"])}, *TEMPS)
        want_sd = dino_params_to_torch(new.params, new.teacher_params, new.center)
    else:
        state = create_train_state(params, tx, jax.random.PRNGKey(0))
        make = (jax_make_supervised_steps if mode == "supervised" else
                lambda m, t, **kw: jax_make_simmim_steps(m, t, 8, 3, "l1", **kw))
        step = make(module, tx, donate=False, grad_accum=2)[0]
        new, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want_sd = (vit_params_to_torch if mode == "supervised"
                   else simmim_params_to_torch)(new.params)
    got_state, got = _run(mode, built[mode], 2)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **JAX_TOL)
    got_sd = (got_state.model_state_dict() if mode == "dino"
              else got_state.model.state_dict())
    assert set(got_sd) == set(want_sd)
    for key, value in want_sd.items():
        np.testing.assert_allclose(got_sd[key].detach().numpy().reshape(np.shape(value)),
                                   np.asarray(value), **JAX_TOL, err_msg=key)
    if mode == "supervised":
        np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))
    if mode == "simmim":
        for key in ("psnr_sse", "psnr_count", "ssim_count"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), **JAX_TOL,
                                       err_msg=key)
        # a sum of per-patch SSIMs of either sign: 1e-6 a patch
        np.testing.assert_allclose(float(got["ssim_sum"]), float(want["ssim_sum"]),
                                   rtol=1e-5, atol=1e-6 * float(want["ssim_count"]))


# ---------------------------------------------------------------------------
# Bernoulli dropout


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_bernoulli_keep_rate_within_four_sigma(rate):
    n = 1 << 20
    keep = keep_mask_bernoulli((n,), rate, torch.Generator().manual_seed(1))
    p = 1.0 - rate
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(float(keep.float().mean()) - p) <= 4 * sigma


def test_bernoulli_scales_kept_values_and_is_identity_when_deterministic():
    x = torch.rand(4096, generator=torch.Generator().manual_seed(2)).bfloat16() + 1
    y = dropout_bernoulli(x, 0.1, torch.Generator().manual_seed(3))
    kept = y != 0
    assert y.dtype == torch.bfloat16 and 0 < int(kept.sum()) < x.numel()
    assert torch.equal(y[kept], (x / 0.9)[kept])
    assert torch.equal(y, dropout_bernoulli(x, 0.1, torch.Generator().manual_seed(3)))
    drop = Dropout(0.1, fast=False)
    assert torch.equal(drop(x, True), x)
    assert torch.equal(drop(x, False, torch.Generator().manual_seed(3)), y)
    assert torch.equal(dropout_bernoulli(x, 0.0, None), x)


def test_fused_ffn_draws_the_bernoulli_mask_of_the_unfused_ffn():
    torch.manual_seed(0)
    unfused = FeedForwardBlock(32, 64, dropout=0.3, fast_dropout=False)
    fused = FeedForwardBlock(32, 64, dropout=0.3, fast_dropout=False, use_fused=True)
    fused.load_state_dict(unfused.state_dict(), strict=True)
    x = torch.randn(2, 9, 32)
    with torch.no_grad():
        want = unfused(x, False, torch.Generator().manual_seed(5))
        got = fused(x, False, torch.Generator().manual_seed(5))
        fast = FeedForwardBlock(32, 64, dropout=0.3, use_fused=True)
        fast.load_state_dict(unfused.state_dict(), strict=True)
        other = fast(x, False, torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(other, want, atol=1e-3)  # dropout16's mask differs
