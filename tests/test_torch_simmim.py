"""The port's SimMIM pieces against the JAX package's, on the CPU.

- ``extract_patches`` / ``patches_to_image`` bit-equal to JAX's, and each
  other's inverse; ``ManualPatchEmbed`` on bridged weights.
- ``SimMIMViT`` (2 blocks, embed 32, 16 px, patch 4, fp32, dropout 0) on the
  weights ``simmim_state_dict_from_flax`` carries across: the masked forward
  with one injected numpy mask (outputs and every parameter's gradient of
  ``masked_l1_loss``) and ``inference_forward``; a JAX ``.pth`` export loads
  with ``strict=True`` and serves JAX's mean-pooled features.
- The mask rule: exactly k = int(N · ratio) masked a row, none at k = 0,
  all at ratio 1.
- ``psnr_stats`` / ``ssim_stats`` against JAX's, patches of 16, 4 and 2
  pixels (the window shrinks below 7).
- One ``make_simmim_steps`` train step and eval step of each criterion
  against JAX's (masks fixed to one table on both sides; SGD at lr 1, so the
  updated parameters carry the gradient).

Tolerances: rtol 1e-5 with an absolute floor of 1e-6 (fp32 sums in another
order); the patch shuffles are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_ssl_tpu.models.simmim as jax_simmim_mod
from vit_ssl_tpu.models.simmim import SimMIMViT as JaxSimMIMViT
from vit_ssl_tpu.models.simmim import masked_l1_loss as jax_masked_l1_loss
from vit_ssl_tpu.ops.patch_embedding import ManualPatchEmbed as JaxManualPatchEmbed
from vit_ssl_tpu.ops.patch_embedding import extract_patches as jax_extract_patches
from vit_ssl_tpu.ops.patch_embedding import patches_to_image as jax_patches_to_image
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_simmim_steps as jax_make_simmim_steps
from vit_ssl_tpu.utils import metrics as jax_metrics
from vit_ssl_tpu.utils.checkpoint import save_torch_checkpoint, simmim_params_to_torch
from vit_ssl_tpu_torch.models import SimMIMViT, make_random_mask, masked_l1_loss
from vit_ssl_tpu_torch.models import simmim as port_simmim_mod
from vit_ssl_tpu_torch.ops import ManualPatchEmbed, extract_patches, patches_to_image
from vit_ssl_tpu_torch.train import SGD, SupervisedTrainState, make_simmim_steps
from vit_ssl_tpu_torch.utils import metrics as port_metrics
from vit_ssl_tpu_torch.utils.checkpoint import load_pth, simmim_state_dict_from_flax

TOL = dict(rtol=1e-5, atol=1e-6)
IMG, PATCH, B = 16, 4, 3
N = (IMG // PATCH) ** 2
NET = dict(num_blocks=2, input_shape=(3, IMG, IMG), embed_dim=32, patch_size=PATCH,
           num_heads=2, mlp_dim=64, dropout=0.0)


def _jiggle(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(np.shape(p)).astype(np.float32), params)


def _mask_table(rows, ratio=0.5, seed=11):
    """(rows, N) bool with exactly int(N · ratio) True a row."""
    rng = np.random.default_rng(seed)
    k = int(N * ratio)
    table = np.zeros((rows, N), bool)
    for r in range(rows):
        table[r, rng.permutation(N)[:k]] = True
    return table


def _images(seed=5, b=B):
    return np.random.default_rng(seed).random((b, IMG, IMG, 3), np.float32)


@pytest.fixture(scope="module")
def jax_model():
    model = JaxSimMIMViT(mask_ratio=0.5, **NET)
    params = jax.jit(lambda r: model.init(r, jnp.zeros((1, IMG, IMG, 3)))["params"])(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)})
    return model, _jiggle(params, 2)


def _port_model(params, **kwargs):
    model = SimMIMViT(mask_ratio=0.5, **{**NET, **kwargs})
    model.load_state_dict(simmim_state_dict_from_flax(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# patches


@pytest.mark.parametrize("shape,p", [((2, 16, 16, 3), 4), ((1, 12, 8, 2), 4),
                                     ((3, 32, 32, 3), 16)])
def test_extract_patches_and_inverse_match_jax(shape, p):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = extract_patches(torch.from_numpy(x), p)
    want = np.asarray(jax_extract_patches(jnp.asarray(x), p))
    np.testing.assert_array_equal(got.numpy(), want)
    back = patches_to_image(got, shape[1:3], p, shape[3])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_patches_to_image(jnp.asarray(want), shape[1:3], p,
                                                      shape[3])))


def test_manual_patch_embed_matches_jax():
    jax_pe = JaxManualPatchEmbed(input_shape=(3, IMG, IMG), embed_dim=24, patch_size=PATCH)
    x = _images()
    params = _jiggle(jax_pe.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(jax_pe.apply({"params": params}, jnp.asarray(x)))
    pe = ManualPatchEmbed((3, IMG, IMG), 24, PATCH)
    pe.load_state_dict({
        "linear.weight": torch.from_numpy(params["linear"]["kernel"].T.copy()),
        "linear.bias": torch.from_numpy(params["linear"]["bias"]),
        "cls_token": torch.from_numpy(params["cls_token"]),
        "positional_embedding": torch.from_numpy(params["positional_embedding"]),
    }, strict=True)
    with torch.no_grad():
        got = pe(torch.from_numpy(x)).numpy()
    assert got.shape == (B, N + 1, 24)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the model


def test_state_dict_is_the_reference_layout(jax_model):
    _, params = jax_model
    want = simmim_params_to_torch(params)
    model = _port_model(params)
    sd = model.state_dict()
    assert list(sd) and set(sd) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_forward_and_gradients_match_jax_with_an_injected_mask(jax_model):
    model_j, params = jax_model
    x, table = _images(), _mask_table(B)

    def jax_loss(p):
        preds, targets, mask = model_j.apply({"params": p}, jnp.asarray(x), True,
                                             mask=jnp.asarray(table))
        return jax_masked_l1_loss(preds, targets, mask), (preds, targets, mask)

    (want_loss, (want_preds, want_targets, want_mask)), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)

    model = _port_model(params)
    preds, targets, mask = model(torch.from_numpy(x), True, (None, None),
                                 mask=torch.from_numpy(table))
    loss = masked_l1_loss(preds, targets, mask)
    loss.backward()
    assert preds.dtype == torch.float32 and preds.shape == (B, N, 3 * PATCH ** 2)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(want_targets))
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(want_preds), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    grads = simmim_params_to_torch(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_inference_forward_matches_jax(jax_model):
    model_j, params = jax_model
    x = _images(6)
    model = _port_model(params)
    with torch.no_grad():
        for patch_features in (False, True):
            want = model_j.apply({"params": params}, jnp.asarray(x), patch_features,
                                 method=model_j.inference_forward)
            got = model.inference_forward(torch.from_numpy(x), patch_features)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_draws_its_mask_and_dropout_from_the_generators(jax_model):
    """Without an injected mask the mask generator draws exactly k masked a
    row; the same generator seeds give the same output, dropout on."""
    _, params = jax_model
    model = _port_model(params, dropout=0.1)
    x = torch.from_numpy(_images())

    def run():
        gens = [torch.Generator().manual_seed(s) for s in (3, 4)]
        return model(x, False, gens)

    preds, _, mask = run()
    assert mask.sum(dim=1).tolist() == [N // 2] * B
    again, _, mask_again = run()
    assert torch.equal(mask, mask_again) and torch.equal(preds, again)
    with pytest.raises(ValueError, match="mask generator"):
        model(x, True, (None, None))


@pytest.mark.parametrize("ratio,k", [(0.5, 8), (0.6, 9), (0.0, 0), (0.05, 0), (1.0, N)])
def test_mask_rule_masks_exactly_k(ratio, k):
    mask = make_random_mask(torch.Generator().manual_seed(0), 64, N, ratio)
    assert mask.dtype == torch.bool and mask.shape == (64, N)
    assert mask.sum(dim=1).tolist() == [k] * 64
    jax_mask = jax_simmim_mod.make_random_mask(jax.random.PRNGKey(0), 64, N, ratio)
    assert np.asarray(jax_mask).sum(axis=1).tolist() == [k] * 64


def test_jax_export_loads_strict_and_serves_mean_pooled_features(jax_model, tmp_path):
    from vit_ssl_tpu_torch import serve

    model_j, params = jax_model
    config = {"training": {"type": "simmim"}, "data": {"img_size": IMG},
              "model": {"num_blocks": 2, "in_channels": 3, "embed_dim": 32,
                        "patch_size": PATCH, "num_heads": 2, "mlp_dim": 64,
                        "dropout": 0.0, "mask_ratio": 0.5,
                        "compute_dtype": "float32"}}
    path = str(tmp_path / "simmim.pth")
    save_torch_checkpoint(path, simmim_params_to_torch(params), {"config": config})
    state, meta = load_pth(path)
    SimMIMViT(mask_ratio=0.5, **NET).load_state_dict(state, strict=True)
    server = serve.Server(path, batch_size=4, device="cpu")
    x = _images(7)
    got = server.forward_batch(x)
    want = model_j.apply({"params": params}, jnp.asarray(x),
                         method=model_j.inference_forward)
    assert got.shape == (B, 32)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    record = server._format("a.png", got[0])
    assert set(record) == {"path", "embedding"}


# ---------------------------------------------------------------------------
# PSNR and SSIM


@pytest.mark.parametrize("p", [16, 4, 2])
def test_psnr_and_ssim_stats_match_jax(p):
    rng = np.random.default_rng(p)
    b, n, c = 3, 5, 3
    target = rng.random((b, n, c * p * p), np.float32)
    pred = np.clip(target + 0.2 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    w = (rng.random((b, n)) < 0.6).astype(np.float32) * np.array([1, 1, 0], np.float32)[:, None]
    got = port_metrics.psnr_stats(torch.from_numpy(pred), torch.from_numpy(target),
                                  torch.from_numpy(w)[..., None])
    want = jax_metrics.psnr_stats(jnp.asarray(pred), jnp.asarray(target),
                                  jnp.asarray(w)[..., None])
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], **TOL)
    got = port_metrics.ssim_stats(torch.from_numpy(pred), torch.from_numpy(target),
                                  torch.from_numpy(w), p, c)
    want = jax_metrics.ssim_stats(jnp.asarray(pred), jnp.asarray(target),
                                  jnp.asarray(w), p, c)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], **TOL)
    per = port_metrics.ssim_per_image(
        torch.from_numpy(pred).reshape(b * n, c, p, p),
        torch.from_numpy(target).reshape(b * n, c, p, p))
    jax_per = jax_metrics.ssim_per_image(
        jnp.asarray(pred).reshape(b * n, c, p, p).transpose(0, 2, 3, 1),
        jnp.asarray(target).reshape(b * n, c, p, p).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(per.numpy(), np.asarray(jax_per), **TOL)


def test_psnr_and_ssim_metric_names():
    handler = port_metrics.MetricHandler({"metrics": ["PSNR", "SSIM"]})
    got = handler.calculate_metrics(psnr_sse=0.5, psnr_count=50.0, ssim_sum=3.0,
                                    ssim_count=4.0)
    assert got == {"PSNR": pytest.approx(20.0), "SSIM": 0.75}
    assert handler.calculate_metrics(psnr_sse=0.0, psnr_count=1.0, ssim_sum=0.0,
                                     ssim_count=0.0)["PSNR"] == float("inf")


# ---------------------------------------------------------------------------
# the steps


def _fix_masks(monkeypatch, table):
    """Both packages' make_random_mask return the first rows of ``table``."""
    monkeypatch.setattr(jax_simmim_mod, "make_random_mask",
                        lambda rng, b, n, ratio: jnp.asarray(table[:b]))
    monkeypatch.setattr(port_simmim_mod, "make_random_mask",
                        lambda gen, b, n, ratio: torch.from_numpy(table[:b]))


@pytest.mark.parametrize("criterion", ["l1", "mse", "smooth_l1"])
def test_step_of_each_criterion_matches_jax(jax_model, criterion, monkeypatch):
    model_j, params = jax_model
    _fix_masks(monkeypatch, _mask_table(4, seed=12))
    weight = np.array([1, 1, 1, 0], np.float32)
    # values past 1 so that smooth_l1 takes both branches
    x = 1.6 * np.random.default_rng(8).random((4, IMG, IMG, 3), np.float32)
    batch = {"image": x, "weight": weight}

    tx = optax.sgd(1.0)
    state = create_train_state(params, tx, jax.random.PRNGKey(3))
    step, eval_step = jax_make_simmim_steps(model_j, tx, PATCH, 3, criterion,
                                            donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_eval = eval_step(state, jbatch, jax.random.PRNGKey(4))
    new_state, want = step(state, jbatch)

    model = _port_model(params)
    optimizer = SGD(lambda count: 1.0)
    port_state = SupervisedTrainState(model, optimizer, seed=0)
    train_step, port_eval = make_simmim_steps(optimizer, PATCH, 3, criterion)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_eval = port_eval(port_state, tbatch, torch.Generator().manual_seed(0))
    got = train_step(port_state, tbatch)
    for key in ("loss", "psnr_sse", "psnr_count", "ssim_sum", "ssim_count"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL, err_msg=key)
        np.testing.assert_allclose(float(got_eval[key]), float(want_eval[key]), **TOL,
                                   err_msg=key)
    updated = simmim_params_to_torch(new_state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), updated[name], **TOL, err_msg=name)
    with pytest.raises(ValueError, match="Unsupported SimMIM criterion"):
        make_simmim_steps(optimizer, PATCH, 3, "huber")
