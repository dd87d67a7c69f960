"""The port's supervised ViT (``vit_ssl_tpu_torch.models.ViT``) against the
JAX package's, on the CPU.

A JAX ``ViT`` (2 blocks, embed 64, image 32, patch 8) is initialised, its
parameters are jiggled with numpy noise, carried across with the port's
``vit_state_dict_from_flax`` and loaded with ``strict=True``; both run on
the same numpy images. fp32, outputs and gradients at atol/rtol 1e-4.
Also: the B3 route forced on both sides, the builder, and the options the
port refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ssl_tpu.ops.attention as jax_attention_mod
from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.utils.checkpoint import vit_params_to_torch
from vit_ssl_tpu_torch.models import (
    DINONetwork,
    SimMIMViT,
    ViT,
    build_model,
    build_vit,
)
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(num_classes=10, num_blocks=2, input_shape=(3, 32, 32), embed_dim=64,
             patch_size=8, num_heads=4, mlp_dim=128, dropout=0.0)


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _images(b=3, seed=0):
    return np.random.default_rng(seed).random((b, 32, 32, 3), np.float32)


@pytest.fixture(scope="module")
def jax_vit():
    module = JaxViT(**SMALL)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return module, _jiggle(params, 1)


def _port_vit(params, **kw):
    vit = ViT(**{**SMALL, **kw})
    vit.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return vit


def _forward_and_input_grad(jax_vit, x, g):
    module, params = jax_vit

    def loss(xin):
        return jnp.sum(module.apply({"params": params}, xin) * jnp.asarray(g))

    want = module.apply({"params": params}, jnp.asarray(x))
    return np.asarray(want), np.asarray(jax.grad(loss)(jnp.asarray(x)))


def test_bridge_gives_the_reference_layout(jax_vit):
    """The port's bridge and the JAX package's own export name the same
    tensors with the same values."""
    _, params = jax_vit
    ours = vit_state_dict_from_flax(params)
    theirs = vit_params_to_torch(params)
    assert set(ours) == set(theirs) == set(ViT(**SMALL).state_dict())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_vit_forward_and_input_gradient_match_jax(jax_vit):
    x, g = _images(), np.random.default_rng(2).standard_normal((3, 10)).astype(np.float32)
    want, want_gx = _forward_and_input_grad(jax_vit, x, g)
    vit = _port_vit(jax_vit[1])
    xt = torch.from_numpy(x).requires_grad_()
    logits = vit(xt)
    (logits * torch.from_numpy(g)).sum().backward()
    assert logits.dtype == torch.float32 and logits.shape == (3, 10)
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)


def test_vit_b3_route_matches_jax(jax_vit, monkeypatch):
    """Both sides forced down kernel B3 (JAX's in interpret mode, the
    port's plain versions): logits and input gradient at TOL, and every
    block went through ``fused_attention``."""
    monkeypatch.setattr(jax_attention_mod, "attention_nhd_profitable",
                        lambda *a, **kw: False)
    monkeypatch.setattr(jax_attention_mod, "fused_attention_profitable",
                        lambda *a, **kw: True)
    monkeypatch.setattr(fa, "attention_nhd_feasible", lambda *a, **kw: False)
    calls = []
    real = attention_mod.fused_attention
    monkeypatch.setattr(attention_mod, "fused_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, g = _images(seed=3), np.random.default_rng(4).standard_normal((3, 10)).astype(np.float32)
    want, want_gx = _forward_and_input_grad(jax_vit, x, g)
    vit = _port_vit(jax_vit[1])
    xt = torch.from_numpy(x).requires_grad_()
    logits = vit(xt)
    (logits * torch.from_numpy(g)).sum().backward()
    assert calls == [(3, 4, 17, 16)] * SMALL["num_blocks"]
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)


def test_vit_return_attn_matches_jax(jax_vit):
    """The last block's probabilities (B, heads, N, N) beside the logits."""
    module, params = jax_vit
    x = _images(seed=5)
    want, want_p = module.apply({"params": params}, jnp.asarray(x), True, True)
    vit = _port_vit(params)
    with torch.inference_mode():
        got, got_p = vit(torch.from_numpy(x), return_attn=True)
    assert got_p.shape == (3, 4, 17, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_vit_dropout_draws_from_the_generator():
    vit = ViT(**{**SMALL, "dropout": 0.1}).reset_parameters(
        torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(seed=6))
    a = vit(x, False, torch.Generator().manual_seed(1))
    b = vit(x, False, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, vit(x))


def test_reset_parameters_is_the_reference_init():
    """Same generator seed, same weights; LayerNorms at ones and zeros, CLS
    and positional embeddings in [0, 1)."""
    a = ViT(**SMALL).reset_parameters(torch.Generator().manual_seed(3))
    b = ViT(**SMALL).reset_parameters(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert torch.equal(sd["classification_head.norm.weight"], torch.ones(64))
    pe = sd["patch_embedding.positional_embedding"]
    assert pe.shape == (1, 17, 64) and 0 <= float(pe.min()) and float(pe.max()) < 1


def _config(mode="supervised", **overrides):
    cfg = to_container(compose("configs", "vit_b_imagenet", overrides=[
        "data.img_size=32", "model.embed_dim=64", "model.num_heads=4",
        "model.num_blocks=2", "model.mlp_dim=128", "model.num_classes=10",
        "model.patch_size=8", "parallel.remat=false",
        *[f"{k}={v}" for k, v in overrides.items()]]))
    cfg["training"]["type"] = mode
    return cfg


@pytest.mark.parametrize("mode", ["supervised", "finetune"])
def test_build_model_builds_the_vit(mode):
    cfg = _config(mode)
    for model in (build_model(cfg, "cpu"), build_vit(cfg, "cpu")):
        assert isinstance(model, ViT)
        assert model.dtype == torch.bfloat16  # the config's compute dtype
        assert len(model.encoder_blocks) == 2
        assert model.classification_head.linear.out_features == 10


def test_build_model_dino_and_simmim():
    cfg = to_container(compose("configs", "dino", overrides=[
        "data.img_size=32", "model.embed_dim=64", "model.num_heads=2",
        "model.num_blocks=1", "model.mlp_dim=128", "model.output_dim=16"]))
    assert isinstance(build_model(cfg, "cpu"), DINONetwork)
    simmim = _config("simmim", **{"+model.mask_ratio": 0.5})
    model = build_model(simmim, "cpu")  # ported since
    assert isinstance(model, SimMIMViT) and model.mask_ratio == 0.5
    assert len(model.encoder_blocks) == 2 and model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not build a ViT"):
        build_vit(cfg, "cpu")


@pytest.mark.parametrize("override,match", [
    ({"parallel.remat": "true"}, None),
    ({"model.scan_layers": "true"}, "scan_layers"),
    ({"model.patch_dropout": "0.5"}, "patch_dropout"),
    ({"model.moe_experts": "4"}, "moe_experts"),
])
def test_unported_options_raise(override, match):
    """Each unported option names ROADMAP.md; ``parallel.remat`` (ported
    since, no match), which the ViT-B config sets, builds a ViT that
    checkpoints its blocks."""
    if match is None:
        assert build_vit(_config(**override), "cpu").remat
        return
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*ROADMAP.md"):
        build_vit(_config(**override), "cpu")


def test_vit_b_config_at_384_is_the_b3_shape():
    """configs/vit_b_imagenet.yaml with data.img_size=384: 577 tokens of 12
    heads of 64, which B1 does not fit: every block routes to B3."""
    cfg = to_container(compose("configs", "vit_b_imagenet",
                               overrides=["data.img_size=384"]))
    m = cfg["model"]
    n = (384 // m["patch_size"]) ** 2 + 1
    assert (n, m["num_heads"], m["embed_dim"]) == (577, 12, 768)
    assert cfg["parallel"]["remat"] is True
    assert fa.attention_route(64, n, m["num_heads"], m["embed_dim"], 2) == "B3"
