"""The port's DINO backbone, builder and weight bridge against the JAX package.

``ViTBackbone`` is held against JAX ``DINONetwork.features`` (the teacher
CLS path that serving runs) on weights carried across by the port's bridge:
a narrow 2-block model at fp32 and bf16, and one block at the full
DINO ViT-S/8 width of ``configs/dino.yaml``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.models.dino import DINONetwork
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch
from vit_ssl_tpu_torch.models import ViTBackbone, build_backbone
from vit_ssl_tpu_torch.utils.checkpoint import (
    backbone_state_dict,
    dino_backbone_state_dict_from_flax,
    dino_state_dict_from_flax,
)

SMALL = dict(num_blocks=2, embed_dim=64, num_heads=2, patch_size=8,
             mlp_dim=128, img=32)
FULL_WIDTH_ONE_BLOCK = dict(num_blocks=1, embed_dim=384, num_heads=6,
                            patch_size=8, mlp_dim=1536, img=96)


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _jax_net(cfg, dtype):
    return DINONetwork(
        num_blocks=cfg["num_blocks"], input_shape=(3, cfg["img"], cfg["img"]),
        embed_dim=cfg["embed_dim"], patch_size=cfg["patch_size"],
        num_heads=cfg["num_heads"], mlp_dim=cfg["mlp_dim"], dropout=0.0,
        output_dim=16, dtype=dtype,
    )


def _port(cfg, dtype):
    return ViTBackbone(
        cfg["num_blocks"], (3, cfg["img"], cfg["img"]), cfg["embed_dim"],
        cfg["patch_size"], cfg["num_heads"], cfg["mlp_dim"], dtype=dtype,
    )


def _both(cfg, jax_dtype, torch_dtype, batch, seed=0):
    x = np.random.default_rng(seed).random(
        (batch, cfg["img"], cfg["img"], 3), np.float32)
    net = _jax_net(cfg, jax_dtype)
    params = _jiggle(net.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))["params"],
                     seed + 1)
    want = np.asarray(
        net.apply({"params": params}, jnp.asarray(x), method=net.features),
        np.float32)
    model = _port(cfg, torch_dtype)
    model.load_state_dict(dino_backbone_state_dict_from_flax(params["backbone"]),
                          strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch_dtype
    return got.float().numpy(), want, params


def _row_cosine(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("cfg,batch", [(SMALL, 3), (FULL_WIDTH_ONE_BLOCK, 2)],
                         ids=["small", "full-width-1-block"])
def test_backbone_matches_jax_features_fp32(cfg, batch):
    got, want, _ = _both(cfg, jnp.float32, torch.float32, batch)
    assert got.shape == (batch, cfg["embed_dim"])
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_backbone_matches_jax_features_bf16():
    """bf16 rounds at other places in the two frameworks (GEMM epilogues,
    bias adds), so the bar is direction, not bits."""
    got, want, _ = _both(SMALL, jnp.bfloat16, torch.bfloat16, 4, seed=3)
    assert np.isfinite(got).all()
    assert _row_cosine(got, want).min() >= 0.999


def test_embed_then_encode_equals_forward():
    model = _port(SMALL, torch.float32).reset_parameters(
        torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        tokens = model.encode(model.embed(x))
        assert tokens.shape == (2, 17, 64)
        torch.testing.assert_close(tokens[:, 0], model(x), rtol=0, atol=0)


def test_reset_parameters_follows_the_generator():
    a = _port(SMALL, torch.float32).reset_parameters(torch.Generator().manual_seed(5))
    b = _port(SMALL, torch.float32).reset_parameters(torch.Generator().manual_seed(5))
    c = _port(SMALL, torch.float32).reset_parameters(torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder_blocks.0.self_attention.w_query.weight"],
                           sc["encoder_blocks.0.self_attention.w_query.weight"])
    pe = sa["patch_embedding.positional_embedding"]
    assert 0.0 <= float(pe.min()) and float(pe.max()) < 1.0  # U[0, 1)


def test_bridge_equals_jax_exporter():
    """The port's jax-free bridge writes the same keys and values as the JAX
    package's own ``dino_params_to_torch``."""
    cfg = SMALL
    net = _jax_net(cfg, jnp.float32)
    dummy = jnp.zeros((1, cfg["img"], cfg["img"], 3))
    student = _jiggle(net.init(jax.random.PRNGKey(0), dummy)["params"], 1)
    teacher = _jiggle(net.init(jax.random.PRNGKey(1), dummy)["params"], 2)
    center = np.random.default_rng(3).standard_normal((1, 16)).astype(np.float32)
    want = dino_params_to_torch(student, teacher, center)
    got = dino_state_dict_from_flax(student, teacher, center)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32),
                                      err_msg=k)
    teacher_sd = backbone_state_dict(got)
    _port(cfg, torch.float32).load_state_dict(teacher_sd, strict=True)
    assert torch.equal(teacher_sd["patch_embedding.cls_token"],
                       got["teacher_backbone.patch_embedding.cls_token"])


def _config(mode="dino", dtype="bfloat16"):
    return {
        "training": {"type": mode},
        "model": {"in_channels": 3, "embed_dim": 64, "num_blocks": 2,
                  "num_heads": 2, "mlp_dim": 128, "patch_size": 8,
                  "compute_dtype": dtype},
        "data": {"img_size": 32},
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_build_backbone_follows_the_config(dtype):
    model = build_backbone(_config(dtype=dtype), "cpu")
    assert model.dtype == getattr(torch, dtype)
    assert len(model.encoder_blocks) == 2
    assert model.patch_embedding.positional_embedding.shape == (1, 17, 64)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_build_backbone_eval_dino_mode():
    cfg = _config()
    del cfg["training"]
    cfg["eval"] = {"mode": "eval_dino"}
    assert isinstance(build_backbone(cfg, "cpu"), ViTBackbone)


@pytest.mark.parametrize("mode", ["supervised", "finetune", "simmim"])
def test_build_backbone_refuses_unported_modes(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_backbone(_config(mode=mode), "cpu")
