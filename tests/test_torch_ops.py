"""Encoder ops of the PyTorch port against the JAX package, on the CPU.

Each JAX module is initialised, its parameters are jiggled with numpy noise
(so LayerNorm scales and biases are not the trivial ones and zeros), carried
across with the port's weight bridge and loaded with ``strict=True``; both
modules then run on the same numpy inputs. fp32 throughout: the point here
is the algorithm, and the kernel is held to its plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ssl_tpu.ops.attention as jax_attention_mod
from vit_ssl_tpu.ops.attention import MultiHeadAttention as JaxMHA
from vit_ssl_tpu.ops.attention import (
    scaled_dot_product_attention as jax_sdpa,
)
from vit_ssl_tpu.ops.encoder_block import EncoderBlock as JaxEncoderBlock
from vit_ssl_tpu.ops.feed_forward import FeedForwardBlock as JaxFFN
from vit_ssl_tpu.ops.mlp_head import MLPHead as JaxMLPHead
from vit_ssl_tpu.ops.patch_embedding import ConvPatchEmbed as JaxConvPatchEmbed
from vit_ssl_tpu.ops.patch_embedding import DynamicPatchEmbed as JaxPatchEmbed
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import (
    ConvPatchEmbed,
    DynamicPatchEmbed,
    EncoderBlock,
    FeedForwardBlock,
    MLPHead,
    MultiHeadAttention,
    scaled_dot_product_attention,
)
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.ops.dropout import (
    Dropout,
    drop_threshold,
    dropout16,
    keep_mask16,
)
from vit_ssl_tpu_torch.ops.flash_attention import KERNEL
from vit_ssl_tpu_torch.utils.checkpoint import (
    attention_state_dict_from_flax,
    encoder_block_state_dict_from_flax,
    feed_forward_state_dict_from_flax,
    patch_embedding_state_dict_from_flax,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(module, x):
    with torch.inference_mode():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("block_size", [0, 5])
def test_scaled_dot_product_attention_matches_jax(block_size):
    q, k, v = (_x((2, 3, 10, 16), seed=s) for s in range(3))
    want, want_p = jax_sdpa(*(jnp.asarray(t) for t in (q, k, v)), True,
                            block_size=block_size)
    got, got_p = scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), True, block_size=block_size
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    assert scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)))[1] is None


@pytest.mark.parametrize("jax_path", ["xla", "kernel"])
@pytest.mark.parametrize("block_size", [0, 5])
def test_multi_head_attention_matches_jax(monkeypatch, jax_path, block_size):
    """Both of JAX's self-attention paths: its XLA einsum path and its B1
    kernel in interpret mode (the gate forced open, as the JAX package's
    own tests do). The port sends self-attention to ``attention_nhd``."""
    if jax_path == "kernel":
        monkeypatch.setattr(jax_attention_mod, "attention_nhd_profitable",
                            lambda *a, **kw: True)
    x = _x((3, 20, 64))
    jax_mha = JaxMHA(d_model=64, num_heads=4, use_flash=jax_path == "kernel")
    params = _jiggle(jax_mha.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = jax_mha.apply({"params": params}, jnp.asarray(x), block_size=block_size)

    mha = MultiHeadAttention(64, 4)
    mha.load_state_dict(attention_state_dict_from_flax(params), strict=True)
    before = kernels.launches[KERNEL]
    with torch.inference_mode():
        got = mha(torch.from_numpy(x), block_size=block_size).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert kernels.launches[KERNEL] == before  # CPU: plain version, no kernel


def test_multi_head_attention_return_attn_matches_jax():
    x = _x((2, 9, 32))
    jax_mha = JaxMHA(d_model=32, num_heads=2)
    params = _jiggle(jax_mha.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2)
    want, want_p = jax_mha.apply({"params": params}, jnp.asarray(x),
                                 return_attn=True)
    mha = MultiHeadAttention(32, 2)
    mha.load_state_dict(attention_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got, got_p = mha(torch.from_numpy(x), return_attn=True)
    assert got_p.shape == (2, 2, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_multi_head_attention_cross_attention_matches_jax():
    q, kv = _x((2, 7, 32)), _x((2, 11, 32), seed=1)
    jax_mha = JaxMHA(d_model=32, num_heads=2)
    params = _jiggle(jax_mha.init(jax.random.PRNGKey(2), jnp.asarray(q))["params"], 3)
    want = jax_mha.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv))
    mha = MultiHeadAttention(32, 2)
    mha.load_state_dict(attention_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = mha(torch.from_numpy(q), torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_multi_head_attention_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="divisible"):
        MultiHeadAttention(30, 4)


def test_feed_forward_matches_jax():
    x = _x((2, 13, 32))
    jax_ff = JaxFFN(d_model=32, d_ff=96, dropout=0.0)
    params = _jiggle(jax_ff.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 4)
    want = jax_ff.apply({"params": params}, jnp.asarray(x))
    ff = FeedForwardBlock(32, 96)
    ff.load_state_dict(feed_forward_state_dict_from_flax(params), strict=True)
    np.testing.assert_allclose(_run(ff, x), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_size", [0, 5])
def test_encoder_block_matches_jax(block_size):
    x = _x((2, 10, 64))
    jax_block = JaxEncoderBlock(d_model=64, num_heads=2, mlp_dim=128, dropout=0.0)
    params = _jiggle(
        jax_block.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 5)
    want = jax_block.apply({"params": params}, jnp.asarray(x),
                           block_size=block_size)
    block = EncoderBlock(64, 2, 128)
    block.load_state_dict(encoder_block_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), block_size).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_dynamic_patch_embed_matches_jax():
    x = np.random.default_rng(6).random((2, 32, 32, 3), np.float32)
    jax_pe = JaxPatchEmbed(input_shape=(3, 32, 32), embed_dim=48, patch_size=8)
    params = _jiggle(jax_pe.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"], 7)
    want = jax_pe.apply({"params": params}, jnp.asarray(x))
    pe = DynamicPatchEmbed((3, 32, 32), 48, 8)
    pe.load_state_dict(patch_embedding_state_dict_from_flax(params), strict=True)
    got = _run(pe, x)
    assert got.shape == (2, 17, 48)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("hw,match", [(30, "divisible")])
def test_dynamic_patch_embed_rejects_other_grids(hw, match):
    pe = DynamicPatchEmbed((3, 32, 32), 16, 8)
    with pytest.raises(ValueError, match=match):
        pe(torch.zeros(1, hw, hw, 3))


@pytest.mark.parametrize("stored,seen,patch", [(96, 48, 8), (16, 8, 8), (32, 48, 8)],
                         ids=["12to6", "2to1", "4to6"])
def test_dynamic_patch_embed_resizes_pos_embedding_like_jax(stored, seen, patch):
    """A grid other than the stored one resizes the positional embedding
    with JAX's antialiased a=-0.5 bicubic (DINO locals: 12x12 -> 6x6)."""
    x = np.random.default_rng(8).random((2, seen, seen, 3), np.float32)
    jax_pe = JaxPatchEmbed(input_shape=(3, stored, stored), embed_dim=16,
                           patch_size=patch)
    params = _jiggle(jax_pe.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"], 9)
    want = jax_pe.apply({"params": params}, jnp.asarray(x))
    pe = DynamicPatchEmbed((3, stored, stored), 16, patch)
    pe.load_state_dict(patch_embedding_state_dict_from_flax(params), strict=True)
    got = _run(pe, x)
    assert got.shape == (2, (seen // patch) ** 2 + 1, 16)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_dropout_identity_at_rate_zero_and_when_deterministic():
    x = torch.randn(4, 7, 16)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(Dropout(0.0)(x, False, g), x)
    assert torch.equal(Dropout(0.1)(x, True, g), x)
    assert torch.equal(Dropout(0.1)(x), x)
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.1)(x, False)


def test_dropout16_keep_rate_and_scale():
    """drop <=> uint16 bits < round(0.1*65536) = 6554: keep rate
    1 - 6554/65536, kept values scaled by 1/0.9 in x's dtype."""
    n = 1 << 20
    keep = keep_mask16((n,), 0.1, torch.Generator().manual_seed(1))
    p = 1 - 6554 / 65536
    assert abs(float(keep.float().mean()) - p) < 5 * (p * (1 - p) / n) ** 0.5
    x = torch.rand(4096, generator=torch.Generator().manual_seed(2)).bfloat16() + 1
    y = dropout16(x, 0.1, torch.Generator().manual_seed(3))
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert torch.equal(y[kept], (x / 0.9)[kept])
    same = dropout16(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(y, same)  # the generator decides the mask


def test_dropout_threshold_saturates():
    assert drop_threshold(0.1) == 6554
    assert drop_threshold(1.0) == 65535


def test_bernoulli_dropout_and_fused_mlp_not_ported():
    """Both are ported since. Bernoulli dropout (``fast=False``) builds and
    drops by its own rule (``tests/test_torch_grad_accum.py`` holds its
    keep rate); the fused MLP (kernel B4) builds with ``use_fused=True``,
    and on the CPU it computes the unfused block's function on the same
    parameters (fp32: the two paths differ only in where they round, which
    fp32 does not show at this size)."""
    drop = Dropout(0.1, fast=False)
    x = torch.ones(4096)
    y = drop(x, False, torch.Generator().manual_seed(0))
    assert not drop.fast and torch.equal(drop(x, True), x)
    assert torch.equal(y.unique(), torch.tensor([0.0, 1 / 0.9]))
    assert not torch.equal(y, Dropout(0.1)(x, False, torch.Generator().manual_seed(0)))
    torch.manual_seed(0)
    unfused = FeedForwardBlock(32, 64)
    fused = FeedForwardBlock(32, 64, use_fused=True)
    fused.load_state_dict(unfused.state_dict(), strict=True)
    x = torch.randn(2, 9, 32)
    with torch.inference_mode():
        torch.testing.assert_close(fused(x), unfused(x), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dropout", [0.1, 0.0])
def test_feed_forward_fused_matches_jax(dropout):
    """The fused block against JAX's fused block (its Pallas kernel in
    interpret mode) on the same weights, in eval mode."""
    x = _x((2, 13, 32))
    jax_ff = JaxFFN(d_model=32, d_ff=128, dropout=dropout, use_fused=True)
    params = _jiggle(jax_ff.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 4)
    want = jax_ff.apply({"params": params}, jnp.asarray(x))
    ff = FeedForwardBlock(32, 128, dropout=dropout, use_fused=True)
    ff.load_state_dict(feed_forward_state_dict_from_flax(params), strict=True)
    np.testing.assert_allclose(_run(ff, x), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_size", [0, 5])
def test_encoder_block_fused_mlp_matches_jax(block_size):
    x = _x((2, 10, 64))
    jax_block = JaxEncoderBlock(d_model=64, num_heads=2, mlp_dim=128, dropout=0.0,
                                use_fused_mlp=True)
    params = _jiggle(
        jax_block.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 5)
    want = jax_block.apply({"params": params}, jnp.asarray(x),
                           block_size=block_size)
    block = EncoderBlock(64, 2, 128, use_fused_mlp=True)
    block.load_state_dict(encoder_block_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), block_size).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_encoder_block_dropout_order():
    """One generator, three masks in a fixed order: after attention, after
    the GELU inside the FFN, after the FFN."""
    torch.manual_seed(0)
    block = EncoderBlock(32, 2, 64, dropout=0.25)
    x = torch.randn(3, 9, 32)
    got = block(x, 0, False, torch.Generator().manual_seed(4))

    g = torch.Generator().manual_seed(4)
    h = block.self_attention(block.layer_norm1(x))
    x1 = dropout16(h, 0.25, g) + x
    ff = block.feed_forward
    h = dropout16(torch.nn.functional.gelu(ff.linear_in(block.layer_norm2(x1))), 0.25, g)
    want = dropout16(ff.linear_out(h), 0.25, g) + x1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, block(x))  # deterministic differs


def force_b3(monkeypatch):
    """Both packages' self-attention down kernel B3: JAX's NHD gate shut and
    its fused gate open (its kernel in interpret mode), the port's B1
    predicate false; nothing in either package is edited."""
    monkeypatch.setattr(jax_attention_mod, "attention_nhd_profitable",
                        lambda *a, **kw: False)
    monkeypatch.setattr(jax_attention_mod, "fused_attention_profitable",
                        lambda *a, **kw: True)
    monkeypatch.setattr(fa, "attention_nhd_feasible", lambda *a, **kw: False)


def test_multi_head_attention_b3_route_matches_jax(monkeypatch):
    """Forced down B3 on both sides: output and the gradients of the input
    and of w_query against JAX's (its B3 kernel forward and custom-VJP
    backward in interpret mode), fp32 at TOL, N = 21 (ragged to the TPU
    kernel's 8-row padding)."""
    force_b3(monkeypatch)
    x = _x((3, 21, 64), seed=11)
    g = _x((3, 21, 64), seed=12)
    jax_mha = JaxMHA(d_model=64, num_heads=4)
    params = _jiggle(jax_mha.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"], 13)

    def loss(p, xin):
        return jnp.sum(jax_mha.apply({"params": p}, xin) * jnp.asarray(g))

    want = jax_mha.apply({"params": params}, jnp.asarray(x))
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    mha = MultiHeadAttention(64, 4)
    mha.load_state_dict(attention_state_dict_from_flax(params), strict=True)
    calls = []
    real = attention_mod.fused_attention
    monkeypatch.setattr(attention_mod, "fused_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    xt = torch.from_numpy(x).requires_grad_()
    out = mha(xt)
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == [(3, 4, 21, 16)]  # B3, head-major
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **TOL)
    np.testing.assert_allclose(mha.w_query.weight.grad.numpy(),
                               np.asarray(want_gp["w_query"]["kernel"]).T, **TOL)


def test_conv_patch_embed_matches_jax():
    x = np.random.default_rng(14).random((2, 32, 32, 3), np.float32)
    jax_pe = JaxConvPatchEmbed(input_shape=(3, 32, 32), embed_dim=48, patch_size=8)
    params = _jiggle(jax_pe.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"], 15)
    want = jax_pe.apply({"params": params}, jnp.asarray(x))
    pe = ConvPatchEmbed((3, 32, 32), 48, 8)
    state = {"conv.weight": torch.from_numpy(
                 np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
             "conv.bias": torch.from_numpy(np.asarray(params["conv"]["bias"])),
             "cls_token": torch.from_numpy(np.asarray(params["cls_token"])),
             "positional_embedding": torch.from_numpy(
                 np.asarray(params["positional_embedding"]))}
    pe.load_state_dict(state, strict=True)
    got = _run(pe, x)
    assert got.shape == (2, 17, 48)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_conv_patch_embed_bf16_rounds_like_jax():
    """In bf16 the conv output, the cast CLS token and the cast positional
    embedding are added in bf16, as JAX adds them (one bf16 ulp apart at
    most: the two convolutions sum in another order)."""
    x = np.random.default_rng(16).random((2, 16, 16, 3), np.float32)
    jax_pe = JaxConvPatchEmbed(input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
                               dtype=jnp.bfloat16)
    params = _jiggle(jax_pe.init(jax.random.PRNGKey(9), jnp.asarray(x))["params"], 17)
    want = np.asarray(jax_pe.apply({"params": params}, jnp.asarray(x)), np.float32)
    pe = ConvPatchEmbed((3, 16, 16), 32, 8, dtype=torch.bfloat16)
    pe.load_state_dict({
        "conv.weight": torch.from_numpy(
            np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(np.asarray(params["conv"]["bias"])),
        "cls_token": torch.from_numpy(np.asarray(params["cls_token"])),
        "positional_embedding": torch.from_numpy(
            np.asarray(params["positional_embedding"]))}, strict=True)
    with torch.inference_mode():
        got = pe(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)


def test_conv_patch_embed_rejects_indivisible_size():
    with pytest.raises(ValueError, match="divisible"):
        ConvPatchEmbed((3, 30, 30), 16, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_head_matches_jax(dtype):
    """LayerNorm and Linear in fp32 whatever the input dtype: fp32 logits."""
    x = _x((4, 32), seed=18)
    jax_head = JaxMLPHead(d_model=32, num_classes=10)
    params = _jiggle(jax_head.init(jax.random.PRNGKey(10), jnp.asarray(x))["params"], 19)
    xin = torch.from_numpy(x).to(dtype)
    want = jax_head.apply({"params": params}, jnp.asarray(xin.float().numpy()))
    head = MLPHead(32, 10)
    head.load_state_dict({
        "norm.weight": torch.from_numpy(np.asarray(params["norm"]["scale"])),
        "norm.bias": torch.from_numpy(np.asarray(params["norm"]["bias"])),
        "linear.weight": torch.from_numpy(np.asarray(params["linear"]["kernel"]).T.copy()),
        "linear.bias": torch.from_numpy(np.asarray(params["linear"]["bias"]))},
        strict=True)
    with torch.inference_mode():
        got = head(xin)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_block_return_attn_matches_jax():
    """The visualizer's path: the block's output and its attention
    probabilities against JAX's."""
    x = _x((2, 10, 64), seed=20)
    jax_block = JaxEncoderBlock(d_model=64, num_heads=2, mlp_dim=128, dropout=0.0)
    params = _jiggle(jax_block.init(jax.random.PRNGKey(11), jnp.asarray(x))["params"], 21)
    want, want_p = jax_block.apply({"params": params}, jnp.asarray(x), True, True)
    block = EncoderBlock(64, 2, 128)
    block.load_state_dict(encoder_block_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got, got_p = block(torch.from_numpy(x), return_attn=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
