"""The model keys the JAX builder reads, in the port's builder
(``vit_ssl_tpu_torch.models.builder``).

- ``model.use_flash_attention=false``: every attention call takes the plain
  PyTorch attention and no kernel wrapper is called, with the kernel path's
  output (JAX's ``use_flash`` gate, ``vit_ssl_tpu/ops/attention.py``);
- ``model.init_scheme``: ``tpu`` draws LeCun-normal kernels, zero biases and
  truncated-normal(0.02) tokens; an unknown name raises JAX's error
  (``vit_ssl_tpu/ops/initializers.py``);
- ``model.matmul_precision``: the names map or are refused by name; an
  unknown one raises JAX's error (``vit_ssl_tpu/ops/precision.py``);
- DINO refuses ``model.scan_layers`` (and builds ``parallel.remat``) as the
  supervised ViT does;
- SimMIM is refused by both builders with its ROADMAP item.
"""

import math

import pytest
import torch

from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu.ops.initializers import InitScheme
from vit_ssl_tpu.ops.precision import resolve_precision as jax_resolve_precision
from vit_ssl_tpu_torch.models import (DINONetwork, SimMIMViT, ViT, build_backbone,
                                      build_dino_network, build_model, build_vit)
from vit_ssl_tpu_torch.models.dino import WeightNormDense
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops.precision import resolve_precision


def _vit_config(**overrides):
    return to_container(compose("configs", "vit_b_imagenet", overrides=[
        "data.img_size=32", "model.embed_dim=64", "model.num_heads=4",
        "model.num_blocks=2", "model.mlp_dim=128", "model.num_classes=10",
        "model.patch_size=8", "parallel.remat=false",
        *[f"{k}={v}" for k, v in overrides.items()]]))


def _dino_config(**overrides):
    return to_container(compose("configs", "dino", overrides=[
        "data.img_size=32", "model.embed_dim=64", "model.num_heads=2",
        "model.num_blocks=2", "model.mlp_dim=128", "model.output_dim=16",
        *[f"{k}={v}" for k, v in overrides.items()]]))


BUILDERS = {"vit": (build_vit, _vit_config), "dino": (build_dino_network, _dino_config)}


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("key,value", [
    ("model.use_flash_attention", "false"), ("model.init_scheme", "tpu"),
    ("model.matmul_precision", "highest"), ("model.matmul_precision", "float32"),
    ("model.matmul_precision", "bfloat16"), ("model.matmul_precision", "fastest"),
    ("model.matmul_precision", "none"),
])
def test_builds_with_each_key(model, key, value):
    build, config = BUILDERS[model]
    net = build(config(**{key: value}), "cpu")
    assert isinstance(net, (ViT, DINONetwork))
    blocks = net.encoder_blocks if model == "vit" else net.backbone.encoder_blocks
    want_flash = not (key == "model.use_flash_attention" and value == "false")
    assert all(b.self_attention.use_flash == want_flash for b in blocks)
    expected = value if key == "model.init_scheme" else "reference"
    assert (net if model == "vit" else net.backbone).init_scheme == expected


def _refuse_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran with use_flash_attention=false")

    for name in ("attention_nhd", "fused_attention", "blockwise_attention"):
        monkeypatch.setattr(attention_mod, name, refuse)


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_use_flash_attention_false_takes_the_plain_attention(model, monkeypatch):
    """The same weights built with the flag on and off: the flag-off model
    never reaches a kernel wrapper (on any route, packed DINO locals
    included) and gives the flag-on model's output."""
    build, config = BUILDERS[model]
    on = build(config(), "cpu").reset_parameters(torch.Generator().manual_seed(0))
    off = build(config(**{"model.use_flash_attention": "false"}), "cpu")
    off.load_state_dict(on.state_dict(), strict=True)
    images = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = on(images)
        want_packed = on.forward_packed(torch.cat([images, images]), 2) \
            if model == "dino" else None
        _refuse_kernels(monkeypatch)
        with pytest.raises(AssertionError, match="kernel wrapper"):
            on(images)  # the flag-on model does reach the (refused) wrappers
        got = off(images)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        if model == "dino":
            torch.testing.assert_close(off.forward_packed(torch.cat([images, images]), 2),
                                       want_packed, atol=1e-5, rtol=1e-5)


def _linears(net):
    return [m for m in net.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_tpu_init_scheme(model):
    """LeCun-normal kernels (std 1/√fan_in within 10 % where fan-in is a few
    hundred), zero biases, tokens from a normal of σ 0.02 truncated at 2σ,
    LayerNorms at ones and zeros; the weight-norm head's v LeCun-normal,
    its bias zero and g = ‖v‖. The RNG streams differ from JAX's by design,
    so the draws are compared by distribution."""
    build, config = BUILDERS[model]
    cfg = config(**{"model.init_scheme": "tpu", "model.embed_dim": 256,
                    "model.mlp_dim": 512, "model.num_heads": 4})
    net = build(cfg, "cpu").reset_parameters(torch.Generator().manual_seed(2))
    checked = 0
    for layer in _linears(net):
        if layer.bias is not None:
            assert torch.count_nonzero(layer.bias) == 0
        fan_in = layer.weight[0].numel()
        if fan_in >= 192:
            std = float(layer.weight.detach().std())
            assert abs(std * math.sqrt(fan_in) - 1) < 0.1, (layer, std)
            assert float(layer.weight.abs().max()) <= 2 / math.sqrt(fan_in) / 0.8796 + 1e-6
            checked += 1
    assert checked >= 4
    embed = net.patch_embedding if model == "vit" else net.backbone.patch_embedding
    for token in (embed.cls_token, embed.positional_embedding):
        assert float(token.abs().max()) <= 0.04 + 1e-7
    pos = embed.positional_embedding
    assert abs(float(pos.std()) - 0.02 * 0.8796) < 0.1 * 0.02
    for norm in (m for m in net.modules() if isinstance(m, torch.nn.LayerNorm)):
        assert torch.equal(norm.weight, torch.ones_like(norm.weight))
        assert torch.count_nonzero(norm.bias) == 0
    if model == "dino":
        fc = net.head.fully_connected
        v = fc.parametrizations.weight.original1
        assert torch.count_nonzero(fc.bias) == 0
        assert abs(float(v.std()) * math.sqrt(v.shape[1]) - 1) < 0.1
        torch.testing.assert_close(fc.parametrizations.weight.original0,
                                   torch.linalg.vector_norm(v, dim=1, keepdim=True))


def test_reference_init_scheme_is_unchanged():
    """The default scheme still draws PyTorch's own init: uniform weights
    within 1/√fan_in, nonzero biases, U[0, 1) tokens."""
    net = build_vit(_vit_config(), "cpu").reset_parameters(torch.Generator().manual_seed(3))
    for layer in _linears(net):
        bound = 1 / math.sqrt(layer.weight[0].numel())
        assert float(layer.weight.abs().max()) <= bound
        if layer.bias is not None:
            assert torch.count_nonzero(layer.bias) > 0
    pos = net.patch_embedding.positional_embedding
    assert 0 <= float(pos.min()) and float(pos.max()) < 1 and float(pos.mean()) > 0.3


def test_unknown_init_scheme_raises_jax_error():
    with pytest.raises(ValueError) as jax_error:
        InitScheme("lecun")
    for model, (build, config) in BUILDERS.items():
        with pytest.raises(ValueError) as port_error:
            build(config(**{"model.init_scheme": "lecun"}), "cpu")
        assert str(port_error.value) == str(jax_error.value) == "Unknown init scheme: lecun"
    with pytest.raises(ValueError, match="Unknown init scheme"):
        WeightNormDense(8, 4, init_scheme="xavier")


def test_unknown_matmul_precision_raises_jax_error():
    with pytest.raises(ValueError) as jax_error:
        jax_resolve_precision("float16")
    for model, (build, config) in BUILDERS.items():
        with pytest.raises(ValueError) as port_error:
            build(config(**{"model.matmul_precision": "float16"}), "cpu")
        assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("name", ["high", "tensorfloat32", "HIGH"])
def test_tf32_matmul_precision_is_refused_by_name(name):
    with pytest.raises(NotImplementedError, match=r"ops/precision\.py"):
        build_vit(_vit_config(**{"model.matmul_precision": name}), "cpu")


def test_matmul_precision_mapping(monkeypatch):
    assert [resolve_precision(n) for n in ("default", "bfloat16", "fastest", "none", None)] \
        == ["default"] * 5
    assert resolve_precision("highest") == resolve_precision("Float32") == "highest"
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(NotImplementedError, match="global"):
        resolve_precision("highest")


@pytest.mark.parametrize("build", [build_dino_network, build_backbone],
                         ids=["network", "backbone"])
@pytest.mark.parametrize("override,match", [
    ({"parallel.remat": "true"}, None),
    ({"model.scan_layers": "true"}, r"scan_layers.*ROADMAP\.md queue A item 9"),
])
def test_dino_refuses_remat_and_scan_layers(build, override, match):
    """A DINO config asking for ``model.scan_layers`` no longer runs without
    it; ``parallel.remat`` (ported since, no match) builds a backbone that
    checkpoints its blocks."""
    if match is None:
        built = build(_dino_config(**override), "cpu")
        assert getattr(built, "backbone", built).remat
        return
    with pytest.raises(NotImplementedError, match=f"(?s){match}"):
        build(_dino_config(**override), "cpu")


@pytest.mark.parametrize("build", [build_model, build_backbone],
                         ids=["build_model", "backbone"])
def test_simmim_is_refused_with_its_roadmap_item(build):
    """SimMIM is ported since: the model factory builds a ``SimMIMViT``
    masking the config's ``model.mask_ratio``; the DINO builders still
    refuse a SimMIM config, and the refusal names no queue item."""
    config = _dino_config()
    config["training"]["type"] = "simmim"
    config["model"]["mask_ratio"] = 0.5
    if build is build_model:
        net = build(config, "cpu")
        assert isinstance(net, SimMIMViT) and net.mask_ratio == 0.5
        assert net.positional_embedding.shape == (1, 16, 64)  # no CLS slot
        return
    with pytest.raises(NotImplementedError, match=r"(?is)simmim.*not a DINO mode") as err:
        build(config, "cpu")
    assert "queue A item" not in str(err.value)
