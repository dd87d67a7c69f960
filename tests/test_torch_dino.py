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
    """A config of another mode is not a DINO backbone's (the model factory
    builds those: ``build_model``); the refusal names no queue item, since
    every mode is ported."""
    with pytest.raises(NotImplementedError, match=f"mode '{mode}' is not a DINO mode") as err:
        build_backbone(_config(mode=mode), "cpu")
    assert "queue A item" not in str(err.value)


# ---------------------------------------------------------------------------
# the training slice's model pieces (dropout 0, fp32)

from vit_ssl_tpu.models import dino as jax_dino  # noqa: E402
from vit_ssl_tpu.utils import metrics as jax_metrics  # noqa: E402
from vit_ssl_tpu_torch.models import DINONetwork as TorchDINONetwork  # noqa: E402
from vit_ssl_tpu_torch.models import build_dino_network  # noqa: E402
from vit_ssl_tpu_torch.models import dino as port_dino  # noqa: E402
from vit_ssl_tpu_torch.train import AdamW, TrainState  # noqa: E402
from vit_ssl_tpu_torch.utils.metrics import DINO_METRICS, dino_distribution_stats  # noqa: E402

NET = dict(num_blocks=2, embed_dim=32, num_heads=2, patch_size=8, mlp_dim=64,
           img=16, output_dim=16)


def _jax_dino(cfg=NET, dtype=jnp.float32, use_fused_mlp=False):
    return DINONetwork(
        num_blocks=cfg["num_blocks"], input_shape=(3, cfg["img"], cfg["img"]),
        embed_dim=cfg["embed_dim"], patch_size=cfg["patch_size"],
        num_heads=cfg["num_heads"], mlp_dim=cfg["mlp_dim"], dropout=0.0,
        output_dim=cfg["output_dim"], dtype=dtype, use_fused_mlp=use_fused_mlp,
    )


def _port_dino(cfg=NET, dtype=torch.float32, use_fused_mlp=False):
    return TorchDINONetwork(
        cfg["num_blocks"], (3, cfg["img"], cfg["img"]), cfg["embed_dim"],
        cfg["patch_size"], cfg["num_heads"], cfg["mlp_dim"], dropout=0.0,
        output_dim=cfg["output_dim"], dtype=dtype, use_fused_mlp=use_fused_mlp,
    )


@pytest.fixture(scope="module")
def dino_pair():
    """(JAX module, student params, teacher params, center, port state):
    the same weights on both sides, carried by the port's bridge into a
    train state with strict=True."""
    net = _jax_dino()
    dummy = jnp.zeros((1, 16, 16, 3))
    student = _jiggle(net.init(jax.random.PRNGKey(0), dummy)["params"], 11)
    teacher = _jiggle(net.init(jax.random.PRNGKey(1), dummy)["params"], 12)
    center = np.random.default_rng(13).standard_normal((1, 16)).astype(np.float32)
    state = TrainState(_port_dino(), AdamW(lambda step: 1e-3), seed=0)
    state.load_model_state_dict(dino_state_dict_from_flax(student, teacher, center),
                                strict=True)
    return net, student, teacher, center, state


def test_train_state_loads_the_bridge_strictly(dino_pair):
    _, student, teacher, center, state = dino_pair
    sd = state.model_state_dict()
    assert set(sd) == set(dino_state_dict_from_flax(student, teacher, center))
    np.testing.assert_array_equal(sd["center"].numpy(), center)
    bad = dict(sd, extra=torch.zeros(1))
    with pytest.raises(KeyError, match="unexpected"):
        state.load_model_state_dict(bad)


@pytest.mark.parametrize("which", ["student", "teacher"])
def test_dino_network_forward_matches_jax(dino_pair, which):
    net, student, teacher, _, state = dino_pair
    params = student if which == "student" else teacher
    x = np.random.default_rng(14).random((3, 16, 16, 3), np.float32)
    want = net.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(state, which)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_dino_network_forward_packed_matches_jax(dino_pair):
    """4 local crops of 8 px (a 1x1 grid against the stored 2x2) packed
    into one block-diagonal sequence per image, view-major output."""
    net, student, _, _, state = dino_pair
    x = np.random.default_rng(15).random((4 * 3, 8, 8, 3), np.float32)
    want = net.apply({"params": student}, jnp.asarray(x), 4, True,
                     method="forward_packed")
    with torch.no_grad():
        got = state.student.forward_packed(torch.from_numpy(x), 4)
        unpacked = state.student(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def fused_dino_pair(dino_pair):
    """``dino_pair``'s weights in networks built with ``use_fused_mlp``
    (the FFNs share their parameters with the unfused ones): JAX's runs its
    Pallas kernel in interpret mode, the port's the plain versions."""
    _, student, teacher, center, _ = dino_pair
    state = TrainState(_port_dino(use_fused_mlp=True), AdamW(lambda step: 1e-3), seed=0)
    state.load_model_state_dict(dino_state_dict_from_flax(student, teacher, center),
                                strict=True)
    return _jax_dino(use_fused_mlp=True), student, state


def test_dino_network_fused_mlp_forward_matches_jax(fused_dino_pair):
    net, student, state = fused_dino_pair
    x = np.random.default_rng(14).random((3, 16, 16, 3), np.float32)
    want = net.apply({"params": student}, jnp.asarray(x))
    with torch.no_grad():
        got = state.student(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_dino_network_fused_mlp_forward_packed_matches_jax(fused_dino_pair):
    net, student, state = fused_dino_pair
    x = np.random.default_rng(15).random((4 * 3, 8, 8, 3), np.float32)
    want = net.apply({"params": student}, jnp.asarray(x), 4, True,
                     method="forward_packed")
    with torch.no_grad():
        got = state.student.forward_packed(torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_dino_head_matches_jax_and_runs_fc_in_fp32(dino_pair):
    net, student, _, _, state = dino_pair
    feats = np.random.default_rng(16).standard_normal((5, 32)).astype(np.float32)
    want = net.apply({"params": student}, jnp.asarray(feats), method=net.head_only)
    with torch.no_grad():
        got = state.student.head(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    bf16 = port_dino.DINOHead(32, 16, dtype=torch.bfloat16).reset_parameters(
        torch.Generator().manual_seed(0))
    assert bf16(torch.from_numpy(feats)).dtype == torch.float32


def test_weight_norm_reset_sets_g_to_the_norm():
    fc = port_dino.WeightNormDense(8, 4).reset_parameters(torch.Generator().manual_seed(1))
    g = fc.parametrizations.weight.original0
    v = fc.parametrizations.weight.original1
    torch.testing.assert_close(g, v.norm(dim=1, keepdim=True))
    x = torch.randn(3, 8)
    torch.testing.assert_close(fc(x), x @ v.T + fc.bias, atol=1e-6, rtol=1e-5)


def test_dino_loss_matches_jax():
    rng = np.random.default_rng(17)
    t, s = rng.standard_normal((2, 4, 16)), rng.standard_normal((6, 4, 16))
    center = rng.standard_normal((1, 16))
    t, s, center = (a.astype(np.float32) for a in (t, s, center))
    want = jax_dino.dino_loss(jnp.asarray(t), jnp.asarray(s), jnp.asarray(center),
                              0.04, 0.1)
    got = port_dino.dino_loss(torch.from_numpy(t), torch.from_numpy(s),
                              torch.from_numpy(center), 0.04, 0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_update_center_matches_jax(weighted):
    rng = np.random.default_rng(18)
    center = rng.standard_normal((1, 16)).astype(np.float32)
    t = rng.standard_normal((8, 16)).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if weighted else None
    want = jax_dino.update_center(jnp.asarray(center), jnp.asarray(t), 0.9,
                                  None if w is None else jnp.asarray(w))
    got = port_dino.update_center(torch.from_numpy(center), torch.from_numpy(t), 0.9,
                                  None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_momentum_update_in_place():
    a = port_dino.DINOHead(8, 4).reset_parameters(torch.Generator().manual_seed(2))
    b = port_dino.DINOHead(8, 4).reset_parameters(torch.Generator().manual_seed(3))
    want = {k: 0.9 * v + 0.1 * b.state_dict()[k] for k, v in a.state_dict().items()}
    port_dino.momentum_update(a, b, 0.9)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 37, 99, 100, 150])
def test_schedules_match_jax(step):
    np.testing.assert_allclose(
        port_dino.cosine_momentum_schedule(step, 0.996, 1.0, 100),
        float(jax_dino.cosine_momentum_schedule(step, 0.996, 1.0, 100)), rtol=1e-6)
    for kind in ("cosine", "linear"):
        np.testing.assert_allclose(
            port_dino.teacher_temp_schedule(step, 0.04, 0.07, 100, kind),
            float(jax_dino.teacher_temp_schedule(step, 0.04, 0.07, 100, kind)),
            rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_dino_distribution_stats_match_jax(weighted):
    rng = np.random.default_rng(19)
    t = rng.standard_normal((2, 4, 16)).astype(np.float32)
    s = rng.standard_normal((6, 4, 16)).astype(np.float32)
    center = rng.standard_normal((1, 16)).astype(np.float32)
    w = np.array([1, 0, 1, 1], np.float32) if weighted else None
    want = jax_metrics.dino_distribution_stats(
        jnp.asarray(t), jnp.asarray(s), jnp.asarray(center),
        None if w is None else jnp.asarray(w))
    got = dino_distribution_stats(torch.from_numpy(t), torch.from_numpy(s),
                                  torch.from_numpy(center),
                                  None if w is None else torch.from_numpy(w))
    assert tuple(got) == DINO_METRICS == tuple(want)
    for k in DINO_METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_build_dino_network_follows_the_config():
    cfg = _config(dtype="bfloat16")
    cfg["model"].update(output_dim=24, dropout=0.2)
    net = build_dino_network(cfg, "cpu")
    assert net.head.fully_connected.bias.shape == (24,)
    assert net.backbone.encoder_blocks[0].drop1.rate == 0.2
    assert net.backbone.dtype == torch.bfloat16
    assert not net.backbone.encoder_blocks[0].feed_forward.use_fused
    cfg["model"]["use_fused_mlp"] = True  # kernel B4: builds, in every block
    fused = build_dino_network(cfg, "cpu")
    assert all(block.feed_forward.use_fused for block in fused.backbone.encoder_blocks)
    net.reset_parameters(torch.Generator().manual_seed(1))
    fused.load_state_dict(net.state_dict(), strict=True)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = fused(x), net(x)
    assert torch.isfinite(got).all()
    assert _row_cosine(got.numpy(), want.numpy()).min() >= 0.999  # bf16 rounding
